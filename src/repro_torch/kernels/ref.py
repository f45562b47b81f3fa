"""Plain PyTorch versions of the Hopper kernels (the ground truth).

Each function computes what its kernel computes, with ordinary tensor ops,
on any device. The CPU path of ``kernels.ops`` runs them; on the card they
are only the yardstick a kernel is held against. The data-plane functions
take an optional batch of leading dims (one row per mapper or reducer),
which the kernels cover in one launch.
"""
from __future__ import annotations

import math

import torch

HASH_MULT = 0x9E3779B1  # Knuth multiplicative hash constant
_U32 = 0xFFFFFFFF


def hash_bucket(tokens: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """``((uint32(tok) * HASH_MULT) mod 2**32 >> 16) % num_buckets`` for every
    token, as int64. Computed in int64 with the multiply split in 16-bit
    halves, so no product overflows (torch has no uint32 ``>>`` on the CPU)."""
    u = tokens.to(torch.int64) & _U32
    lo = u & 0xFFFF
    hi = u >> 16
    h = (lo * HASH_MULT + (((hi * HASH_MULT) & 0xFFFF) << 16)) & _U32
    return (h >> 16) % num_buckets


def hash_partition(tokens: torch.Tensor, num_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (..., n) int32 → (bucket ids (..., n) int32, histogram (..., B) int32).
    Tokens < 0 are padding: id -1, not counted."""
    valid = tokens >= 0
    b = hash_bucket(tokens, num_buckets)
    ids = torch.where(valid, b, -1).to(torch.int32)
    hist = torch.zeros(tokens.shape[:-1] + (num_buckets,), dtype=torch.int64, device=tokens.device)
    hist.scatter_add_(-1, b, valid.to(torch.int64))
    return ids, hist.to(torch.int32)


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """values (..., n, d) float, seg_ids (..., n) int32 → (..., num_segments, d)
    fp32 sums per segment (float64 for float64 values, which the kernel does
    not take). Ids outside ``[0, num_segments)`` (-1 = padding) are dropped,
    as in the TPU kernel's one-hot."""
    *batch, n, d = values.shape
    w = 1
    for s in batch:
        w *= s
    ids = seg_ids.reshape(w, n).to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    rows = ids + torch.arange(w, device=ids.device)[:, None] * num_segments
    rows = torch.where(ok, rows, w * num_segments)  # a dump row, cut off below
    acc = torch.promote_types(values.dtype, torch.float32)
    out = torch.zeros((w * num_segments + 1, d), dtype=acc, device=values.device)
    out.index_add_(0, rows.reshape(-1), values.reshape(w * n, d).to(acc))
    return out[:-1].reshape(*batch, num_segments, d)


def ring_fused_step(acc: torch.Tensor, wire: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The S3 in-transit hop: acc fp32, wire bf16 (same shape) →
    (acc + fp32(wire), that sum rounded to bf16, nearest even)."""
    new_acc = acc + wire.to(torch.float32)
    return new_acc, new_acc.to(torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (b, h, sq, d), k/v (b, h_kv, sk, d) → softmax(q·kᵀ/√d)·v as
    (b, h, sq, d) in q's dtype, fp32 math. Query head ``i`` attends to kv
    head ``i // (h // h_kv)`` (h_kv = h is the JAX oracle's case). The
    causal mask is aligned to the bottom right, ``kpos <= qpos + (sk - sq)``,
    as in the JAX oracle."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    rep = q.shape[1] // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(rep, dim=1)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=1)
    s = torch.matmul(q.to(torch.float32), kf.transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        s = s.masked_fill(torch.arange(sk, device=q.device)[None, :] > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)
