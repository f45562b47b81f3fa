"""Plain PyTorch versions of the Hopper kernels (the ground truth).

Each function computes what its kernel computes, with ordinary tensor ops,
on any device. The CPU path of ``kernels.ops`` runs them; on the card they
are only the yardstick a kernel is held against. Every function takes an
optional batch of leading dims (one row per mapper or reducer), which the
kernels cover in one launch.
"""
from __future__ import annotations

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
    fp32 sums per segment. Ids outside ``[0, num_segments)`` (-1 = padding)
    are dropped, as in the TPU kernel's one-hot."""
    *batch, n, d = values.shape
    w = 1
    for s in batch:
        w *= s
    ids = seg_ids.reshape(w, n).to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    rows = ids + torch.arange(w, device=ids.device)[:, None] * num_segments
    rows = torch.where(ok, rows, w * num_segments)  # a dump row, cut off below
    out = torch.zeros((w * num_segments + 1, d), dtype=torch.float32, device=values.device)
    out.index_add_(0, rows.reshape(-1), values.reshape(w * n, d).to(torch.float32))
    return out[:-1].reshape(*batch, num_segments, d)


def ring_fused_step(acc: torch.Tensor, wire: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The S3 in-transit hop: acc fp32, wire bf16 (same shape) →
    (acc + fp32(wire), that sum rounded to bf16, nearest even)."""
    new_acc = acc + wire.to(torch.float32)
    return new_acc, new_acc.to(torch.bfloat16)
