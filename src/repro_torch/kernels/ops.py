"""Public kernel wrappers: dispatch by the tensor's device.

A tensor on the CPU goes to the plain version in ``kernels.ref``; a tensor
on a CUDA device goes to the Hopper kernel, which launches or raises. There
is no fallback from one to the other. A tensor on the ``meta`` device
(shapes, no values: the dry run) goes to the plain version too, which gives
the output's shape and dtype. ``LAUNCHES`` counts, per kernel, the
kernel launches made through these wrappers (CPU calls do not count), so a
run can show that its path went through the kernels; ``COPIES`` counts the
inputs a kernel's own wrapper copied before it could read them (the bare
launchers count too), zeroed with ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import hash_partition as _hashp
from repro_torch.kernels import ref
from repro_torch.kernels import ring_fused_step as _ring
from repro_torch.kernels import segment_reduce as _segred
from repro_torch.kernels.ring_fused_step import COPIES

LAUNCHES = {"hash_partition": 0, "segment_reduce": 0, "ring_fused_step": 0,
            "flash_attention": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, COPIES):
        for k in counts:
            counts[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    """True where the plain version runs (the CPU, and the meta device),
    False on a CUDA device; any other device raises."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


class _SegmentReduce(torch.autograd.Function):
    """``segment_reduce`` with a gradient. The reference has no backward
    kernel to port (no ``custom_vjp`` around its ``pallas_call``): the
    gradient of a row is the gradient of the segment it was summed into,
    a plain index gather, cast to the values' dtype, and 0 where its id was
    dropped."""

    @staticmethod
    def forward(ctx, values, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        ctx.dtype = values.dtype
        if _on_cpu(values):
            return ref.segment_reduce(values, seg_ids, num_segments)
        out = _segred.segment_reduce(values, seg_ids, num_segments)
        LAUNCHES["segment_reduce"] += 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        (seg_ids,) = ctx.saved_tensors
        n_seg = grad_out.shape[-2]
        ok = (seg_ids >= 0) & (seg_ids < n_seg)
        idx = torch.where(ok, seg_ids, 0).to(torch.int64)
        rows = torch.gather(grad_out, -2, idx[..., None].expand(*idx.shape, grad_out.shape[-1]))
        return torch.where(ok[..., None], rows, 0.0).to(ctx.dtype), None, None


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """values (..., n, d), seg_ids (..., n) int32 (-1 = drop) → (..., num_segments, d)
    fp32 (float64 values: float64 on the CPU). Differentiable in ``values``."""
    return _SegmentReduce.apply(values, seg_ids, num_segments)


def hash_partition(tokens: torch.Tensor, num_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (..., n) int32 → (bucket ids (..., n) int32, histogram (..., B) int32)."""
    if _on_cpu(tokens):
        return ref.hash_partition(tokens, num_buckets)
    out = _hashp.hash_partition(tokens, num_buckets)
    LAUNCHES["hash_partition"] += 1
    return out


def ring_fused_step(acc: torch.Tensor, wire: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """acc fp32, wire bf16 → (acc + fp32(wire), bf16 of that sum)."""
    if _on_cpu(acc):
        return ref.ring_fused_step(acc, wire)
    out = _ring.ring_fused_step(acc, wire)
    LAUNCHES["ring_fused_step"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (b, h, sq, d), k/v (b, h_kv, sk, d) → softmax(q·kᵀ/√d)·v as
    (b, h, sq, d) in q's dtype."""
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal)
    out = _flash.flash_attention(q, k, v, causal=causal)
    LAUNCHES["flash_attention"] += 1
    return out
