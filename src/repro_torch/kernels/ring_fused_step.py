"""ring_fused_step on Hopper — Scenario 3's fused in-transit hop.

Replaces the Pallas TPU kernel ``repro/kernels/ring_fused_step.py``
(``ring_fused_step``): upcast the incoming bf16 wire payload, accumulate
into the fp32 partial and emit the re-compressed bf16 payload for the next
hop, in one pass instead of three. ``csrc/ring_fused_step.cu`` holds the
kernel; its note gives the bound (12 B an element). The plain version is
``kernels.ref.ring_fused_step``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def _fn():
    fn = _build.library("ring_fused_step").ring_fused_step_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ring_fused_step(acc: torch.Tensor, wire: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. acc fp32 and wire bf16 of one shape on one CUDA
    device → (new acc fp32, new wire bf16), elementwise."""
    if acc.device.type != "cuda" or wire.device != acc.device:
        raise ValueError(
            f"ring_fused_step kernel needs CUDA tensors on one device, got "
            f"{acc.device} and {wire.device}")
    if acc.dtype != torch.float32 or wire.dtype != torch.bfloat16:
        raise TypeError(f"need fp32 acc and bf16 wire, got {acc.dtype} and {wire.dtype}")
    if acc.shape != wire.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and wire {tuple(wire.shape)} differ")
    acc = acc.contiguous()
    wire = wire.contiguous()
    new_acc = torch.empty_like(acc)
    new_wire = torch.empty_like(wire)
    with torch.cuda.device(acc.device):  # a launch goes to the current card
        err = _fn()(acc.data_ptr(), wire.data_ptr(), new_acc.data_ptr(), new_wire.data_ptr(),
                    acc.numel(), torch.cuda.current_stream(acc.device).cuda_stream)
    _build.check(err, "ring_fused_step")
    return new_acc, new_wire
