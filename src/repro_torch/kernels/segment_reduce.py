"""segment_reduce on Hopper — the p4mr switch REDUCER.

Replaces the Pallas TPU kernel ``repro/kernels/segment_reduce.py``
(``segment_reduce``): rows of ``values`` summed into ``num_segments``
stateful buckets (word counts, reducer labels). The TPU kernel's one-hot
matmul is not carried over. ``csrc/segment_reduce.cu`` keeps a private
histogram per block in shared memory where the bins fit
(``max_bin_bytes``: num_segments × 4 bytes for a broadcast value row,
counted in uint32; else num_segments × d × 4 in fp32) and scatters with
global fp32 atomics where they do not; its note gives the bound (one id and
one value row per row). The plain version is ``kernels.ref.segment_reduce``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _fn():
    fn = _build.library("segment_reduce").segment_reduce_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def max_bin_bytes() -> int:
    """The most bytes of bins the kernel's shared-memory branch takes on the
    current CUDA device; a shape whose bins are larger takes the global-atomic
    branch."""
    fn = _build.library("segment_reduce").segment_reduce_max_bin_bytes
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Launch the kernel. values (..., n, d) fp32/bf16/fp16 and seg_ids
    (..., n) int32 on one CUDA device → (..., num_segments, d) fp32; each
    leading row (reducer) sums into its own segments, all in one launch.
    ``values`` may be a broadcast along rows (``expand``), read in place."""
    if values.device.type != "cuda" or seg_ids.device != values.device:
        raise ValueError(
            f"segment_reduce kernel needs CUDA tensors on one device, got "
            f"{values.device} and {seg_ids.device}")
    if values.dtype not in DTYPES:
        raise TypeError(f"values dtype {values.dtype} not in {sorted(map(str, DTYPES))}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"seg_ids must be int32, got {seg_ids.dtype}")
    if values.dim() < 2 or values.shape[:-1] != seg_ids.shape:
        raise ValueError(f"values {tuple(values.shape)} and seg_ids {tuple(seg_ids.shape)} "
                         "must be (..., n, d) and (..., n)")
    if num_segments < 1:
        raise ValueError(f"num_segments must be positive, got {num_segments}")
    *batch, n, d = values.shape
    rows = values.reshape(-1, d)  # a view for contiguous and row-broadcast inputs
    if d > 1 and rows.stride(1) != 1:
        rows = rows.contiguous()
    ids = seg_ids.contiguous()
    out = torch.zeros((*batch, num_segments, d), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):  # a launch goes to the current card
        err = _fn()(rows.data_ptr(), DTYPES[values.dtype], ids.data_ptr(), out.data_ptr(),
                    rows.shape[0], max(n, 1), rows.stride(0), d, num_segments,
                    torch.cuda.current_stream(values.device).cuda_stream)
    _build.check(err, "segment_reduce")
    return out
