"""hash_partition on Hopper — the p4mr switch MAPPER.

Replaces the Pallas TPU kernel ``repro/kernels/hash_partition.py``
(``hash_partition``): each token's reducer bucket (multiplicative hash, the
paper's "routing id") and the per-bucket histogram, the capacity signal the
shuffle sizes its send buffer from. The CUDA source is
``csrc/hash_partition.cu``; its note gives the bound (8 B a token of memory
traffic) and how the design meets it. The plain version is
``kernels.ref.hash_partition``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# the privatized histogram lives in shared memory: 227 KB a block on Hopper
MAX_BUCKETS = 232448 // 4
MAX_ROWS = 65535  # rows ride on gridDim.y


def _fn():
    fn = _build.library("hash_partition").hash_partition_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hash_partition(tokens: torch.Tensor, num_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. tokens (..., n) int32 on a CUDA device → (ids
    (..., n) int32, histogram (..., num_buckets) int32); every leading row
    (mapper) in the one launch."""
    if tokens.device.type != "cuda":
        raise ValueError(f"hash_partition kernel needs a CUDA tensor, got {tokens.device}")
    if tokens.dtype != torch.int32:
        raise TypeError(f"tokens must be int32, got {tokens.dtype}")
    if tokens.dim() < 1:
        raise ValueError("tokens must have at least one dim")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(
            f"num_buckets {num_buckets} outside [1, {MAX_BUCKETS}]: the per-block "
            "histogram must fit in shared memory")
    tokens = tokens.contiguous()
    n = tokens.shape[-1]
    rows = tokens.numel() // n if n else 0
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the grid's {MAX_ROWS}")
    ids = torch.empty_like(tokens)
    hist = torch.zeros(tokens.shape[:-1] + (num_buckets,), dtype=torch.int32, device=tokens.device)
    with torch.cuda.device(tokens.device):  # a launch goes to the current card
        err = _fn()(tokens.data_ptr(), ids.data_ptr(), hist.data_ptr(), rows, n, num_buckets,
                    torch.cuda.current_stream(tokens.device).cuda_stream)
    _build.check(err, "hash_partition")
    return ids, hist
