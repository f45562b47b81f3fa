"""flash_attention on Hopper — the LM stack's prefill attention.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, ``pallas_call`` at :79): ``softmax(q·kᵀ/√d)·v`` with
an optional causal mask, in online-softmax blocks so the score matrix never
reaches device memory. ``csrc/flash_attention.cu`` holds the kernel and its
note gives the bound (operations, on the bf16 tensor cores). Unlike the TPU
kernel it takes any sequence length (ragged tiles are masked) and k/v with
fewer heads than q (grouped-query attention: query head ``i`` reads kv head
``i // (h // h_kv)``). bf16 inputs are loaded by TMA through tensor maps
that the launcher builds per call over the tensors as laid out; fp32 inputs
take a CUDA-core kernel. The plain version is ``kernels.ref.flash_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
# grid: fp32 (b·h, q tiles of 32 rows), q tiles on grid.y; bf16 one linear
# grid.x of b·h × q tiles of 128 rows
_MAX_Q_TILES = 65535
_Q_TILE_ROWS = {torch.bfloat16: 128, torch.float32: 32}


def _fn():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides, else a
    contiguous copy in a new allocation. Both kernels need unit stride along d; a bf16 tensor map
    (TMA) also needs a 16-byte aligned start and, along every dimension
    longer than 1, a positive stride of a multiple of 16 bytes. The model's
    (b, s, h, d) views meet that and are read in place; a view that does not
    (an offset start, a broadcast head) costs one copy here."""
    rows_aligned = t.data_ptr() % 16 == 0 and all(
        st > 0 and st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)
    if t.stride(3) == 1 and (t.dtype != torch.bfloat16 or rows_aligned):
        return t
    return t.clone(memory_format=torch.contiguous_format)  # a new, aligned allocation


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Launch the kernel. q (b, h, sq, d), k/v (b, h_kv, sk, d) with h_kv
    dividing h, fp32 or bf16 (one dtype), d in (64, 128), on one CUDA device
    → (b, h, sq, d) in q's dtype, laid out in memory as q is. Strided views
    (the model's (b, s, h, d) seen as (b, h, s, d)) are read in place.
    ``causal`` needs sq == sk (kpos <= qpos). Scores are scaled by 1/√d."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs CUDA tensors on one device, got "
                         f"{q.device}, {k.device} and {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {sorted(map(str, DTYPES))}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (b, h, sq, d) and k, v (b, h_kv, sk, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, hkv, sk, dk = k.shape
    if k.shape[0] != b or dk != d or hkv < 1 or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if causal and sq != sk:
        raise ValueError(f"causal attention needs sq == sk, got {sq} and {sk}")
    n_tiles = -(-sq // _Q_TILE_ROWS[q.dtype])
    if (sk < 1 or n_tiles > _MAX_Q_TILES or b * h >= 2**31
            or (q.dtype == torch.bfloat16 and n_tiles * b * h >= 2**31)):
        raise ValueError(f"sizes out of the kernel's range: b·h={b * h}, sq={sq}, sk={sk}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    q, k, v = _readable(q), _readable(k), _readable(v)
    if out.stride(3) != 1:
        out = torch.empty_like(q)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    with torch.cuda.device(q.device):  # a launch goes to the current card
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
                    b, h, hkv, sq, sk, d, *strides, int(causal),
                    1.0 / math.sqrt(d),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused a layout of q "
                           f"{tuple(q.stride())}, k {tuple(k.stride())}, v {tuple(v.stride())} "
                           f"(CUresult {-err})")
    _build.check(err, "flash_attention")
    return out
