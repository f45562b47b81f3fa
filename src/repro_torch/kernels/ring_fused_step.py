"""ring_fused_step on Hopper — Scenario 3's fused in-transit hop.

Replaces the Pallas TPU kernel ``repro/kernels/ring_fused_step.py``
(``ring_fused_step``): upcast the incoming bf16 wire payload, accumulate
into the fp32 partial and emit the re-compressed bf16 payload for the next
hop, in one pass instead of three. ``csrc/ring_fused_step.cu`` holds the
kernel and its note gives the bound: 12 B an element, each input read once
and each output written once. The plain version is
``kernels.ref.ring_fused_step``.

The kernel reads ``acc`` and ``wire`` where they lie. ``plan`` folds them
into at most three dims, (batches, rows, cols), cols the last dim of the
logical shape, merging neighbouring dims where both tensors allow it as a
view, and gives each tensor's element strides over them. Two routes:

- ``rows``: unit stride along cols in both, as a flat hop, a row-major
  chunk and the row-strided (tp, chunk, rest) batches of ``rep_aggregate``
  have. A streaming pass in 16-B vectors (an ``acc`` off 16-B alignment,
  such as a process-mesh chunk at an odd offset, is shifted in registers),
  in 4-B elements where a pitch, ``wire`` or an output is off alignment.
- ``tiles``: unit stride along a row dim of ``acc`` and along cols of
  ``wire``, as the transposed chunk ``scatter_gradient`` cuts along a leaf's
  later dim, dense or inside the wider gradient. 64 x 64 tiles through
  shared memory, ``acc`` read along its rows and the rest along cols.

Any other layout is copied to row-major here first (``wire`` where a
row-major ``acc`` would not do, then ``acc`` where still needed), and each
copy counts in ``COPIES["ring_fused_step"]``, which ``ops.reset_launches``
zeroes. The outputs are new contiguous tensors of the logical shape.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

ROUTES = {"rows": 0, "tiles": 1}
# tensors a wrapper copied before its kernel could read them (a plain
# integer per kernel, counted by the launcher itself)
COPIES = {"ring_fused_step": 0}


class Plan(NamedTuple):
    """How the kernel reads one call: ``route`` ("rows", "tiles" or "copy"),
    ``dims`` (batches, rows, cols), and the element strides over them of
    ``acc``, ``wire`` and the contiguous outputs (``out``)."""

    route: str
    dims: tuple[int, int, int]
    acc: tuple[int, int, int]
    wire: tuple[int, int, int]
    out: tuple[int, int, int]


_COPY = Plan("copy", (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0))


def _row_major(shape) -> tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(shape):
        strides.insert(0, n)
        n *= size
    return tuple(strides)


@functools.lru_cache(maxsize=4096)
def plan(shape: tuple[int, ...], acc_stride: tuple[int, ...], wire_stride: tuple[int, ...]
         ) -> Plan:
    """The route and kernel arguments for an ``acc`` and a ``wire`` of
    ``shape`` with these element strides, or route "copy". A pure function
    of its arguments."""
    dims: list[list[int]] = []  # [size, acc stride, wire stride, out stride]
    for d in zip(shape, acc_stride, wire_stride, _row_major(shape)):
        if d[0] == 1:
            continue
        if dims and all(s == t * d[0] for s, t in zip(dims[-1][1:], d[1:])):
            dims[-1] = [dims[-1][0] * d[0], *d[1:]]  # merges as a view in all three
        else:
            dims.append(list(d))
    cols = dims.pop() if dims else [1, 1, 1, 1]
    if len(dims) > 2 or cols[2] != 1:
        return _COPY
    one = [1, 0, 0, 0]
    if cols[1] == 1:
        batch, rows = ([one] * 2 + dims)[-2:]
        route = "rows"
    else:
        unit = [d for d in dims if d[1] == 1]
        if len(unit) != 1:
            return _COPY
        rows = unit[0]
        batch = next((d for d in dims if d is not rows), one)
        route = "tiles"
    b, r, c = batch, rows, cols
    return Plan(route, (b[0], r[0], c[0]), (b[1], r[1], c[1]), (b[2], r[2], c[2]),
                (b[3], r[3], c[3]))


@functools.cache
def _launcher():
    """The kernel's C launcher, bound once, its argument types set at load."""
    fn = _build.library("ring_fused_step").ring_fused_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _copied(t: torch.Tensor) -> torch.Tensor:
    COPIES["ring_fused_step"] += 1
    return t.contiguous()


@functools.lru_cache(maxsize=4096)
def _arguments(shape, acc_stride, wire_stride) -> tuple[Plan, tuple[int, ...]]:
    """``plan`` and the launcher's integer arguments from it (route, dims,
    strides, the outputs' two pitches)."""
    p = plan(shape, acc_stride, wire_stride)
    if p.route == "copy":
        return p, ()
    return p, (ROUTES[p.route], *p.dims, *p.acc, *p.wire, *p.out[:2])


def _planned(acc: torch.Tensor, wire: torch.Tensor):
    """(acc, wire, plan, the launcher's integer arguments) for the kernel:
    the tensors as they are where a route reads them, else copied to
    row-major (counted)."""
    p, args = _arguments(acc.shape, acc.stride(), wire.stride())
    if p.route != "copy":
        return acc, wire, p, args
    if plan(acc.shape, _row_major(acc.shape), wire.stride()).route == "copy":
        wire = _copied(wire)
        p = plan(acc.shape, acc.stride(), wire.stride())
    if p.route == "copy":
        acc = _copied(acc)
    return (acc, wire, *_arguments(acc.shape, acc.stride(), wire.stride()))


def ring_fused_step(acc: torch.Tensor, wire: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. acc fp32 and wire bf16 of one shape, any strides,
    on one CUDA device → (new acc fp32, new wire bf16), elementwise,
    contiguous."""
    if acc.device.type != "cuda" or wire.device != acc.device:
        raise ValueError(
            f"ring_fused_step kernel needs CUDA tensors on one device, got "
            f"{acc.device} and {wire.device}")
    if acc.dtype != torch.float32 or wire.dtype != torch.bfloat16:
        raise TypeError(f"need fp32 acc and bf16 wire, got {acc.dtype} and {wire.dtype}")
    if acc.shape != wire.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and wire {tuple(wire.shape)} differ")
    new_acc = torch.empty_like(acc, memory_format=torch.contiguous_format)
    new_wire = torch.empty_like(wire, memory_format=torch.contiguous_format)
    if acc.numel() == 0:
        return new_acc, new_wire
    acc, wire, _, args = _planned(acc, wire)
    # a launch goes to the current card: enter acc's only where it is another
    on_card = (contextlib.nullcontext() if acc.device.index == torch.cuda.current_device()
               else torch.cuda.device(acc.device))
    with on_card:
        err = _launcher()(acc.data_ptr(), wire.data_ptr(), new_acc.data_ptr(),
                          new_wire.data_ptr(), *args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ring_fused_step")
    return new_acc, new_wire
