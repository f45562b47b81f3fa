"""SPMD execution of the shuffle on the world-dim mesh: the ``all_to_all`` path.

The port of ``repro/shuffle/spmd.py``:

* ``shuffle_reduce``    — histogram-space shuffle: bucket b of every
  mapper's array travels to device b, arrivals are summed — the S2 "reduce
  while shuffling" step.
* ``partition_tokens``  — the switch MAPPER: the ``hash_partition`` kernel
  gives each token's routing id and the per-bucket histogram (one launch
  for every mapper), then tokens are packed into a capacity-sized send
  buffer.
* ``token_shuffle``     — ``partition_tokens`` + one capacity-sized
  ``all_to_all``: raw tokens land on the reducer that owns their hash
  bucket, padding slots carry -1.

Tensors lead with the mesh dims (see ``repro_torch.mesh``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.mesh import Mesh


def shuffle_reduce(values: torch.Tensor, mesh: Mesh, axis_name: str = "all") -> torch.Tensor:
    """Shuffle every device's ``values`` (width,) by contiguous bucket and
    reduce on arrival: device k gets bucket k, (width/p,), summed across
    all mappers. Bucket = index // (width/p), so concatenating the outputs
    over the axis gives the full reduced array. Requires width % p == 0."""
    nm = mesh.ndim
    p = mesh.axis_size(axis_name)
    width = values.shape[-1]
    if width % p:
        raise ValueError(f"width {width} not divisible by world {p}")
    buckets = values.reshape(values.shape[:-1] + (p, width // p))  # keyby
    arrived = mesh.all_to_all(buckets, axis_name, split_axis=0, concat_axis=0)
    return arrived.sum(dim=nm)  # reduce at arrival


def partition_tokens(
    tokens: torch.Tensor, num_buckets: int, *, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack ``tokens`` (..., n) int32 into a (..., num_buckets, capacity)
    send buffer by hash bucket, plus the (..., num_buckets) histogram.

    A token's slot is its rank within its bucket in stream order; tokens
    past ``capacity`` are dropped (size it to ``hist.max()`` upstream) and
    empty slots hold -1. The ranks come from a stable sort of the bucket
    ids, not the reference's (n, B) one-hot cumsum, which would cost
    4 * n * B bytes per pass.
    """
    if capacity < 1:
        raise ValueError(f"capacity must be positive, got {capacity}")
    ids, hist = ops.hash_partition(tokens, num_buckets)
    n = tokens.shape[-1]
    ids64 = ids.to(torch.int64)
    sorted_ids, order = torch.sort(ids64, dim=-1, stable=True)
    # sorted stream: the -1 padding first, then bucket 0, 1, ... in stream order
    hist64 = hist.to(torch.int64)
    start = (ids64 < 0).sum(-1, keepdim=True) + torch.cumsum(hist64, -1) - hist64
    pos = torch.arange(n, device=tokens.device)
    rank_sorted = pos - torch.gather(start, -1, sorted_ids.clamp(min=0))
    slot = torch.empty_like(ids64).scatter_(-1, order, rank_sorted)
    ok = (ids64 >= 0) & (slot < capacity)
    # invalid and overflow tokens go to one extra dump slot, cut off below
    dest = torch.where(ok, ids64 * capacity + slot, num_buckets * capacity)
    buf = torch.full(tokens.shape[:-1] + (num_buckets * capacity + 1,), -1,
                     dtype=tokens.dtype, device=tokens.device)
    buf.scatter_(-1, dest, tokens)
    buf = buf[..., :-1].reshape(tokens.shape[:-1] + (num_buckets, capacity))
    return buf, hist


def token_shuffle(
    tokens: torch.Tensor, mesh: Mesh, axis_name: str = "all", *, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route raw tokens to the reducer owning their hash bucket: one
    capacity-sized ``all_to_all``. Returns (received (p*capacity,) tokens
    with -1 padding, this mapper's per-bucket histogram), per device."""
    p = mesh.axis_size(axis_name)
    buf, hist = partition_tokens(tokens, p, capacity=capacity)
    recv = mesh.all_to_all(buf, axis_name, split_axis=0, concat_axis=0)
    return recv.reshape(recv.shape[: mesh.ndim] + (-1,)), hist
