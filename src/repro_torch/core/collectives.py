"""In-transit collectives: the paper's switch-reducer as ppermute schedules.

The port of ``repro/core/collectives.py`` on the world-dim mesh.
Scenario-2 ("Reduce in the network") is a ring reduce-scatter in which
every hop receives a partial, adds its own contribution and forwards — the
paper's stateful switch reducer. Scenario-3 also applies a per-hop *map*
(bf16 on the wire) before forwarding; with the ``bf16_wire``/``fp32_unwire``
pair every hop is one ``ring_fused_step`` kernel launch, which accumulates
and emits the next hop's bf16 payload in one pass.

Every function takes the ``mesh``, an axis name and optionally ``groups``
(axis_index_groups) so subgroups of an axis can run their own rings.
Tensors lead with the mesh dims; shapes below are per device.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.mesh import Mesh

MapFn = Callable[[torch.Tensor], torch.Tensor]


def _axis_size(mesh: Mesh, axis_name, groups) -> int:
    if groups is not None:
        sizes = {len(g) for g in groups}
        if len(sizes) != 1:
            raise ValueError("all groups must have equal size")
        return sizes.pop()
    return mesh.axis_size(axis_name)


def _ring_perm(mesh: Mesh, axis_name, groups, step: int = 1):
    """Permutation sending rank i -> i+step within each ring (group)."""
    if groups is None:
        p = mesh.axis_size(axis_name)
        return [(i, (i + step) % p) for i in range(p)]
    perm = []
    for g in groups:
        p = len(g)
        for k, src in enumerate(g):
            perm.append((src, g[(k + step) % p]))
    return perm


def _group_rank(mesh: Mesh, axis_name, groups):
    """The rank within its ring (0..p-1) of each device this call computes
    for (``Mesh.own_index``): a tensor of the mesh shape on world dims, this
    process's as a host int on a ``ProcessMesh``."""
    idx = mesh.own_index(axis_name)
    if groups is None:
        return idx
    table = [0] * mesh.axis_size(axis_name)
    for g in groups:
        for k, src in enumerate(g):
            table[src] = k
    if isinstance(idx, int):
        return table[idx]
    return torch.tensor(table, device=idx.device)[idx]


def ring_reduce_scatter(
    x: torch.Tensor,
    mesh: Mesh,
    axis_name,
    *,
    groups: Sequence[Sequence[int]] | None = None,
    wire_map: MapFn | None = None,
    unmap: MapFn | None = None,
) -> torch.Tensor:
    """In-transit ring reduce-scatter over local dim 0 (must equal ring size).

    ``x``: (p, ...) — p chunks per device. Returns this rank's fully reduced
    chunk ``sum_over_ranks(x[rank])`` with shape ``x.shape[1:]``.

    Schedule (p−1 steps): at step s, rank r forwards the partial of chunk
    (r−1−s) mod p and accumulates the received partial of chunk
    (r−2−s) mod p with its local copy. ``wire_map``/``unmap`` implement the
    S3 fused map; the bf16/fp32 pair runs each hop as ``ring_fused_step``.

    On a ``ProcessMesh`` the ring rank is a host int (``own_index``), and each
    hop's local chunk is a view of ``x`` (``ProcessMesh.dynamic_index_in_dim``):
    ``ring_fused_step`` reads it where it lies, transposed or not. On the
    world-dim mesh one call serves every device, and the chunks are gathered
    by index.
    """
    nm = mesh.ndim
    p = _axis_size(mesh, axis_name, groups)
    if x.shape[nm] != p:
        raise ValueError(f"leading dim {x.shape[nm]} != ring size {p}")
    if p == 1:
        return x.select(nm, 0)
    r = _group_rank(mesh, axis_name, groups)
    perm = _ring_perm(mesh, axis_name, groups, 1)
    partial = mesh.dynamic_index_in_dim(x, (r - 1) % p)

    if wire_map is bf16_wire and unmap is fp32_unwire:
        wire = bf16_wire(partial)
        for s in range(p - 1):
            recv = mesh.ppermute(wire, axis_name, perm)
            local = mesh.dynamic_index_in_dim(x, (r - 2 - s) % p)
            # local + fp32(recv) == fp32_unwire(recv) + local, bitwise
            partial, wire = ops.ring_fused_step(local, recv)
        return partial

    wire = wire_map or (lambda a: a)
    dewire = unmap or (lambda a: a)
    for s in range(p - 1):
        recv = mesh.ppermute(wire(partial), axis_name, perm)
        partial = dewire(recv) + mesh.dynamic_index_in_dim(x, (r - 2 - s) % p)
    return partial


def ring_all_gather(
    x: torch.Tensor,
    mesh: Mesh,
    axis_name,
    *,
    groups: Sequence[Sequence[int]] | None = None,
) -> torch.Tensor:
    """In-transit ring all-gather: each rank contributes ``x`` (chunk shape),
    returns (p, ...) with chunk k from rank k. p−1 ppermute hops."""
    nm = mesh.ndim
    p = _axis_size(mesh, axis_name, groups)
    if p == 1:
        return x.unsqueeze(nm)
    r = _group_rank(mesh, axis_name, groups)
    perm = _ring_perm(mesh, axis_name, groups, 1)
    out = torch.zeros(x.shape[:nm] + (p,) + x.shape[nm:], dtype=x.dtype, device=x.device)
    mesh.dynamic_update_index_in_dim(out, x, r)
    cur = x
    for s in range(p - 1):
        cur = mesh.ppermute(cur, axis_name, perm)
        # after s+1 forwards, ``cur`` is the chunk of rank (r - s - 1)
        mesh.dynamic_update_index_in_dim(out, cur, (r - s - 1) % p)
    return out


def _chunked(x: torch.Tensor, nm: int, p: int) -> tuple[torch.Tensor, int]:
    """Flatten each device's tensor, zero-pad to a multiple of p, split in p chunks."""
    flat = x.reshape(x.shape[:nm] + (-1,))
    pad = (-flat.shape[-1]) % p
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(x.shape[:nm] + (p, -1)), pad


def _unchunked(full: torch.Tensor, like: torch.Tensor, nm: int, pad: int) -> torch.Tensor:
    full = full.reshape(like.shape[:nm] + (-1,))
    if pad:
        full = full[..., :-pad]
    return full.reshape(like.shape)


def ring_all_reduce(
    x: torch.Tensor,
    mesh: Mesh,
    axis_name,
    *,
    groups: Sequence[Sequence[int]] | None = None,
    wire_map: MapFn | None = None,
    unmap: MapFn | None = None,
) -> torch.Tensor:
    """RS + AG ring all-reduce of an arbitrary-shaped tensor.

    Pads the flattened tensor to a multiple of p, runs the in-transit
    reduce-scatter then all-gather, unpads, restores shape. 2(p−1) hops,
    2·S·(p−1)/p bytes on the wire per device.
    """
    p = _axis_size(mesh, axis_name, groups)
    if p == 1:
        return x
    nm = mesh.ndim
    chunks, pad = _chunked(x, nm, p)
    mine = ring_reduce_scatter(chunks, mesh, axis_name, groups=groups,
                               wire_map=wire_map, unmap=unmap)
    full = ring_all_gather(mine, mesh, axis_name, groups=groups)
    return _unchunked(full, x, nm, pad)


def tree_all_reduce(
    x: torch.Tensor,
    mesh: Mesh,
    axis_name,
    *,
    groups: Sequence[Sequence[int]] | None = None,
) -> torch.Tensor:
    """Recursive-doubling all-reduce (log2 p exchange+add rounds); requires
    a power-of-two ring size."""
    p = _axis_size(mesh, axis_name, groups)
    if p & (p - 1):
        raise ValueError(f"tree_all_reduce needs power-of-two size, got {p}")
    step = 1
    while step < p:
        if groups is None:
            perm = [(i, i ^ step) for i in range(p)]
        else:
            perm = [(src, g[k ^ step]) for g in groups for k, src in enumerate(g)]
        x = x + mesh.ppermute(x, axis_name, perm)
        step *= 2
    return x


def hierarchical_all_reduce(
    x: torch.Tensor,
    mesh: Mesh,
    inner_axis,
    outer_axis,
    *,
    wire_map: MapFn | None = None,
    unmap: MapFn | None = None,
) -> torch.Tensor:
    """Two-level all-reduce for the multi-pod mesh: ring-RS over
    ``inner_axis``, psum of the shards over ``outer_axis``, ring-AG back
    over ``inner_axis``. Cross-pod traffic is S/p_inner instead of S."""
    p = mesh.axis_size(inner_axis)
    nm = mesh.ndim
    chunks, pad = _chunked(x, nm, p)
    mine = ring_reduce_scatter(chunks, mesh, inner_axis, wire_map=wire_map, unmap=unmap)
    mine = mesh.psum(mine, outer_axis)
    full = ring_all_gather(mine, mesh, inner_axis)
    return _unchunked(full, x, nm, pad)


# Wire-compression maps for Scenario 3 (map fused into the hop).
def bf16_wire(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def fp32_unwire(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)
