"""A device mesh held in one tensor: the port's stand-in for ``shard_map``.

The JAX package runs SPMD over N devices, each seeing its own shard, and
moves data with ``lax`` collectives. The port runs every shard on one card:
a tensor carries one leading dim per mesh axis, in mesh order, followed by
the per-device (local) shape. Collectives become index operations over
those dims with ``lax``'s semantics, so code written per device in the
reference reads the same here with ``mesh`` passed along.

``Mesh(..., device=None)`` means the card; with no CUDA it raises rather
than run on the CPU. The tests pass ``device="cpu"``.

``count_collectives()`` counts, while it is open, the bytes that the
collectives put out, by the XLA collective they stand for: every device's
output, summed over the mesh (the roofline's collective term).
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch

Perm = Sequence[tuple[int, int]]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COUNTERS: list[dict[str, int]] = []


@contextlib.contextmanager
def count_collectives():
    """Yields {collective: bytes}, which every collective run while the
    context is open adds its output's bytes to (all devices')."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    _COUNTERS.append(counts)
    try:
        yield counts
    finally:
        _COUNTERS.remove(counts)


def note_collective(kind: str, nbytes: int) -> None:
    """Add ``nbytes`` of collective ``kind`` to the open counters."""
    for counts in _COUNTERS:
        counts[kind] += int(nbytes)


def _noted(kind: str, out: torch.Tensor) -> torch.Tensor:
    note_collective(kind, out.numel() * out.element_size())
    return out


def resolve_device(device, who: str) -> torch.device:
    """``None`` means the card; with no CUDA this raises rather than run on
    the CPU. ``who`` names the caller in the message."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who} runs on the CUDA device and none is available; "
                               "pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


class Mesh:
    """Named mesh axes of given sizes, laid out on ``device``."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], device=None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.shape)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate axis names {self.axis_names}")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"axis sizes must be positive, got {self.shape}")
        self.device = resolve_device(device, "Mesh()")

    # -- layout ------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def dim(self, axis: str) -> int:
        """The tensor dim that carries mesh axis ``axis``."""
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(f"unknown mesh axis {axis!r}; mesh has {self.axis_names}") from None

    def axis_size(self, axis: str) -> int:
        return self.shape[self.dim(axis)]

    def axis_index(self, axis: str) -> torch.Tensor:
        """Every device's index along ``axis``: an int64 tensor of the mesh shape."""
        a = self.dim(axis)
        view = [1] * self.ndim
        view[a] = self.shape[a]
        idx = torch.arange(self.shape[a], device=self.device).view(view)
        return idx.expand(self.shape).contiguous()

    def shard(self, data) -> torch.Tensor:
        """Lay per-device numpy shards onto the mesh (``in_specs=P(*axes)``):
        an array whose leading dims are the mesh shape, or a flat sequence of
        ``mesh.size`` equal-shaped per-device arrays in row-major mesh order."""
        if isinstance(data, np.ndarray):
            arr = data
        else:
            arr = np.stack([np.asarray(s) for s in data])
            arr = arr.reshape(self.shape + arr.shape[1:])
        if arr.shape[: self.ndim] != self.shape:
            raise ValueError(f"leading dims {arr.shape[:self.ndim]} are not the mesh {self.shape}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _local(self, x: torch.Tensor) -> int:
        """Check ``x`` carries the mesh dims; return the dim its local shape starts at."""
        if tuple(x.shape[: self.ndim]) != self.shape:
            raise ValueError(f"tensor {tuple(x.shape)} does not lead with the mesh {self.shape}")
        return self.ndim

    # -- collectives ---------------------------------------------------------
    def ppermute(self, x: torch.Tensor, axis: str, perm: Perm) -> torch.Tensor:
        """``lax.ppermute``: device ``src`` sends its shard to ``dst`` along
        ``axis``; a device that no pair sends to receives zeros."""
        self._local(x)
        a, p = self.dim(axis), self.axis_size(axis)
        srcs = [int(s) for s, _ in perm]
        dsts = [int(d) for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"perm {list(perm)} sends from or to a device twice")
        if any(not 0 <= i < p for i in srcs + dsts):
            raise ValueError(f"perm {list(perm)} out of range for axis size {p}")
        xs = x.movedim(a, 0)
        if sorted(dsts) == list(range(p)):
            inv = [0] * p
            for s, d in zip(srcs, dsts):
                inv[d] = s
            out = xs[torch.tensor(inv, device=x.device)]
        else:
            out = torch.zeros_like(xs)
            if srcs:
                out[torch.tensor(dsts, device=x.device)] = xs[torch.tensor(srcs, device=x.device)]
        return _noted("collective-permute", out.movedim(0, a).contiguous())

    def _groups(self, axis: str, axis_index_groups) -> tuple[torch.Tensor, torch.Tensor]:
        """``axis_index_groups`` along ``axis`` (None: the whole axis) as two
        index tensors: (p, k) each device's group members in group order,
        and (p,) its position in its group."""
        p = self.axis_size(axis)
        groups = [list(range(p))] if axis_index_groups is None else [
            [int(i) for i in g] for g in axis_index_groups]
        if sorted(i for g in groups for i in g) != list(range(p)):
            raise ValueError(f"axis_index_groups {axis_index_groups} must partition range({p})")
        k = len(groups[0])
        if any(len(g) != k for g in groups):
            raise ValueError(f"axis_index_groups {axis_index_groups} are not of one size")
        members = [None] * p
        pos = [0] * p
        for g in groups:
            for j, m in enumerate(g):
                members[m], pos[m] = g, j
        return (torch.tensor(members, device=self.device), torch.tensor(pos, device=self.device))

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int = 0,
                   concat_axis: int = 0, tiled: bool = False,
                   axis_index_groups: Sequence[Sequence[int]] | None = None) -> torch.Tensor:
        """``lax.all_to_all``: chunk ``d`` of local dim ``split_axis`` on
        device ``s`` lands as chunk ``s`` of local dim ``concat_axis`` on
        device ``d``; untiled, ``recv[d][s] = send[s][d]``. With
        ``axis_index_groups``, ``s`` and ``d`` are positions within each
        group, and each group exchanges on its own."""
        nm = self._local(x)
        a, p = self.dim(axis), self.axis_size(axis)
        s = nm + split_axis
        if axis_index_groups is None and not tiled:
            if x.shape[s] != p:
                raise ValueError(f"split dim {x.shape[s]} != axis size {p}")
            return _noted("all-to-all", x.transpose(a, s).movedim(s, nm + concat_axis).contiguous())
        if axis_index_groups is None:
            n = x.shape[s]
            if n % p:
                raise ValueError(f"split dim {n} not divisible by axis size {p}")
            y = x.reshape(x.shape[:s] + (p, n // p) + x.shape[s + 1:]).transpose(a, s)
            # y's local dims: the split dim became (source, chunk); gather the
            # sources into the concat dim, in source order
            c = nm + concat_axis + (1 if concat_axis >= split_axis else 0)
            j = c - 1 if c > s else c
            y = y.movedim(s, j)
            return _noted("all-to-all", y.reshape(y.shape[:j] + (y.shape[j] * y.shape[j + 1],)
                                                  + y.shape[j + 2:]).contiguous())
        members, pos = self._groups(axis, axis_index_groups)
        k = members.shape[1]
        xs = x.movedim(a, 0)  # (p, other mesh dims, local)
        if tiled:
            if xs.shape[s] % k:
                raise ValueError(f"split dim {xs.shape[s]} not divisible by group size {k}")
            xs = xs.unflatten(s, (k, -1))
        elif xs.shape[s] != k:
            raise ValueError(f"split dim {xs.shape[s]} != group size {k}")
        # device m takes chunk pos[m] from each member of its group, in group order
        y = xs.movedim(s, 1)[members, pos[:, None]]  # (p, k sources, ...)
        y = y.movedim(1, nm + concat_axis)
        if tiled:
            y = y.flatten(nm + concat_axis, nm + concat_axis + 1)
        return _noted("all-to-all", y.movedim(0, a).contiguous())

    def all_gather(self, x: torch.Tensor, axis: str, tiled: bool = False,
                   axis_index_groups: Sequence[Sequence[int]] | None = None) -> torch.Tensor:
        """``lax.all_gather``: every device gets the (p, *local) stack of the
        shards along ``axis`` (of its group's members, in group order, with
        ``axis_index_groups``); tiled, concatenated along local dim 0."""
        nm = self._local(x)
        a, p = self.dim(axis), self.axis_size(axis)
        if axis_index_groups is None:
            y = x.movedim(a, nm - 1).unsqueeze(a)
            out = y.expand(y.shape[:a] + (p,) + y.shape[a + 1:]).contiguous()
        else:
            members, _ = self._groups(axis, axis_index_groups)
            out = x.movedim(a, 0)[members].movedim(1, nm).movedim(0, a).contiguous()  # (..., k, local)
        if tiled:
            out = out.reshape(out.shape[:nm] + (-1,) + out.shape[nm + 2:])
        return _noted("all-gather", out)

    def psum(self, x: torch.Tensor, axes, axis_index_groups: Sequence[Sequence[int]] | None = None
             ) -> torch.Tensor:
        """``lax.psum`` over one axis or a tuple of axes; with
        ``axis_index_groups`` (one axis only), each group sums on its own."""
        return _noted("all-reduce", self._reduce(x, axes, axis_index_groups, torch.sum))

    def pmax(self, x: torch.Tensor, axes, axis_index_groups: Sequence[Sequence[int]] | None = None
             ) -> torch.Tensor:
        """``lax.pmax``, as ``psum`` with the maximum."""
        return _noted("all-reduce", self._reduce(x, axes, axis_index_groups, torch.amax))

    def pmin(self, x: torch.Tensor, axes, axis_index_groups: Sequence[Sequence[int]] | None = None
             ) -> torch.Tensor:
        """``lax.pmin``, as ``psum`` with the minimum."""
        return _noted("all-reduce", self._reduce(x, axes, axis_index_groups, torch.amin))

    def _reduce(self, x, axes, axis_index_groups, op) -> torch.Tensor:
        self._local(x)
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [self.dim(a) for a in axes]
        if axis_index_groups is None:
            return op(x, dim=dims, keepdim=True).expand(x.shape).contiguous()
        if len(axes) != 1:
            raise ValueError("axis_index_groups needs exactly one axis")
        members, _ = self._groups(axes[0], axis_index_groups)
        return op(x.movedim(dims[0], 0)[members], dim=1).movedim(0, dims[0]).contiguous()

    def psum_scatter(self, x: torch.Tensor, axis: str, scatter_dimension: int = 0,
                     tiled: bool = False,
                     axis_index_groups: Sequence[Sequence[int]] | None = None) -> torch.Tensor:
        """``lax.psum_scatter``: the sum over ``axis`` (over each group with
        ``axis_index_groups``), of which device ``i`` (position ``i`` in its
        group) keeps chunk ``i`` of local dim ``scatter_dimension``; untiled,
        that dim has the group's size and is dropped."""
        nm = self._local(x)
        a = self.dim(axis)
        members, pos = self._groups(axis, axis_index_groups)
        k = members.shape[1]
        s = nm + scatter_dimension
        total = x.movedim(a, 0)[members].sum(1)  # (p, other mesh dims, local)
        if tiled:
            if total.shape[s] % k:
                raise ValueError(f"scatter dim {total.shape[s]} not divisible by group size {k}")
            total = total.unflatten(s, (k, -1))
        elif total.shape[s] != k:
            raise ValueError(f"scatter dim {total.shape[s]} != group size {k}")
        rows = torch.arange(total.shape[0], device=x.device)
        out = total.movedim(s, 1)[rows, pos]
        return _noted("reduce-scatter", out.movedim(0, a).contiguous())

    # -- per-device indexing -----------------------------------------------
    def _per_device(self, index, n: int, size: int = 1) -> torch.Tensor:
        """Flat per-device start indices into a dim of ``n``, as ``lax`` reads
        them: negative counts from the end, then clamped so ``size`` fits."""
        idx = torch.as_tensor(index, device=self.device).to(torch.int64)
        idx = idx.expand(self.shape).reshape(-1)
        return torch.where(idx < 0, idx + n, idx).clamp(0, n - size)

    def dynamic_index_in_dim(self, x: torch.Tensor, index) -> torch.Tensor:
        """``lax.dynamic_index_in_dim`` (``keepdims=False``) on local dim 0,
        with a per-device index (an int or a tensor of the mesh shape)."""
        nm = self._local(x)
        flat = x.reshape((self.size,) + x.shape[nm:])
        rows = torch.arange(self.size, device=x.device)
        return flat[rows, self._per_device(index, x.shape[nm])].reshape(self.shape + x.shape[nm + 1:])

    def dynamic_update_index_in_dim(self, x: torch.Tensor, update: torch.Tensor, index
                                    ) -> torch.Tensor:
        """``lax.dynamic_update_index_in_dim`` on local dim 0, per-device
        index; writes into ``x`` in place and returns it."""
        nm = self._local(x)
        flat = x.view((self.size,) + x.shape[nm:])
        rows = torch.arange(self.size, device=x.device)
        flat[rows, self._per_device(index, x.shape[nm])] = update.reshape((self.size,) + x.shape[nm + 1:])
        return x

    def dynamic_slice_in_dim(self, x: torch.Tensor, start, size: int) -> torch.Tensor:
        """``lax.dynamic_slice_in_dim`` on local dim 0: ``size`` entries from a
        per-device ``start`` (negative counts from the end; clamped into range)."""
        nm = self._local(x)
        n = x.shape[nm]
        if not 0 <= size <= n:
            raise ValueError(f"slice size {size} outside [0, {n}]")
        flat = x.reshape((self.size,) + x.shape[nm:])
        start = self._per_device(start, n, size)
        cols = start[:, None] + torch.arange(size, device=x.device)
        rows = torch.arange(self.size, device=x.device)[:, None]
        return flat[rows, cols].reshape(self.shape + (size,) + x.shape[nm + 1:])
