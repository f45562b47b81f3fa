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

``ProcessMesh`` is the same interface over ``torch.distributed``: one
process per mesh device, each holding only its own shard. Its tensors
lead with one dim of size 1 per mesh axis (the process's block of the
mesh), so the code above them reads the same on both meshes; its
collectives are calls into process groups. ``count_collectives`` there
counts this process's output, whose sum over the processes is what the
world-dim mesh counts for the same program.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

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


def counting() -> bool:
    """Is a ``count_collectives`` context open? (A caller whose note takes
    work of its own skips it when none is.)"""
    return bool(_COUNTERS)


def note_collective(kind: str, nbytes: int) -> None:
    """Add ``nbytes`` of collective ``kind`` to the open counters."""
    for counts in _COUNTERS:
        counts[kind] += int(nbytes)


@contextlib.contextmanager
def uncounted():
    """Collectives run inside are not counted: the caller notes them itself
    (a wire wider than the operand that the reference moves)."""
    saved = _COUNTERS[:]
    _COUNTERS.clear()
    try:
        yield
    finally:
        _COUNTERS[:] = saved


def _noted(kind: str, out: torch.Tensor) -> torch.Tensor:
    note_collective(kind, out.numel() * out.element_size())
    return out


def _check_perm(perm: Perm, p: int) -> tuple[list[int], list[int]]:
    """``perm``'s sources and destinations, checked: each device sends and
    receives at most once, and every index lies on an axis of size ``p``."""
    srcs = [int(s) for s, _ in perm]
    dsts = [int(d) for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm {list(perm)} sends from or to a device twice")
    if any(not 0 <= i < p for i in srcs + dsts):
        raise ValueError(f"perm {list(perm)} out of range for axis size {p}")
    return srcs, dsts


def _partition(p: int, axis_index_groups) -> list[list[int]]:
    """``axis_index_groups`` of an axis of size ``p`` (None: the whole axis)
    as lists, checked to partition ``range(p)`` into groups of one size."""
    groups = [list(range(p))] if axis_index_groups is None else [
        [int(i) for i in g] for g in axis_index_groups]
    if sorted(i for g in groups for i in g) != list(range(p)):
        raise ValueError(f"axis_index_groups {axis_index_groups} must partition range({p})")
    if any(len(g) != len(groups[0]) for g in groups):
        raise ValueError(f"axis_index_groups {axis_index_groups} are not of one size")
    return groups


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
        # the leading dims of this process's tensors: the whole mesh here
        self.block = self.shape

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

    def own_index(self, axis: str) -> torch.Tensor | int:
        """The index along ``axis`` of the devices one call computes for: on
        world dims every device's (``axis_index``); a ``ProcessMesh`` gives
        its own device's as a host int."""
        return self.axis_index(axis)

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
        if tuple(x.shape[: self.ndim]) != self.block:
            raise ValueError(f"tensor {tuple(x.shape)} does not lead with the mesh block {self.block}")
        return self.ndim

    # -- collectives ---------------------------------------------------------
    def ppermute(self, x: torch.Tensor, axis: str, perm: Perm) -> torch.Tensor:
        """``lax.ppermute``: device ``src`` sends its shard to ``dst`` along
        ``axis``; a device that no pair sends to receives zeros."""
        self._local(x)
        a, p = self.dim(axis), self.axis_size(axis)
        srcs, dsts = _check_perm(perm, p)
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
        groups = _partition(p, axis_index_groups)
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

    def broadcast(self, x: torch.Tensor, axis: str, index: int) -> torch.Tensor:
        """Device ``index``'s ``x`` on every device along ``axis``: what
        ``lax.psum`` gives of that device's ``x`` and the others' zeros, and
        counted as that all-reduce. Here views of one copy of its row."""
        self._local(x)
        a = self.dim(axis)
        if not 0 <= index < self.axis_size(axis):
            raise ValueError(f"index {index} out of range for axis size {self.axis_size(axis)}")
        return _noted("all-reduce", x.narrow(a, index, 1).contiguous().expand(x.shape))

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
        idx = idx.expand(self.block).reshape(-1)
        return torch.where(idx < 0, idx + n, idx).clamp(0, n - size)

    def dynamic_index_in_dim(self, x: torch.Tensor, index) -> torch.Tensor:
        """``lax.dynamic_index_in_dim`` (``keepdims=False``) on local dim 0,
        with a per-device index (an int or a tensor of the mesh shape)."""
        nm = self._local(x)
        n = math.prod(self.block)
        flat = x.reshape((n,) + x.shape[nm:])
        rows = torch.arange(n, device=x.device)
        return flat[rows, self._per_device(index, x.shape[nm])].reshape(self.block + x.shape[nm + 1:])

    def dynamic_update_index_in_dim(self, x: torch.Tensor, update: torch.Tensor, index
                                    ) -> torch.Tensor:
        """``lax.dynamic_update_index_in_dim`` on local dim 0, per-device
        index; writes into ``x`` in place and returns it."""
        nm = self._local(x)
        n = math.prod(self.block)
        flat = x.view((n,) + x.shape[nm:])
        rows = torch.arange(n, device=x.device)
        flat[rows, self._per_device(index, x.shape[nm])] = update.reshape((n,) + x.shape[nm + 1:])
        return x

    def dynamic_slice_in_dim(self, x: torch.Tensor, start, size: int) -> torch.Tensor:
        """``lax.dynamic_slice_in_dim`` on local dim 0: ``size`` entries from a
        per-device ``start`` (negative counts from the end; clamped into range)."""
        nm = self._local(x)
        n = x.shape[nm]
        if not 0 <= size <= n:
            raise ValueError(f"slice size {size} outside [0, {n}]")
        flat = x.reshape((math.prod(self.block),) + x.shape[nm:])
        start = self._per_device(start, n, size)
        cols = start[:, None] + torch.arange(size, device=x.device)
        rows = torch.arange(flat.shape[0], device=x.device)[:, None]
        return flat[rows, cols].reshape(self.block + (size,) + x.shape[nm + 1:])


# ---------------------------------------------------------------------------
# The process mesh: one torch.distributed process per mesh device.
# ---------------------------------------------------------------------------
_STAGING: list[dict] = []


@contextlib.contextmanager
def count_staging():
    """Yields {"copies", "bytes", "seconds"}, which every host copy that a
    ``ProcessMesh`` makes for gloo on the card adds to while the context is
    open: the copies, their bytes, and the host seconds they took (each
    timed after the card was synchronised, so none waits on earlier work)."""
    counts = {"copies": 0, "bytes": 0, "seconds": 0.0}
    _STAGING.append(counts)
    try:
        yield counts
    finally:
        _STAGING.remove(counts)


def _note_staging(t: torch.Tensor, seconds: float) -> None:
    for counts in _STAGING:
        counts["copies"] += 1
        counts["bytes"] += t.numel() * t.element_size()
        counts["seconds"] += seconds


def process_device(device, backend: str) -> torch.device:
    """The device of this process's shard under ``backend``: ``None`` or an
    index-less ``"cuda"`` means this local rank's card, ``cuda:{LOCAL_RANK}``
    under nccl (which needs one card per local rank) and
    ``cuda:{LOCAL_RANK mod cards}`` under gloo (ranks share the cards and
    gloo sees host copies); with no CUDA it raises rather than run on the
    CPU. A device named with its index is kept. nccl carries CUDA tensors
    only."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; one of 'gloo', 'nccl'")
    if device is None or torch.device(device) == torch.device("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("ProcessMesh() runs on the CUDA device and none is available; "
                               "pass device='cpu' to run on the CPU")
        local, cards = int(os.environ.get("LOCAL_RANK", "0")), torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise RuntimeError(f"nccl needs one card per local rank: local rank {local}, "
                               f"{cards} cards")
        device = torch.device("cuda", local % cards)
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl carries CUDA tensors only, not {device}; use gloo on the CPU")
    return device


def _inverse(order: list[int]) -> list[int]:
    inv = [0] * len(order)
    for q, j in enumerate(order):
        inv[j] = q
    return inv


def _reduce_op(op):
    return {torch.sum: dist.ReduceOp.SUM, torch.amax: dist.ReduceOp.MAX,
            torch.amin: dist.ReduceOp.MIN}[op]


def _group_ranks(pg) -> list[int]:
    """The global ranks of process group ``pg`` (None: the default group), in group rank order."""
    return dist.get_process_group_ranks(pg if pg is not None else dist.group.WORLD)


def local_group(ranks: Sequence[int], device, backend: str | None = None):
    """A process group over the global ``ranks``, made by its members alone
    (``new_group(..., use_local_synchronization=True)``; a process outside
    it makes no call and gets None), its communicator formed before it
    returns by one ``all_reduce`` of the members. ``backend``: the group's
    (None: the default group's; "gloo" in an nccl world gives a group that
    stages the card's tensors through host memory beside the world's own).
    A default group bound to a card (nccl, ``launch.procs``) would make it
    by splitting the world's communicator, which every rank of the world
    must join: the binding is lifted while it is made, so that the members
    form it among themselves. The members call it together, as SPMD code
    does."""
    ranks = sorted(int(r) for r in ranks)
    if dist.get_rank() not in ranks:
        return None
    default = dist.group.WORLD
    bound = default.bound_device_id
    if bound is not None:
        default.bound_device_id = None
    try:
        pg = dist.new_group(ranks, use_local_synchronization=True, backend=backend)
    finally:
        if bound is not None:
            default.bound_device_id = bound
    on = torch.device(device) if dist.get_backend(pg) == "nccl" else torch.device("cpu")
    dist.all_reduce(torch.zeros(1, device=on), group=pg)
    return pg


class _Group:
    """This process's group of a collective: the process group (None: the
    default group), its members' global ranks in member order, and
    ``order[q]``, the member position of group rank ``q`` (None where the
    two orders agree)."""

    def __init__(self, pg, ranks: list[int]):
        self.pg, self.ranks = pg, ranks
        order = [ranks.index(r) for r in _group_ranks(pg)]
        self.order = None if order == list(range(len(ranks))) else order


class ProcessMesh(Mesh):
    """``Mesh``'s interface with one ``torch.distributed`` process per mesh
    device: rank ``r`` is the device at the row-major coordinate ``r`` of
    ``shape``, and holds only that device's shard.

    ``shape`` stays the global mesh; this process's tensors lead with
    ``block``, one dim of size 1 per axis, then the local shape. Every
    collective is a call into the process group of the axes it names (or
    of each ``axis_index_groups`` group): ``batch_isend_irecv`` pairs for
    ``ppermute``, ``all_to_all_single``, ``all_gather_into_tensor``,
    ``all_reduce``, ``reduce_scatter_tensor`` and ``broadcast`` (and ``gather`` to one
    process, which no ``lax`` collective is). The groups are made the
    first time an axis (or axis tuple, or group list) is asked for; SPMD
    code asks in the same order on every rank, as ``new_group`` needs.

    The default process group must be initialized first
    (``launch.procs.init_process_mesh`` or ``launch.procs.spawn``). The
    mesh spans ``group``, ``prod(shape)`` processes: the default group
    (None), or a group of some or all of its ranks (``local_group``; the
    survivors of an elastic shrink, ``launch.procs.shrink_process_mesh``; a
    gloo group beside an nccl world's). Its rank is the process's rank in
    that group, and every call names that group or one made over its ranks
    by them alone under its backend (``local_group``), with peers and roots
    among them: after a shrink no call reaches the default group or a rank
    that left. ``close`` destroys the groups such a mesh made.
    ``device=None`` means the card
    (``process_device``). Under gloo on the card every collective copies
    its operand into a pinned host buffer (one per shape, kept), runs
    gloo on it and copies the result back: ``transport`` says so, and
    ``count_staging`` counts the copies. Under nccl the tensors go as
    they are.
    """

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], device=None,
                 group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh() needs an initialized process group "
                               "(launch.procs.init_process_mesh or launch.procs.spawn)")
        backend = dist.get_backend(group)
        super().__init__(axis_names, shape, device=process_device(device, backend))
        world = dist.get_world_size(group)
        if world != self.size:
            raise ValueError(f"a mesh of {self.shape} needs {self.size} processes; "
                             f"the process group has {world}")
        self.group = group
        self.ranks = _group_ranks(group)  # the global rank of each mesh position
        self.rank = dist.get_rank(group)
        if self.rank < 0:
            raise ValueError(f"this process (rank {dist.get_rank()}) is not in the mesh's "
                             f"group {self.ranks}")
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, self.shape))
        self.block = (1,) * self.ndim
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.transport = backend + (", staged through pinned host memory" if self.staged else "")
        self._pgs: dict = {}
        self._made: list = []  # the groups made over ``group``, which ``close`` destroys
        self._pinned: dict = {}

    def axis_index(self, axis: str) -> torch.Tensor:
        """This device's index along ``axis``, an int64 tensor of the block's shape."""
        return torch.full(self.block, self.coords[self.dim(axis)], dtype=torch.int64,
                          device=self.device)

    def own_index(self, axis: str) -> int:
        """This device's index along ``axis``, on the host."""
        return self.coords[self.dim(axis)]

    def shard(self, data) -> torch.Tensor:
        """This device's shard of what ``Mesh.shard`` takes (an array whose
        leading dims are the mesh shape, or ``mesh.size`` per-device arrays
        in row-major mesh order), leading with the block."""
        if isinstance(data, np.ndarray):
            if data.shape[: self.ndim] != self.shape:
                raise ValueError(f"leading dims {data.shape[:self.ndim]} are not the mesh {self.shape}")
            mine = data[self.coords]
        else:
            data = list(data)
            if len(data) != self.size:
                raise ValueError(f"{len(data)} shards for a mesh of {self.size} devices")
            mine = np.asarray(data[self.rank])
        mine = np.ascontiguousarray(mine)
        return torch.from_numpy(mine).reshape(self.block + mine.shape).to(self.device)

    # -- groups and the host copies ---------------------------------------------
    def _peer(self, a: int, index: int) -> int:
        """The mesh position of the device at ``index`` along dim ``a`` beside this one."""
        return self.rank + (int(index) - self.coords[a]) * math.prod(self.shape[a + 1:])

    def _group(self, axes, axis_index_groups=None) -> _Group:
        """This process's group over ``axes`` (a name or a tuple), or over
        its ``axis_index_groups`` group of one axis; every group of the
        partition is made on every rank, in one order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [self.dim(a) for a in axes]
        if axis_index_groups is None:
            members = [list(itertools.product(*(range(self.shape[d]) for d in dims)))]
        elif len(dims) != 1:
            raise ValueError("axis_index_groups needs exactly one axis")
        else:
            members = [[(i,) for i in g]
                       for g in _partition(self.shape[dims[0]], axis_index_groups)]
        key = (tuple(dims), tuple(map(tuple, members)))
        hit = self._pgs.get(key)
        if hit is not None:
            return hit
        others = [d for d in range(self.ndim) if d not in dims]
        mine = None
        for rest in itertools.product(*(range(self.shape[d]) for d in others)):
            for g in members:
                ranks = []
                for m in g:
                    c = [0] * self.ndim
                    for d, v in itertools.chain(zip(others, rest), zip(dims, m)):
                        c[d] = v
                    ranks.append(self.ranks[int(np.ravel_multi_index(c, self.shape))])
                pg = self._new_group(ranks)
                if self.ranks[self.rank] in ranks:
                    mine = (pg, ranks)
        hit = self._pgs[key] = _Group(*mine)
        return hit

    def _new_group(self, ranks: list[int]):
        """The process group over the global ``ranks``: the mesh's own where
        they are all of it; on the default group a ``new_group`` that every
        rank makes; over a group of its own one made by its members alone
        (``local_group``) under that group's backend, None elsewhere."""
        if len(ranks) == self.size:
            return self.group
        if self.group is None:
            return dist.new_group(sorted(ranks))
        pg = local_group(ranks, self.device, dist.get_backend(self.group))
        if pg is not None:
            self._made.append(pg)
        return pg

    def close(self) -> None:
        """Destroy the groups that this mesh made over a group of its own
        (its axes' groups), in the order they were made: its members call it
        together. Not the group it spans, which is its maker's; on the
        default group nothing (its groups live as long as the world)."""
        for pg in self._made:
            dist.destroy_process_group(pg)
        self._made.clear()
        if self.group is not None:
            self._pgs.clear()

    def _buffer(self, tag: str, shape, dtype) -> torch.Tensor:
        key = (tag, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            # a normal tensor even when made under inference mode (a serving
            # step's), so that a later collective outside it can write into it
            with torch.inference_mode(False):
                buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _outgoing(self, t: torch.Tensor, tag: str = "send") -> torch.Tensor:
        """``t`` as the backend takes it: contiguous, and under staging copied
        into a pinned host buffer."""
        t = t.contiguous()
        if not self.staged:
            return t
        buf = self._buffer(tag, t.shape, t.dtype)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        buf.copy_(t)
        _note_staging(buf, time.perf_counter() - t0)
        return buf

    def _incoming(self, shape, dtype) -> torch.Tensor:
        """A buffer for the backend to write into: pinned host memory under staging."""
        if self.staged:
            return self._buffer("recv", shape, dtype)
        return torch.empty(tuple(shape), dtype=dtype, device=self.device)

    def _landed(self, buf: torch.Tensor) -> torch.Tensor:
        """What the backend wrote, on this mesh's device (copied there under staging)."""
        if not self.staged:
            return buf
        t0 = time.perf_counter()
        out = buf.to(self.device)
        torch.cuda.synchronize(self.device)
        _note_staging(buf, time.perf_counter() - t0)
        return out

    # -- collectives ---------------------------------------------------------
    def ppermute(self, x: torch.Tensor, axis: str, perm: Perm) -> torch.Tensor:
        """``lax.ppermute`` as ``batch_isend_irecv`` pairs: this device sends
        to its destination and receives from its source; with no source it
        gets zeros."""
        self._local(x)
        a = self.dim(axis)
        me = self.coords[a]
        srcs, dsts = _check_perm(perm, self.axis_size(axis))
        to = [d for s, d in zip(srcs, dsts) if s == me]
        frm = [s for s, d in zip(srcs, dsts) if d == me]
        if to == [me]:
            return _noted("collective-permute", x.clone(memory_format=torch.contiguous_format))
        ops = []
        if to:
            ops.append(dist.P2POp(dist.isend, self._outgoing(x), group=self.group,
                                   group_peer=self._peer(a, to[0])))
        if frm:
            recv = self._incoming(x.shape, x.dtype)
            ops.append(dist.P2POp(dist.irecv, recv, group=self.group,
                                   group_peer=self._peer(a, frm[0])))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = self._landed(recv) if frm else torch.zeros_like(
            x, memory_format=torch.contiguous_format)
        return _noted("collective-permute", out)

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int = 0,
                   concat_axis: int = 0, tiled: bool = False,
                   axis_index_groups: Sequence[Sequence[int]] | None = None) -> torch.Tensor:
        """``lax.all_to_all`` as one ``all_to_all_single`` on the group."""
        nm = self._local(x)
        g = self._group(axis, axis_index_groups)
        k, s = len(g.ranks), split_axis
        xl = x.reshape(x.shape[nm:])
        if tiled:
            if xl.shape[s] % k:
                raise ValueError(f"split dim {xl.shape[s]} not divisible by group size {k}")
            xl = xl.unflatten(s, (k, -1))
        elif xl.shape[s] != k:
            raise ValueError(f"split dim {xl.shape[s]} != group size {k}")
        send = xl.movedim(s, 0)  # chunk j goes to member j
        if g.order:
            send = send[g.order]
        shape = send.shape
        send = self._outgoing(send.reshape(-1))
        recv = self._incoming(send.shape, send.dtype)
        dist.all_to_all_single(recv, send, group=g.pg)
        y = self._landed(recv).view(shape)
        if g.order:
            y = y[_inverse(g.order)]
        y = y.movedim(0, concat_axis)  # the sources, in member order
        if tiled:
            y = y.flatten(concat_axis, concat_axis + 1)
        return _noted("all-to-all", y.reshape(self.block + y.shape).contiguous())

    def all_gather(self, x: torch.Tensor, axis: str, tiled: bool = False,
                   axis_index_groups: Sequence[Sequence[int]] | None = None) -> torch.Tensor:
        """``lax.all_gather`` as one ``all_gather_into_tensor`` on the group."""
        nm = self._local(x)
        g = self._group(axis, axis_index_groups)
        send = self._outgoing(x.reshape(-1))
        recv = self._incoming((len(g.ranks) * send.numel(),), send.dtype)
        (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(
            recv, send, group=g.pg)
        y = self._landed(recv).view((len(g.ranks),) + x.shape[nm:])
        if g.order:
            y = y[_inverse(g.order)]
        if tiled:
            y = y.reshape((-1,) + y.shape[2:])
        return _noted("all-gather", y.reshape(self.block + y.shape).contiguous())

    def _reduce(self, x, axes, axis_index_groups, op) -> torch.Tensor:
        self._local(x)
        g = self._group(axes, axis_index_groups)
        buf = (self._outgoing(x, "reduce") if self.staged
               else x.clone(memory_format=torch.contiguous_format))
        dist.all_reduce(buf, op=_reduce_op(op), group=g.pg)
        return self._landed(buf)

    def broadcast(self, x: torch.Tensor, axis: str, index: int) -> torch.Tensor:
        """``Mesh.broadcast`` as one ``broadcast`` on the axis's group."""
        self._local(x)
        if not 0 <= index < self.axis_size(axis):
            raise ValueError(f"index {index} out of range for axis size {self.axis_size(axis)}")
        g = self._group(axis)
        buf = (self._outgoing(x, "reduce") if self.staged
               else x.clone(memory_format=torch.contiguous_format))
        dist.broadcast(buf, src=g.ranks[index], group=g.pg)
        return _noted("all-reduce", self._landed(buf))

    def dynamic_index_in_dim(self, x: torch.Tensor, index) -> torch.Tensor:
        """``Mesh.dynamic_index_in_dim``; an index on the host (an int: this
        process is the one device that reads it) gives a view of ``x``'s
        slice, not a gather, counted as ``lax`` counts it (a negative index
        from the end, then clamped)."""
        if not isinstance(index, (int, np.integer)):
            return super().dynamic_index_in_dim(x, index)
        nm = self._local(x)
        n = x.shape[nm]
        i = int(index) + n if index < 0 else int(index)
        return x.select(nm, min(max(i, 0), n - 1))

    def gather(self, x: torch.Tensor, root: int = 0) -> torch.Tensor | None:
        """Every process's ``x`` (one shape on all) on process ``root`` (a
        mesh position): the (processes, *x) stack in rank order there, None
        elsewhere; one ``gather`` on the mesh's group. Not a ``lax``
        collective (nothing counts it): a checkpoint's writer collects the
        shards with it. Unstaged, the processes' shards land in the rows of
        the stack itself."""
        send = self._outgoing(x)
        if self.rank != root:
            dist.gather(send, None, group=self.group, group_dst=root)
            return None
        if not self.staged:
            out = torch.empty((self.size,) + tuple(send.shape), dtype=send.dtype,
                              device=self.device)
            dist.gather(send, list(out.unbind(0)), group=self.group, group_dst=root)
            return out
        bufs = [self._buffer(f"gather{i}", send.shape, send.dtype) for i in range(self.size)]
        dist.gather(send, bufs, group=self.group, group_dst=root)
        return torch.stack([self._landed(b) for b in bufs])

    def psum_scatter(self, x: torch.Tensor, axis: str, scatter_dimension: int = 0,
                     tiled: bool = False,
                     axis_index_groups: Sequence[Sequence[int]] | None = None) -> torch.Tensor:
        """``lax.psum_scatter`` as one ``reduce_scatter_tensor`` on the group."""
        nm = self._local(x)
        g = self._group(axis, axis_index_groups)
        k, s = len(g.ranks), scatter_dimension
        xl = x.reshape(x.shape[nm:])
        if tiled:
            if xl.shape[s] % k:
                raise ValueError(f"scatter dim {xl.shape[s]} not divisible by group size {k}")
            xl = xl.unflatten(s, (k, -1))
        elif xl.shape[s] != k:
            raise ValueError(f"scatter dim {xl.shape[s]} != group size {k}")
        send = xl.movedim(s, 0)  # member j keeps chunk j
        if g.order:
            send = send[g.order]
        chunk = send.shape[1:]
        send = self._outgoing(send.reshape(-1))
        recv = self._incoming((send.numel() // k,), send.dtype)
        (getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor)(
            recv, send, group=g.pg)
        y = self._landed(recv).view(chunk)
        return _noted("reduce-scatter", y.reshape(self.block + y.shape).contiguous())
