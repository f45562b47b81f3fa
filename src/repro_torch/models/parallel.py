"""Sharding: the reference's ``ShardEnv`` over a ``("data", "model")``
mesh of world dims on one card, the tensor-parallel products, the sharded
vocab, and the gradient aggregation of training.

The counterpart of ``repro/models/parallel.py``. ``ShardEnv`` carries every
field and derived group of the reference's: a model axis of ``model_size``
devices runs ``tp`` tensor-parallel ranks and ``rep = model_size / tp``
replica groups (model index m ↦ tp rank m // rep, rep rank m % rep), the
data axis (and pod) is the FSDP world.

The port folds the tp ranks into the ops rather than looping over them. A
value that the reference holds equal on every rank of a group is held once:
the parameters (logical, without the duplicate slots of kv heads and
experts; ``fetch_weight`` gives the ranks' working slices as a view), the
residual stream after ``psum_tp``, the caches, the rows that
the tp ranks of a group share. What differs between ranks carries a rank
dim: a column-parallel product is one matmul whose output dim reads as
(tp, F/tp), a row-parallel product is a batched product over tp whose bf16
partials ``psum_tp`` sums, and the compute-at-data route's column product
sums the bf16 partials of the fsdp d-slices. The logits of the tp vocab
shards are held side by side, so ``argmax_logits``'s first maximum is the
reference's pmax/pmin tie-break toward the smallest id.

On a ``ProcessMesh`` (``ShardEnv.mesh``: one process per device) the same
code runs at one tp rank: the process holds its device's shard of every
parameter (``convert.rank_shards``), its rows and its cache, ``held_tp`` is
1, and every collective of the reference's steps is a process-group call.
``fetch_weight`` all-gathers the stored shard, the FSDP dim over (pod,
data) and then the TP dim over the rep groups (serving gathers the bf16
copies: the same values as the reference's fp32 gather, half the bytes);
``psum_tp`` sums the partials in fp32 over the tp group and rounds to
bf16 once, as the folded sum does; the compute-at-data products move
activations with ``all_to_all``/``all_gather``/``psum_scatter``; the
embedding psums the vocab shards; the greedy token is the local argmax with
``pmax``/``pmin``. On the world-dim mesh each of those is noted for
``mesh.count_collectives`` with every device's bytes, so the counts of the
two forms agree (where every device's rows are its own: the batch splits
over the rep groups, or rep is 1). Both count the operands' bytes, as the
reference moves them: the fp32 that the process form's ``psum_tp`` and
compute-at-data reduce-scatter put on the wire for bf16 partials is a
wider wire for the same collective.

Training on world dims runs the same folded forward under autograd, one
data-parallel rank (pod × data × rep) at a time, and the backward gives the
logical gradient of the rank's loss. What the reference's weight fetch does in its
backward is then run leaf by leaf on every rank's gradient
(``aggregate_leaf``): the rep-group reduce-scatter along the TP dim
(``rep_aggregate``), then the FSDP reduce-scatter along the FSDP dim over
(pod, data) (``fsdp_aggregate``), each as the scenario says, and the sums of
``sync_gradients`` for the leaves the fetch does not gather (``fsdp_dim``
None: over the data world; ``tp_dim`` None or kv/expert slots: over the
model axis).

The process form is differentiable as the reference's ``shard_map`` with
``check_vma=False`` is: each collective is a ``torch.autograd.Function``
whose backward is the reference's transpose. A weight's gather
(``fetch_weight``, the reference's ``scenario_all_gather``) reduce-scatters
its gradient under the env's scenario (``scatter_gradient``, ``_sag_bwd``):
the rep groups' ring first, then the FSDP one, so that the gradient leaves
the backward aggregated over the data-parallel world and shaped like the
rank's storage shard. A psum's backward is the same psum (each device's
loss is its own, and their sum is the objective), an activation's
all-gather's a reduce-scatter, an all-to-all's the inverse all-to-all
(``psum``, ``all_gather``, ``all_to_all``). A training step fetches every
leaf once in fp32, and the gradients of its uses and microbatches add in
fp32 before the one reduce-scatter (``launch.steps.ProcessTrainStep``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.scenarios import Scenario
from repro_torch.mesh import Mesh, ProcessMesh, counting, note_collective, uncounted

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ShardEnv:
    """Static sharding context: ``ShardEnv`` of ``repro/models/parallel.py``."""

    model_size: int  # size of the 'model' mesh axis
    data_size: int
    pod_size: int = 1
    tp: int = 1  # tensor-parallel degree (divides model_size)
    scenario: Scenario = Scenario.NATIVE
    model_axis: str = "model"
    data_axis: str = "data"
    pod_axis: str | None = None  # None on single-pod meshes
    # serving: route the decode activations to the weights' fsdp shards
    # (serve_col_matmul) instead of gathering the weights
    compute_at_data: bool = False
    # a ProcessMesh: this process is one device of it, at held_tp = 1
    mesh: Mesh | None = None

    def __post_init__(self):
        if self.model_size % self.tp:
            raise ValueError(f"tp={self.tp} must divide model axis {self.model_size}")

    @property
    def rep(self) -> int:
        return self.model_size // self.tp

    @property
    def fsdp_axes(self) -> tuple[str, ...]:
        return (self.pod_axis, self.data_axis) if self.pod_axis else (self.data_axis,)

    @property
    def fsdp_size(self) -> int:
        return self.pod_size * self.data_size

    @property
    def dp_world(self) -> int:
        """Total gradient-averaging world (pod × data × rep)."""
        return self.fsdp_size * self.rep

    @property
    def tp_groups(self) -> list[list[int]] | None:
        """Groups of model-axis indices forming each TP domain (fixed r)."""
        return tp_groups(self.tp, self.rep)

    @property
    def rep_groups(self) -> list[list[int]] | None:
        """Replica groups (fixed t, contiguous): the ZeRO gather domain."""
        if self.rep == 1:
            return None
        return [[t * self.rep + r for r in range(self.rep)] for t in range(self.tp)]

    def dup_sync_groups(self, n_logical: int) -> list[list[int]] | None:
        """Model-axis groups holding identical copies of a parameter that is
        logically split into ``n_logical`` entities (kv heads, experts):
        copies from the rep replicas and from tp > n_logical spans. None when
        there are none (n_logical % tp == 0 and rep == 1)."""
        if n_logical <= 0:
            return None
        if n_logical % self.tp == 0:
            return self.rep_groups
        if self.tp % n_logical:
            raise ValueError(f"n_logical={n_logical} incompatible with tp={self.tp}")
        span = self.tp // n_logical
        return [[(h * span + i) * self.rep + r for i in range(span) for r in range(self.rep)]
                for h in range(n_logical)]

    def dup_map(self, n_logical: int) -> tuple[int, ...]:
        """The logical entity stored in each slot of a storage dim of
        model_size · per_rank slots that shards ``n_logical`` entities."""
        per_rank = max(1, n_logical // self.tp)
        out = []
        for j in range(self.model_size * per_rank):
            t = (j // per_rank) // self.rep
            if n_logical % self.tp == 0:
                out.append(t * per_rank + j % per_rank)
            else:
                out.append(t // (self.tp // n_logical))
        return tuple(out)

    @property
    def held_tp(self) -> int:
        """The tp ranks this process computes: all of them folded, 1 on a
        process mesh."""
        return self.tp if self.mesh is None else 1

    def tp_offset(self, per: int) -> int:
        """The first index of this process's ``per`` entries along a dim
        that the tp ranks split (heads, the vocab): 0 folded, where the dim
        is held whole."""
        return 0 if self.mesh is None else self.tp_index * per

    def _coord(self, axis: str) -> int:
        if self.mesh is None:
            raise ValueError("a device's index needs the env's process mesh")
        return self.mesh.coords[self.mesh.dim(axis)]

    @property
    def model_index(self) -> int:
        """This process's index on the model axis (process mesh only)."""
        return self._coord(self.model_axis)

    @property
    def tp_index(self) -> int:
        """This process's tp rank (process mesh only)."""
        return self.model_index // self.rep

    @property
    def fsdp_index(self) -> int:
        """This process's rank in the (pod, data) world (process mesh only)."""
        pod = self._coord(self.pod_axis) if self.pod_axis else 0
        return pod * self.data_size + self._coord(self.data_axis)

    def world(self) -> "ShardEnv":
        """The same env without its process mesh: the world-dim form."""
        return dataclasses.replace(self, mesh=None)

    def tp_rank(self, mesh: Mesh) -> torch.Tensor:
        """Every device's tp rank: an index tensor of the mesh's shape."""
        return mesh.axis_index(self.model_axis) // self.rep

    def rep_rank(self, mesh: Mesh) -> torch.Tensor:
        return mesh.axis_index(self.model_axis) % self.rep

    def psum_tp(self, parts: torch.Tensor) -> torch.Tensor:
        """The sum over the TP domain of the tp ranks' partials, which lie
        along dim 0 (``held_tp`` of them), summed in fp32 and rounded once
        to their dtype: the row-parallel combine, held once for the group.
        On a process mesh, the all-reduce of the fp32 partial over the tp
        group (gloo's bf16 sums are not relied on). Either form counts the
        reference's all-reduce of the partials' dtype, every tp rank's
        output (``mesh.count_collectives``)."""
        if self.mesh is None:
            out = parts[0] if parts.shape[0] == 1 else parts.sum(0)
            note_collective("all-reduce", out.numel() * parts.element_size() * self.tp)
            return out
        wide = parts.to(torch.float32).sum(0)
        with uncounted():
            out = self.tp_sum(wide)
        note_collective("all-reduce", wide.numel() * parts.element_size())
        return out.to(parts.dtype)

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum`` of ``x`` over this process's tp group (process mesh
        only), differentiable: its backward is the same psum."""
        return psum(self._lead(x), self.mesh, self.model_axis, self.tp_groups).reshape(x.shape)

    def _lead(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` behind the process mesh's block (a dim of 1 per axis)."""
        return x.reshape(self.mesh.block + tuple(x.shape))

    def _note(self, kind: str, nbytes: float) -> None:
        """Note a collective on the world-dim mesh (the process mesh's own
        calls note themselves)."""
        if self.mesh is None:
            note_collective(kind, int(nbytes))

    def batch_split_rep(self, global_batch: int) -> bool:
        """Does the batch additionally split across rep groups?"""
        return self.rep > 1 and global_batch % (self.fsdp_size * self.rep) == 0

    def local_batch(self, global_batch: int) -> int:
        dp = self.fsdp_size * (self.rep if self.batch_split_rep(global_batch) else 1)
        if global_batch % self.fsdp_size:
            if global_batch >= self.fsdp_size:
                raise ValueError(f"batch {global_batch} not divisible by dp {self.fsdp_size}")
            return 1  # tiny batches replicate
        return max(1, global_batch // dp)

    def loss_normalizer(self, global_batch: int, seq: int) -> float:
        """1 / (sum over all devices of the locally counted tokens)."""
        return 1.0 / (self.local_batch(global_batch) * seq * self.fsdp_size * self.model_size)

    def tp_group(self) -> "ShardEnv":
        """One data-parallel rank's env: its tp group alone (data 1, rep 1),
        which a training forward runs under (its rows are one rank's)."""
        return ShardEnv(self.tp, 1, tp=self.tp, scenario=self.scenario)

    def row_groups(self, rows: int) -> tuple[int, int]:
        """Rows held once (the distinct rows of the device-major batch: fsdp ×
        (rep when the batch splits over it) × b_loc) → (how many rep groups
        hold rows of their own: rep or 1, b_loc)."""
        rep = self.rep if self.batch_split_rep(rows) else 1
        if rows % (self.fsdp_size * rep):
            raise ValueError(f"{rows} rows do not lay out over fsdp {self.fsdp_size} × rep {rep}")
        return rep, rows // (self.fsdp_size * rep)


ONE = ShardEnv(1, 1)


class LeafPlace(NamedTuple):
    """A port parameter's ``LeafSpec`` facts (dims within one layer)."""

    fsdp_dim: int | None
    tp_dim: int | None
    dup_of: int  # logical kv heads or experts in slots; 0 for a plain leaf

    def tp_chunks(self, env) -> int:
        """Along how many distinct device shards the TP dim is cut: the
        model axis for a plain TP leaf, the logical entities over their
        per-rank slots for kv heads and experts (their copies are equal),
        1 for a leaf without a TP dim."""
        if self.tp_dim is None:
            return 1
        if self.dup_of:
            return self.dup_of // max(1, self.dup_of // env.tp)
        return env.model_size

    def tp_chunk(self, env, model_index: int) -> int:
        """Which of the ``tp_chunks`` distinct shards of the TP dim the
        device at ``model_index`` on the model axis holds (0 without a TP
        dim; for kv heads and experts, the first logical entity of its
        slots over the slots a rank)."""
        if self.tp_dim is None:
            return 0
        if self.dup_of:
            per = max(1, self.dup_of // env.tp)
            return env.dup_map(self.dup_of)[model_index * per] // per
        return model_index

    def rep_gathered(self, env) -> bool:
        """Does the fetch gather the TP dim over the rep groups (a plain TP
        leaf; kv/expert slots are each rank's working set)?"""
        return self.tp_dim is not None and not self.dup_of and env.rep > 1

    def shifted(self, k: int) -> "LeafPlace":
        """The place of the leaf behind ``k`` more leading dims (stacked layers)."""
        return LeafPlace(*(None if d is None else d + k for d in self[:2]), self.dup_of)


def shard_leaf(t: torch.Tensor, place: LeafPlace, env: ShardEnv, fsdp_index: int,
               model_index: int, *, slots: bool = False) -> torch.Tensor:
    """Device (``fsdp_index`` in the (pod, data) world, ``model_index`` on
    the model axis)'s shard of a leaf, as ``jax.device_put`` with its
    partition spec lays it out: the TP dim cut into ``model_size`` chunks
    and the FSDP dim into ``fsdp_size``. ``t``: the logical leaf, whose kv
    heads or experts are first laid out in their slots (``dup_map``), or
    with ``slots`` the stored one. A view of ``t`` where no slots are made."""
    cuts = []
    if place.tp_dim is not None:
        if place.dup_of and not slots:
            dm = torch.tensor(env.dup_map(place.dup_of), device=t.device)
            t = t.index_select(place.tp_dim, dm)
        cuts.append((place.tp_dim, env.model_size, model_index))
    if place.fsdp_dim is not None:
        cuts.append((place.fsdp_dim, env.fsdp_size, fsdp_index))
    for dim, n, i in cuts:
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does not split over {n}")
        t = t.narrow(dim, i * (t.shape[dim] // n), t.shape[dim] // n)
    return t


NORM = LeafPlace(0, None, 0)  # a norm's scale: FSDP-sharded, no TP dim


def tp_groups(tp: int, rep: int) -> list[list[int]] | None:
    """The TP domains of a model axis of tp · rep indices (None: the whole axis)."""
    if rep == 1:
        return None
    return [[t * rep + r for t in range(tp)] for r in range(rep)]


def fetch_weight(w: torch.Tensor, env: ShardEnv, place: LeafPlace, *,
                 fsdp: bool = True) -> torch.Tensor:
    """``fetch_weight``: the storage shard → the working slice.
    On a process mesh ``w`` is this device's shard; it is all-gathered
    along its FSDP dim over (pod, data) (``fsdp``: unless the caller
    computes at the data), then along its TP dim over the rep group (a
    plain TP leaf; kv heads and experts are stored in the rank's slots).
    Its backward is the scenario's reduce-scatter of each gather, the rep
    groups' first (``scatter_gradient``): the gradient leaves it aggregated
    and shaped like ``w``. On the world-dim mesh ``w`` is the logical leaf,
    held whole, and comes back as it is: every tp rank's working slice side
    by side. The gathers that the process form runs are noted, every
    device's output."""
    if env.mesh is None:
        if counting():
            _note_fetch(w, env, place, fsdp)
        return w
    if fsdp and place.fsdp_dim is not None and env.fsdp_size > 1:
        w = _FetchGather.apply(w, env, env.fsdp_axes, place.fsdp_dim, None)
    if place.rep_gathered(env):
        w = _FetchGather.apply(w, env, env.model_axis, place.tp_dim, env.rep_groups)
    return w


class _FetchGather(torch.autograd.Function):
    """``scenario_all_gather`` on a process mesh: the forward all-gathers
    ``w`` along ``dim`` over ``axes`` (or each of ``groups`` of the model
    axis), the backward reduce-scatters the gradient as the env's scenario
    says (``scatter_gradient``)."""

    @staticmethod
    def forward(ctx, w, env, axes, dim, groups):
        ctx.args = (env, axes, dim, groups)
        return _gather(env, w, axes, dim, groups)

    @staticmethod
    def backward(ctx, g):
        return (scatter_gradient(g, *ctx.args),) + (None,) * 4


def scatter_gradient(g: torch.Tensor, env: ShardEnv, axes, dim: int, groups=None
                     ) -> torch.Tensor:
    """``_sag_bwd`` on the process mesh: the gradient ``g`` of a gathered
    weight → this device's chunk of ``dim`` summed over ``axes`` (a name
    or a tuple, the major axis first; or over each of ``groups`` of one
    axis), as ``env.scenario`` aggregates it. NATIVE: ``psum_scatter``;
    S2_IN_NET and HIERARCHICAL: ``ring_reduce_scatter`` axis by axis;
    S3_IN_NET_MAP: the same ring with bf16 on the wire, each hop one
    ``ring_fused_step``; S1_HOST: the endpoint sum (all-gather, sum, slice)
    axis by axis. fp32 in, fp32 out."""
    mesh, sc = env.mesh, Scenario(env.scenario)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    nm = mesh.ndim
    if sc is Scenario.NATIVE:
        out = mesh.psum_scatter(env._lead(g.movedim(dim, 0)), axes, 0, tiled=True,
                                axis_index_groups=groups)
        return out.reshape(out.shape[nm:]).movedim(0, dim)
    wire = sc is Scenario.S3_IN_NET_MAP
    for ax in axes:
        p = len(groups[0]) if groups is not None else mesh.axis_size(ax)
        gm = g.movedim(dim, 0)
        chunks = gm.reshape((p, gm.shape[0] // p) + gm.shape[1:])
        if sc is Scenario.S1_HOST:
            every = mesh.all_gather(env._lead(chunks), ax, axis_index_groups=groups)
            mine = coll._group_rank(mesh, ax, groups)
            red = every.reshape(every.shape[nm:]).sum(0)[mine]
        else:
            red = coll.ring_reduce_scatter(env._lead(chunks), mesh, ax, groups=groups,
                                           wire_map=coll.bf16_wire if wire else None,
                                           unmap=coll.fp32_unwire if wire else None)
            red = red.reshape(red.shape[nm:])
        g = red.movedim(0, dim)
    return g


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, groups):
        ctx.args = (mesh, axes, groups)
        return mesh.psum(x, axes, groups)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, groups = ctx.args
        return (mesh.psum(g, axes, groups),) + (None,) * 3


def psum(x: torch.Tensor, mesh: Mesh, axes, groups=None) -> torch.Tensor:
    """``lax.psum`` (``x`` leads with the mesh's block), differentiable on a
    process mesh: its backward is the same psum, as the reference's
    transpose under ``check_vma=False``."""
    if not isinstance(mesh, ProcessMesh):
        return mesh.psum(x, axes, groups)
    return _Psum.apply(x, mesh, axes, groups)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tiled, groups):
        ctx.args = (mesh, axis, tiled, groups)
        return mesh.all_gather(x, axis, tiled=tiled, axis_index_groups=groups)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, tiled, groups = ctx.args
        return (mesh.psum_scatter(g, axis, 0, tiled=tiled, axis_index_groups=groups),) + (
            None,) * 4


def all_gather(x: torch.Tensor, mesh: Mesh, axis, *, tiled: bool = False, groups=None
               ) -> torch.Tensor:
    """``lax.all_gather`` of an activation, differentiable on a process mesh:
    its backward is ``psum_scatter`` over the same group."""
    if not isinstance(mesh, ProcessMesh):
        return mesh.all_gather(x, axis, tiled=tiled, axis_index_groups=groups)
    return _AllGather.apply(x, mesh, axis, tiled, groups)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat, tiled, groups):
        ctx.args = (mesh, axis, split, concat, tiled, groups)
        return mesh.all_to_all(x, axis, split, concat, tiled=tiled, axis_index_groups=groups)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split, concat, tiled, groups = ctx.args
        return (mesh.all_to_all(g, axis, concat, split, tiled=tiled, axis_index_groups=groups),
                ) + (None,) * 6


def all_to_all(x: torch.Tensor, mesh: Mesh, axis, split: int, concat: int, *,
               tiled: bool = False, groups=None) -> torch.Tensor:
    """``lax.all_to_all``, differentiable on a process mesh: its backward is
    the inverse all-to-all (``split`` and ``concat`` swapped)."""
    if not isinstance(mesh, ProcessMesh):
        return mesh.all_to_all(x, axis, split, concat, tiled=tiled, axis_index_groups=groups)
    return _AllToAll.apply(x, mesh, axis, split, concat, tiled, groups)


def _gather(env: ShardEnv, w: torch.Tensor, axes, dim: int, groups=None) -> torch.Tensor:
    """``lax.all_gather(w, axes, axis=dim, tiled=True)`` on the process mesh."""
    y = env.mesh.all_gather(env._lead(w), axes, axis_index_groups=groups)
    y = y.reshape(y.shape[env.mesh.ndim:])  # (members, *w.shape)
    return y.movedim(0, dim).flatten(dim, dim + 1)


def _note_fetch(w: torch.Tensor, env: ShardEnv, place: LeafPlace, fsdp: bool) -> None:
    """The world-dim count of a fetch: each device gathers its FSDP dim
    (its model-axis shard, whole), then its rep group's TP slices."""
    devices = env.fsdp_size * env.model_size
    nbytes = w.numel() * w.element_size()
    if place.tp_dim is not None:
        per = max(1, place.dup_of // env.tp) if place.dup_of else 1
        nbytes = nbytes * per // place.dup_of if place.dup_of else nbytes // env.tp
    rep = place.rep_gathered(env)
    if fsdp and place.fsdp_dim is not None and env.fsdp_size > 1:
        note_collective("all-gather", devices * nbytes // (env.rep if rep else 1))
    if rep:
        note_collective("all-gather", devices * nbytes)


def col_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) in bf16, bf16 out: the tp ranks'
    column-parallel products at once (output dim t · F/tp + f is rank t's)."""
    return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))


def serve_row_matmul(h: torch.Tensor, w: torch.Tensor, env: ShardEnv, *,
                     at_data: bool = False) -> torch.Tensor:
    """h (..., F) @ w (F, d) with F split over the tp ranks: each held rank's
    bf16 product over its F/tp, stacked on dim 0 (held_tp, ..., d), what it
    holds before the caller's ``psum_tp``. ``w``: the fetched working slice,
    or with ``at_data`` (the compute-at-data route over an fsdp world) the
    slice fetched without its FSDP gather, each rank's d/fsdp columns: then
    the rows are all-gathered over (pod, data), multiplied by those columns
    and sent back by an all-to-all (the reference's serving form). Folded,
    those collectives only move whole rows and columns, so it is the same
    product."""
    n = env.held_tp
    h, w = h.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE)
    if at_data and env.fsdp_size > 1 and env.mesh is not None:
        lead, axes = h.shape[:-1], env.fsdp_axes
        hg = env.mesh.all_gather(env._lead(h.reshape(-1, h.shape[-1])), axes, tiled=True)
        part = torch.matmul(hg.reshape(hg.shape[env.mesh.ndim:]), w)  # (fsdp·rows, d/fsdp)
        y = env.mesh.all_to_all(env._lead(part), axes, 0, 1, tiled=True)
        return y.reshape((1,) + lead + (-1,))
    if at_data and env.fsdp_size > 1:  # every device's gathered rows and its a2a's output
        rows = h.numel() // h.shape[-1] * env.tp
        env._note("all-gather", rows * env.fsdp_size * h.shape[-1] // env.tp * 2)
        env._note("all-to-all", rows * w.shape[-1] * 2)
    if n == 1:
        return torch.matmul(h, w)[None]
    wt = w.unflatten(0, (n, -1))  # (held, F/tp, d)
    ht = h.unflatten(-1, (n, -1)).movedim(-2, 0)  # (held, ..., F/tp)
    return torch.matmul(ht.flatten(1, -2), wt).unflatten(1, ht.shape[1:-1])


def row_parallel(x: torch.Tensor, w: torch.Tensor, env: ShardEnv | None = None) -> torch.Tensor:
    """x (..., f) @ w (f, d) in bf16 with the input dim TP-sharded (``w``
    fetched): at tp = 1 one product; above, the tp ranks' bf16 partials
    summed by ``psum_tp``."""
    if env is None or env.tp == 1:
        return col_parallel(x, w)
    return env.psum_tp(serve_row_matmul(x, w, env))


def serve_col_matmul(x: torch.Tensor, w: torch.Tensor, env: ShardEnv) -> torch.Tensor:
    """x (..., d) @ w (d, F), compute at data: each fsdp rank contracts the
    rows sent to it over its d-slice of d/fsdp (its resident weight shard)
    into a bf16 partial, and the reduce-scatter sums the fsdp partials in
    fp32, rounded to bf16 once (counted as the reference's reduce-scatter
    of the bf16 partials). On a process mesh ``w`` is this rank's
    (d/fsdp, F/tp) (fetched without the FSDP gather), the activations go by
    an all-to-all and the sums by a reduce-scatter; folded, a batched
    product over the d-slices and their sum, with ``w`` whole."""
    x, w = x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE)
    n = env.fsdp_size
    if n == 1:
        return torch.matmul(x, w)
    if env.mesh is not None:
        lead, axes, nd = x.shape[:-1], env.fsdp_axes, env.mesh.ndim
        xs = env.mesh.all_to_all(env._lead(x.reshape(-1, x.shape[-1])), axes, 1, 0, tiled=True)
        part = torch.matmul(xs.reshape(xs.shape[nd:]), w)  # (fsdp·rows, F/tp)
        with uncounted():
            y = env.mesh.psum_scatter(env._lead(part.to(torch.float32)), axes, 0, tiled=True)
        note_collective("reduce-scatter", y.numel() * part.element_size())
        return y.reshape(lead + (-1,)).to(COMPUTE_DTYPE)
    xs = x.unflatten(-1, (n, -1)).movedim(-2, 0)  # (fsdp, ..., d/fsdp)
    parts = torch.matmul(xs.flatten(1, -2), w.unflatten(0, (n, -1)))  # (fsdp, rows, F)
    env._note("all-to-all", x.numel() * 2 * env.tp)
    env._note("reduce-scatter", parts[0].numel() * parts.element_size())
    return parts.sum(0).unflatten(0, xs.shape[1:-1])


def pad_vocab(vocab: int, model_size: int = 1) -> int:
    return ((vocab + model_size - 1) // model_size) * model_size


def embed_lookup(ids: torch.Tensor, table: torch.Tensor, env: ShardEnv | None = None
                 ) -> torch.Tensor:
    """ids (...) int → (..., d) bf16 rows of ``table`` (the fetched
    (V_pad/held_tp, d)); ids outside the padded vocab give zero rows, as the
    sharded lookup does. Over tp ranks each id's row comes from the one shard
    that holds it and the others add zeros (``psum_tp``), so the lookup held
    once is the same. On a process mesh ``table`` is this rank's vocab shard."""
    per = table.shape[0]
    start = 0 if env is None else env.tp_offset(per)
    loc = ids - start
    ok = (loc >= 0) & (loc < per)
    emb = table[loc.clamp(0, per - 1).long()]
    emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                      device=emb.device)).to(COMPUTE_DTYPE)
    if env is not None and env.mesh is not None:
        return env.psum_tp(emb[None])
    if env is not None and env.tp > 1:
        env._note("all-reduce", emb.numel() * emb.element_size() * env.tp)
    return emb


def _local_logits(x: torch.Tensor, table: torch.Tensor, vocab: int, env: ShardEnv | None
                  ) -> tuple[torch.Tensor, int]:
    """(fp32 logits of the held vocab columns, padding at -inf; the id of
    their first column)."""
    out = torch.matmul(x.to(COMPUTE_DTYPE), table.to(COMPUTE_DTYPE).t()).to(torch.float32)
    start = 0 if env is None else env.tp_offset(out.shape[-1])
    if start + out.shape[-1] > vocab:
        out[..., max(0, vocab - start):] = float("-inf")
    return out, start


def logits(x: torch.Tensor, table: torch.Tensor, vocab: int, env: ShardEnv | None = None
           ) -> torch.Tensor:
    """x (..., d) → fp32 logits (..., V_pad) from a bf16 product with the
    tied table, vocab padding columns set to -inf: the tp ranks'
    ``sharded_logits`` side by side, masked as ``argmax_logits`` masks them.
    On a process mesh, this rank's vocab shard (..., V_pad/tp)."""
    return _local_logits(x, table, vocab, env)[0]


def argmax_logits(x: torch.Tensor, table: torch.Tensor, vocab: int,
                  env: ShardEnv | None = None) -> torch.Tensor:
    """Greedy next token (...,) int32 over the vocab. Folded, the logits are
    held whole, and ``torch.argmax`` returns the first maximum: the
    smallest-id tie-break of the reference's pmax/pmin over the tp vocab
    shards (noted as those two all-reduces). On a process mesh, the
    reference's form: the local maximum and its id, ``pmax`` over the tp
    group, and ``pmin`` of the ids of the shards that hold it."""
    lg, start = _local_logits(x, table, vocab, env)
    if env is None or env.mesh is None:
        if env is not None and env.tp > 1:
            env._note("all-reduce", lg[..., 0].numel() * 8 * env.tp)
        return torch.argmax(lg, dim=-1).to(torch.int32)
    m, groups = env.mesh, env.tp_groups
    loc_max, loc_arg = torch.max(lg, dim=-1)
    gmax = m.pmax(env._lead(loc_max), env.model_axis, groups).reshape(loc_max.shape)
    cand = torch.where(loc_max >= gmax, loc_arg.to(torch.int32) + start,
                       torch.iinfo(torch.int32).max)
    return m.pmin(env._lead(cand), env.model_axis, groups).reshape(cand.shape)


def sharded_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 vocab: int, env: ShardEnv | None = None) -> torch.Tensor:
    """``sharded_xent``: per-position nll (...) in fp32 of labels under the
    logits of x (..., d) against ``table`` (V_pad, d), from a bf16 product:
    vocab-padding columns at -inf, a max stabiliser that carries no gradient
    (the reference's pmax has no transpose), and labels < 0 (padding) at 0
    loss. Over tp ranks each rank holds V_pad / tp columns: its sum of
    exponentials is summed over the ranks as the reference sums them, and
    the label's logit comes from the one rank that holds it. Folded, the
    ranks' columns lie side by side and their sums add in fp32; on a
    process mesh ``table`` is this rank's (V_pad / tp, d), the max is a
    ``pmax`` over the tp group, and the two sums are differentiable psums
    (``ShardEnv.tp_sum``)."""
    procs = env is not None and env.mesh is not None
    tp = 1 if env is None else env.held_tp
    lg = torch.matmul(x.to(COMPUTE_DTYPE), table.to(COMPUTE_DTYPE).t()).to(torch.float32)
    per = lg.shape[-1]
    if per % tp:
        raise ValueError(f"a vocab of {per} rows does not split over tp {tp}: pad it to the "
                         "model axis (Model(cfg, env=...))")
    start = env.tp_offset(per) if procs else 0
    col = start + torch.arange(per, device=lg.device)
    lg = torch.where(col < vocab, lg, float("-inf"))
    mx = torch.amax(lg, dim=-1).detach()
    if procs:
        mx = env.mesh.pmax(env._lead(mx), env.model_axis, env.tp_groups).reshape(mx.shape)
    se = torch.sum(torch.exp(lg - mx[..., None]).unflatten(-1, (tp, -1)), dim=-1)
    se = se.sum(-1) if tp > 1 else se[..., 0]
    loc = labels - start
    ok = (loc >= 0) & (loc < per)
    tl = torch.gather(lg, -1, loc.clamp(0, per - 1).long()[..., None])[..., 0]
    tl = torch.where(ok, tl, 0.0)
    if procs:
        se, tl = env.tp_sum(se), env.tp_sum(tl)
    nll = torch.log(se) + mx - tl
    return torch.where(labels >= 0, nll, 0.0)


# ---------------------------------------------------------------------------
# training: the batch split and the scenario-selected aggregation
# ---------------------------------------------------------------------------
def local_batch(global_batch: int, world: int) -> int:
    """``ShardEnv.local_batch`` with rep = 1: each of ``world`` ranks' rows."""
    if global_batch % world:
        if global_batch >= world:
            raise ValueError(f"batch {global_batch} not divisible by dp {world}")
        return 1  # tiny batches replicate
    return max(1, global_batch // world)


def fsdp_aggregate(g: torch.Tensor, mesh: Mesh, dim: int | None,
                   scenario: Scenario | str) -> torch.Tensor:
    """One leaf's gradient aggregation: ``g`` holds every rank's gradient
    (the mesh dims, then the leaf). With an FSDP ``dim`` it is what
    ``_sag_bwd`` runs under ``scenario``, axis by axis, the major axis
    first: each rank keeps its chunk of ``dim`` summed over the world —
    NATIVE: the sum (``psum_scatter``); S1_HOST: the endpoint sum (gather,
    sum, slice), which is the same on every rank and so computed once;
    S2_IN_NET and HIERARCHICAL: ``ring_reduce_scatter`` over chunks of
    ``dim``; S3_IN_NET_MAP: the same ring with bf16 on the wire, each hop
    one ``ring_fused_step``. With ``dim`` None (a leaf that is not FSDP
    sharded) it is ``sync_gradients``' sum over the world. Returns the whole
    aggregated leaf: the ranks' chunks concatenated along ``dim``, which is
    what the next step's all-gather of the updated weights amounts to.
    ``mesh.count_collectives`` sees the collectives that the reference runs
    here (the psum, the psum_scatter, S1's all-gathers, the rings'
    ppermutes), with every rank's output bytes."""
    nm, world = mesh.ndim, mesh.size
    sc = Scenario(scenario)
    if dim is not None and g.shape[nm + dim] % world:
        raise ValueError(f"FSDP dim {dim} of a {tuple(g.shape[nm:])} gradient does not split "
                         f"over {world} ranks")
    leaf_bytes = g.numel() // world * g.element_size()
    if dim is None or sc is Scenario.NATIVE:
        note_collective("all-reduce" if dim is None else "reduce-scatter",
                        leaf_bytes * (world if dim is None else 1))
        return g.reshape((world,) + g.shape[nm:]).sum(0)
    if sc is Scenario.S1_HOST:
        per = leaf_bytes  # each rank gathers its axis' gradients, then keeps its chunk
        for ax in mesh.axis_names:
            note_collective("all-gather", world * mesh.axis_size(ax) * per)
            per //= mesh.axis_size(ax)
            g = g.sum(0)
        return g
    wire = sc is Scenario.S3_IN_NET_MAP
    for ax in mesh.axis_names:
        p = mesh.axis_size(ax)
        gm = g.movedim(nm + dim, nm)
        chunks = gm.reshape(gm.shape[:nm] + (p, gm.shape[nm] // p) + gm.shape[nm + 1:])
        red = coll.ring_reduce_scatter(chunks, mesh, ax,
                                       wire_map=coll.bf16_wire if wire else None,
                                       unmap=coll.fp32_unwire if wire else None)
        g = red.movedim(nm, nm + dim)
    flat = g.reshape((world,) + g.shape[nm:])
    return flat.movedim(0, dim).flatten(dim, dim + 1)


def rep_aggregate(g: torch.Tensor, mesh: Mesh, dim: int, tp: int,
                  scenario: Scenario | str) -> torch.Tensor:
    """The backward of ``fetch_weight``'s rep-group gather for one leaf:
    ``g`` holds every rank's gradient, (mesh dims, *leaf), whose last mesh
    axis is the model axis's rep ranks (the tp ranks folded: a rank's
    gradient is the whole leaf, tp rank t's working slice at slice t of the
    TP ``dim``). Rank (t, r) keeps chunk t·rep + r of ``dim`` summed over
    its rep group, as ``_sag_bwd`` computes it under ``scenario``: NATIVE
    (``psum_scatter``) and S1_HOST (gather, sum, slice) the sum;
    S2_IN_NET and HIERARCHICAL ``ring_reduce_scatter`` over the group;
    S3_IN_NET_MAP the same ring with bf16 on the wire, each hop one
    ``ring_fused_step`` over every tp group's ring at once. Returns (the
    other mesh dims, *leaf), the chunks in their places. A model axis of
    one rank returns ``g`` without it."""
    nm, ax, rep = mesh.ndim, mesh.axis_names[-1], mesh.shape[-1]
    if rep == 1:
        return g.select(nm - 1, 0)
    x = g.shape[nm + dim]
    if x % (tp * rep):
        raise ValueError(f"TP dim {dim} of a {tuple(g.shape[nm:])} gradient does not split over "
                         f"tp {tp} x rep {rep}")
    sc = Scenario(scenario)
    out_bytes = g.numel() // rep * g.element_size()  # every device's chunk, summed
    if sc in (Scenario.NATIVE, Scenario.S1_HOST):
        if sc is Scenario.NATIVE:
            note_collective("reduce-scatter", out_bytes)
        else:  # each device gathers its group's working slices
            note_collective("all-gather", out_bytes * rep * rep)
        return g.sum(nm - 1)
    wire = sc is Scenario.S3_IN_NET_MAP
    gm = g.movedim(nm + dim, nm)  # (mesh dims, X, rest)
    chunks = gm.reshape(gm.shape[:nm] + (tp, rep, x // (tp * rep)) + gm.shape[nm + 1:])
    red = coll.ring_reduce_scatter(chunks.movedim(nm + 1, nm), mesh, ax,
                                   wire_map=coll.bf16_wire if wire else None,
                                   unmap=coll.fp32_unwire if wire else None)
    # (other dims, rep rank r, tp, chunk, rest): rank r holds chunk r of each tp slice
    whole = red.movedim(nm - 1, nm).flatten(nm - 1, nm + 1)
    return whole.movedim(nm - 1, nm - 1 + dim)


def aggregate_leaf(g: torch.Tensor, mesh: Mesh, scenario: Scenario | str, *,
                   fsdp_dim: int | None, tp_dim: int | None = None, dup_of: int = 0,
                   tp: int = 1) -> torch.Tensor:
    """One leaf's aggregation on every rank's gradient ``g`` (mesh dims,
    *leaf): the reference's backward of ``fetch_weight`` and
    ``sync_gradients``' sums. ``mesh``: the data world, ("data",) or
    ("pod", "data"), optionally followed by the model axis's rep ranks
    ("model"). A leaf the fetch gathers over the rep groups (a TP dim, not
    kv/expert slots: ``dup_of`` 0) is reduce-scattered over them first
    (``rep_aggregate``), then over the data world along its FSDP dim
    (``fsdp_aggregate``; ``fsdp_dim`` None: summed). A leaf it does not
    gather (``tp_dim`` None, or slots whose copies sit on the model axis)
    has each rep rank's FSDP reduce-scatter, then the model axis's sum (the
    reference's psum over the axis, or over ``dup_sync_groups``), in fp32.
    Returns the whole aggregated leaf."""
    if "model" not in mesh.axis_names:
        return fsdp_aggregate(g, mesh, fsdp_dim, scenario)
    m = mesh.dim("model")
    if m != mesh.ndim - 1:
        raise ValueError(f"the model axis must come last, mesh axes {mesh.axis_names}")
    data = Mesh(mesh.axis_names[:m], mesh.shape[:m], device=mesh.device)
    if tp_dim is not None and not dup_of:
        return fsdp_aggregate(rep_aggregate(g, mesh, tp_dim, tp, scenario), data, fsdp_dim,
                              scenario)
    g = fsdp_aggregate(g, data, None if fsdp_dim is None else fsdp_dim + 1, scenario)
    if mesh.shape[m] * tp > 1:
        note_collective("all-reduce", g.numel() * g.element_size() * tp)
    return g.sum(0)
