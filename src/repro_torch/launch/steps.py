"""Step builders on one card: the train step, prefill and one-token decode
over a launcher's ``("data", "model")`` or ``("pod", "data", "model")`` mesh.

The port of ``repro/launch/steps.py``. There the steps are
``jax.jit``-compiled ``shard_map``s over a mesh with fixed shapes; here they
are plain callables over a ``Model`` that check the shapes they were built
for. The serving steps run under ``torch.inference_mode``. Built with a
``mesh`` (world dims on the card; the model made with ``make_env``'s
env), they take and give batches in the reference's device-major layout
(``shapes.batch_layout``), hold the distinct rows once (``rows_of``) and run
the model's tp ranks folded; ``compute_at_data`` is the serve step's
compute-at-data route. Without a mesh they take (global_batch, ...) rows,
as before. Built with a ``ProcessMesh`` (one process per device, the
model made under its env: ``make_env``), a step takes and gives the
process's block of the device-major batch and runs the model at one tp
rank, its collectives calls into process groups. The train step runs the
reference's ``make_train_step`` on a launcher's mesh
(``launch.mesh.make_mesh``), its batches always device-major: the
data-parallel ranks, (pod ×) data × rep, one after another, each rank's
forward and backward on its own rows under its tp group, folded (``ShardEnv.tp_group``), then the scenario's
aggregation of every leaf (S1/S2/S3/NATIVE/HIERARCHICAL:
``models.parallel.aggregate_leaf``: over the rep groups along the TP dim,
then over (pod, data) along the FSDP dim, and the model axis's sums), the
clip and the AdamW update. On a ``ProcessMesh`` ``make_train_step`` gives
``ProcessTrainStep``: one data-parallel rank a process, on its shards and
its block of the batch, the aggregation the backward of its weight fetch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.scenarios import Scenario
from repro_torch.launch import shapes
from repro_torch.launch.mesh import data_extent
from repro_torch.mesh import Mesh, ProcessMesh, note_collective
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.convert import leaf_paths
from repro_torch.models.parallel import ShardEnv, fetch_weight, pad_vocab
from repro_torch.models.specs import leaf_places
from repro_torch.optim import AdamW, OptState, clip_by_global_norm, sync_gradients


def batch_shape(batch) -> tuple[int, int]:
    """(b, s) of a prompt batch: tokens (b, s), or a dict of ``tokens`` or
    ``embeds`` (b, s, d) and the other inputs of ``Model.prefill_hidden``."""
    if isinstance(batch, torch.Tensor):
        return tuple(batch.shape)
    return tuple((batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[:2])


def make_env(cfg, mesh: Mesh, scenario: Scenario | str = Scenario.NATIVE) -> ShardEnv:
    """The ``ShardEnv`` of ``cfg`` on ``mesh`` (axes among "pod", "data",
    "model"; a missing model axis is 1): tp is ``cfg.resolve_tp``. A
    ``ProcessMesh`` is carried in the env (``ShardEnv.mesh``)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if "data" not in sizes:
        raise ValueError(f"mesh axes {mesh.axis_names}: a mesh needs a data axis")
    model = sizes.get("model", 1)
    return ShardEnv(model_size=model, data_size=sizes["data"], pod_size=sizes.get("pod", 1),
                    tp=cfg.resolve_tp(model), scenario=Scenario(scenario),
                    pod_axis="pod" if "pod" in sizes else None,
                    mesh=mesh if isinstance(mesh, ProcessMesh) else None)


def rows_of(env: ShardEnv, x: torch.Tensor, global_batch: int) -> torch.Tensor:
    """A device-major batch tensor (``batch_layout``'s dims, b_loc, ...) →
    its distinct rows, held once: (fsdp · (rep when the batch splits over the
    rep groups) · b_loc, ...); on a process mesh the process's rows (b_loc,
    ...). A split batch's model dim gives each rep group's rows at every tp
    rank of the group; they must be equal (the reference sums the ranks'
    partials), and this raises where they are not: on a process mesh by a
    ``pmax`` and a ``pmin`` of the rows over the tp group, noted so on the
    world-dim mesh."""
    dims, b_loc = shapes.batch_layout(env, global_batch)
    nd = len(dims)
    if tuple(x.shape[:nd + 1]) != dims + (b_loc,):
        raise ValueError(f"batch {tuple(x.shape)} does not lead with {dims + (b_loc,)}")
    split = env.batch_split_rep(global_batch)
    if env.mesh is not None:
        if split:
            xf = x.to(torch.float32)
            hi = env.mesh.pmax(xf, env.model_axis, env.tp_groups)
            if not torch.equal(hi, env.mesh.pmin(xf, env.model_axis, env.tp_groups)):
                raise ValueError("the tp ranks of a rep group hold different rows")
        return x.reshape(x.shape[nd:])
    if split:
        note_collective("all-reduce", x.numel() * 8)
        x = x.unflatten(nd - 1, (env.tp, env.rep))
        first = x.select(nd - 1, 0)
        if not torch.equal(x, first.unsqueeze(nd - 1).expand_as(x)):
            raise ValueError("the tp ranks of a rep group hold different rows")
        x = first
    return x.flatten(0, nd)


def held_rows(env: ShardEnv, global_batch: int) -> int:
    """How many distinct rows a device-major batch of ``global_batch`` holds
    (``rows_of``'s): fsdp · (rep when the batch splits over the rep groups)
    · b_loc; a process's b_loc on a process mesh."""
    dims, b_loc = shapes.batch_layout(env, global_batch)
    if env.mesh is not None:
        return b_loc
    return env.fsdp_size * (env.rep if dims[-1] > 1 else 1) * b_loc


def device_major(env: ShardEnv, rows: torch.Tensor, global_batch: int) -> torch.Tensor:
    """``rows_of``'s inverse: rows held once → the device-major layout, each
    rep group's rows at every tp rank of the group (a process's rows → its
    block)."""
    dims, b_loc = shapes.batch_layout(env, global_batch)
    rest = tuple(rows.shape[1:])
    if dims[-1] > 1 and env.mesh is None:
        x = rows.reshape(dims[:-1] + (1, env.rep, b_loc) + rest)
        return x.expand(dims[:-1] + (env.tp, env.rep, b_loc) + rest).reshape(
            dims + (b_loc,) + rest)
    return rows.reshape(dims + (b_loc,) + rest)


def rank_rows(env: ShardEnv, rows: torch.Tensor, global_batch: int) -> torch.Tensor:
    """The distinct rows of the whole batch (``held_rows(env.world(), ...)``
    of them, as every process can make them from one seed) → this
    process's own rows (b_loc, ...), its block of the device-major batch."""
    world = env.world()
    dims, _ = shapes.batch_layout(world, global_batch)
    dm = device_major(world, rows, global_batch)
    m = env.mesh
    at = [m.coords[m.dim(a)] for a in m.axis_names if a != env.model_axis]
    at.append(env.model_index if dims[-1] > 1 else 0)
    return dm[tuple(at)]


def gather_rows(env: ShardEnv, x: torch.Tensor, global_batch: int) -> torch.Tensor:
    """``rank_rows``' inverse over the process mesh: every process's rows
    (b_loc, ...) all-gathered over the whole mesh → the distinct rows of the
    batch, held once, on every process."""
    m = env.mesh
    full = m.all_gather(x.reshape(m.block + tuple(x.shape)), m.axis_names)
    full = full.reshape(m.shape + tuple(x.shape))
    world = env.world()
    dims, _ = shapes.batch_layout(world, global_batch)
    if dims[-1] == 1:
        full = full.narrow(m.dim(env.model_axis), 0, 1)
    return rows_of(world, full, global_batch)


def _serving_env(model: M.Model, mesh: Mesh | None) -> ShardEnv:
    if mesh is None:
        return model.env
    env = make_env(model.cfg, mesh)
    have = model.env
    if (have.model_size, have.data_size, have.pod_size, have.tp, have.mesh is None) != (
            env.model_size, env.data_size, env.pod_size, env.tp, env.mesh is None):
        where = "a process mesh" if env.mesh is not None else "world dims"
        raise ValueError(f"model made for {have}, the mesh {mesh.shape} on {where} needs {env}: "
                         "make it with Model(cfg, env=steps.make_env(cfg, mesh))")
    return env


def map_batch(batch, fn):
    """``fn`` over a batch: a tensor, or each tensor of a dict of inputs."""
    return fn(batch) if isinstance(batch, torch.Tensor) else {k: fn(v) for k, v in batch.items()}


def make_prefill_step(model: M.Model, *, global_batch: int, seq: int, impl: str = "masked",
                      mesh: Mesh | None = None):
    """``step(batch, cache=None) → (cache, next tokens int32)``; ``batch``
    is prompt tokens or a dict of the model's inputs
    (``Model.prefill_hidden``): (global_batch, seq, ...) rows without a
    ``mesh``, the device-major layout of ``shapes.prefill_input_specs``
    with one, and the next tokens come in the same layout. A ``cache``
    longer than ``seq`` (from ``model.init_cache`` over the rows held once)
    is filled in place."""
    env = _serving_env(model, mesh)

    @torch.inference_mode()
    def step(batch, cache: dict | None = None):
        if mesh is not None:
            batch = map_batch(batch, lambda v: rows_of(env, v, global_batch))
        b, s = batch_shape(batch)
        want = (global_batch if mesh is None else b, seq)
        if (b, s) != want:
            raise ValueError(f"prefill step built for {want}, got {(b, s)}")
        cache, nxt = M.prefill(model, batch, impl=impl, cache=cache, env=env)
        return cache, nxt if mesh is None else device_major(env, nxt, global_batch)

    return step


def make_serve_step(model: M.Model, *, global_batch: int, seq_max: int,
                    mesh: Mesh | None = None, compute_at_data: bool = False):
    """``step(cache, tokens, cache_len) → (next tokens, cache)``: one greedy
    decode step at position ``cache_len`` of a cache allocated for
    ``seq_max`` positions, written in place. Tokens: (global_batch,), or
    the device-major layout of ``shapes.decode_input_specs`` with a
    ``mesh``. ``compute_at_data`` routes the decode activations to the
    weights' fsdp d-slices (``parallel.serve_col_matmul``)."""
    env = dataclasses.replace(_serving_env(model, mesh), compute_at_data=compute_at_data)

    @torch.inference_mode()
    def step(cache: dict, tokens: torch.Tensor, cache_len: int):
        if mesh is not None:
            tokens = rows_of(env, tokens, global_batch)
        elif tuple(tokens.shape) != (global_batch,):
            raise ValueError(f"serve step built for batch {global_batch}, got "
                             f"{tuple(tokens.shape)}")
        if not 0 <= int(cache_len) < seq_max:
            raise ValueError(f"cache_len {cache_len} outside the cache of {seq_max}")
        nxt, cache = M.decode_step(model, cache, tokens, cache_len, env)
        return (nxt if mesh is None else device_major(env, nxt, global_batch)), cache

    return step


REP_SPLIT = ("the batch splits over the rep groups, and the reference's data pipeline gives "
             "every model index rows of its own: the tp ranks of a rep group compute on "
             "different rows and psum_tp mixes their partials (a breakage of the reference, "
             "ROADMAP.md §3). Train on a global batch that does not split over fsdp x rep, "
             "or give each rep group's rows at every tp rank of the group")


class TrainStep:
    """``make_train_step``'s step: ``step(state, batch) → (state, metrics)``
    updates the model's parameters in place (and its bf16 copies, so that
    serving reads the new weights) and returns the new optimizer state and
    the reference's metrics, summed over every device of the mesh as its
    psum sums them: ``loss`` (Σ nll · norm, the load-balance loss left
    out), ``ntok`` (each tp rank counts its rows' tokens), ``grad_norm``
    (before the clip) and ``lr``. ``batch``: arrays or tensors in the
    reference's device-major layout (``shapes.train_input_specs`` of
    ``step.env``, ``TrainPipeline(cfg, step.env, ...)``). Its phases are
    methods of their own, so that a caller can time or check each:
    ``rank_gradients``, ``aggregate``, ``apply``."""

    def __init__(self, model: M.Model, mesh: Mesh, *, scenario, optimizer: AdamW,
                 microbatches: int, global_batch: int, seq: int, impl: str, clip_norm: float):
        cfg = model.cfg
        M.check_train_impl(impl)
        if "model" not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names}: training takes a launcher's mesh "
                             "(launch.mesh.make_mesh), model axis included")
        procs = isinstance(mesh, ProcessMesh)
        if procs != isinstance(self, ProcessTrainStep):
            raise ValueError("a process mesh trains through ProcessTrainStep, world dims through "
                             "TrainStep: build the step with make_train_step")
        if procs != (model.env.mesh is not None):
            where = "a process mesh" if procs else "world dims"
            raise ValueError(f"model made for {model.env}, training on {where} {mesh.shape}: "
                             "make it with Model(cfg, env=steps.make_env(cfg, mesh))")
        if mesh.device.type != model.device.type:
            raise ValueError(f"mesh on {mesh.device}, model on {model.device}")
        self.env = env = make_env(cfg, mesh, scenario)
        if model.vocab_padded != pad_vocab(cfg.vocab, env.model_size):
            raise ValueError(f"model made with a vocab of {model.vocab_padded} rows, the mesh "
                             f"{mesh.shape} pads it to {pad_vocab(cfg.vocab, env.model_size)}: "
                             "make it with Model(cfg, env=steps.make_env(cfg, mesh))")
        self.model, self.mesh, self.mesh_shape = model, data_extent(mesh), mesh.shape
        # the ranks' gradients: the data world's dims, then the rep ranks
        self.grad_mesh = Mesh(self.mesh.axis_names + ("model",), self.mesh.shape + (env.rep,),
                              device=mesh.device)
        self.scenario = Scenario(scenario)
        self.optimizer, self.impl, self.clip_norm = optimizer, impl, clip_norm
        self.global_batch = global_batch
        self.specs = shapes.train_input_specs(cfg, env, seq, global_batch)
        self.world = env.dp_world
        self.split_rep = env.batch_split_rep(global_batch)
        self.b_loc = env.local_batch(global_batch)
        # microbatches must divide the local batch (rep splitting shrinks it)
        while self.b_loc % microbatches:
            microbatches -= 1
        self.microbatches = microbatches
        # enc-dec shapes split seq between encoder frames and decoder labels
        self.norm = env.loss_normalizer(global_batch, seq // 2 if cfg.enc_layers else seq)
        self.places = leaf_places(model)
        self.dims = {k: pl.fsdp_dim for k, pl in self.places.items()}
        # 8-bit moments run on the reference's stacked leaves ({JAX leaf path:
        # the layers stacked}), their blocks cut from each device's shard of
        # them; fp32 moments (elementwise) on the port's parameters. A
        # process's stacked leaf is its device's shard already: one row, no cut
        self.stacked = optimizer.eightbit
        paths = leaf_paths(model)
        self.path_places = {path: self.places[k] for k, (path, _) in paths.items()}
        lead = {k: int(self.stacked and i is not None) for k, (_, i) in paths.items()}
        self.layout = {} if procs else {(paths[k][0] if self.stacked else k): tuple(
            (d + lead[k], n) for d, n in ((pl.fsdp_dim, env.fsdp_size),
                                          (pl.tp_dim, pl.tp_chunks(env)))
            if d is not None and n > 1) or None for k, pl in self.places.items()}
        model.requires_grad_(True)
        self.params = dict(model.named_parameters())

    def opt_tree(self, tensors: dict) -> dict:
        """Tensors keyed by parameter name → the tree the optimizer runs on:
        the same, or with 8-bit moments the stacked leaves (new tensors)."""
        return convert.stack_leaves(self.model, tensors) if self.stacked else tensors

    def shard_row(self, path: str, fsdp_index: int, model_index: int) -> int:
        """The row that device (``fsdp_index`` in the (pod, data) world,
        ``model_index`` on the model axis) holds among the world-dim 8-bit
        moments' rows of stacked leaf ``path`` (``layout``'s cuts, the FSDP
        cut's index major, then the TP dim's distinct shards)."""
        pl, env = self.path_places[path], self.env
        f = fsdp_index if pl.fsdp_dim is not None else 0
        return f * pl.tp_chunks(env) + pl.tp_chunk(env, model_index)

    def ring_hops(self) -> int:
        """The ring hops of one aggregation under S2, S3 and HIERARCHICAL,
        each one ``ring_fused_step`` launch under S3: per leaf, rep - 1 on
        the rep groups' rings where the weight fetch gathers over them, and
        p - 1 on each data axis of p ranks where it has an FSDP dim."""
        data = sum(p - 1 for p in self.mesh.shape)
        return sum((self.env.rep - 1) * (pl.tp_dim is not None and not pl.dup_of)
                   + data * (pl.fsdp_dim is not None) for pl in self.places.values())

    def init_state(self) -> OptState:
        return self.optimizer.init(self.opt_tree(self.params), self.layout)

    def rank_rows(self, batch: dict) -> dict:
        """A batch → {name: (fsdp ranks, rep ranks with rows of their own,
        b_loc, ...)} on the model's device: rep rank r's rows are those of
        every tp rank of its group (the same on every rank of the group,
        checked), or, where the batch does not split over the rep groups, one
        set of rows that every rep rank shares."""
        env, dev = self.env, self.model.device
        dims, _ = shapes.batch_layout(env, self.global_batch)
        nd = len(dims)
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=dev)
            if k not in self.specs:
                raise ValueError(f"batch input {k!r}: the step takes {sorted(self.specs)}")
            want = self.specs[k][0]
            if tuple(v.shape) != want:
                raise ValueError(f"batch {k!r} {tuple(v.shape)} does not lead with the world "
                                 f"{dims} and {want[nd]} rows a rank (the step takes {want})")
            v = v.flatten(0, nd - 2)  # (fsdp ranks, model dim, b_loc, ...)
            if dims[-1] > 1:
                v = v.unflatten(1, (env.tp, env.rep))
                first = v[:, 0]
                if v.device.type != "meta" and not torch.equal(
                        v, first.unsqueeze(1).expand_as(v)):
                    raise ValueError(REP_SPLIT)
                v = first
            out[k] = v
        return out

    def rank_gradients(self, batch: dict, ranks=None):
        """Each data-parallel rank's forward and backward on its own
        ``b_loc`` rows, under its tp group, its microbatches' fp32 gradients
        accumulated as the reference's ``micro`` does; a rank's loss is the
        sum of its tp ranks' (``Model.train_loss`` × tp) scaled by
        ``env.loss_normalizer``. Returns ({name: (data world dims, rep,
        *leaf) fp32}, Σ nll, Σ ntok), the sums over every device of the
        mesh. Rep ranks that share their rows share one backward, their
        gradients one tensor (an expanded view). ``ranks``: the (flat)
        data-parallel ranks to run, all by default; the others' gradients
        stay zero (the dry run counts one rank: they are alike)."""
        env, mb, dev = self.env, self.microbatches, self.model.device
        rows = self.rank_rows(batch)
        held = env.rep if self.split_rep else 1
        names = list(self.params)
        lead = self.mesh.shape + (held,)
        grads = {k: torch.zeros(lead + tuple(p.shape), dtype=torch.float32, device=dev)
                 for k, p in self.params.items()}
        nll = torch.zeros((), dtype=torch.float32, device=dev)
        ntok = torch.zeros((), dtype=torch.int64, device=dev)
        n = self.b_loc // mb
        copies = env.tp * (env.rep // held)  # devices that compute each rank's loss
        group = env.tp_group()
        todo = range(self.world) if ranks is None else ranks
        for rank in sorted({(f, r % held) for f, r in (divmod(x, env.rep) for x in todo)}):
            f, r = rank
            for i in range(mb):
                part = {k: v[f, r].unflatten(0, (mb, n))[i] for k, v in rows.items()}
                loss, aux = self.model.train_loss(part, impl=self.impl, env=group)
                gs = torch.autograd.grad(loss * (self.norm * mb * env.tp),
                                         [self.params[k] for k in names], allow_unused=True)
                for k, g in zip(names, gs):
                    if g is not None:
                        grads[k].view((-1,) + g.shape)[f * held + r].add_(
                            g.to(torch.float32) / mb)
                nll += aux["nll_sum"] * copies
                ntok += aux["ntok"] * copies
        if held < env.rep:
            grads = {k: g.expand(self.mesh.shape + (env.rep,) + g.shape[len(lead):])
                     for k, g in grads.items()}
        return grads, nll, ntok

    def aggregate(self, rank_grads: dict) -> dict:
        """The scenario's aggregation of every leaf over the mesh
        (``optim.sync_gradients``): {name: the whole aggregated gradient}."""
        return sync_gradients(rank_grads, self.places, self.grad_mesh, self.scenario,
                              tp=self.env.tp)

    @torch.no_grad()
    def apply(self, state: OptState, grads: dict) -> tuple[OptState, torch.Tensor]:
        """The clip and the AdamW update, written into the model's
        parameters, then its bf16 copies remade. Returns (new state, the
        gradient's norm before the clip). On a process mesh the clip's norm
        is over the mesh (``global_grad_norm``'s weighted all-reduce) and the
        update is of this process's shards."""
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm, self.places, self.env)
        new, state = self.optimizer.update(self.opt_tree(grads), state,
                                           self.opt_tree(self.params), self.layout)
        if self.stacked:
            new = convert.unstack_leaves(self.model, new)
        for k, p in self.params.items():
            p.copy_(new[k])
        self.model.cast_weights()
        return state, gnorm

    def __call__(self, state: OptState, batch: dict) -> tuple[OptState, dict]:
        rank_grads, nll, ntok = self.rank_gradients(batch)
        grads = self.aggregate(rank_grads)
        del rank_grads
        state, gnorm = self.apply(state, grads)
        return state, {"loss": nll * self.norm, "ntok": ntok, "grad_norm": gnorm,
                       "lr": self.optimizer.schedule(state.count)}


class ProcessTrainStep(TrainStep):
    """``TrainStep`` on a ``ProcessMesh``: this process is one device of the
    mesh and holds only its shard of every parameter and of the moments. A
    step takes the process's block of the device-major batch
    (``TrainPipeline(cfg, step.env, ...)`` cuts it), and its phases are:

    * ``rank_gradients``: every leaf fetched once, in fp32
      (``parallel.fetch_weight``: the FSDP all-gather over (pod, data), then
      the TP one over the rep group), then one forward and backward a
      microbatch on the process's rows at its tp rank, the gradients of the
      working slices accumulated in fp32 as the reference's ``micro`` does;
      a tp rank's loss is its own, and the collectives' backward (psums of
      psums, the MoE's inverse all-to-all) sum the devices' losses.
    * ``aggregate``: the fetch's backward, leaf by leaf in parameter order:
      the scenario's reduce-scatter of each gather (``scatter_gradient``:
      S1/S2/S3/NATIVE/HIERARCHICAL, S3's hops on ``ring_fused_step``), then
      ``sync_gradients``' sums; the gradient of each storage shard.
    * ``apply``: the clip over the mesh (``global_grad_norm``'s weighted,
      all-reduced sum) and the AdamW update of the shards.

    ``loss`` and ``ntok`` are psum'd over the whole mesh, as the
    reference's metrics. It trains every block kind that world dims train:
    GQA + MLP, the MoE on both dispatches, MLA, Mamba-2, the RG-LRU with
    local attention, M-RoPE over embeddings and enc-dec. 8-bit moments are
    quantized on the process's stacked leaves (``opt_tree``), which are its
    device's shards of the reference's: the blocks and the row that
    ``TrainStep`` cuts for that device (``shard_row``)."""

    def __init__(self, model: M.Model, mesh: ProcessMesh, **kw):
        super().__init__(model, mesh, **kw)
        if tuple(model.env.mesh.shape) != tuple(mesh.shape):
            raise ValueError(f"model made for the process mesh {model.env.mesh.shape}, training "
                             f"on {mesh.shape}: make it with Model(cfg, env=steps.make_env(cfg, "
                             "mesh))")
        self.pmesh = mesh
        self.fetched: dict | None = None
        self.leaves: dict = {}

    def rank_rows(self, batch: dict) -> dict:
        """The process's block of the batch → its rows {name: (b_loc, ...)}
        on the model's device (``rows_of``: where the batch splits over the
        rep groups, the tp ranks of a group must hold the same rows)."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=self.model.device)
            if k not in self.specs:
                raise ValueError(f"batch input {k!r}: the step takes {sorted(self.specs)}")
            if tuple(v.shape) != self.specs[k][0]:
                raise ValueError(f"batch {k!r} {tuple(v.shape)}: the process's block is "
                                 f"{self.specs[k][0]}")
            out[k] = rows_of(self.env, v, self.global_batch)
        return out

    def fetch(self) -> dict:
        """Every parameter's working slice, gathered in fp32 from its storage
        shard (kept in ``fetched`` for ``aggregate``): the forward of the
        reference's weight fetch, once a step. A parameter stored in bf16
        (grok) is gathered from an fp32 copy of its shard (``leaves``) and
        computed with in bf16, so that its gradient adds up in bf16 over its
        uses and is aggregated in fp32, as on world dims. Returns the slices
        the model computes with."""
        self.leaves = {k: p if p.dtype == torch.float32 else p.detach().float().requires_grad_()
                       for k, p in self.params.items()}
        self.fetched = {k: fetch_weight(p, self.env, self.places[k])
                        for k, p in self.leaves.items()}
        return {k: w.to(self.params[k].dtype) for k, w in self.fetched.items()}

    def rank_gradients(self, batch: dict):
        """The process's forward and backward on its ``b_loc`` rows, its
        microbatches' gradients of the working slices accumulated in fp32,
        the loss scaled by ``env.loss_normalizer`` (no tp factor: each tp
        rank's loss is its own). Keeps the fetched slices for ``aggregate``.
        Returns ({name: the working slice's fp32 gradient}, Σ nll, Σ ntok),
        the sums psum'd over the whole mesh."""
        env, mb, m = self.env, self.microbatches, self.pmesh
        rows = self.rank_rows(batch)
        work = self.fetch()
        names = list(work)
        grads = {}  # a microbatch's gradient is the sum's first term: no zeros held beside it
        nll = torch.zeros((), dtype=torch.float32, device=m.device)
        ntok = torch.zeros((), dtype=torch.int64, device=m.device)
        n = self.b_loc // mb
        with self.model.working(work):
            for i in range(mb):
                part = {k: v.unflatten(0, (mb, n))[i] for k, v in rows.items()}
                loss, aux = self.model.train_loss(part, impl=self.impl, env=env)
                gs = torch.autograd.grad(loss * (self.norm * mb), [work[k] for k in names],
                                         allow_unused=True)
                for k, g in zip(names, gs):
                    if g is not None:
                        g = g.to(torch.float32)
                        g = g / mb if mb > 1 else g
                        grads[k] = grads[k].add_(g) if k in grads else g
                del gs
                nll += aux["nll_sum"]
                ntok += aux["ntok"]
        for k, w in work.items():  # a slice the loss does not reach
            grads.setdefault(k, torch.zeros(w.shape, dtype=torch.float32, device=w.device))
        total = m.psum(torch.stack([nll.to(torch.float64), ntok.to(torch.float64)]).reshape(
            m.block + (2,)), m.axis_names).reshape(2)
        return grads, total[0].to(torch.float32), total[1].to(torch.int64)

    def aggregate(self, rank_grads: dict) -> dict:
        """The fetch's backward on the gradients of the working slices, leaf
        by leaf in one order on every process (each gather's scenario
        reduce-scatter, the rep groups' first), then ``sync_gradients``'
        sums: {name: the gradient of this process's storage shard}."""
        work, self.fetched = self.fetched, None
        if work is None:
            raise ValueError("aggregate takes the gradients of this step's rank_gradients")
        out = {}
        for k, p in self.leaves.items():
            w = work.pop(k)
            out[k] = rank_grads[k] if w is p else torch.autograd.grad(
                w, p, grad_outputs=rank_grads[k])[0]
        self.leaves = {}
        return sync_gradients(out, self.places, self.pmesh, self.scenario, tp=self.env.tp)


def make_train_step(model: M.Model, mesh: Mesh, *, scenario: Scenario | str = Scenario.NATIVE,
                    optimizer: AdamW | None = None, microbatches: int = 1, global_batch: int = 8,
                    seq: int = 128, impl: str = "masked", clip_norm: float = 1.0) -> TrainStep:
    """The train step of ``model`` on ``mesh`` (a launcher's ("data",
    "model") or ("pod", "data", "model"), ``launch.mesh.make_mesh``; on the
    model's device, which must be made with
    ``make_env(cfg, mesh)``'s padded vocab), aggregating gradients under
    ``scenario``; ``optimizer`` defaults to ``AdamW`` with the config's
    8-bit moments setting. Turns the model's parameters' gradients on."""
    cls = ProcessTrainStep if isinstance(mesh, ProcessMesh) else TrainStep
    return cls(model, mesh, scenario=scenario,
               optimizer=optimizer or AdamW(eightbit=model.cfg.opt_state_8bit),
               microbatches=microbatches, global_batch=global_batch, seq=seq, impl=impl,
               clip_norm=clip_norm)
