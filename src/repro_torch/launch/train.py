"""Train the LM with in-network gradient aggregation on one card, with
checkpoints and the elastic restart.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \
        --steps 20 --mesh 4,2 --scenario s3_in_net_map --device cpu \
        --ckpt /tmp/ck --ckpt-every 4 --fail-step 14 --shrink-to 4

The port of ``repro/launch/train.py``: data (``TrainPipeline``'s Markov
tokens) → model → gradients aggregated over the mesh by the chosen §4
scenario (``--scenario s1_host | s2_in_net | s3_in_net_map | native |
hierarchical``; S3's hops run the ``ring_fused_step`` kernel on the card)
→ AdamW → a checkpoint every ``--ckpt-every`` steps (``--ckpt DIR``,
written in the background; the latest restores at start unless
``--fresh``). ``--mesh data,model`` or ``pod,data,model`` as in the
reference, the world dims of a ``Mesh`` on one device (``--device``, the
card by default): the data-parallel ranks run one after another, each under
its tp group (``cfg.resolve_tp`` of the model axis) folded into the ops.

Elastic restart: ``--fail-step K --shrink-to N`` simulates losing devices at
step K. The run waits for its writes, takes ``elastic_mesh_plan(N,
model_size=...)`` (the model axis kept: 4,2 on 4 devices is 2,2), rebuilds
the mesh, the train step and the pipeline, restores the latest checkpoint
and carries on at its step; the batch at a step is the same global rows at
any data world, so the data stream is preserved. Parameters and fp32
moments restore at any data world of the same model axis; 8-bit moments are
cut per device shard and refuse a change of mesh (in either form).

Under ``torchrun`` (``WORLD_SIZE`` set) the run is one process per mesh
device (``--backend gloo | nccl``, ``launch.procs.init_process_mesh``):

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --smoke --mesh 4,2 --scenario s2_in_net --backend gloo --device cpu \
        --ckpt /tmp/ck --ckpt-every 8 --fail-step 16 --shrink-to 4 --steps 24

each process holding its device's shard of the parameters and moments
(fp32, or 8-bit: the (codes, scales) of its device's shard of each stacked
leaf; ``launch.steps.ProcessTrainStep``) and its block of every batch. A
checkpoint gathers the shards into the same whole leaves, and the 8-bit
rows into the world-dim form's rows, which rank 0 writes: the same files as
a world-dim run on that mesh writes. A restore reads them in every process,
which keeps its shard (its row). The restart carries on inside the
processes, as the reference's does inside its one: once the checkpoint is
on disk (a barrier of the whole world), ranks ``0 … prod(plan.shape) − 1``
form a process group of their own (``procs.shrink_process_mesh``, made by
them alone under gloo and nccl), rebuild the model (each leaf cut to its
new shard as it is drawn), the step and the pipeline on a ``ProcessMesh`` of
the plan's shape over it, restore the checkpoint and train on to
``--steps``; the other ranks return their losses. After the shrink no call
of a survivor reaches the default group. The same command on the smaller
world without ``--fail-step`` (``--nproc-per-node 4 ... --mesh 2,2``,
``relaunch_args``) restores the latest checkpoint too. With a card per
process, ``--backend nccl`` and no ``--device``: each process computes on
its local rank's card and the collectives go card to card.

A checkpoint is the reference's tree, ``{"params": {JAX leaf path: array},
"opt": (count, m, v)}`` (``checkpoint_tree``: kv heads and experts in their
slots, the vocab padded to the model axis), so either package restores the
other's (fp32 moments); its meta records the mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.pipeline import TrainPipeline
from repro_torch.launch import procs as procs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import AXES, make_mesh
from repro_torch.mesh import Mesh, ProcessMesh
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim import OptState
from repro_torch.runtime.fault_tolerance import elastic_mesh_plan


def build(model: Model, mesh: Mesh, args, optimizer=None):
    """(train step, data pipeline) for ``model`` on ``mesh`` as ``args`` ask
    (``optimizer``: an ``AdamW`` other than the default)."""
    step = steps_lib.make_train_step(
        model, mesh, scenario=args.scenario, optimizer=optimizer,
        microbatches=args.microbatches, global_batch=args.global_batch, seq=args.seq,
        impl=args.impl)
    pipe = TrainPipeline(model.cfg, step.env, args.global_batch, args.seq,
                         seed=args.seed)
    return step, pipe


def checkpoint_tree(step: steps_lib.TrainStep, state: OptState) -> dict | None:
    """The model's parameters and ``state`` as the reference checkpoints
    them on the step's mesh: ``{"params": {JAX leaf path: tensor}, "opt":
    (count, m, v)}``, stacked leaves stacked, kv heads and experts in their
    slots (new tensors; other unstacked leaves are the live tensors, which
    the store copies). 8-bit moments are the (codes, scales) of each
    distinct device shard of a stacked leaf, a row each, as ``AdamW`` keeps
    them: the port's own layout (the reference's hold every device's). On a
    process mesh every process's shards are gathered to rank 0 into the
    same whole leaves (``convert.gather_shards``), and its 8-bit row into
    the world-dim rows (``gather_rows``): the others get None."""
    model, env = step.model, step.env
    cfg = model.cfg
    if env.mesh is not None:
        def whole(tree):
            return convert.gather_shards(convert.stack_leaves(model, tree), cfg, env)

        moments = functools.partial(gather_rows, step) if step.stacked else whole
        tree = {"params": whole(step.params),
                "opt": (np.int32(state.count), moments(state.m), moments(state.v))}
        return tree if env.mesh.rank == 0 else None

    def moments(tree):
        return tree if step.stacked else convert.to_slots(convert.stack_leaves(model, tree),
                                                          cfg, env)

    return {"params": convert.to_slots(convert.stack_leaves(model, step.params), cfg, env),
            "opt": (np.int32(state.count), moments(state.m), moments(state.v))}


def gather_rows(step: steps_lib.TrainStep, tree: dict, root: int = 0) -> dict:
    """A process's 8-bit moments ({JAX leaf path: (codes, scales)}, one row:
    its device's shard of the stacked leaf) → on process ``root`` the
    world-dim step's rows of the same mesh, each from the first device that
    holds it (``TrainStep.shard_row``; a shard's copies hold equal
    moments), leaf by leaf in path order; {} elsewhere. Every process must
    call it."""
    env = step.env
    m = env.mesh
    out = {}
    for path in sorted(tree):
        every = [m.gather(t.contiguous(), root) for t in tree[path]]
        if every[0] is None:
            continue
        rows = {}
        for r in range(m.size):
            rows.setdefault(step.shard_row(path, *divmod(r, env.model_size)), r)
        out[path] = tuple(torch.cat([e[rows[k]] for k in range(len(rows))]) for e in every)
    return out


def checkpoint_meta(step: steps_lib.TrainStep, **meta) -> dict:
    """A checkpoint's meta: ``meta`` and the step's mesh (its data-parallel
    world, the mesh's shape and tp), which 8-bit moments need again."""
    return {**meta, "world": step.world, "mesh": list(step.mesh_shape), "tp": step.env.tp}


def _leaves(step: steps_lib.TrainStep, flat: dict, prefix: str) -> dict:
    """The leaves of a restored checkpoint under ``prefix``, as the step's
    parameters hold them: read out of their slots on world dims; on a
    process mesh this process's device's shard of each (whole leaves read on
    the host, the shard moved to the model's device)."""
    model = step.model
    tree = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    if step.env.mesh is None:
        return convert.unstack_leaves(model, convert.from_slots(tree, model.cfg, step.env))
    shards = convert.rank_shards(tree, model.cfg, step.env, slots=True)
    return {k: t.contiguous().to(model.device)
            for k, t in convert.unstack_leaves(model, shards).items()}


def _moments(step: steps_lib.TrainStep, flat: dict, prefix: str, like: dict | None) -> dict:
    """The moments of a restored checkpoint under ``prefix``: fp32 leaves
    (``_leaves``), or 8-bit (codes, scales) pairs shaped as ``like``'s: on a
    process mesh its device's row of the world-dim rows
    (``TrainStep.shard_row``), moved to the model's device."""
    if like is None:
        return _leaves(step, flat, prefix)
    tree = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    env = step.env
    out = {}
    for path, pair in like.items():
        got = tuple(tree.get(f"{path}/{i}") for i in (0, 1))
        if env.mesh is not None and all(g is not None for g in got):
            row = step.shard_row(path, env.fsdp_index, env.model_index)
            got = tuple(g[row:row + 1].to(step.model.device) for g in got)
        if any(g is None or g.shape != t.shape for g, t in zip(got, pair)):
            raise ValueError(f"8-bit moments of {path}: the checkpoint does not hold "
                             f"{[tuple(t.shape) for t in pair]}")
        out[path] = got
    return out


def refuse_eightbit_change(manifest: dict, world: int, mesh_shape) -> None:
    """Raise where 8-bit moments of checkpoint ``manifest`` cannot restore at
    data-parallel ``world`` on ``mesh_shape``: they are cut per device shard,
    so another mesh (or the reference's files) cannot take them."""
    meta = manifest["meta"]
    if meta.get("world") != world or meta.get("mesh", list(mesh_shape)) != list(mesh_shape):
        raise ValueError(
            f"8-bit moments of step {manifest['step']} were cut per device shard at world "
            f"{meta.get('world', 'unknown (not written by the port)')} (mesh "
            f"{meta.get('mesh')}) and do not restore at world {world} (mesh "
            f"{list(mesh_shape)}): restart on the same mesh, or train with fp32 moments")


@torch.no_grad()
def restore(step: steps_lib.TrainStep, store: CheckpointStore, at: int | None = None
            ) -> tuple[OptState, int]:
    """Load checkpoint ``at`` (the latest by default) into ``step``'s model
    and return (its optimizer state, its step). Raises where it cannot
    restore: 8-bit moments saved on another mesh (they are cut per device
    shard) or by the reference, a leaf's shape or dtype that is not the
    model's, slot copies that differ. On a process mesh every process reads
    the whole leaves and keeps its device's shards, as the reference's
    re-sharding restore does."""
    model, opt = step.model, step.optimizer
    manifest = store.manifest(at)
    if opt.eightbit:
        refuse_eightbit_change(manifest, step.world, step.mesh_shape)
    host = step.env.mesh is not None
    flat, manifest = store.restore(step=manifest["step"], device="cpu" if host else model.device)
    params = _leaves(step, flat, "params/")
    for name, p in step.params.items():
        if params[name].dtype != p.dtype:
            raise ValueError(f"checkpoint leaf of {name} is {params[name].dtype}, the model "
                             f"stores {p.dtype}")
        p.copy_(params[name])
    model.cast_weights()
    like = step.init_state().m if opt.eightbit else None
    state = OptState(count=int(flat["opt/0"]), m=_moments(step, flat, "opt/1/", like),
                     v=_moments(step, flat, "opt/2/", like))
    return state, int(manifest["step"])


def init_or_restore(step: steps_lib.TrainStep, store: CheckpointStore | None, fresh: bool
                    ) -> tuple[OptState, int]:
    """(optimizer state, first step): the latest checkpoint in ``store``
    unless ``fresh`` or there is none, else a fresh state at step 0 (the
    model as it is)."""
    if store is None or fresh or store.latest_step() is None:
        return step.init_state(), 0
    state, start = restore(step, store)
    _say(step, f"[train] restored step {start} from {store.directory}")
    return state, start


def _say(step: steps_lib.TrainStep, msg: str) -> None:
    """Print ``msg``: on a process mesh from rank 0 alone."""
    if step.env.mesh is None or step.env.mesh.rank == 0:
        print(msg, flush=True)


def run(args, optimizer=None) -> list[float]:
    """Train up to step ``args.steps`` from random weights (seed
    ``args.seed``) or the latest checkpoint; returns the loss of every step
    taken (a restart takes its steps again). Under ``torchrun``
    (``WORLD_SIZE`` set) this process is one device of a ``ProcessMesh``
    (``--backend``), holding its shards; after a simulated failure the
    survivors carry on over a group of their own and the others return the
    losses they took (the module's doc). The default group is destroyed
    here only where this call joined it, so that a caller's world goes
    on."""
    from repro_torch.configs import get_config, get_smoke_config

    if args.fail_step is not None and args.shrink_to and not args.ckpt:
        raise ValueError("--fail-step/--shrink-to: the elastic restart needs --ckpt")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.moe_dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.moe_dispatch))
    shape = [int(x) for x in args.mesh.split(",")]
    joined = False
    if "WORLD_SIZE" in os.environ:  # one process per mesh device
        import torch.distributed as dist

        from repro_torch.launch.procs import init_process_mesh

        joined = not dist.is_initialized()
        mesh = init_process_mesh(shape, AXES[-len(shape):], backend=args.backend,
                                 device=args.device)
    else:
        mesh = make_mesh(shape, device=args.device)
    try:
        return _train(args, cfg, mesh, optimizer)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, cfg, mesh: Mesh, optimizer) -> list[float]:
    procs = isinstance(mesh, ProcessMesh)
    store = CheckpointStore(args.ckpt) if args.ckpt else None
    model = Model(cfg, device=mesh.device, seed=args.seed, env=steps_lib.make_env(cfg, mesh))
    step, pipe = build(model, mesh, args, optimizer)
    state, k = init_or_restore(step, store, args.fresh)
    saved = k if store is not None and store.latest_step() == k else None
    fail_step = args.fail_step
    losses = []
    shrunk = None  # the survivors' mesh, whose groups this run made
    while k < args.steps:
        if fail_step is not None and k == fail_step and args.shrink_to:
            kept = None if procs else model  # a survivor's shards are larger: drawn anew
            del step, pipe, state, model
            restarted = restart(args, cfg, mesh, store, optimizer, model=kept)
            if restarted is None:  # this process's device is gone
                return losses
            mesh, model, step, pipe, state, k = restarted[:6]
            shrunk = mesh if procs else None
            fail_step = None
            continue
        t0 = time.perf_counter()
        state, metrics = step(state, pipe.batch_at(k))
        loss = float(metrics["loss"])
        losses.append(loss)
        k += 1
        if k % args.log_every == 0 or k == args.steps:
            _say(step, f"[train] step {k:5d} loss {loss:.4f} "
                       f"gnorm {float(metrics['grad_norm']):.3f} "
                       f"lr {metrics['lr']:.2e} {time.perf_counter() - t0:.2f}s")
        if store is not None and k % args.ckpt_every == 0:
            save(store, k, step, state, blocking=False, loss=loss)
            saved = k
    if store is not None:
        store.wait()
        if saved != k:
            save(store, k, step, state, blocking=True)
    if shrunk is not None:
        procs_lib.release_process_mesh(shrunk)
    return losses


class Restarted(NamedTuple):
    """A survivor's run after the elastic restart (``restart``): the new
    mesh, model, step, pipeline, restored state and step to go on from;
    ``failed_at``, the ``time.perf_counter()`` of the failure on this
    process, and ``times``, the seconds of each part since: the group's
    formation (a process mesh only), the rebuild and the restore."""
    mesh: Mesh
    model: Model
    step: steps_lib.TrainStep
    pipe: TrainPipeline
    state: OptState
    k: int
    failed_at: float
    times: dict


def restart(args, cfg, mesh: Mesh, store: CheckpointStore, optimizer=None, *,
            model: Model | None = None) -> Restarted | None:
    """The elastic restart after a simulated failure at ``--fail-step``
    (``--shrink-to N``), once the caller has let go of its step, pipeline
    and state: wait for the checkpoint writes (on a process mesh, then a
    barrier of ``mesh``'s processes), take ``elastic_mesh_plan(N,
    model_size=...)``, refuse a change of mesh with 8-bit moments (every
    process, before any leaves), then on a process mesh shrink to the
    plan's first ranks (``procs.shrink_process_mesh``; the others get None
    and make no further call) and on world dims make the plan's mesh, draw
    ``cfg``'s model from ``args.seed`` on it unless ``model`` is given (on
    world dims the run's own, whose leaves are whole), build the step and
    the pipeline and restore the latest checkpoint. A survivor releases the
    groups of its mesh when it is done (``procs.release_process_mesh``)."""
    procs = isinstance(mesh, ProcessMesh)
    store.wait()
    if procs:  # rank 0's checkpoint is on disk before anyone leaves
        torch.distributed.barrier(group=mesh.group)
    failed_at = time.perf_counter()
    first = not procs or mesh.rank == 0
    plan = elastic_mesh_plan(args.shrink_to, model_size=steps_lib.make_env(cfg, mesh).model_size)
    eightbit = optimizer.eightbit if optimizer is not None else cfg.opt_state_8bit
    if eightbit:
        refuse_eightbit_change(store.manifest(), steps_lib.make_env(
            cfg, make_mesh(plan.shape, plan.axes, device=mesh.device)).dp_world, plan.shape)
    if first:
        print(f"[train] step {args.fail_step}: simulating a device failure; shrinking to "
              f"{args.shrink_to} devices: --mesh {','.join(map(str, plan.shape))}", flush=True)
    times, t = {}, failed_at
    if procs:
        mesh = procs_lib.shrink_process_mesh(mesh, plan)
        if mesh is None:
            return None
        t = _lap(times, "group_s", t, mesh.device)
    else:
        mesh = make_mesh(plan.shape, plan.axes, device=mesh.device)
    if model is None:
        model = Model(cfg, device=mesh.device, seed=args.seed, env=steps_lib.make_env(cfg, mesh))
    step, pipe = build(model, mesh, args, optimizer)
    t = _lap(times, "rebuild_s", t, mesh.device)
    state, k = init_or_restore(step, store, fresh=False)
    _lap(times, "restore_s", t, mesh.device)
    if first:
        print(f"[train] restarted at step {k} on --mesh {','.join(map(str, plan.shape))}: "
              + ", ".join(f"{key[:-2]} {v:.2f}s" for key, v in times.items()), flush=True)
    return Restarted(mesh, model, step, pipe, state, k, failed_at, times)


def _lap(times: dict, key: str, since: float, device) -> float:
    """Record the seconds since ``since`` under ``key``, once ``device``'s
    queued work is done; returns the time now."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    times[key] = now - since
    return now


def save(store: CheckpointStore, k: int, step: steps_lib.TrainStep, state: OptState, *,
         blocking: bool, **meta) -> None:
    """Checkpoint step ``k`` (``checkpoint_tree``, ``checkpoint_meta``):
    on a process mesh every process gathers, and rank 0 writes."""
    tree = checkpoint_tree(step, state)
    if tree is not None:
        store.save(k, tree, meta=checkpoint_meta(step, arch=step.model.cfg.name, **meta),
                   blocking=blocking)


def relaunch_args(args) -> argparse.Namespace | None:
    """The relaunch form of the restart after ``--fail-step`` for
    ``--shrink-to N``: a new world on ``elastic_mesh_plan(N,
    model_size=...)``'s mesh (the model axis kept) that restores the latest
    checkpoint and simulates no failure, as the survivors carry on inside
    the first world. None where the run simulates none."""
    if args.fail_step is None or not args.shrink_to:
        return None
    shape = [int(x) for x in args.mesh.split(",")]
    plan = elastic_mesh_plan(args.shrink_to, model_size=shape[-1])
    return argparse.Namespace(**{**vars(args), "mesh": ",".join(map(str, plan.shape)),
                                 "fail_step": None, "shrink_to": None, "fresh": False})


def _rank_run(args, device) -> list[float]:
    if device.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    return run(argparse.Namespace(**{**vars(args), "device": device}))


def spawn_run(args, store_path, *, backend: str = "gloo", device=None,
              timeout_s: float = 300) -> list[float]:
    """``run(args)`` in one spawned process per mesh device
    (``launch.procs.spawn``, ``device``: each rank's, ``None`` the card);
    a simulated failure restarts inside the same processes. Returns rank
    0's losses, a survivor's: the steps before the failure, then the
    restarted ones (every survivor's are the same)."""
    world = math.prod(int(x) for x in args.mesh.split(","))
    return procs_lib.spawn(functools.partial(_rank_run, args), world, backend=backend,
                           device=device, store_path=store_path, timeout_s=timeout_s)[0]


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mesh", default="1,1", help="data,model (or pod,data,model)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--scenario", default="native")
    ap.add_argument("--impl", default="masked")
    ap.add_argument("--moe-dispatch", default=None, choices=[None, "a2a", "replicated"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--fresh", action="store_true", help="ignore existing checkpoints")
    ap.add_argument("--fail-step", type=int, default=None)
    ap.add_argument("--shrink-to", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (under torchrun, the local rank's)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="the process group's backend under torchrun (WORLD_SIZE set)")
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
