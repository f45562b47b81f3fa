"""Train the LM with in-network gradient aggregation on one card, with
checkpoints and the elastic restart.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \
        --steps 20 --mesh 4,1 --scenario s3_in_net_map --device cpu \
        --ckpt /tmp/ck --ckpt-every 4 --fail-step 14 --shrink-to 2

The port of ``repro/launch/train.py``: data (``TrainPipeline``'s Markov
tokens) → model → gradients aggregated over the data world by the chosen
§4 scenario (``--scenario s1_host | s2_in_net | s3_in_net_map | native |
hierarchical``; S3's hops run the ``ring_fused_step`` kernel on the card)
→ AdamW → a checkpoint every ``--ckpt-every`` steps (``--ckpt DIR``,
written in the background; the latest restores at start unless
``--fresh``). ``--mesh data,model`` or ``pod,data,model`` as in the
reference; the data world is the world dims of a ``Mesh`` on one device
(``--device``, the card by default), and a model axis above 1 raises:
training under tensor parallelism is ROADMAP.md §1 item 2.

Elastic restart: ``--fail-step K --shrink-to N`` simulates losing devices at
step K. The run waits for its writes, takes ``elastic_mesh_plan(N,
model_size=1)``, rebuilds the mesh, the train step and the pipeline on the
smaller data world, restores the latest checkpoint and carries on at its
step; the batch at a step is the same global rows at any world, so the
data stream is preserved. Parameters and fp32 moments are held whole and
restore at any world; 8-bit moments are cut per rank's FSDP shard and
refuse a change of world.

A checkpoint is the reference's tree, ``{"params": {JAX leaf path: array},
"opt": (count, m, v)}`` (``checkpoint_tree``), so either package restores
the other's (fp32 moments).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.pipeline import TrainPipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import data_world, make_mesh
from repro_torch.mesh import Mesh
from repro_torch.models import convert
from repro_torch.models.model import Model
from repro_torch.optim import OptState
from repro_torch.runtime.fault_tolerance import elastic_mesh_plan


def build(model: Model, mesh: Mesh, args, optimizer=None):
    """(train step, data pipeline) for ``model`` on ``mesh``'s data world
    (``launch.mesh.data_world``) as ``args`` ask (``optimizer``: an
    ``AdamW`` other than the default)."""
    mesh = data_world(mesh)
    step = steps_lib.make_train_step(
        model, mesh, scenario=args.scenario, optimizer=optimizer,
        microbatches=args.microbatches, global_batch=args.global_batch, seq=args.seq,
        impl=args.impl)
    pipe = TrainPipeline(model.cfg, mesh, args.global_batch, args.seq, seed=args.seed)
    return step, pipe


def _moment_tree(model: Model, moments: dict, eightbit: bool) -> dict:
    if not eightbit:
        return convert.stack_leaves(model, moments)
    codes = convert.stack_leaves(model, {k: c for k, (c, _) in moments.items()})
    scales = convert.stack_leaves(model, {k: s for k, (_, s) in moments.items()})
    return {path: (codes[path], scales[path]) for path in codes}


def checkpoint_tree(step: steps_lib.TrainStep, state: OptState) -> dict:
    """The model's parameters and ``state`` as the reference checkpoints
    them: ``{"params": {JAX leaf path: tensor}, "opt": (count, m, v)}``,
    stacked leaves stacked (new tensors; unstacked ones are the live
    tensors, which the store copies). 8-bit moments are (codes, scales)
    pairs of each rank's FSDP shard, stacked over the layers: the port's own
    layout."""
    model, eightbit = step.model, step.optimizer.eightbit
    return {"params": convert.stack_leaves(model, step.params),
            "opt": (np.int32(state.count), _moment_tree(model, state.m, eightbit),
                    _moment_tree(model, state.v, eightbit))}


def _unstack_moments(model: Model, flat: dict, prefix: str, like: dict, eightbit: bool) -> dict:
    if not eightbit:
        tree = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        return convert.unstack_leaves(model, tree)
    parts = []
    for i in (0, 1):
        tree = {k[len(prefix):-2]: v for k, v in flat.items()
                if k.startswith(prefix) and k.endswith(f"/{i}")}
        parts.append(convert.unstack_leaves(model, tree, {n: t[i].shape for n, t in like.items()}))
    return {n: (parts[0][n], parts[1][n]) for n in parts[0]}


@torch.no_grad()
def restore(step: steps_lib.TrainStep, store: CheckpointStore, at: int | None = None
            ) -> tuple[OptState, int]:
    """Load checkpoint ``at`` (the latest by default) into ``step``'s model
    and return (its optimizer state, its step). Raises where it cannot
    restore: 8-bit moments saved at another world (they are cut per rank's
    FSDP shard) or by the reference, a leaf's shape or dtype that is not
    the model's."""
    model, opt = step.model, step.optimizer
    manifest = store.manifest(at)
    meta = manifest["meta"]
    if opt.eightbit and meta.get("world") != step.world:
        raise ValueError(
            f"8-bit moments of step {manifest['step']} were cut per rank's FSDP shard at world "
            f"{meta.get('world', 'unknown (not written by the port)')} and do not restore at "
            f"world {step.world}: restart at the same world, or train with fp32 moments")
    flat, manifest = store.restore(step=manifest["step"], device=model.device)
    params = convert.unstack_leaves(
        model, {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")})
    for name, p in step.params.items():
        if params[name].dtype != p.dtype:
            raise ValueError(f"checkpoint leaf of {name} is {params[name].dtype}, the model "
                             f"stores {p.dtype}")
        p.copy_(params[name])
    model.cast_weights()
    like = step.init_state().m if opt.eightbit else None
    state = OptState(count=int(flat["opt/0"]),
                     m=_unstack_moments(model, flat, "opt/1/", like, opt.eightbit),
                     v=_unstack_moments(model, flat, "opt/2/", like, opt.eightbit))
    return state, int(manifest["step"])


def init_or_restore(step: steps_lib.TrainStep, store: CheckpointStore | None, fresh: bool
                    ) -> tuple[OptState, int]:
    """(optimizer state, first step): the latest checkpoint in ``store``
    unless ``fresh`` or there is none, else a fresh state at step 0 (the
    model as it is)."""
    if store is None or fresh or store.latest_step() is None:
        return step.init_state(), 0
    state, start = restore(step, store)
    print(f"[train] restored step {start} from {store.directory}")
    return state, start


def run(args, optimizer=None) -> list[float]:
    """Train up to step ``args.steps`` from random weights (seed
    ``args.seed``) or the latest checkpoint; returns the loss of every step
    taken (a restart takes its steps again)."""
    from repro_torch.configs import get_config, get_smoke_config

    if args.fail_step is not None and args.shrink_to and not args.ckpt:
        raise ValueError("--fail-step/--shrink-to: the elastic restart needs --ckpt")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.moe_dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.moe_dispatch))
    mesh = data_world(make_mesh([int(x) for x in args.mesh.split(",")], device=args.device))
    store = CheckpointStore(args.ckpt) if args.ckpt else None
    model = Model(cfg, device=args.device, seed=args.seed)
    step, pipe = build(model, mesh, args, optimizer)
    state, k = init_or_restore(step, store, args.fresh)
    fail_step = args.fail_step
    losses = []
    while k < args.steps:
        if fail_step is not None and k == fail_step and args.shrink_to:
            # simulated failure: shrink the data world and restore
            print(f"[train] step {k}: simulating a device failure; shrinking to "
                  f"{args.shrink_to} devices")
            store.wait()
            plan = elastic_mesh_plan(args.shrink_to, model_size=1)
            del step, pipe, state
            step, pipe = build(model, make_mesh(plan.shape, plan.axes, device=args.device),
                               args, optimizer)
            state, k = init_or_restore(step, store, fresh=False)
            fail_step = None
            continue
        t0 = time.perf_counter()
        state, metrics = step(state, pipe.batch_at(k))
        loss = float(metrics["loss"])
        losses.append(loss)
        k += 1
        if k % args.log_every == 0 or k == args.steps:
            print(f"[train] step {k:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {metrics['lr']:.2e} {time.perf_counter() - t0:.2f}s")
        if store is not None and k % args.ckpt_every == 0:
            store.save(k, checkpoint_tree(step, state),
                       meta={"arch": cfg.name, "loss": loss, "world": step.world},
                       blocking=False)
    if store is not None:
        store.wait()
        if store.latest_step() != k:
            store.save(k, checkpoint_tree(step, state),
                       meta={"arch": cfg.name, "world": step.world}, blocking=True)
    return losses


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mesh", default="1,1", help="data,model (or pod,data,model); model 1")
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
    ap.add_argument("--device", default="cuda")
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
