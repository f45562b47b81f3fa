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
cut per device shard and refuse a change of mesh.

A checkpoint is the reference's tree, ``{"params": {JAX leaf path: array},
"opt": (count, m, v)}`` (``checkpoint_tree``: kv heads and experts in their
slots, the vocab padded to the model axis), so either package restores the
other's (fp32 moments); its meta records the mesh.
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
from repro_torch.launch.mesh import make_mesh
from repro_torch.mesh import Mesh
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


def checkpoint_tree(step: steps_lib.TrainStep, state: OptState) -> dict:
    """The model's parameters and ``state`` as the reference checkpoints
    them on the step's mesh: ``{"params": {JAX leaf path: tensor}, "opt":
    (count, m, v)}``, stacked leaves stacked, kv heads and experts in their
    slots (new tensors; other unstacked leaves are the live tensors, which
    the store copies). 8-bit moments are the (codes, scales) of each
    distinct device shard of a stacked leaf, a row each, as ``AdamW`` keeps
    them: the port's own layout (the reference's hold every device's)."""
    model, env = step.model, step.env
    cfg = model.cfg

    def moments(tree):
        return tree if step.stacked else convert.to_slots(convert.stack_leaves(model, tree),
                                                          cfg, env)

    return {"params": convert.to_slots(convert.stack_leaves(model, step.params), cfg, env),
            "opt": (np.int32(state.count), moments(state.m), moments(state.v))}


def checkpoint_meta(step: steps_lib.TrainStep, **meta) -> dict:
    """A checkpoint's meta: ``meta`` and the step's mesh (its data-parallel
    world, the mesh's shape and tp), which 8-bit moments need again."""
    return {**meta, "world": step.world, "mesh": list(step.mesh_shape), "tp": step.env.tp}


def _moments(step: steps_lib.TrainStep, flat: dict, prefix: str, like: dict | None) -> dict:
    """The moments of a restored checkpoint under ``prefix``: fp32 leaves
    read out of their slots, or 8-bit (codes, scales) pairs shaped as
    ``like``'s."""
    tree = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    if like is None:
        model = step.model
        return convert.unstack_leaves(model, convert.from_slots(tree, model.cfg, step.env))
    out = {}
    for path, pair in like.items():
        got = tuple(tree.get(f"{path}/{i}") for i in (0, 1))
        if any(g is None or g.shape != t.shape for g, t in zip(got, pair)):
            raise ValueError(f"8-bit moments of {path}: the checkpoint does not hold "
                             f"{[tuple(t.shape) for t in pair]}")
        out[path] = got
    return out


@torch.no_grad()
def restore(step: steps_lib.TrainStep, store: CheckpointStore, at: int | None = None
            ) -> tuple[OptState, int]:
    """Load checkpoint ``at`` (the latest by default) into ``step``'s model
    and return (its optimizer state, its step). Raises where it cannot
    restore: 8-bit moments saved on another mesh (they are cut per device
    shard) or by the reference, a leaf's shape or dtype that is not the
    model's, slot copies that differ."""
    model, opt = step.model, step.optimizer
    manifest = store.manifest(at)
    meta = manifest["meta"]
    if opt.eightbit and (meta.get("world") != step.world
                         or meta.get("mesh", list(step.mesh_shape)) != list(step.mesh_shape)):
        raise ValueError(
            f"8-bit moments of step {manifest['step']} were cut per device shard at world "
            f"{meta.get('world', 'unknown (not written by the port)')} (mesh "
            f"{meta.get('mesh')}) and do not restore at world {step.world} (mesh "
            f"{list(step.mesh_shape)}): restart on the same mesh, or train with fp32 moments")
    flat, manifest = store.restore(step=manifest["step"], device=model.device)
    params = convert.unstack_leaves(model, convert.from_slots(
        {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")},
        model.cfg, step.env))
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
    mesh = make_mesh([int(x) for x in args.mesh.split(",")], device=args.device)
    store = CheckpointStore(args.ckpt) if args.ckpt else None
    model = Model(cfg, device=args.device, seed=args.seed, env=steps_lib.make_env(cfg, mesh))
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
            plan = elastic_mesh_plan(args.shrink_to, model_size=step.env.model_size)
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
                       meta=checkpoint_meta(step, arch=cfg.name, loss=loss),
                       blocking=False)
    if store is not None:
        store.wait()
        if store.latest_step() != k:
            store.save(k, checkpoint_tree(step, state),
                       meta=checkpoint_meta(step, arch=cfg.name), blocking=True)
    return losses


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
    ap.add_argument("--device", default="cuda")
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
