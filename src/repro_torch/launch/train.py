"""Train the LM with in-network gradient aggregation on one card.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \
        --steps 20 --mesh 4,1 --scenario s3_in_net_map --device cpu

The port of ``repro/launch/train.py``: data (``TrainPipeline``'s Markov
tokens) → model → gradients aggregated over the data world by the chosen
§4 scenario (``--scenario s1_host | s2_in_net | s3_in_net_map | native |
hierarchical``; S3's hops run the ``ring_fused_step`` kernel on the card)
→ AdamW. ``--mesh data,model`` or ``pod,data,model`` as in the reference;
the data world is the world dims of a ``Mesh`` on one device (``--device``,
the card by default), and a model axis above 1 raises: tensor parallelism
waits for more than one card. Checkpoints and the elastic restart
(``--ckpt``, ``--fail-step``, ``--shrink-to``) wait for ROADMAP item 5(c)
and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.data.pipeline import TrainPipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.mesh import Mesh
from repro_torch.models.model import Model


def make_mesh(shape: tuple[int, ...], device) -> Mesh:
    """``--mesh``'s (data, model) or (pod, data, model) → the data world's
    ``Mesh`` on ``device``; the model axis must be 1."""
    if len(shape) not in (2, 3):
        raise ValueError(f"--mesh takes data,model or pod,data,model, got {shape}")
    if shape[-1] != 1:
        raise ValueError(f"model axis {shape[-1]}: tensor parallelism needs more than one card "
                         "and is not ported; use a model axis of 1")
    axes = ("pod", "data") if len(shape) == 3 else ("data",)
    return Mesh(axes, shape[:-1], device=device)


def build(model: Model, mesh: Mesh, args, optimizer=None):
    """(train step, data pipeline) for ``model`` on ``mesh`` as ``args`` ask
    (``optimizer``: an ``AdamW`` other than the default)."""
    step = steps_lib.make_train_step(
        model, mesh, scenario=args.scenario, optimizer=optimizer,
        microbatches=args.microbatches, global_batch=args.global_batch, seq=args.seq,
        impl=args.impl)
    pipe = TrainPipeline(model.cfg, mesh, args.global_batch, args.seq, seed=args.seed)
    return step, pipe


def run(args, optimizer=None) -> list[float]:
    """Train ``args.steps`` steps from random weights (seed ``args.seed``);
    returns the loss of every step."""
    from repro_torch.configs import get_config, get_smoke_config

    for flag in ("ckpt", "fail_step", "shrink_to"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(f"--{flag.replace('_', '-')}: checkpoints and the elastic "
                                      "restart are ROADMAP item 5(c), not ported yet")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.moe_dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.moe_dispatch))
    mesh = make_mesh(tuple(int(x) for x in args.mesh.split(",")), args.device)
    model = Model(cfg, device=args.device, seed=args.seed)
    step, pipe = build(model, mesh, args, optimizer)
    state = step.init_state()
    losses = []
    for k in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step(state, pipe.batch_at(k))
        loss = float(metrics["loss"])
        losses.append(loss)
        if (k + 1) % args.log_every == 0 or k + 1 == args.steps:
            print(f"[train] step {k + 1:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {metrics['lr']:.2e} {time.perf_counter() - t0:.2f}s")
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
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None, help="ROADMAP 5(c): raises")
    ap.add_argument("--fail-step", type=int, default=None, help="ROADMAP 5(c): raises")
    ap.add_argument("--shrink-to", type=int, default=None, help="ROADMAP 5(c): raises")
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
