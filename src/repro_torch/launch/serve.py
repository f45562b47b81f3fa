"""Batched serving: prefill a prompt batch, then greedy decode.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --batch 8 --prompt-len 4096 --gen 32
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --smoke \
        --batch 2 --prompt-len 32 --gen 8 --device cpu
    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke --mesh 2,4 \
        --device cpu
    torchrun --nproc-per-node 8 -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --smoke --mesh 2,4 --backend gloo --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --mesh 2,2 --backend nccl

The port of ``repro/launch/serve.py`` on one device (``--device``, the card
by default), for every arch of ``repro_torch.configs``. Every cache leaf is
allocated at ``prompt_len + gen`` positions up front (a local-attention
layer's at most its window, an enc-dec model's cross cache at the encoder's
length) and prefill fills it in place: the values of the JAX serve.py's
prefill cache padded into a decode cache (``pad_cache``), without holding
both. Inputs are seeded: token prompts; for an embedding-input model
(qwen2-vl) patch embeddings and a (t, h, w) position grid, the stub that
the JAX model's input specs describe; for enc-dec (seamless) frame
embeddings of ``--enc-len`` positions and a token prompt. ``--impl flash``
(the default on the card) runs the prefill self-attention through the
``flash_attention`` kernel where the kernel computes the layer's function
(``models.model.attention_impl``), ``masked`` through the JAX model's
chunked attention; decode is the same for both. ``--mesh d,m`` (or
``p,d,m``) serves across a ``("data", "model")`` (or ``("pod", "data",
"model")``) mesh of world dims, ``launch.mesh.make_mesh``'s (default 1,1):
the model's tp ranks from ``cfg.resolve_tp(m)``, the batch in the
device-major layout of ``launch.shapes.batch_layout`` and its distinct rows
held once (``launch.steps.held_rows``). Under ``torchrun`` (``WORLD_SIZE``
set) it serves on a process mesh instead, one process per mesh device
(``launch.procs.init_process_mesh``, ``--backend``), every block kind:
every process makes the model from the seed, keeping its device's shard of
each leaf as it is drawn, makes the same global prompts (token prompts,
patch embeddings with their grid, or ``--enc-len`` frames with a token
prompt) and keeps its own rows of each input (``steps.rank_rows``), and
rank 0 prints the tokens gathered from every process.

    torchrun --nproc-per-node 8 -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --smoke --mesh 2,4 --enc-len 12 \
        --backend gloo --device cpu
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch

from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import AXES, make_mesh
from repro_torch.mesh import Mesh
from repro_torch.models.model import Model

GRID_SIDE = 32  # a frame of 32 × 32 patches: 448 × 448 pixels at qwen2-vl's 14-pixel patch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grid_positions(b: int, s: int, device) -> torch.Tensor:
    """(b, s, 3) int32 M-RoPE positions of s patches laid out row-major on
    frames of side × side (side = √s up to ``GRID_SIDE``): (frame, row,
    column) of each."""
    side = max(1, min(GRID_SIDE, math.isqrt(s)))
    i = torch.arange(s, device=device)
    grid = torch.stack([i // (side * side), (i // side) % side, i % side], dim=-1)
    return grid.to(torch.int32)[None].expand(b, s, 3)


def prompt_batch(model: Model, b: int, s: int, *, seed: int, enc_len: int | None = None):
    """Seeded prompts for ``model`` on its device: tokens (b, s) int32, or
    the dict its prefill takes (``Model.prefill_hidden``): ``embeds`` (b, s,
    d) bf16 from N(0, 1) and ``grid_positions`` for an embedding-input model;
    ``tokens`` with ``enc_embeds`` (b, enc_len, d) bf16 and ``enc_positions``
    for enc-dec (``enc_len`` defaults to s)."""
    cfg, dev = model.cfg, model.device
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.compute_dtype)

    def embeds(n):
        return torch.randn((b, n, cfg.d_model), generator=g, device=dev).to(dt)

    if cfg.embed_input and not cfg.enc_layers:
        batch = {"embeds": embeds(s)}
        if cfg.mrope_sections is not None:
            batch["positions"] = grid_positions(b, s, dev)
        return batch
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev, dtype=torch.int32)
    if not cfg.enc_layers:
        return tokens
    n = s if enc_len is None else enc_len
    return {"tokens": tokens, "enc_embeds": embeds(n),
            "enc_positions": torch.arange(n, device=dev, dtype=torch.int32)[None].expand(b, n)}


def generate(model: Model, batch, gen: int, *, impl: str, mesh: Mesh | None = None,
             global_batch: int | None = None, compute_at_data: bool = False) -> dict:
    """Prefill ``batch`` (tokens (b, s) or a dict of the model's inputs),
    then decode greedily to ``gen`` tokens in all (the prefill's next token
    is the first). With a ``mesh``, ``batch`` holds the distinct rows of a
    ``global_batch`` (``steps.rows_of``) and the steps run over the mesh
    in its device-major layout; ``compute_at_data`` takes the decode's
    compute-at-data route. Returns ``{"tokens": (b, gen) int32 on the
    model's device, "cache", "prefill_s", "decode_s"}``; times are host
    walls that end in a device synchronise."""
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    b, s = steps_lib.batch_shape(batch)
    gb = b if mesh is None else global_batch
    pstep = steps_lib.make_prefill_step(model, global_batch=gb, seq=s, impl=impl, mesh=mesh)
    sstep = steps_lib.make_serve_step(model, global_batch=gb, seq_max=s + gen, mesh=mesh,
                                      compute_at_data=compute_at_data)
    dev = model.device
    enc = None if isinstance(batch, torch.Tensor) else batch.get("enc_embeds")
    cache = model.init_cache(b, s + gen, enc_len=None if enc is None else enc.shape[1])
    if mesh is not None:
        batch = steps_lib.map_batch(batch, lambda v: steps_lib.device_major(model.env, v, gb))
    _sync(dev)
    t0 = time.perf_counter()
    cache, toks = pstep(batch, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [toks]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        toks, cache = sstep(cache, toks, s + i)
        out.append(toks)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    if mesh is not None:
        out = [steps_lib.rows_of(model.env, t, gb) for t in out]
    return {"tokens": torch.stack(out, 1), "cache": cache, "prefill_s": t_prefill,
            "decode_s": t_decode}


def run(args):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
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
        return _serve(args, cfg, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _serve(args, cfg, mesh):
    env = steps_lib.make_env(cfg, mesh)
    model = Model(cfg, device=mesh.device, seed=args.seed, env=env)
    impl = args.impl or ("flash" if model.device.type == "cuda" else "masked")
    rows = steps_lib.held_rows(env.world(), args.batch)
    batch = prompt_batch(model, rows, args.prompt_len, seed=args.seed, enc_len=args.enc_len)
    if env.mesh is not None:  # the same global prompts on every process: keep its own rows
        batch = steps_lib.map_batch(batch, lambda v: steps_lib.rank_rows(env, v, args.batch))
    res = generate(model, batch, args.gen, impl=impl, mesh=mesh, global_batch=args.batch)
    toks = res["tokens"]
    where = ""
    if env.mesh is not None:
        toks = steps_lib.gather_rows(env, toks, args.batch)
        where = f" on {mesh.size} processes ({mesh.transport})"
    gen = toks.cpu().numpy()  # (rows, gen)
    n_tok = gen.size
    if env.mesh is None or mesh.rank == 0:
        print(f"[serve] {cfg.name} on {model.device} ({impl}), mesh {mesh.shape}{where} (tp "
              f"{env.tp}, rep {env.rep}): prefill {rows}x"
              f"{args.prompt_len} in {res['prefill_s']:.2f}s; decoded {n_tok} tokens in "
              f"{res['decode_s']:.2f}s ({n_tok / max(res['decode_s'], 1e-9):.1f} tok/s)")
        print("[serve] sample:", gen[0][:16].tolist())
    return gen


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--enc-len", type=int, default=None,
                    help="encoder input length of an enc-dec model (default: --prompt-len)")
    ap.add_argument("--mesh", default="1,1",
                    help="data,model or pod,data,model: the serving mesh")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="the process group's backend under torchrun (WORLD_SIZE set)")
    ap.add_argument("--impl", choices=("flash", "masked"), default=None,
                    help="prefill attention (default: flash on the card, masked on the CPU)")
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
