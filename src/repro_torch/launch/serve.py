"""Batched serving: prefill a prompt batch, then greedy decode.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --batch 8 --prompt-len 4096 --gen 32
    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \
        --batch 2 --prompt-len 32 --gen 8 --device cpu

The port of ``repro/launch/serve.py`` on one device (``--device``, the card
by default). The KV cache is allocated at ``prompt_len + gen`` up front and
prefill writes its first ``prompt_len`` slots in place: the same values as
the JAX serve.py's prefill cache padded into a decode cache (``pad_cache``),
without holding both. ``--impl flash`` (the default on the card) runs the
prefill attention through the ``flash_attention`` kernel, ``masked`` through
the JAX model's chunked attention; decode is the same for both.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.launch import steps as steps_lib
from repro_torch.models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, tokens: torch.Tensor, gen: int, *, impl: str) -> dict:
    """Prefill ``tokens`` (b, s), then decode greedily to ``gen`` tokens in
    all (the prefill's next token is the first). Returns ``{"tokens": (b,
    gen) int32 on the model's device, "cache", "prefill_s", "decode_s"}``;
    times are host walls that end in a device synchronise."""
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    b, s = tokens.shape
    pstep = steps_lib.make_prefill_step(model, global_batch=b, seq=s, impl=impl)
    sstep = steps_lib.make_serve_step(model, global_batch=b, seq_max=s + gen)
    dev = model.device
    cache = model.init_cache(b, s + gen)
    _sync(dev)
    t0 = time.perf_counter()
    cache, toks = pstep(tokens, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [toks]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        toks, cache = sstep(cache, toks, s + i)
        out.append(toks)
    _sync(dev)
    return {"tokens": torch.stack(out, 1), "cache": cache, "prefill_s": t_prefill,
            "decode_s": time.perf_counter() - t0}


def run(args) -> np.ndarray:
    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device, seed=args.seed)
    impl = args.impl or ("flash" if model.device.type == "cuda" else "masked")
    rng = np.random.RandomState(args.seed)
    prompts = rng.randint(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    res = generate(model, torch.from_numpy(prompts).to(model.device), args.gen, impl=impl)
    gen = res["tokens"].cpu().numpy()  # (batch, gen)
    n_tok = gen.size
    print(f"[serve] {cfg.name} on {model.device} ({impl}): prefill {args.batch}x"
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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", choices=("flash", "masked"), default=None,
                    help="prefill attention (default: flash on the card, masked on the CPU)")
    return ap


if __name__ == "__main__":
    run(parser().parse_args())
