#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    PYTHONPATH=src python3 chip_smoke.py

1. Builds the Hopper kernels (``src/repro_torch/csrc``) into ``build/``.
2. Holds every kernel against its plain PyTorch version on the card, at edge
   shapes (bitwise where the function is exact, 2e-2 for float sums;
   ``segment_reduce`` in both of its branches, the shared-memory histogram
   up to the largest segment count that fits and the global atomics one
   past it; for ``flash_attention`` causal and not, d 64 and 128, fp32 at
   3e-4 and bf16 at 3e-2 elementwise and ``ROW_TOL`` per output row, ragged
   lengths up to 4096, grouped kv heads, strided layouts).
3. Runs the paper's word count at full width — 8 mappers x 2**24 Zipf words,
   vocab 50,000 — in three forms (token shuffle + reducer count, histogram
   shuffle, S1 host baseline), each bitwise against ``wordcount_reference``,
   and the §4 aggregation of 8 x 25,557,032 fp32 gradients (ResNet-50's
   parameter count) in all five scenarios against a float64 host mean.
   Kernel launch counts are zeroed before each path and read after it.
4. Times each kernel at its main-path shapes with CUDA events, beside its
   plain version, a one-call PyTorch yardstick where one exists (for
   ``segment_reduce`` the faster of ``index_add_`` and ``bincount``), and
   its bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32, 989 TFLOP/s bf16
   on the tensor cores).
5. Serves Qwen1.5-0.5B at full width (24 layers, d 1024, 16 heads of 64,
   vocab 151,936; random weights from ``SEED``): prefills 8 prompts of 4096
   tokens through the ``flash_attention`` kernel (exactly 24 launches) and
   decodes 32 greedy tokens, then runs the same prefill with
   ``impl="masked"`` (the JAX model's chunked attention) and holds every
   layer's K/V cache, the last position's final hidden state and layer 0's
   attention output to it: on the served weights, then on the model
   sharpened (``sharpen``: attention far from uniform), and, as a control
   the limits must reject, with the kernel run without its causal mask.
   The repo's serving shapes (``launch/shapes.py``: prefill_32k, decode_32k)
   are sized for a 256-chip pod; one card takes batch 8 at train_4k's
   4096-token sequence. Then holds ``flash_attention`` to its plain version
   at that prefill's shape (b 8, h 16, s 4096, d 64, bf16, causal), per
   output row, and times it as in step 4, with
   ``scaled_dot_product_attention`` as the yardstick.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that last line. Needs one CUDA device.

``inputs`` and ``main_paths`` are the one definition of the word-count and
aggregation paths, ``serve_inputs``, ``serve_paths`` and ``prefill_paths``
of the serving ones; ``benchmarks/torch_path_profile.py`` profiles the same
tables.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM data sheet, bf16 tensor cores, dense

N_MAPPERS = 8
TOKENS_PER_MAPPER = 2**24
VOCAB = 50_000
GRAD_SIZE = 25_557_032  # ResNet-50 parameters
SEED = 1
SERVE_ARCH = "qwen1.5-0.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 4096, 32
# flash vs masked prefill, normwise relative (||a - b|| / ||b||) per layer's
# K/V cache and for the final hidden state. Both run in bf16 (2**-8 relative
# a rounding), but round in different places: the masked path rounds the
# scores and p to bf16 before P·V, the kernel keeps both in fp32 until its own
# bf16 P·V. Each layer adds a few such roundings to the residual stream; over
# 24 layers, as a random walk, that is a few 1e-2.
SERVE_TOL = 5e-2
# flash vs masked, layer 0's attention output (after wo), normwise relative:
# both paths see the same input there, so only the attention core's own
# roundings (scores and p in bf16 on the masked path, bf16 P in the kernel)
# and the bf16 outputs separate them, a few 2**-9 each.
ATTN_TOL = 2e-2
# wq and wk × QK_GAIN (with random biases and norm scales) in the sharpened
# comparison: score std about 2 at this width, as the parity tests' ×10 gives
# about 1.5 at the smoke config's width 32. Init weights give about 0.6.
QK_GAIN = 2.0
# kernel against plain version, the normwise relative difference of each
# output row (one query of one head), by dtype: for bf16 the output's own
# rounding is up to 2**-9 of each value and the kernel's bf16 P adds as much;
# for fp32 the reference's elementwise 3e-4, held per row.
ROW_TOL = {"torch.float32": 3e-4, "torch.bfloat16": 1e-2}
AGG_TOL = {"s1_host": 1e-5, "s2_in_net": 1e-5, "s3_in_net_map": 3e-2,
           "native": 1e-5, "hierarchical": 1e-5}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time for moving ``nbytes`` and doing ``ops`` at the card's
    peaks (``ops_per_s``: the rate of the operations' type), and which bounds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def max_abs_err(pairs) -> float:
    """Largest absolute difference over (kernel, plain) output pairs."""
    return max(float((k.double() - p.double()).abs().max()) for k, p in pairs)


def bare_launchers():
    """The kernels' own launchers (CUDA only, not counted in ``ops.LAUNCHES``).
    The package exports the dispatching wrappers under the same names, so the
    modules are looked up directly."""
    mods = [importlib.import_module(f"repro_torch.kernels.{n}")
            for n in ("hash_partition", "segment_reduce", "ring_fused_step")]
    return mods[0].hash_partition, mods[1].segment_reduce, mods[2].ring_fused_step


def inputs():
    """The full-size data of the main paths, made from ``SEED`` on the host
    and laid on the card: (word shards as numpy, words (8, 2**24) int32,
    gradients as numpy, gradients (8, 25,557,032) fp32)."""
    import numpy as np

    from repro_torch.data.pipeline import wordcount_shards
    from repro_torch.mesh import Mesh

    shards = wordcount_shards(N_MAPPERS * TOKENS_PER_MAPPER, N_MAPPERS, VOCAB, seed=SEED)
    shards[3][-5:] = -1  # padding, as the tests do
    grads_np = np.random.default_rng(SEED).standard_normal((8, GRAD_SIZE), dtype=np.float32)
    return (shards, Mesh(("all",), (N_MAPPERS,)).shard(shards),
            grads_np, Mesh(("data",), (8,)).shard(grads_np))


def main_paths(words, grads) -> dict:
    """The port's main paths, name → call, through the entry points a user
    calls: word count by token shuffle, by histogram shuffle and by the S1
    host baseline on ``("all",)=8``; aggregation in S1, S2, S3 and NATIVE on
    ``("data",)=8`` and HIERARCHICAL on ``("pod","data")=(2,4)``."""
    from repro_torch.core import scenarios
    from repro_torch.core import wordcount as wc
    from repro_torch.mesh import Mesh

    mesh = Mesh(("all",), (N_MAPPERS,))
    mesh8, mesh24 = Mesh(("data",), (8,)), Mesh(("pod", "data"), (2, 4))

    def hist_path():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return wc.wordcount_step(words, VOCAB, mesh, "all", histogram_fn=wc.kernel_histogram)

    paths = {
        "wordcount_token": lambda: wc.wordcount_token_shuffle(words, VOCAB, mesh, "all"),
        "wordcount_histogram": hist_path,
        "wordcount_s1_host": lambda: wc.wordcount_host_baseline(words, VOCAB, mesh, "all"),
    }
    for sc in ("s1_host", "s2_in_net", "s3_in_net_map", "native"):
        paths[f"aggregate_{sc}"] = lambda sc=sc: scenarios.aggregate(
            grads, mesh8, sc, data_axis="data")
    paths["aggregate_hierarchical"] = lambda: scenarios.aggregate(
        grads.view(2, 4, -1), mesh24, "hierarchical", data_axis="data", pod_axis="pod")
    return paths


def check_kernels_at_edges(torch) -> None:
    """Each kernel against its plain version on the card, at edge shapes."""
    from repro_torch.kernels import ref

    hp, sr, rf = bare_launchers()
    dev = "cuda"
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def tokens(shape, lo=-1, hi=100_000):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32).to(dev)

    cases = [(tokens((n,)), b) for n in (1, 1023, 1024, 1025, 3000) for b in (2, 8, 16)]
    cases += [
        (torch.full((256,), -1, dtype=torch.int32, device=dev), 4),  # all padding
        (tokens((8, 1025)), 8),  # batched mappers
        (tokens((4096,), -2**31, 2**31 - 1), 61),  # full int32 range
        (tokens((2, 5000)), 20_000),  # histogram above 48 KB of shared memory
    ]
    for t, b in cases:
        (ki, kh), (pi, ph) = hp(t, b), ref.hash_partition(t, b)
        if not (equal(ki, pi) and equal(kh, ph)):
            raise AssertionError(f"hash_partition differs at {tuple(t.shape)}, B={b}")

    def vals(shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)

    for n, d, nseg, dtype in [(64, 8, 4, torch.float32), (1000, 32, 16, torch.float32),
                              (513, 128, 7, torch.bfloat16), (2048, 16, 64, torch.float32),
                              (1, 3, 2, torch.float16), (1025, 4, 9, torch.float16)]:
        v, ids = vals((n, d), dtype), tokens((n,), -1, nseg)
        torch.testing.assert_close(sr(v, ids, nseg), ref.segment_reduce(v, ids, nseg),
                                   rtol=2e-2, atol=2e-2)
    v, ids = vals((8, 1025, 3), torch.float32), tokens((8, 1025), -1, 5)  # batched reducers
    torch.testing.assert_close(sr(v, ids, 5), ref.segment_reduce(v, ids, 5), rtol=2e-2, atol=2e-2)
    ids = tokens((8, 4097), -1, 300)
    ones = torch.ones((1, 1, 1), device=dev).expand(8, 4097, 1)  # broadcast count: exact
    if not equal(sr(ones, ids, 300), ref.segment_reduce(ones, ids, 300)):
        raise AssertionError("segment_reduce integer counts differ")
    pad = torch.full((300,), -1, dtype=torch.int32, device=dev)
    if sr(vals((300, 2), torch.float32), pad, 4).abs().sum() != 0:
        raise AssertionError("segment_reduce counted padding rows")
    check_segment_reduce_branches(torch, sr, tokens, vals)

    for n in (1, 100, 1023, 1024, 1025, 16384, 40000):
        acc = vals((n + 1,), torch.float32)
        wire = vals((n + 1,), torch.bfloat16)
        for a, w in ((acc[:n], wire[:n]), (acc[1:], wire[1:])):  # aligned and not
            (ka, kw), (pa, pw) = rf(a, w), ref.ring_fused_step(a, w)
            if not (equal(ka, pa) and equal(kw, pw)):
                raise AssertionError(f"ring_fused_step differs at n={n}")
    torch.cuda.synchronize()


def check_segment_reduce_branches(torch, sr, tokens, vals) -> int:
    """``segment_reduce``'s two branches against the plain version: the
    shared-memory histogram (uint32 counts for a broadcast value row, fp32
    sums otherwise) wherever the bins fit in ``max_bin_bytes``, and the
    global-atomic scatter one segment past that. Counts bitwise, float sums
    at 2e-2. Returns the number of cases."""
    from repro_torch.kernels import ref

    seg_mod = importlib.import_module("repro_torch.kernels.segment_reduce")
    limit = seg_mod.max_bin_bytes()
    most = limit // 4  # count bins (or d-1 fp32 bins) that fit
    dev = "cuda"

    def ones(shape):
        return torch.ones((1,) * (len(shape) + 1), device=dev).expand(tuple(shape) + (1,))

    def zipf(shape, nseg, hot):
        """Ids whose one id ``hot`` is more than half of each row, the rest
        uniform, a few -1 (padding) and a few past ``nseg`` (dropped)."""
        ids = tokens(shape, -1, nseg + 3)
        ids[tokens(shape, 0, 10) < 6] = hot
        return ids

    counts = [  # (ids, num_segments): bitwise
        (zipf((20_001,), most, 7), most),  # largest count histogram that fits
        (zipf((20_001,), most + 1, most), most + 1),  # one past: global branch
        (zipf((8, 40_003), 50_000, 3), 50_000),  # batched reducers, rows start mid-vector
        (zipf((3, 1_000_003), 1000, 999), 1000),  # many chunks a reducer, ragged tails
        (torch.full((4, 5000), -1, dtype=torch.int32, device=dev), 50_000),  # all padding
    ]
    big = zipf((100_005,), 50_000, 1)
    counts.append((big[1:], 50_000))  # starts 4 bytes past a 16-byte boundary
    n = 0
    for ids, nseg in counts:
        if not equal(sr(ones(ids.shape), ids, nseg), ref.segment_reduce(ones(ids.shape), ids, nseg)):
            raise AssertionError(f"segment_reduce counts differ at ids {tuple(ids.shape)}, "
                                 f"num_segments={nseg}")
        n += 1
    bcast = torch.randn((1, 3), device=dev).expand(20_001, 3)  # a broadcast row, d 3: counted
    ids = zipf((20_001,), 500, 2)
    torch.testing.assert_close(sr(bcast, ids, 500), ref.segment_reduce(bcast, ids, 500),
                               rtol=2e-2, atol=2e-2)
    sums = [  # (rows, d, num_segments, dtype): fp32 sums in shared memory, then past it
        ((20_001,), 1, most, torch.float32),
        ((20_001,), 1, most + 1, torch.float32),
        ((4, 9_999), 8, most // 8, torch.bfloat16),
        ((4, 9_999), 8, most // 8 + 1, torch.bfloat16),
        ((2, 3_001), 64, 900, torch.float16),
    ]
    for shape, d, nseg, dtype in sums:
        v, ids = vals(tuple(shape) + (d,), dtype), zipf(shape, nseg, 0)
        torch.testing.assert_close(sr(v, ids, nseg), ref.segment_reduce(v, ids, nseg),
                                   rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()
    return n + 1 + len(sums)


def row_rel_err(got, want) -> float:
    """Largest normwise relative difference over the rows (last dim) of two
    (..., d) tensors, in float64."""
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def check_flash_at_edges(torch, dtypes=None) -> int:
    """``flash_attention`` against its plain version on the card: causal and
    not, d 64 and 128, fp32 and bf16 (or ``dtypes``), lengths on both sides
    of the bf16 kernel's 128-row query tile and 128- or 64-key K/V tile up
    to the prefill's 4096, b·h 1 and 6; then grouped kv heads (rep 2, 4 and
    16), the model's strided (b, s, h, d) layout and sq != sk. Tolerance 3e-4 fp32,
    3e-2 bf16 elementwise (``tests/test_kernels.py:101``) and ``ROW_TOL`` per
    output row. Returns the number of cases."""
    from repro_torch.kernels import ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention").flash_attention
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen).to("cuda", dtype)

    def check(q, k, v, causal, what):
        got = fa(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        tol = 3e-2 if q.dtype == torch.bfloat16 else 3e-4
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"flash_attention {what}: {got.shape} {got.dtype} "
                                 f"!= {want.shape} {want.dtype}")
        try:
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        except AssertionError as e:
            raise AssertionError(f"flash_attention differs at {what}: {e}") from None
        row_err = row_rel_err(got, want)
        if row_err > ROW_TOL[str(q.dtype)]:
            raise AssertionError(f"flash_attention differs at {what}: a row is {row_err:.3e} "
                                 f"off normwise, limit {ROW_TOL[str(q.dtype)]}")

    n = 0
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for s in (1, 100, 127, 128, 129, 1000, 4095, 4096):
                for b, h in ((1, 1), (2, 3)):
                    for causal in (True, False):
                        q, k, v = (rnd(b, h, s, d, dtype=dtype) for _ in range(3))
                        check(q, k, v, causal, f"b={b} h={h} s={s} d={d} {dtype} causal={causal}")
                        n += 1
            # grouped kv heads, read through the (b, s, h, d) layout the model uses
            q = rnd(2, 257, 8, d, dtype=dtype).transpose(1, 2)
            k, v = (rnd(2, 257, 2, d, dtype=dtype).transpose(1, 2) for _ in range(2))
            check(q, k, v, True, f"GQA 8/2 strided s=257 d={d} {dtype}")
            check(q, k, v, False, f"GQA 8/2 strided s=257 d={d} {dtype} non-causal")
            k, v = (rnd(2, 2, 70, d, dtype=dtype) for _ in range(2))
            check(q, k, v, False, f"sq=257 sk=70 d={d} {dtype}")
            # 16 query heads over 8 kv heads (rep 2) and over 1 (rep 16), strided
            q = rnd(1, 129, 16, d, dtype=dtype).transpose(1, 2)
            for kvh in (8, 1):
                k, v = (rnd(1, 129, kvh, d, dtype=dtype).transpose(1, 2) for _ in range(2))
                check(q, k, v, True, f"GQA 16/{kvh} strided s=129 d={d} {dtype}")
            n += 5
    torch.cuda.synchronize()
    return n


def rel_err(a, b) -> float:
    """Normwise relative difference ||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def sharpen(model) -> None:
    """Set what init leaves flat, as ``tests/test_torch_serve.py``'s
    ``perturb`` does, from ``SEED``: random QKV biases (N × 0.5) and norm
    scales (1 + 0.2 N), and wq, wk × ``QK_GAIN``, so that attention is far
    from uniform and carries weight in the residual stream."""
    import torch

    g = torch.Generator(device=model.device).manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bq", "bk", "bv"):
                p.copy_(torch.randn(p.shape, generator=g, device=p.device) * 0.5)
            elif leaf == "scale":
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=g, device=p.device))
            elif leaf in ("wq", "wk"):
                p.mul_(QK_GAIN)
    model.cast_weights()


def prefill_run(model, prompts, impl: str):
    """One prefill: (cache, final hidden at the last position, layer 0's
    attention output (b, s, d))."""
    import torch

    seen = {}
    hook = model.blocks[0].attn.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("attn0", out[0]))
    try:
        with torch.inference_mode():
            cache, h = model.prefill_hidden(prompts, impl=impl)
    finally:
        hook.remove()
    return cache, h, seen["attn0"]


def prefill_readings(got, want) -> dict:
    """Normwise relative differences of two ``prefill_run`` results: K/V
    cache per layer (worst, layer 0, last layer), final hidden, layer 0's
    attention output; and whether the hidden state is finite."""
    import torch

    (cg, hg, ag), (cw, hw, aw) = got, want
    kv = [max(rel_err(cg[x][i], cw[x][i]) for x in ("k", "v")) for i in range(len(cg["k"]))]
    return {"kv_worst": max(kv), "kv_worst_layer": kv.index(max(kv)), "kv_layer0": kv[0],
            "kv_last_layer": kv[-1], "hidden": rel_err(hg, hw), "attn0": rel_err(ag, aw),
            "finite": bool(torch.isfinite(hg).all())}


def within(r: dict) -> bool:
    """Whether ``prefill_readings`` are inside ``SERVE_TOL`` and ``ATTN_TOL``."""
    return (r["kv_worst"] <= SERVE_TOL and r["hidden"] <= SERVE_TOL and r["attn0"] <= ATTN_TOL
            and r["finite"])


def serve_walls(res: dict) -> dict:
    """Prefill and decode walls of one ``serve.generate`` result, as rates."""
    return {
        "prefill_ms": res["prefill_s"] * 1e3,
        "decode_ms_per_step": res["decode_s"] * 1e3 / (SERVE_GEN - 1),
        "decode_tokens_per_s": SERVE_BATCH * (SERVE_GEN - 1) / res["decode_s"],
        "generated_tokens_per_s": SERVE_BATCH * SERVE_GEN / (res["prefill_s"] + res["decode_s"]),
    }


def serve_inputs():
    """Qwen1.5-0.5B at full width on the card, weights from a ``torch.Generator``
    seeded with ``SEED``, and ``SERVE_BATCH`` prompts of ``SERVE_PROMPT``
    random ids from ``SEED``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(SERVE_ARCH)
    model = Model(cfg, device="cuda", seed=SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                            device="cuda", dtype=torch.int32)
    return model, prompts


def serve_paths(model, prompts) -> dict:
    """The serving path, name → call: what ``python -m repro_torch.launch.serve``
    runs — prefill with its attention through the ``flash_attention`` kernel,
    then ``SERVE_GEN`` greedy tokens in all."""
    from repro_torch.launch import serve

    return {"serve_flash": lambda: serve.generate(model, prompts, SERVE_GEN, impl="flash")}


def prefill_paths(model, prompts) -> dict:
    """The serving path's prefill alone, name → call: ``launch.steps``'
    prefill step with its attention through the ``flash_attention`` kernel,
    writing the first ``SERVE_PROMPT`` slots of a cache allocated once (as
    ``serve.generate`` does), so a repeated call is the warm prefill."""
    from repro_torch.launch import steps

    b, s = prompts.shape
    step = steps.make_prefill_step(model, global_batch=b, seq=s, impl="flash")
    cache = model.init_cache(b, s + SERVE_GEN)
    return {"serve_prefill_flash": lambda: step(prompts, cache)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.core import wordcount as wc
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 1. build ------------------------------------------------------------
    build_s = _build.build_all()
    log(f"build: {build_s:.2f} s for {len(_build.NAMES)} kernels")
    for name in _build.NAMES:
        logf = _build.BUILD / f"{name}.log"
        lines = logf.read_text().splitlines() if logf.exists() else []
        for line in lines:
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 2. kernels against their plain versions, edge shapes ----------------
    t0 = time.perf_counter()
    check_kernels_at_edges(torch)
    n_flash = check_flash_at_edges(torch)
    log(f"edge checks: all four kernels match their plain versions ({n_flash} flash_attention "
        f"cases; {time.perf_counter() - t0:.2f} s)")

    # 3. main paths -----------------------------------------------------------
    t = time.perf_counter()
    shards, words, grads_np, grads = inputs()
    want_counts = wc.wordcount_reference(shards, VOCAB)
    if want_counts.max() >= wc.MAX_EXACT_COUNT:
        raise AssertionError("a word count reaches 2**24: fp32 atomics would not be exact")
    want_mean = torch.from_numpy(grads_np.mean(0, dtype=np.float64)).cuda()
    n_valid = int(sum((s >= 0).sum() for s in shards))
    del grads_np
    log(f"data: word count {N_MAPPERS} x {TOKENS_PER_MAPPER} tokens, vocab {VOCAB}, top word "
        f"{want_counts.max() / want_counts.sum():.4f} of tokens; aggregation 8 x {GRAD_SIZE} "
        f"fp32 ({grads.numel() * 4 / 1e9:.3f} GB); {time.perf_counter() - t:.2f} s on the host")

    launches = {k: 0 for k in ops.LAUNCHES}
    walls: dict[str, float] = {}
    outs: dict[str, object] = {}
    for name, fn in main_paths(words, grads).items():
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        log(f"path {name}: {walls[name] * 1e3:.3f} ms wall, launches {got}")

        if name == "wordcount_token":
            reducer_counts, recv = out
            if not np.array_equal(reducer_counts.sum(0).to(torch.int64).cpu().numpy(), want_counts):
                raise AssertionError("token path counts differ from wordcount_reference")
            owner = ref.hash_bucket(torch.arange(VOCAB, device="cuda"), N_MAPPERS)
            seen = (reducer_counts > 0).nonzero()
            if not bool((seen[:, 0] == owner[seen[:, 1]]).all()):
                raise AssertionError("a word was counted on a reducer that does not own its bucket")
            if int((recv >= 0).sum()) != n_valid:
                raise AssertionError("the token shuffle dropped tokens")
            outs["recv"] = recv
            log(f"  capacity {recv.shape[-1] // N_MAPPERS}, send buffer {recv.numel() * 4 / 1e9:.3f} GB, "
                "counts bitwise == wordcount_reference")
        elif name.startswith("wordcount_"):
            if not np.array_equal(out.reshape(-1).to(torch.int64).cpu().numpy(), want_counts):
                raise AssertionError(f"{name} counts differ from wordcount_reference")
            log("  counts bitwise == wordcount_reference")
        else:
            sc = name.removeprefix("aggregate_")
            tol = AGG_TOL[sc]
            err = (out.reshape(8, GRAD_SIZE).double() - want_mean).abs()
            bad = not bool((err <= tol + tol * want_mean.abs()).all())
            log(f"  max abs err vs float64 mean {float(err.max())!r} (rtol=atol={tol})")
            if bad:
                raise AssertionError(f"{sc}: beyond rtol=atol={tol}")
            if sc == "s3_in_net_map" and got["ring_fused_step"] != 7:
                raise AssertionError(f"S3 over 8 ranks made {got['ring_fused_step']} hops, not 7")
        del out

    # 4. kernels at their main-path shapes: agreement and time ---------------
    hp, sr, rf = bare_launchers()
    rows = []

    n_tok = words.numel()
    kout, pout = hp(words, N_MAPPERS), ref.hash_partition(words, N_MAPPERS)
    if not all(equal(k, p) for k, p in zip(kout, pout)):
        raise AssertionError("hash_partition differs at the main-path shape")
    b, b_by = bound_ms(n_tok * 8 + N_MAPPERS * N_MAPPERS * 4, 3 * n_tok)
    rows.append({
        "name": "hash_partition", "route": "cuda",
        "source": "src/repro_torch/csrc/hash_partition.cu",
        "replaces": "src/repro/kernels/hash_partition.py:47",
        "launches": launches["hash_partition"], "max_abs_err": max_abs_err(zip(kout, pout)),
        "ms": cuda_ms(lambda: hp(words, N_MAPPERS)),
        "plain_ms": cuda_ms(lambda: ref.hash_partition(words, N_MAPPERS)),
        "bound_ms": b, "bound_by": b_by, "library_ms": None,
        "path": "wordcount_token",
        "shape": f"tokens ({N_MAPPERS}, {TOKENS_PER_MAPPER}) int32, B={N_MAPPERS}",
    })
    del kout, pout

    # segment_reduce at both of its main-path shapes: the histogram path's
    # mapper counts and the token path's reducer counts of received words
    seg_mod = importlib.import_module("repro_torch.kernels.segment_reduce")
    for path, ids in (("wordcount_histogram", words), ("wordcount_token", outs.pop("recv"))):
        ones = torch.ones((1, 1, 1), device="cuda").expand(ids.shape + (1,))
        ks, ps = sr(ones, ids, VOCAB), ref.segment_reduce(ones, ids, VOCAB)
        if not equal(ks, ps):
            raise AssertionError(f"segment_reduce counts differ at the {path} shape")
        w = ids.shape[0]
        dump = w * VOCAB
        offs = torch.arange(w, device="cuda")[:, None] * VOCAB
        flat_idx = torch.where(ids >= 0, ids.long() + offs, dump).reshape(-1)
        src = torch.ones((1,), device="cuda").expand(flat_idx.shape)
        lib_out = torch.zeros((dump + 1,), device="cuda")
        n_ids = int((ids >= 0).sum())
        # two one-call yardsticks for the same counts; the row keeps the faster
        index_add_ms = cuda_ms(lambda: lib_out.index_add_(0, flat_idx, src))
        bincount_ms = cuda_ms(lambda: torch.bincount(flat_idx, minlength=dump + 1))
        b, b_by = bound_ms(ids.numel() * 4 + 4 + w * VOCAB * 4, n_ids)
        rows.append({
            "name": "segment_reduce", "route": "cuda",
            "source": "src/repro_torch/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:55",
            "launches": launches["segment_reduce"], "max_abs_err": max_abs_err([(ks, ps)]),
            "ms": cuda_ms(lambda: sr(ones, ids, VOCAB)),
            "plain_ms": cuda_ms(lambda: ref.segment_reduce(ones, ids, VOCAB)),
            "bound_ms": b, "bound_by": b_by,
            "library_ms": min(index_add_ms, bincount_ms),
            "index_add_ms": index_add_ms, "bincount_ms": bincount_ms,
            "branch": ("shared-memory histogram" if VOCAB * 4 <= seg_mod.max_bin_bytes()
                       else "global atomics"),
            "path": path,
            "shape": f"ids {tuple(ids.shape)} int32 ({n_ids} valid), broadcast ones, "
                     f"nseg={VOCAB} per row",
        })
        del ks, ps, flat_idx, src, lib_out, ids

    g = torch.Generator(device="cuda").manual_seed(SEED)
    acc = torch.randn((GRAD_SIZE,), generator=g, device="cuda")
    wire = torch.randn((GRAD_SIZE,), generator=g, device="cuda").to(torch.bfloat16)
    kout, pout = rf(acc, wire), ref.ring_fused_step(acc, wire)
    if not all(equal(k, p) for k, p in zip(kout, pout)):
        raise AssertionError("ring_fused_step differs at the main-path shape")
    b, b_by = bound_ms(GRAD_SIZE * 12, GRAD_SIZE)
    rows.append({
        "name": "ring_fused_step", "route": "cuda",
        "source": "src/repro_torch/csrc/ring_fused_step.cu",
        "replaces": "src/repro/kernels/ring_fused_step.py:41",
        "launches": launches["ring_fused_step"], "max_abs_err": max_abs_err(zip(kout, pout)),
        "ms": cuda_ms(lambda: rf(acc, wire)),
        "plain_ms": cuda_ms(lambda: ref.ring_fused_step(acc, wire)),
        "bound_ms": b, "bound_by": b_by, "library_ms": None,
        "path": "aggregate_s3_in_net_map",
        "shape": f"acc ({GRAD_SIZE},) fp32 + wire bf16: one S3 hop over 8 ranks",
    })

    peak_wc_gb = torch.cuda.max_memory_allocated() / 1e9
    del words, grads, acc, wire, kout, pout, outs, shards, want_counts, want_mean

    # 5. serving at full width -------------------------------------------------
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, prompts = serve_inputs()
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"serve: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads "
        f"(kv {cfg.n_kv_heads}) of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.param_count() / 1e6:.1f} M parameters in fp32 with bf16 copies, random from seed "
        f"{SEED}; {SERVE_BATCH} prompts x {SERVE_PROMPT} tokens, {SERVE_GEN} greedy tokens. "
        f"Reduced from prefill_32k/decode_32k (src/repro/launch/shapes.py, sized for a 256-chip "
        f"pod) to batch {SERVE_BATCH} at train_4k's {SERVE_PROMPT}-token sequence; depth and "
        f"widths are the config's. Built in {time.perf_counter() - t:.2f} s")
    serve_stats = {}
    for name, fn in serve_paths(model, prompts).items():
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        log(f"path {name}: {walls[name] * 1e3:.3f} ms wall, launches {got}")
        if got["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"prefill made {got['flash_attention']} flash_attention launches, "
                                 f"not one per layer ({cfg.n_layers})")
        toks = res["tokens"]
        if toks.shape != (SERVE_BATCH, SERVE_GEN) or not bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"generated tokens {tuple(toks.shape)} out of shape or vocab")
        serve_stats[name] = {**serve_walls(res),
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  cold: {json.dumps(serve_stats[name])}")
    flash_toks = res["tokens"]
    del res
    serve_stats["serve_flash_warm"] = serve_walls(
        serve.generate(model, prompts, SERVE_GEN, impl="flash"))
    log(f"  warm (second run, not counted): {json.dumps(serve_stats['serve_flash_warm'])}")
    masked = serve.generate(model, prompts, SERVE_GEN, impl="masked")
    serve_stats["serve_masked"] = serve_walls(masked)
    same = flash_toks == masked["tokens"]
    prefix = int(same.int().cumprod(1).sum())
    log(f"  masked prefill (the JAX model's chunked attention): "
        f"{json.dumps(serve_stats['serve_masked'])}; "
        f"greedy tokens equal to flash's at {int(same.sum())} of {same.numel()} positions, "
        f"{prefix} before a sequence's first difference")
    del masked

    # flash vs masked prefill: on the served weights, then on the same model
    # sharpened; then a control that the limits must reject, the kernel run
    # without its causal mask
    log(f"  flash vs masked prefill, normwise relative (limits: K/V cache of every layer and "
        f"final hidden {SERVE_TOL}, layer 0's attention output {ATTN_TOL}):")
    want = prefill_run(model, prompts, "masked")
    serve_checks = {"served": prefill_readings(prefill_run(model, prompts, "flash"), want)}
    sharpen(model)
    want = prefill_run(model, prompts, "masked")
    serve_checks["sharpened"] = prefill_readings(prefill_run(model, prompts, "flash"), want)
    real = ops.flash_attention
    with mock.patch.object(ops, "flash_attention",
                           lambda q, k, v, causal=True: real(q, k, v, causal=False)):
        serve_checks["control"] = prefill_readings(prefill_run(model, prompts, "flash"), want)
    del want
    for label, r in serve_checks.items():
        log(f"    {label}: {json.dumps(r)}")
    for label in ("served", "sharpened"):
        if not within(serve_checks[label]):
            raise AssertionError(f"flash prefill differs from masked ({label} weights): "
                                 f"{serve_checks[label]}")
    ctl = serve_checks["control"]
    if ctl["kv_worst"] <= SERVE_TOL or ctl["attn0"] <= ATTN_TOL:
        raise AssertionError(f"the flash-vs-masked limits pass a kernel without its causal "
                             f"mask: {ctl}")
    log(f"    (sharpened: wq, wk x {QK_GAIN}, random biases and norm scales; control: the "
        f"sharpened model with the kernel run non-causal, rejected by the limits)")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was never launched on the main paths")

    # flash_attention at the prefill's shape: agreement and time
    fa = importlib.import_module("repro_torch.kernels.flash_attention").flash_attention
    fb, fh, fs, fd = SERVE_BATCH, cfg.n_heads, SERVE_PROMPT, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((fb, fs, fh, fd), generator=g, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))  # the model's (b, s, h, d) layout, as views
    kout, pout = fa(q, k, v, causal=True), ref.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(kout.float(), pout.float(), rtol=3e-2, atol=3e-2)
    err, row_err = max_abs_err([(kout, pout)]), row_rel_err(kout, pout)
    norm_err = rel_err(kout, pout)
    log(f"flash_attention at the prefill's shape vs plain: max abs {err!r}, normwise "
        f"{norm_err!r}, worst row {row_err!r} (limit {ROW_TOL[str(kout.dtype)]})")
    if row_err > ROW_TOL[str(kout.dtype)]:
        raise AssertionError(f"flash_attention at the prefill's shape: a row is {row_err} "
                             f"off normwise")
    del kout, pout
    b, b_by = bound_ms(4 * fb * fh * fs * fd * 2, 4 * fd * fb * fh * fs * (fs + 1) / 2,
                       BF16_TC_OPS_PER_S)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "ms": cuda_ms(lambda: fa(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v, causal=True), iters=3, warmup=1),
        "bound_ms": b, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "norm_rel_err": norm_err, "max_row_rel_err": row_err,
        "path": "serve_flash",
        "shape": f"q, k, v ({fb}, {fh}, {fs}, {fd}) bf16 views of (b, s, h, d), causal",
    })

    log(json.dumps({"paths_wall_s": walls, "serve": serve_stats, "serve_checks": serve_checks,
                    "peak_mem_gb": {"wordcount_aggregation": peak_wc_gb,
                                    "serve": torch.cuda.max_memory_allocated() / 1e9},
                    "build_s": build_s}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
