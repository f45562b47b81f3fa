#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    PYTHONPATH=src python3 chip_smoke.py

1. Builds the Hopper kernels (``src/repro_torch/csrc``) into ``build/``.
2. Holds every kernel against its plain PyTorch version on the card, at edge
   shapes (bitwise where the function is exact, 2e-2 for float sums).
3. Runs the paper's word count at full width — 8 mappers x 2**24 Zipf words,
   vocab 50,000 — in three forms (token shuffle + reducer count, histogram
   shuffle, S1 host baseline), each bitwise against ``wordcount_reference``,
   and the §4 aggregation of 8 x 25,557,032 fp32 gradients (ResNet-50's
   parameter count) in all five scenarios against a float64 host mean.
   Kernel launch counts are zeroed before each path and read after it.
4. Times each kernel at its main-path shapes with CUDA events, beside its
   plain version, a one-call PyTorch yardstick where one exists, and its
   bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32).

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that last line. Needs one CUDA device.

``inputs`` and ``main_paths`` are the one definition of the main paths;
``benchmarks/torch_path_profile.py`` profiles the same table.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores

N_MAPPERS = 8
TOKENS_PER_MAPPER = 2**24
VOCAB = 50_000
GRAD_SIZE = 25_557_032  # ResNet-50 parameters
SEED = 1
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
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

    for n in (1, 100, 1023, 1024, 1025, 16384, 40000):
        acc = vals((n + 1,), torch.float32)
        wire = vals((n + 1,), torch.bfloat16)
        for a, w in ((acc[:n], wire[:n]), (acc[1:], wire[1:])):  # aligned and not
            (ka, kw), (pa, pw) = rf(a, w), ref.ring_fused_step(a, w)
            if not (equal(ka, pa) and equal(kw, pw)):
                raise AssertionError(f"ring_fused_step differs at n={n}")
    torch.cuda.synchronize()


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
    log(f"edge checks: all three kernels match their plain versions "
        f"({time.perf_counter() - t0:.2f} s)")

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
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was never launched on the main paths")

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
        b, b_by = bound_ms(ids.numel() * 4 + 4 + w * VOCAB * 4, n_ids)
        rows.append({
            "name": "segment_reduce", "route": "cuda",
            "source": "src/repro_torch/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:55",
            "launches": launches["segment_reduce"], "max_abs_err": max_abs_err([(ks, ps)]),
            "ms": cuda_ms(lambda: sr(ones, ids, VOCAB)),
            "plain_ms": cuda_ms(lambda: ref.segment_reduce(ones, ids, VOCAB)),
            "bound_ms": b, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: lib_out.index_add_(0, flat_idx, src)),
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

    log(json.dumps({"paths_wall_s": walls,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "build_s": build_s}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
