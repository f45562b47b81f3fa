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
   Then the same jobs as p4mr programs compiled by the port's compiler onto
   an 8-ring (``TorusTopology((8,))``) and run by
   ``plan.run(backend="torch")``: the word count as the rebalanced
   in-network tree (``PLAN_PASSES``) and as the unlowered KEYBY fan-in over
   ``kernel_histogram``'s per-shard histograms, bitwise against
   ``wordcount_reference``; S1 (unoptimized, reducer pinned at d0's
   switch), S2 and S3 (``PLAN_PASSES``) against a float64 host sum within
   ``AGG_TOL`` and bitwise against the same plan run on the CPU over the
   first ``PREFIX`` elements. Then the default pipeline's plans, lowered
   shuffles: ``wordcount_via_plan``'s compile (a ``p4mr.Session``
   arbitrating 1, 4 or 8 buckets through ``lower-shuffle`` and
   ``reroute-feedback``) over the same histograms, bitwise, with
   ``wordcount_via_plan`` itself run beside it, on the card (its default)
   and on the host (``backend="simulate"``); and
   ``compile_scenario``'s S1/S2/S3 plans over the gradient rows, within
   ``AGG_TOL`` of the float64 sum and bitwise against the same plan run on
   the CPU at full width. Then the vectorized simulator's step on the card
   (the plan's own ``VoqParams`` with ``use_torch=True``) over the
   ``BENCH_simulator.json`` fat_tree_k8 cell, which must take steps on the
   card and give the numpy path's makespan and busy ticks, and S3's ring in the order ``plan_ring_order`` derives on a
   (2, 4) torus. Then the autotuned pipeline: the Session word count's
   compile with the ``autotune`` pass appended and telemetry on
   (``plan_wordcount_autotuned``), run over the same histograms, bitwise;
   ``BENCH_scheduler.json``'s two-tenant cell at vocab 50,000 scheduled by
   ``p4mr.Scheduler`` on a k=4 fat-tree, each tenant's plan run on the
   card over its own 4 shards' histograms, bitwise
   (``scheduler_two_tenants``). Then, in a phase of its own with its own
   peak device memory, ``sequence_parallel_linear_scan`` of an
   RG-LRU recurrence at recurrentgemma-2b's width (8 ranks × 2,048
   positions × batch 8 × 2,560, fp32) within 2e-5 of a float64 sequential
   recurrence on the card; and ``pipeline_apply`` of 8 stages of
   tanh(h @ W_s) at d 1024 over 32 microbatches of (8, 512, 1024) fp32
   within 2e-5 of the stages applied in sequence in float64. Plans compile
   (and the tenants are scheduled) once, outside the timed call; the host
   compile time, each plan's simulated makespan, each path's wall and peak
   device memory are logged. Kernel launch counts are zeroed before each
   path and read after it.
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

``inputs`` and ``main_paths`` are the one definition of the word-count,
aggregation, compiled-plan and scheduler paths, ``recurrence_inputs`` and
``recurrence_paths`` of the scan and pipeline ones, ``serve_inputs``,
``serve_paths`` and ``prefill_paths`` of the serving ones;
``benchmarks/torch_path_profile.py`` profiles the same tables.
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
SCENARIOS = {"s1": "s1_host", "s2": "s2_in_net", "s3": "s3_in_net_map"}
AGG_TOL = {"s1_host": 1e-5, "s2_in_net": 1e-5, "s3_in_net_map": 3e-2,
           "native": 1e-5, "hierarchical": 1e-5}
# the first compiled-plan paths keep their pipeline, the default one minus
# lower-shuffle and reroute-feedback, so that their plans stay binary trees
# and their numbers comparable; the fabric; and the prefix of their output
# held bitwise to a CPU run
PLAN_PASSES = ("parse", "validate", "dead-node-elim", "rebalance-reduce-tree",
               "insert-combiners", "place", "route", "emit", "verify")
PLAN_RING = 8
PREFIX = 2**20
# switch memory for the aggregation plans: the default 1 MiB cannot hold one
# 25,557,032-wide state table (204 MB at 8 bytes an item); 512 MiB holds two,
# as 1 MiB holds two of the word count's 50,000-word tables, so both trees
# get fan-in 2
PLAN_SWITCH_MEMORY = 1 << 29
# the simulator path: ``benchmarks/bench_simulator.py``'s fat_tree_k8 cell
# (16 mappers, vocab 8192, 16 buckets, no skew, trains capped as by default)
SIM_K, SIM_MAPPERS, SIM_VOCAB, SIM_BUCKETS = 8, 16, 8192, 16
# the scheduler path: ``benchmarks/bench_scheduler.py``'s two_wordcounts
# cell at VOCAB words; tenant → (the corpus shards it counts, on hosts h<i>,
# and its sink host)
TENANTS = {"tenant_a": (range(0, 4), "h15"), "tenant_b": (range(4, 8), "h12")}
# the recurrence paths: an RG-LRU recurrence at recurrentgemma-2b's width
# (src/repro/configs/recurrentgemma_2b.py, d 2560) sharded over 8 ranks, and
# 8 pipeline stages of tanh(h @ W_s) at qwen1.5-0.5b's d_model 1024; both
# held to the reference tests' 2e-5 (rtol = atol) against float64
SCAN_RANKS, SCAN_LEN, SCAN_BATCH, SCAN_WIDTH = 8, 2048, 8, 2560
PIPE_STAGES, PIPE_MICRO, PIPE_SHAPE = 8, 32, (8, 512, 1024)
RECURRENCE_TOL = 2e-5


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


def autotuned_wordcount():
    """``plan_wordcount_session``'s compile with the ``autotune`` pass
    appended: a ``Session`` on the 8-ring with ``max_fanin=4``, the
    ``autotuned`` preset and telemetry on, arbitrating 1 / 4 / 8 buckets.
    Returns (plan, the session's ``Telemetry``)."""
    from repro_torch import compiler, p4mr
    from repro_torch.core import wordcount as wc
    from repro_torch.core.topology import TorusTopology

    sess = p4mr.Session(TorusTopology(dims=(PLAN_RING,)), cost_model=compiler.CostModel(max_fanin=4),
                        options="autotuned", telemetry=True)
    plan = sess.arbitrate_buckets(
        lambda b: wc.wordcount_shuffle_program(N_MAPPERS, VOCAB, num_buckets=b),
        [1, N_MAPPERS // 2, N_MAPPERS], name="wordcount")
    return plan, sess.telemetry


def compile_plans(compile_ms: dict | None = None) -> dict:
    """The compiled-plan paths' plans, name → ``CompiledPlan``, each
    compiled on the host by the port's compiler: onto ``PLAN_RING``
    switches, and for ``simulator_device_step`` onto a k=8 fat-tree; each
    compile's wall (ms) goes into ``compile_ms`` when given. The autotuned
    plan is ``autotuned_wordcount``'s."""
    from repro_torch import compiler
    from repro_torch.core import scenarios, topology
    from repro_torch.core import wordcount as wc
    from repro_torch.core.topology import TorusTopology

    topo = TorusTopology(dims=(PLAN_RING,))
    agg_cost = compiler.CostModel(switch_memory_bytes=PLAN_SWITCH_MEMORY)
    jobs = {
        "plan_wordcount_tree": (wc.wordcount_program(N_MAPPERS, VOCAB), PLAN_PASSES, {}),
        "plan_wordcount_keyby": (
            wc.wordcount_shuffle_program(N_MAPPERS, VOCAB, num_buckets=N_MAPPERS),
            compiler.UNOPTIMIZED_PASSES, {}),
        "plan_aggregate_s1": (
            scenarios.scenario_program(8, "s1_host", state_width=GRAD_SIZE),
            compiler.UNOPTIMIZED_PASSES,
            {"pins": {"R": topo.attach_switch("d0")}, "cost_model": agg_cost}),
        "plan_aggregate_s2": (scenarios.scenario_program(8, "s2_in_net", state_width=GRAD_SIZE),
                              PLAN_PASSES, {"cost_model": agg_cost}),
        "plan_aggregate_s3": (
            scenarios.scenario_program(8, "s3_in_net_map", state_width=GRAD_SIZE),
            PLAN_PASSES, {"cost_model": agg_cost}),
    }
    ft = topology.fat_tree_topology(SIM_K)
    sim_prog = wc.wordcount_shuffle_program(
        SIM_MAPPERS, SIM_VOCAB, num_buckets=SIM_BUCKETS,
        hosts=[f"h{i}" for i in range(SIM_MAPPERS)], sink_host=f"h{len(ft.hosts) - 1}")
    builds = {name: (lambda prog=prog, passes=passes, kw=kw: compiler.compile(
        prog, topo, passes=passes, **kw)) for name, (prog, passes, kw) in jobs.items()}
    # the default pipeline: wordcount_via_plan's compile, and compile_scenario
    builds["plan_wordcount_session"] = lambda: wc._compile_wordcount_plan(N_MAPPERS, VOCAB)
    for sc in ("s1", "s2", "s3"):
        builds[f"plan_scenario_{sc}"] = lambda sc=sc: scenarios.compile_scenario(
            8, SCENARIOS[sc], state_width=GRAD_SIZE, cost_model=agg_cost)
    builds["simulator_device_step"] = lambda: compiler.compile(
        sim_prog, ft, passes=compiler.STATIC_ECMP_PASSES)
    plans = {}
    for name, build in builds.items():
        t = time.perf_counter()
        plans[name] = build()
        if compile_ms is not None:
            compile_ms[name] = (time.perf_counter() - t) * 1e3
    return plans


def schedule_tenants():
    """``BENCH_scheduler.json``'s two_wordcounts cell at ``VOCAB`` words:
    ``Scheduler(reroute_rounds=3)`` on a k=4 fat-tree admits ``TENANTS``.
    Returns (``ScheduleReport``, tenant → its plan on the fat-tree's integer
    view, which the torch backend addresses)."""
    from repro_torch import p4mr
    from repro_torch.core.topology import fat_tree_topology

    sess = p4mr.Session(fat_tree_topology(4))
    sched = p4mr.Scheduler(sess, reroute_rounds=3)
    for name, (hosts, sink) in TENANTS.items():
        job = p4mr.job(name)
        keyed = [job.store(f"s{i}", host=f"h{h}", items=VOCAB).key_by(4)
                 for i, h in enumerate(hosts)]
        keyed[0].reduce("SUM", *keyed[1:], label="R").collect(sink, label="OUT")
        sched.submit(job, name=name)
    rep = sched.run()
    return rep, {name: sess.plans[name].indexed() for name in rep.admitted}


def main_paths(words, grads, plans: dict | None = None, schedule=None) -> dict:
    """The port's main paths, name → call, through the entry points a user
    calls: word count by token shuffle, by histogram shuffle and by the S1
    host baseline on ``("all",)=8``; aggregation in S1, S2, S3 and NATIVE on
    ``("data",)=8`` and HIERARCHICAL on ``("pod","data")=(2,4)``; then the
    compiled plans of ``compile_plans`` and ``autotuned_wordcount``
    (``plans``, or compiled here, outside the calls), run by
    ``plan.run(backend="torch")``: the word counts over ``kernel_histogram``'s
    per-shard histograms, the aggregations over the gradient rows. Each plan
    call returns {sink: float64 numpy}. Then ``simulator_device_step``, the
    vectorized simulator over that plan with its step on the card (returns a
    ``SimReport``), and
    ``aggregate_s3_plan_order``, S3 on ``("data",)=8`` in the ring order
    ``plan_ring_order`` derives on a (2, 4) torus. Last
    ``scheduler_two_tenants``: the tenants of ``schedule_tenants`` (``schedule``,
    or scheduled here, outside the call), each plan run on the card over its
    own mappers' ``kernel_histogram`` rows (one launch for all 8)."""
    import dataclasses

    from repro_torch.compiler.vectorized import VoqParams, simulate_vectorized
    from repro_torch.core import scenarios
    from repro_torch.core import wordcount as wc
    from repro_torch.core.topology import TorusTopology
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

    def plan_wordcount(plan):
        hist = wc.kernel_histogram(words, VOCAB)  # one segment_reduce launch, every mapper
        return plan.run({f"s{i}": hist[i] for i in range(N_MAPPERS)}, backend="torch")

    plans = plans or {**compile_plans(), "plan_wordcount_autotuned": autotuned_wordcount()[0]}
    for name, plan in plans.items():
        if name.startswith("plan_wordcount"):
            paths[name] = lambda plan=plan: plan_wordcount(plan)
        elif name == "simulator_device_step":
            spec = plan.flow_spec()  # built once, outside the call
            params = dataclasses.replace(VoqParams.from_cost_model(plan.cost_model),
                                         use_torch=True)
            paths[name] = lambda plan=plan, spec=spec, params=params: simulate_vectorized(
                plan.program, spec, plan.cost_model, params=params)
        else:
            paths[name] = lambda plan=plan: plan.run(
                {f"g{i}": grads[i] for i in range(8)}, backend="torch")
    order = scenarios.plan_ring_order(8, topo=TorusTopology(dims=(2, 4)))
    paths["aggregate_s3_plan_order"] = lambda: scenarios.aggregate(
        grads, mesh8, "s3_in_net_map", data_axis="data", ring_order=order)
    _, tenant_plans = schedule or schedule_tenants()

    def scheduled():
        hist = wc.kernel_histogram(words, VOCAB)  # one segment_reduce launch, every mapper
        return {name: plan.run({f"s{i}": hist[m] for i, m in enumerate(TENANTS[name][0])})
                for name, plan in tenant_plans.items()}

    paths["scheduler_two_tenants"] = scheduled
    return paths


def recurrence_inputs():
    """The recurrence paths' data on the card, from ``SEED``: the decay
    ``a`` in [0.5, 1) and input ``b`` of (``SCAN_RANKS``, ``SCAN_LEN``,
    ``SCAN_BATCH``, ``SCAN_WIDTH``) fp32 (rank r holds positions
    [r·SCAN_LEN, (r+1)·SCAN_LEN)), the stages' (d, d) weights scaled by
    1/√d, and ``PIPE_MICRO`` microbatches of ``PIPE_SHAPE`` fp32."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (SCAN_RANKS, SCAN_LEN, SCAN_BATCH, SCAN_WIDTH)
    a = 0.5 + 0.5 * torch.rand(shape, generator=g, device="cuda")
    b = torch.randn(shape, generator=g, device="cuda")
    d = PIPE_SHAPE[-1]
    ws = torch.randn((PIPE_STAGES, d, d), generator=g, device="cuda") / d**0.5
    micro = torch.randn((PIPE_MICRO,) + PIPE_SHAPE, generator=g, device="cuda")
    return a, b, ws, micro


def pipeline_stage(w, h):
    """tanh(h @ W_s) on every stage at once: each stage's microbatch rows
    times its (d, d) weights, one batched product."""
    import torch

    p, d = w.shape[0], w.shape[-1]
    return torch.tanh(torch.bmm(h.reshape(p, -1, d), w)).view(h.shape)


def recurrence_paths(a, b, ws, micro) -> dict:
    """``sequence_parallel_linear_scan`` of ``h_t = a_t·h_{t−1} + b_t`` over
    ``("seq",)=SCAN_RANKS`` and ``pipeline_apply`` of ``PIPE_STAGES`` stages
    over ``("pipe",)=PIPE_STAGES``, name → call."""
    from repro_torch.core.pipeline import pipeline_apply
    from repro_torch.core.ring_scan import sequence_parallel_linear_scan
    from repro_torch.mesh import Mesh

    seq, pipe = Mesh(("seq",), (SCAN_RANKS,)), Mesh(("pipe",), (PIPE_STAGES,))
    return {
        "ring_scan_linear_recurrence": lambda: sequence_parallel_linear_scan(a, b, seq, "seq"),
        "pipeline_apply": lambda: pipeline_apply(pipeline_stage, ws, micro, pipe, "pipe"),
    }


def sequential_recurrence(a, b):
    """The scan's check: ``h_t = a_t·h_{t−1} + b_t`` in float64, one position
    at a time along the whole (rank-major) sequence, on the card."""
    import torch

    out = torch.empty(a.shape, dtype=torch.float64, device=a.device)
    h = torch.zeros(a.shape[2:], dtype=torch.float64, device=a.device)
    for r in range(a.shape[0]):
        for t in range(a.shape[1]):
            h = torch.addcmul(b[r, t].double(), a[r, t].double(), h)
            out[r, t] = h
    return out


def beyond_tol(got, want) -> tuple[float, float]:
    """(largest |got − want|, largest |got − want| / (tol + tol·|want|)) in
    float64, ``RECURRENCE_TOL`` as rtol and atol: the second is at most 1
    where ``numpy.testing.assert_allclose`` would pass."""
    d = (got.double() - want).abs()
    return float(d.max()), float((d / (RECURRENCE_TOL + RECURRENCE_TOL * want.abs())).max())


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

    from repro_torch.compiler import vectorized
    from repro_torch.compiler.simulator import simulate_timing
    from repro_torch.compiler.vectorized import simulate_vectorized
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
    want_sum = grads_np.sum(0, dtype=np.float64)
    n_valid = int(sum((s >= 0).sum() for s in shards))
    del grads_np
    log(f"data: word count {N_MAPPERS} x {TOKENS_PER_MAPPER} tokens, vocab {VOCAB}, top word "
        f"{want_counts.max() / want_counts.sum():.4f} of tokens; aggregation 8 x {GRAD_SIZE} "
        f"fp32 ({grads.numel() * 4 / 1e9:.3f} GB); {time.perf_counter() - t:.2f} s on the host")

    launches = {k: 0 for k in ops.LAUNCHES}
    walls: dict[str, float] = {}
    outs: dict[str, object] = {}
    path_peak_gb: dict[str, float] = {}
    compile_ms: dict[str, float] = {}
    host_s: dict[str, float] = {}  # host-side runs beside the paths: checks, simulations
    plans = compile_plans(compile_ms)
    t = time.perf_counter()
    plans["plan_wordcount_autotuned"], tuned_telemetry = autotuned_wordcount()
    compile_ms["plan_wordcount_autotuned"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    schedule = schedule_tenants()
    compile_ms["scheduler_two_tenants"] = (time.perf_counter() - t) * 1e3
    paths = main_paths(words, grads, plans, schedule)
    makespans = {}
    for name, plan in plans.items():
        width = plan.program.nodes[plan.program.sources()[0]].items
        # a fresh simulation: the plan's own memo may hold the compile's run
        t = time.perf_counter()
        makespans[name] = simulate_timing(plan.program, plan.routes, plan.cost_model).makespan_ticks
        host_s[f"{name}.simulate_timing"] = time.perf_counter() - t
        if name == "simulator_device_step":
            what = f"{plan.flow_spec().total_packets} packets on a k={SIM_K} fat-tree"
        else:
            what = (f"one ppermute each of a ({PLAN_RING}, {width}) value, "
                    f"{PLAN_RING * width * 4 / 1e9:.3f} GB at fp32")
        log(f"compiled {name}: {compile_ms[name]:.3f} ms on the host, {len(plan.program)} nodes, "
            f"{plan.routes.total_hops} wire hops ({what}); simulated makespan "
            f"{makespans[name]} ticks ({host_s[f'{name}.simulate_timing'] * 1e3:.3f} ms)")
        log("  " + "; ".join(f"{r.name}: {r.summary}" for r in plan.pass_records))
        if name == "plan_wordcount_autotuned":
            tune, tel = plan.tuning, tuned_telemetry.metrics.to_dict()
            log(f"  autotune: accepted {tune.accepted_by_kind()} of {len(tune.actions)} actions; "
                f"streamed makespan {tune.initial_makespan_ticks} -> {tune.final_makespan_ticks} "
                f"ticks (model ticks); telemetry verify.runs "
                f"{tel['counters'].get('verify.runs', 0)}, "
                f"{len(tuned_telemetry.tracer.spans)} spans")
            if tune.final_makespan_ticks > tune.initial_makespan_ticks:
                raise AssertionError("the autotuned plan is slower than the plan it started from")
    rep_s, tenant_plans = schedule
    schedule_ticks = {"scheduled": rep_s.makespan_ticks,
                      "unscheduled": rep_s.unscheduled_makespan_ticks,
                      "solo": rep_s.solo_makespan_ticks,
                      "hot_swaps_accepted": sum(h.accepted for h in rep_s.hot_swaps),
                      "anomalies": len(rep_s.anomalies)}
    log(f"scheduled scheduler_two_tenants: {compile_ms['scheduler_two_tenants']:.3f} ms on the "
        f"host; {rep_s.summary()}; makespan scheduled {rep_s.makespan_ticks}, unscheduled "
        f"{rep_s.unscheduled_makespan_ticks}, solo {rep_s.solo_makespan_ticks} ticks; hot swaps "
        + "; ".join(f"{h.name} {h.makespan_before}->{h.makespan_after} "
                    f"({'accepted' if h.accepted else 'kept'})" for h in rep_s.hot_swaps))
    if sorted(tenant_plans) != sorted(TENANTS):
        raise AssertionError(f"the scheduler admitted {sorted(tenant_plans)}, not both tenants")
    if rep_s.makespan_ticks > rep_s.unscheduled_makespan_ticks:
        raise AssertionError("the schedule is worse than the unscheduled merge")

    def drive(name, fn):
        """One path's call: kernel launch counts and the simulator's card
        steps zeroed just before it and read just after, its wall and its
        own peak device memory logged. Returns (out, launches, steps)."""
        ops.reset_launches()
        vectorized.STEPS["torch"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        path_peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
        got = dict(ops.LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        log(f"path {name}: {walls[name] * 1e3:.3f} ms wall, launches {got}, peak device memory "
            f"{path_peak_gb[name]:.3f} GB ({path_peak_gb[name] - base_gb:.3f} GB over the "
            f"{base_gb:.3f} GB held before the call)")
        return out, got, vectorized.STEPS["torch"]

    # the phase's peak so far: each path below resets the counter to read its own
    pre_paths_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, fn in paths.items():
        out, got, torch_steps = drive(name, fn)

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
        elif name.startswith("plan_wordcount_"):
            counts = out["OUT"]
            if got["segment_reduce"] != 1:
                raise AssertionError(f"{name} made {got['segment_reduce']} segment_reduce launches")
            if not counts.max() < wc.MAX_EXACT_COUNT:
                raise AssertionError(f"{name}: a count reaches 2**24, past exact fp32")
            if counts.dtype != np.float64 or not np.array_equal(counts, want_counts.astype(np.float64)):
                raise AssertionError(f"{name} counts differ from wordcount_reference")
            log(f"  counts bitwise == wordcount_reference (top count {int(counts.max())} < 2**24)")
            if name == "plan_wordcount_session":
                # the same compile's own entry point: on the card (its default:
                # kernel_histogram, then the plan's torch step in float64), and
                # on the host (numpy histograms, then the packet simulator)
                for where, kw in (("on the card", {}), ("on the host", {"backend": "simulate"})):
                    t = time.perf_counter()
                    via_counts, sim = wc.wordcount_via_plan(shards, VOCAB, **kw)
                    key = f"wordcount_via_plan {where}"
                    host_s[key] = time.perf_counter() - t
                    if not np.array_equal(via_counts, want_counts):
                        raise AssertionError(f"{key}: counts differ from wordcount_reference")
                    log(f"  {key}: counts bitwise == wordcount_reference, simulated makespan "
                        f"{sim.report.makespan_ticks} ticks ({sim.report.time_s!r} s modelled), "
                        f"{host_s[key]:.2f} s wall")
        elif name.startswith("plan_scenario_"):
            sc = SCENARIOS[name.removeprefix("plan_scenario_")]
            tol = AGG_TOL[sc]
            got_sum = out["OUT"]
            err = float(np.linalg.norm(got_sum - want_sum) / np.linalg.norm(want_sum))
            # the same plan object on the CPU at full width: a lowered plan's
            # bucket windows are fixed at GRAD_SIZE, so a prefix would not do
            t = time.perf_counter()
            cpu = plans[name].run({f"g{i}": grads[i].cpu() for i in range(8)},
                                  backend="torch", device="cpu")["OUT"]
            host_s[f"{name}.cpu_run"] = time.perf_counter() - t
            same = np.array_equal(got_sum.view(np.uint64), cpu.view(np.uint64))
            del cpu
            log(f"  normwise err vs float64 host sum {err!r} (limit {tol}); all {GRAD_SIZE} "
                f"elements {'bitwise ==' if same else 'DIFFER from'} the plan run on the CPU "
                f"({host_s[f'{name}.cpu_run']:.2f} s wall there)")
            if not np.isfinite(got_sum).all() or got_sum.shape != (GRAD_SIZE,) or err > tol:
                raise AssertionError(f"{name}: beyond {tol} of the float64 sum, or malformed")
            if not same:
                raise AssertionError(f"{name}: the card's result differs from the CPU's")
        elif name == "scheduler_two_tenants":
            if got["segment_reduce"] != 1:
                raise AssertionError(f"{name} made {got['segment_reduce']} segment_reduce launches")
            for tenant, counts in ((n, o["OUT"]) for n, o in out.items()):
                mine = wc.wordcount_reference([shards[m] for m in TENANTS[tenant][0]], VOCAB)
                if counts.dtype != np.float64 or not np.array_equal(counts, mine.astype(np.float64)):
                    raise AssertionError(f"{name}: {tenant}'s counts differ from "
                                         "wordcount_reference over its shards")
            log("  each tenant's counts bitwise == wordcount_reference over its own 4 shards")
        elif name == "simulator_device_step":
            plan = plans[name]
            if not torch_steps:
                raise AssertionError("the simulator took no step on the card")
            t = time.perf_counter()
            rep_np = simulate_vectorized(plan.program, plan.flow_spec(), plan.cost_model)
            host_s["simulator_numpy"] = time.perf_counter() - t
            log(f"  {plan.flow_spec().total_packets} packets: makespan {out.makespan_ticks} ticks "
                f"with the step on the card ({torch_steps} steps) vs {rep_np.makespan_ticks} on the numpy path "
                f"({host_s['simulator_numpy'] * 1e3:.3f} ms wall there); busy ticks "
                f"{'equal' if out.switch_busy_ticks == rep_np.switch_busy_ticks else 'DIFFER'}")
            if (out.makespan_ticks != rep_np.makespan_ticks
                    or out.switch_busy_ticks != rep_np.switch_busy_ticks):
                raise AssertionError("the simulator's step on the card differs from numpy's")
        elif name.startswith("plan_aggregate_"):
            sc = SCENARIOS[name.removeprefix("plan_aggregate_")]
            tol = AGG_TOL[sc]
            got_sum = out["OUT"]
            err = float(np.linalg.norm(got_sum - want_sum) / np.linalg.norm(want_sum))
            cpu = plans[name].run({f"g{i}": grads[i, :PREFIX].cpu() for i in range(8)},
                                  backend="torch", device="cpu")["OUT"]
            same = np.array_equal(got_sum[:PREFIX].view(np.uint64), cpu.view(np.uint64))
            log(f"  normwise err vs float64 host sum {err!r} (limit {tol}); first {PREFIX} "
                f"elements {'bitwise ==' if same else 'DIFFER from'} the plan run on the CPU")
            if not np.isfinite(got_sum).all() or got_sum.shape != (GRAD_SIZE,) or err > tol:
                raise AssertionError(f"{name}: beyond {tol} of the float64 sum, or malformed")
            if not same:
                raise AssertionError(f"{name}: the card's result differs from the CPU's")
        else:
            sc = ("s3_in_net_map" if name == "aggregate_s3_plan_order"
                  else name.removeprefix("aggregate_"))
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

    peak_wc_gb = max(pre_paths_peak_gb, torch.cuda.max_memory_allocated() / 1e9,
                     *path_peak_gb.values())
    del words, grads, acc, wire, kout, pout, outs, shards, want_counts, want_mean, want_sum
    # the paths' closures hold the corpus, the gradients and the plans; the
    # checks left the token path's buffers and a float64 error tensor
    del paths, schedule, tenant_plans, recv, reducer_counts, err

    # 3b. the recurrences: a phase of its own, with its own peak (the
    # allocator keeps its cached blocks, as it did for the paths above)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    recurrence = recurrence_inputs()
    torch.cuda.synchronize()
    log(f"data: recurrence a, b ({SCAN_RANKS}, {SCAN_LEN}, {SCAN_BATCH}, {SCAN_WIDTH}) fp32 "
        f"({recurrence[0].numel() * 4 / 1e9:.3f} GB each), {PIPE_STAGES} stage weights "
        f"({PIPE_SHAPE[-1]}, {PIPE_SHAPE[-1]}), {PIPE_MICRO} microbatches {PIPE_SHAPE} fp32; "
        f"{time.perf_counter() - t:.2f} s on the card")
    pre_paths_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, fn in recurrence_paths(*recurrence).items():
        out, _, _ = drive(name, fn)
        if name == "ring_scan_linear_recurrence":
            t = time.perf_counter()
            want = sequential_recurrence(*recurrence[:2])
            host_s["ring_scan_float64_reference"] = time.perf_counter() - t
            err, ratio = beyond_tol(out, want)
            del want
            log(f"  max abs err vs the float64 sequential recurrence {err!r}, "
                f"{ratio!r} of the rtol=atol={RECURRENCE_TOL} limit "
                f"({host_s['ring_scan_float64_reference']:.2f} s for the reference)")
            if out.shape != recurrence[0].shape or not bool(torch.isfinite(out).all()) or ratio > 1:
                raise AssertionError(f"{name}: beyond rtol=atol={RECURRENCE_TOL}, or malformed")
        elif name == "pipeline_apply":
            from repro_torch.core.pipeline import pipeline_stats

            ws, micro = recurrence[2].double(), recurrence[3].double()
            want = micro
            for s in range(PIPE_STAGES):
                want = torch.tanh(want @ ws[s])
            err, ratio = beyond_tol(out[0], want)
            rows_same = all(out[r].data_ptr() == out[0].data_ptr() for r in range(PIPE_STAGES))
            del want, ws, micro
            st = pipeline_stats(PIPE_STAGES, PIPE_MICRO)
            log(f"  {st.ticks} ticks, bubble fraction {st.bubble_fraction!r}; max abs err vs "
                f"the stages applied in sequence (float64) {err!r}, {ratio!r} of the "
                f"rtol=atol={RECURRENCE_TOL} limit; every stage row a view of the last's: "
                f"{rows_same}")
            if (tuple(out.shape) != (PIPE_STAGES, PIPE_MICRO) + PIPE_SHAPE or ratio > 1
                    or not rows_same):
                raise AssertionError(f"{name}: beyond rtol=atol={RECURRENCE_TOL}, or malformed")
        del out
    peak_rec_gb = max(pre_paths_peak_gb, torch.cuda.max_memory_allocated() / 1e9,
                      *(path_peak_gb[n] for n in ("ring_scan_linear_recurrence", "pipeline_apply")))
    del recurrence

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
                    "plan_compile_ms": compile_ms, "plan_makespan_ticks": makespans,
                    "autotune": plans["plan_wordcount_autotuned"].tuning.summary(),
                    "schedule_ticks": schedule_ticks,
                    "host_s": host_s, "path_peak_mem_gb": path_peak_gb,
                    "peak_mem_gb": {"wordcount_aggregation": peak_wc_gb,
                                    "recurrence": peak_rec_gb,
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
