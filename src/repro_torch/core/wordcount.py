"""Word-Count on the world-dim mesh (§2, Fig 1) — the paper's running example.

The port of the mesh half of ``repro/core/wordcount.py``.
Map: each device ("mapper") histograms its local word list.
Shuffle: counts travel to their reducers in one ``all_to_all`` over the axis
(``shuffle.spmd.shuffle_reduce``).
Reduce: each device ("reducer") sums the partial counts it received, as part
of the shuffle's arrival processing, i.e. in transit.

Word ids are dense ints in [0, vocab); bucket(word) = word // (vocab/p).
``kernel_histogram`` runs the ``segment_reduce`` kernel as the mapper
histogram; ``local_histogram`` is the plain scatter-add the reference uses
by default and for its S1 baseline. ``wordcount_token_shuffle`` is the
other data plane: raw words travel to the reducer of their hash bucket and
are counted there. ``wordcount_program`` and ``wordcount_shuffle_program``
state the same job as p4mr programs for the compiler, and
``wordcount_via_plan`` counts through a compiled, lowered shuffle plan.
"""
from __future__ import annotations

import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import dag
from repro_torch.kernels import ops
from repro_torch.mesh import Mesh

# fp32 atomics count exactly while every count stays at or below 2**24
MAX_EXACT_COUNT = 2**24


def local_histogram(words: torch.Tensor, vocab: int) -> torch.Tensor:
    """Map: count words in each device's shard. (..., n) int32 → (..., vocab)
    int32. -1 entries are padding and are not counted."""
    valid = (words >= 0).to(torch.int32)
    hist = torch.zeros(words.shape[:-1] + (vocab,), dtype=torch.int32, device=words.device)
    return hist.scatter_add_(-1, words.clamp(0, vocab - 1).to(torch.int64), valid)


def kernel_histogram(words: torch.Tensor, vocab: int) -> torch.Tensor:
    """``local_histogram`` through the ``segment_reduce`` kernel: a count of
    ones (a broadcast, never materialized) per word, one launch for every
    device. Words must lie in [-1, vocab); exact while each shard holds at
    most 2**24 words."""
    n = words.shape[-1]
    if n > MAX_EXACT_COUNT:
        raise ValueError(f"{n} words per shard: fp32 counts are exact only up to {MAX_EXACT_COUNT}")
    ones = torch.ones((1, 1), dtype=torch.float32, device=words.device)
    counts = ops.segment_reduce(ones.expand(words.shape + (1,)), words, vocab)
    return counts[..., 0].to(torch.int32)


def wordcount_step(
    words: torch.Tensor,
    vocab: int,
    mesh: Mesh,
    axis_name: str = "all",
    *,
    histogram_fn: Callable[[torch.Tensor, int], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Deprecated SPMD word-count: every reducer's (vocab/p,) counts.

    Device k ends up owning the final counts of words
    [k·vocab/p, (k+1)·vocab/p): data is reduced while being shuffled (the
    S2/S3 path of the paper). Requires vocab % p == 0 (pad upstream).

    Deprecated as an entry point, as in the reference: call
    ``shuffle.spmd.shuffle_reduce`` on the local histogram directly.
    """
    from repro_torch.shuffle.spmd import shuffle_reduce

    warnings.warn(
        "repro_torch.core.wordcount.wordcount_step is deprecated; call "
        "repro_torch.shuffle.spmd.shuffle_reduce on the local histogram",
        DeprecationWarning,
        stacklevel=2,
    )
    hist = (histogram_fn or local_histogram)(words, vocab)  # map
    return shuffle_reduce(hist, mesh, axis_name)  # keyby + reduce in transit


def wordcount_token_shuffle(
    words: torch.Tensor, vocab: int, mesh: Mesh, axis_name: str = "all"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Word count by shuffling raw words: the mapper hashes every word to
    the reducer that owns its bucket (``hash_partition``), one
    capacity-sized ``all_to_all`` carries the words there
    (``shuffle.spmd.token_shuffle``), and each reducer counts what it
    received with ``segment_reduce``.

    The capacity is the largest bucket of any mapper, so no word is dropped.
    Returns (each reducer's (vocab,) int32 counts, nonzero only for the
    words it owns; the received words, -1 padded). Counting in fp32 is exact
    below 2**24 a word; a count that reaches it raises.
    """
    from repro_torch.shuffle.spmd import token_shuffle

    _, hist = ops.hash_partition(words, mesh.axis_size(axis_name))
    recv, _ = token_shuffle(words, mesh, axis_name, capacity=max(1, int(hist.max())))
    ones = torch.ones((1, 1), dtype=torch.float32, device=words.device)
    counts = ops.segment_reduce(ones.expand(recv.shape + (1,)), recv, vocab)[..., 0]
    if float(counts.max()) >= MAX_EXACT_COUNT:
        raise ValueError(f"a word count reaches {MAX_EXACT_COUNT}: fp32 counts are no longer exact")
    return counts.to(torch.int32), recv


def wordcount_host_baseline(
    words: torch.Tensor, vocab: int, mesh: Mesh, axis_name: str = "all"
) -> torch.Tensor:
    """Scenario-1 baseline: ship ALL raw histograms to every endpoint
    (all_gather) and reduce locally — endpoint compute, p× the wire bytes."""
    hist = local_histogram(words, vocab)
    gathered = mesh.all_gather(hist, axis_name)  # (p, vocab) per device
    full = gathered.sum(dim=mesh.ndim, dtype=torch.int32)
    p = mesh.axis_size(axis_name)
    k = mesh.axis_index(axis_name)
    return mesh.dynamic_slice_in_dim(full, k * (vocab // p), vocab // p)


def wordcount_reference(word_shards: list[np.ndarray], vocab: int) -> np.ndarray:
    """Oracle: plain counting over all shards. (vocab,)"""
    out = np.zeros((vocab,), np.int64)
    for ws in word_shards:
        ws = np.asarray(ws)
        ws = ws[ws >= 0]
        np.add.at(out, ws, 1)
    return out


# ---------------------------------------------------------------------------
# Word-count as a p4mr DAG, lowered by the pass-based compiler: per-shard
# histogram stores feeding a reduction the compiler restructures (chain →
# balanced tree, combiners at shared uplinks); ``plan.run(backend="torch")``
# runs it on the world-dim mesh.
# ---------------------------------------------------------------------------
def wordcount_program(
    num_shards: int,
    vocab: int,
    *,
    hosts: list[str] | None = None,
    sink_host: str | None = None,
):
    """Chain-of-binary-SUMs word-count DAG (what a naive frontend emits).

    Store ``s<i>`` carries shard i's (vocab,)-histogram; the left-deep
    SUM chain is exactly the shape the rebalance pass turns into a
    balanced in-network tree. ``hosts`` defaults to torus devices d0..dn-1.
    """
    if num_shards < 1:
        raise ValueError("need at least one shard")
    hosts = hosts if hosts is not None else [f"d{i}" for i in range(num_shards)]
    if len(hosts) != num_shards:
        raise ValueError(f"{num_shards} shards but {len(hosts)} hosts")
    p = dag.Program()
    for i, h in enumerate(hosts):
        p.store(f"s{i}", host=h, path=f"shard_{i}", items=vocab)
    if num_shards == 1:
        p.sum("COUNTS", "s0", state_width=vocab)
    else:
        acc = "s0"
        for i in range(1, num_shards):
            name = "COUNTS" if i == num_shards - 1 else f"partial{i}"
            p.sum(name, acc, f"s{i}", state_width=vocab)
            acc = name
    p.collect("OUT", "COUNTS", sink_host=sink_host or hosts[-1])
    return p


def wordcount_shuffle_program(
    num_shards: int,
    vocab: int,
    *,
    num_buckets: int | None = None,
    weights: Sequence[float] | None = None,
    hosts: list[str] | None = None,
    sink_host: str | None = None,
):
    """Word-count as the paper's real Map-Reduce shape: MAP→KEYBY→REDUCE.

    Store ``s<i>`` carries shard i's (vocab,)-histogram, ``k<i>`` declares
    the mapper→reducer hash routing (``weights`` = per-bucket skew), and
    the single SUM is the reducer the ``lower-shuffle`` pass splits into
    per-bucket in-network reducers; unlowered, it runs as one fan-in
    reducer. This is what ``wordcount_via_plan`` compiles;
    ``wordcount_program`` keeps the naive chain form the rebalance pass
    exists for.
    """
    if num_shards < 1:
        raise ValueError("need at least one shard")
    hosts = hosts if hosts is not None else [f"d{i}" for i in range(num_shards)]
    if len(hosts) != num_shards:
        raise ValueError(f"{num_shards} shards but {len(hosts)} hosts")
    buckets = num_buckets if num_buckets is not None else min(num_shards, vocab)
    p = dag.Program()
    keybys = []
    for i, h in enumerate(hosts):
        p.store(f"s{i}", host=h, path=f"shard_{i}", items=vocab)
        p.key_by(f"k{i}", f"s{i}", num_buckets=buckets, weights=weights)
        keybys.append(f"k{i}")
    p.sum("COUNTS", *keybys, state_width=vocab)
    p.collect("OUT", "COUNTS", sink_host=sink_host or hosts[-1])
    return p


def _compile_wordcount_plan(
    num_shards: int,
    vocab: int,
    *,
    topo=None,
    passes=None,
    cost_model=None,
    num_buckets: int | None = None,
    weights: Sequence[float] | None = None,
):
    """``wordcount_via_plan``'s compile: a ``p4mr.Session`` on ``topo``
    (default: the ``num_shards``-device torus) compiles the MAP→KEYBY→
    REDUCE program, or, with ``num_buckets=None``, arbitrates the bucket
    count over 1 / p/2 / p (``shuffle.arbitrate_buckets``). Returns the
    ``CompiledPlan``."""
    from repro_torch import compiler, p4mr, shuffle
    from repro_torch.core.topology import TorusTopology

    n = num_shards
    topo = topo if topo is not None else TorusTopology(dims=(max(n, 2),))
    cm = cost_model or compiler.CostModel(max_fanin=4)
    opts = p4mr.CompileOptions(passes=tuple(passes)) if passes is not None else None
    sess = p4mr.Session(topo, cost_model=cm, options=opts)

    def make(b: int):
        # re-bin declared skew to the candidate bucket count (weights are a
        # density over the key space, not tied to one bucket granularity)
        w = shuffle.resample_weights(weights, b) if weights is not None else None
        return wordcount_shuffle_program(n, vocab, num_buckets=b, weights=w)

    if num_buckets is not None:
        return sess.compile(make(min(num_buckets, vocab)), name="wordcount")
    candidates = sorted({1, max(1, n // 2), min(n, vocab)})
    return sess.arbitrate_buckets(make, candidates, name="wordcount")


def wordcount_via_plan(
    word_shards: list[np.ndarray],
    vocab: int,
    *,
    topo=None,
    passes=None,
    cost_model=None,
    num_buckets: int | None = None,
    weights: Sequence[float] | None = None,
    backend: str = "torch",
    device=None,
):
    """Count words through the compiler: shards → histograms → MAP→KEYBY→
    REDUCE program → ``lower-shuffle`` → the compiled plan. Returns
    ``(counts, SimResult)``; counts are bitwise what
    ``wordcount_reference`` produces — integer-valued sums, reassembled in
    bucket order.

    ``backend="torch"`` (the default) counts on the card, or on
    ``device`` when one is named (``device="cpu"``): ``kernel_histogram``
    over the shards, padded with -1 to one length, then the plan's torch
    step in float64; the ``SimResult`` holds those counts and the plan's
    streamed timing (``plan.simulate_timing()``, which depends on the
    traffic's shape only). ``backend="simulate"`` is the reference
    package's route and runs on the host alone: numpy histograms, then
    the packet simulator.

    ``num_buckets=None`` lets the §3 cost model arbitrate the fan-out the
    same way ``compile_best`` arbitrates chain-vs-tree
    (``shuffle.arbitrate_buckets`` over 1 / p/2 / p buckets). Compiles
    through a ``repro_torch.p4mr.Session`` (the framework API).
    """
    if backend not in ("torch", "simulate"):
        raise ValueError(f"unknown backend {backend!r}; one of 'torch', 'simulate'")
    plan = _compile_wordcount_plan(
        len(word_shards), vocab, topo=topo, passes=passes, cost_model=cost_model,
        num_buckets=num_buckets, weights=weights,
    )
    if backend == "simulate":
        inputs = {
            f"s{i}": wordcount_reference([ws], vocab).astype(np.float64)
            for i, ws in enumerate(word_shards)
        }
        sim = plan.simulate(inputs)
        return sim.outputs["OUT"].astype(np.int64), sim
    from repro_torch.compiler.simulator import SimResult
    from repro_torch.mesh import resolve_device

    dev = resolve_device(device, "wordcount_via_plan")
    width = max(len(ws) for ws in word_shards)
    words = torch.full((len(word_shards), width), -1, dtype=torch.int32)
    for i, ws in enumerate(word_shards):
        words[i, : len(ws)] = torch.from_numpy(np.asarray(ws, dtype=np.int32))
    hist = kernel_histogram(words.to(dev), vocab)
    out = plan.run({f"s{i}": hist[i] for i in range(len(word_shards))},
                   backend="torch", device=dev, item_dtype=torch.float64)
    return out["OUT"].astype(np.int64), SimResult(outputs=out, report=plan.simulate_timing())
