"""The port's autotuner (``repro_torch.autotune``) against the JAX package's.

The autotuner is host Python in both packages: a hill-climb over plan
mutations scored by the packet simulator, whose ties ``heapq`` and dict
order decide. So both packages run in this process and every result must
be *equal*, not close: the ``TuningReport`` (``to_dict()``: every action,
accepted or not, with its times and makespans, the cache counts), the
tuned plan (``describe()`` with the pass walls cut out, routes, pins) and
its simulated outputs. The four cells are ``BENCH_autotune.json``'s
(``benchmarks/bench_autotune.py:58``); the rest mirrors
``tests/test_autotune.py`` case by case, and the compiler's ``autotune``
pass, the ``autotuned`` preset and ``compile_best(autotune=True)`` are
held to the reference's too.

The JAX package is imported on first use (``NS["jax"]``); nothing here
needs a device.
"""
import dataclasses
import importlib
import json
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

_MODULES = {"autotune": "autotune", "compiler": "compiler", "dag": "core.dag", "dsl": "core.dsl",
            "topology": "core.topology", "wordcount": "core.wordcount",
            "routing": "core.routing", "p4mr": "p4mr"}


class _Packages(dict):
    """"jax" → the JAX package's modules, "torch" → the port's, each
    namespace imported when first asked for."""

    def __missing__(self, name):
        root = {"jax": "repro", "torch": "repro_torch"}[name]
        ns = self[name] = types.SimpleNamespace(**{
            k: importlib.import_module(f"{root}.{m}") for k, m in _MODULES.items()})
        return ns


NS = _Packages()


def both(fn):
    """``fn`` run on the JAX package and on the port: (want, got)."""
    return fn(NS["jax"]), fn(NS["torch"])


def no_walls(text: str) -> str:
    """A plan's ``describe()`` without the per-pass wall times, the one
    thing two equal compiles do not share."""
    return re.sub(r" \(\d+us\)", "", text)


def tuned_summary(plan) -> tuple:
    """What two tuned plans must share: the tuning report, the plan's text,
    routes and pins."""
    return (
        json.dumps(plan.tuning.to_dict() if plan.tuning is not None else None),
        no_walls(plan.describe()),
        [(r.src_label, r.dst_label, list(r.path)) for r in plan.routes.routes],
        dict(plan.pins),
        dict(plan.user_pins),
    )


# ----------------------------------------------------------------- cells --
# benchmarks/bench_autotune.py: (topology, num_buckets, skew), 6 rounds,
# bench_shuffle's 8 mappers over a 256-key vocabulary
BENCH_CELLS = (("fat_tree_k4", 8, 2.0), ("fat_tree_k4", 4, 1.0),
               ("torus_4x4", 8, 2.0), ("torus_4x4", 8, 0.0))
TUNE_ROUNDS, N_MAPPERS, VOCAB = 6, 8, 256


def _topology(ns, name):
    if name == "fat_tree_k4":
        ft = ns.topology.fat_tree_topology(4)
        return ft, [f"h{i}" for i in range(N_MAPPERS)], f"h{len(ft.hosts) - 1}"
    return ns.topology.TorusTopology(dims=(4, 4)), [f"d{2 * i}" for i in range(N_MAPPERS)], "d15"


def _weights(num_buckets, skew):
    return None if skew == 0.0 else tuple(1.0 / (b + 1) ** skew for b in range(num_buckets))


def _cell_program(ns, topo_name, num_buckets, skew):
    topo, hosts, sink = _topology(ns, topo_name)
    prog = ns.wordcount.wordcount_shuffle_program(
        N_MAPPERS, VOCAB, num_buckets=num_buckets, weights=_weights(num_buckets, skew),
        hosts=hosts, sink_host=sink)
    return prog, topo


def _case_inputs(num_buckets, skew):
    """bench_shuffle's seeded per-cell mapper histograms."""
    rs = np.random.RandomState(num_buckets * 7 + int(skew * 3))
    return {f"s{i}": rs.randint(0, 50, size=(VOCAB,)).astype(np.float64)
            for i in range(N_MAPPERS)}


def _skewed_shuffle(ns, num_buckets=8, skew=2.0):
    """``tests/test_autotune.py``'s fat-tree shuffle."""
    return _cell_program(ns, "fat_tree_k4", num_buckets, skew)


@pytest.mark.parametrize("cell", BENCH_CELLS, ids=lambda c: f"{c[0]}.b{c[1]}.skew{c[2]}")
def test_bench_autotune_cells_match_jax_exactly(cell):
    """Static, feedback and tuned makespans, the whole ``TuningReport``
    and the tuned plan equal the reference's; the tuned plan's outputs
    are the exact sum (bench_autotune.py:77), in the simulator and, on
    the torus (integer switch ids), in the port's torch step on the CPU."""
    inputs = _case_inputs(cell[1], cell[2])
    want_sum = np.sum([inputs[f"s{i}"] for i in range(N_MAPPERS)], axis=0)

    def run(ns):
        prog, topo = _cell_program(ns, *cell)
        static = ns.compiler.compile(prog, topo, passes=ns.compiler.STATIC_ECMP_PASSES)
        feedback = ns.compiler.compile(prog, topo)
        tuned = ns.autotune.tune(feedback, rounds=TUNE_ROUNDS)
        sim = tuned.simulate(inputs)
        np.testing.assert_array_equal(sim.outputs["OUT"], want_sum)  # tuning is exact
        makespans = [p.simulate_timing().makespan_ticks for p in (static, feedback, tuned)]
        return (makespans, tuned.tuning.accepted_by_kind(), tuned_summary(tuned),
                repr(dataclasses.asdict(sim.report))), tuned

    (want, _), (got, tuned) = both(run)
    assert got == want
    rep = tuned.tuning
    assert rep.final_makespan_ticks <= rep.initial_makespan_ticks  # never worse
    if cell[0] == "torus_4x4":
        out = tuned.run(inputs, device="cpu")["OUT"]
        assert out.dtype == np.float64 and np.array_equal(out, want_sum)


def test_k_shortest_paths_match_jax():
    def run(ns):
        ksp = ns.routing.k_shortest_paths
        ft, t = ns.topology.fat_tree_topology(4), ns.topology.TorusTopology(dims=(4, 4))
        out = [ksp(ft, "E0_0", "E2_0", k) for k in (1, 2, 6)]
        out.append(ksp(ft, "E0_0", "E0_0", 3))
        out.append(ksp(t, 0, 5, 8, max_stretch=0))
        out.append(ksp(t, 0, 10, 8))
        with pytest.raises(ValueError):
            ksp(ft, "E0_0", "E2_0", 0)
        return out

    want, got = both(run)
    assert got == want
    hops = [len(p) - 1 for p in got[2]]
    assert hops == sorted(hops) and hops[-1] > hops[0]  # detours, shortest first


def test_hill_climb_matches_jax_and_never_worsens():
    """``tests/test_autotune.py``'s steepest-descent, stuck and ladder
    modes and the cache round trip, on a scalar state."""
    def run(ns):
        at = ns.autotune

        def propose(x, rnd):
            return [
                at.Candidate("add", "+1", lambda x=x: x + 1),
                at.Candidate("sub", "-2", lambda x=x: x - 2),
                at.Candidate("skip", "nope", lambda: (_ for _ in ()).throw(
                    at.SkipCandidate("infeasible"))),
            ]

        out = [at.hill_climb(10.0, objective=float, propose=propose, rounds=3)]
        one_up = lambda x, r: [at.Candidate("add", "+1", lambda x=x: x + 1)]  # noqa: E731
        out.append(at.hill_climb(0.0, objective=float, propose=one_up, rounds=5))
        out.append(at.hill_climb(0.0, objective=float, propose=one_up, rounds=5,
                                 stop_when_stuck=False))
        builds, cache = [], {}

        def cached(x, rnd):
            return [at.Candidate("step", "-1", lambda x=x: x - 1, cache_key=("step", rnd)),
                    at.Candidate("decoy", "+5", lambda: builds.append(1) or 5.0,
                                 cache_key=("decoy",))]

        out.append(at.hill_climb(3.0, objective=float, propose=cached, rounds=3, cache=cache))
        return [(best, score, [dataclasses.astuple(r) for r in recs])
                for best, score, recs in out], len(builds), cache

    want, got = both(run)
    assert got == want
    (steep, stuck, ladder, cached), builds, cache = got
    assert steep[:2] == (4.0, 4.0) and stuck[0] == 0.0
    assert len(stuck[2]) == 1 and len(ladder[2]) == 5
    assert cached[:2] == (0.0, 0.0) and builds == 1 and cache[("decoy",)] == 5.0


@pytest.mark.parametrize("case", ["sweep_b2", "reroute_only", "infeasible_rebucket",
                                  "torus_cache", "reweight_only", "provenance"])
def test_tune_cases_of_the_reference_tests_match_jax(case):
    """Each ``tune`` case of ``tests/test_autotune.py`` gives the
    reference's report and plan."""
    def run(ns):
        if case == "sweep_b2":
            prog, topo = _skewed_shuffle(ns, 2, 0.0)
            return tuned_summary(ns.autotune.tune(ns.compiler.compile(prog, topo), rounds=3))
        if case == "reroute_only":
            topo = ns.topology.fat_tree_topology(4)
            p = ns.dag.Program()
            for i, h in enumerate(["h0", "h2"]):
                p.store(f"m{i}", host=h, items=21)
                p.bucket(f"m{i}b0", f"m{i}", bucket=0, num_buckets=2, offset=0, width=20)
                p.bucket(f"m{i}b1", f"m{i}", bucket=1, num_buckets=2, offset=20, width=1)
            p.sum("R0", "m0b0", "m1b0", state_width=20)
            p.sum("R1", "m0b1", "m1b1", state_width=1)
            p.collect("OUT0", "R0", sink_host="h8")
            p.collect("OUT1", "R1", sink_host="h10")
            static = ns.compiler.compile(p, topo, passes=ns.compiler.STATIC_ECMP_PASSES,
                                         pins={"R0": "E2_0", "R1": "E2_1"})
            tuned = ns.autotune.tune(static, rounds=4, actions=("reroute",))
            return (tuned_summary(tuned), static.simulate_timing().makespan_ticks,
                    tuned.simulate_timing().makespan_ticks)
        if case == "infeasible_rebucket":
            topo = ns.topology.fat_tree_topology(4)
            prog = ns.wordcount.wordcount_shuffle_program(
                8, 256, num_buckets=8, hosts=[f"h{i}" for i in range(8)],
                sink_host=f"h{len(topo.hosts) - 1}")
            fb = ns.compiler.compile(prog, topo,
                                     cost_model=ns.compiler.CostModel(switch_memory_bytes=384))
            return tuned_summary(ns.autotune.tune(fb, rounds=2, actions=("rebucket",)))
        if case == "torus_cache":
            prog = ns.wordcount.wordcount_shuffle_program(
                8, 256, num_buckets=8, weights=_weights(8, 2.0),
                hosts=[f"d{i}" for i in range(8)], sink_host="d15")
            fb = ns.compiler.compile(prog, ns.topology.TorusTopology(dims=(4, 4)))
            return tuned_summary(ns.autotune.tune(fb, rounds=6))
        prog, topo = _skewed_shuffle(ns, *((8, 2.0) if case == "reweight_only" else (4, 1.0)))
        fb = ns.compiler.compile(prog, topo)
        if case == "reweight_only":
            with pytest.raises(ValueError, match="unknown autotune action"):
                ns.autotune.tune(fb, rounds=1, actions=("warp-drive",))
            return tuned_summary(ns.autotune.tune(fb, rounds=2, actions=("reweight",)))
        # provenance: what the pipeline threads through for the tuner
        tuned = ns.autotune.tune(fb, rounds=2)
        assert fb.tuning is None and tuned.tuning is not None
        return (ns.dsl.program_to_source(fb.source_program), fb.user_pins, repr(fb.shuffle_meta), tuned_summary(tuned))

    want, got = both(run)
    assert got == want
    if case == "torus_cache":
        rep = json.loads(got[0])
        assert rep["cache_hits"] > 0 and rep["cache_misses"] > 0
    if case == "reroute_only":
        assert got[2] < got[1] and set(json.loads(got[0][0])["accepted_by_kind"]) == {"reroute"}
    if case == "infeasible_rebucket":
        assert any(a["time_s_after"] is None and a["note"]
                   for a in json.loads(got[0])["actions"])


@pytest.mark.parametrize("entry", ["pass", "pass_off", "compile_best", "session_preset",
                                   "session_knobs"])
def test_autotune_pass_preset_and_compile_best_match_jax(entry):
    """The ``autotune`` pass at the end of ``AUTOTUNE_PASSES`` (and off
    with 0 rounds), ``compile_best(autotune=True)`` and a ``Session`` under
    the ``autotuned`` preset and its knobs compile as the reference's."""
    def run(ns):
        prog, topo = _skewed_shuffle(ns, 8, 2.0)
        if entry == "pass":
            plan = ns.compiler.compile(prog, topo, passes=ns.compiler.AUTOTUNE_PASSES,
                                       options={"autotune_rounds": 3})
        elif entry == "pass_off":
            plan = ns.compiler.compile(prog, topo, passes=ns.compiler.AUTOTUNE_PASSES,
                                       options={"autotune_rounds": 0})
        elif entry == "compile_best":
            plan = ns.compiler.compile_best(prog, topo, autotune=True)
        elif entry == "session_preset":
            plan = ns.p4mr.Session(topo, options="autotuned").compile(prog, name="wc")
        else:
            opts = ns.p4mr.CompileOptions(preset="autotuned", autotune_rounds=2,
                                          autotune_actions=("reroute", "rebucket"))
            plan = ns.p4mr.Session(topo, options=opts).compile(prog, name="wc")
        return tuned_summary(plan), [(r.name, r.summary) for r in plan.pass_records]

    want, got = both(run)
    assert got == want
    tuned = json.loads(got[0][0])
    assert (tuned is None) == (entry == "pass_off")
    assert "autotune" in [name for name, _ in got[1]] or entry == "compile_best"


def test_autotuned_session_wordcount_compile_matches_jax():
    """``chip_smoke.py``'s ``plan_wordcount_autotuned`` compile at its
    width: the Session word count (8 mappers, vocab 50,000, an 8-ring,
    ``max_fanin=4``, buckets arbitrated over 1 / 4 / 8) under the
    ``autotuned`` preset gives the reference's plan and tuning report."""
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.TorusTopology(dims=(8,)),
                               cost_model=ns.compiler.CostModel(max_fanin=4),
                               options="autotuned")
        plan = sess.arbitrate_buckets(
            lambda b: ns.wordcount.wordcount_shuffle_program(8, 50_000, num_buckets=b),
            [1, 4, 8], name="wordcount")
        return tuned_summary(plan), plan.simulate_timing().makespan_ticks

    want, got = both(run)
    assert got == want
    assert json.loads(got[0][0])["final_makespan_ticks"] == got[1]


def test_autotune_pass_without_an_emitted_plan_raises_as_in_jax():
    """The ``autotune`` pass without an emitted plan raises as the
    reference's does."""
    def run(ns):
        prog, topo = _skewed_shuffle(ns, 4, 1.0)
        with pytest.raises(ValueError, match="emitted plan") as ei:
            ns.compiler.compile(prog, topo, passes=("parse", "validate", "autotune"))
        return str(ei.value)

    want, got = both(run)
    assert got == want
