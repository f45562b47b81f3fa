"""The port's default pipeline (``lower-shuffle``, ``reroute-feedback``),
``p4mr.Session``, the compiled word count and scenarios, and
``core.serialization`` against the JAX package, on the same inputs.

Compiling and simulating need no devices, so both packages run in this
process: ``lower-shuffle`` on the ``BENCH_shuffle.json`` fat_tree_k4 cells
(program text, bucket widths, bucket→switch assignment, placement,
routes), ``reroute-feedback``'s routes and rounds, ``Session.compile``,
``compile_best`` (both objectives), ``arbitrate_buckets`` and
``simulate`` (combined and solo makespans of two word counts sharing a
fat-tree), ``wordcount_via_plan`` (counts bitwise, reports field by
field), ``compile_scenario``, ``plan_ring_order`` and
``simulated_scenario_time``, and ``serialization``'s functions to the
last bit. One subprocess runs the JAX package's ``plan.run(backend="jax")``
of lowered shuffle plans on 8 fake CPU devices; the port's
``plan.run(backend="torch", device="cpu")`` of the same plans must equal
it bitwise.
"""
import dataclasses
import importlib
import os
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

_MODULES = {"compiler": "compiler", "verify": "verify", "dag": "core.dag", "dsl": "core.dsl",
            "prim": "core.primitives", "scenarios": "core.scenarios",
            "serialization": "core.serialization", "topology": "core.topology",
            "wordcount": "core.wordcount", "p4mr": "p4mr", "shuffle": "shuffle"}


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


def fields(report) -> str:
    """Every field of a ``SimReport``, exactly."""
    return repr(dataclasses.asdict(report))


def summary(plan, ns):
    """What two compiles must share: pass records, program text,
    placement, routes, pins, cost, verifier output, ``reroute-feedback``
    stats and ``lower-shuffle``'s record (bucket widths, reducers and
    their switches)."""
    return (
        [(r.name, r.summary) for r in plan.pass_records],
        ns.dsl.program_to_source(plan.program),
        dict(plan.placement.assignment),
        [(r.src_label, r.dst_label, list(r.path)) for r in plan.routes.routes],
        dict(plan.pins),
        dataclasses.astuple(plan.cost),
        [d.format() for d in plan.diagnostics or ()],
        plan.feedback,
        repr(plan.shuffle_meta),
    )


def _weights(buckets, skew):
    return None if skew == 0.0 else tuple(1.0 / (b + 1) ** skew for b in range(buckets))


def _shuffle_cell(ns, topo_name, buckets, skew, **kw):
    """A ``benchmarks/bench_shuffle.py`` cell (8 mappers, vocab 256) under
    the default pipeline."""
    if topo_name == "fat_tree_k4":
        topo = ns.topology.fat_tree_topology(4)
        hosts, sink = [f"h{i}" for i in range(8)], f"h{len(topo.hosts) - 1}"
    else:
        topo = ns.topology.TorusTopology(dims=(4, 4))
        hosts, sink = [f"d{2 * i}" for i in range(8)], "d15"
    prog = ns.wordcount.wordcount_shuffle_program(
        8, 256, num_buckets=buckets, weights=_weights(buckets, skew), hosts=hosts,
        sink_host=sink)
    return ns.compiler.compile(prog, topo, **kw)


def _cell_inputs(buckets, skew):
    rs = np.random.RandomState(buckets * 7 + int(skew * 3))
    return {f"s{i}": rs.randint(0, 50, size=(256,)).astype(np.float64) for i in range(8)}


# ------------------------------------------------------------ lower-shuffle --
@pytest.mark.parametrize("skew", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("buckets", [2, 4, 8])
def test_lower_shuffle_on_the_bench_shuffle_cells_matches_jax(buckets, skew):
    def run(ns):
        plan = _shuffle_cell(ns, "fat_tree_k4", buckets, skew)
        stats = ns.shuffle.plan_shuffle(plan)
        sim = plan.simulate(_cell_inputs(buckets, skew))
        return (summary(plan, ns), repr(dataclasses.asdict(stats)), fields(sim.report),
                sim.outputs["OUT"].tolist()), plan.shuffle_meta["COUNTS"]

    (want, _), (got, meta) = both(run)
    assert got == want
    assert meta["num_buckets"] == buckets and sum(meta["widths"]) == 256
    assert len(set(meta["bucket_reducers"].values())) == buckets
    assert got[3] == sum(_cell_inputs(buckets, skew).values()).tolist()


def test_split_widths_and_resample_weights_match_jax():
    def run(ns):
        sh = ns.shuffle
        return ([sh.split_widths(w, b, ws) for w, b, ws in
                 ((256, 8, None), (100, 3, (5.0, 1.0, 1.0)), (7, 4, (1.0, 0.0, 2.0, 1.0)),
                  (50_000, 8, tuple(1.0 / (i + 1) ** 1.3 for i in range(8))))],
                [sh.resample_weights(w, b) for w, b in
                 (((4.0, 2.0, 1.0, 1.0), 8), ((4.0, 2.0, 1.0, 1.0), 2), ((1.0, 3.0, 2.0), 5))])

    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("case", ["torus_skew0", "torus_skew2", "one_round", "no_rounds"])
def test_reroute_feedback_routes_and_rounds_match_jax(case):
    topo_name, skew, rounds = {
        "torus_skew0": ("torus_4x4", 0.0, None), "torus_skew2": ("torus_4x4", 2.0, None),
        "one_round": ("fat_tree_k4", 2.0, 1), "no_rounds": ("fat_tree_k4", 2.0, 0),
    }[case]
    options = None if rounds is None else {"reroute_rounds": rounds}
    want, got = both(lambda ns: summary(_shuffle_cell(ns, topo_name, 8, skew, options=options), ns))
    assert got == want
    feedback = got[7]
    assert feedback["rounds"] == (rounds if rounds is not None else feedback["rounds"])
    assert feedback["makespan_ticks"] <= feedback["static_makespan_ticks"]


# ------------------------------------------------------------------ Session --
def _tenant(ns, name, hosts, sink, vocab=64):
    job = ns.p4mr.job(name)
    keyed = [job.store(f"s{i}", host=h, items=vocab).key_by(4) for i, h in enumerate(hosts)]
    keyed[0].reduce("SUM", *keyed[1:], label="R").collect(sink, label="OUT")
    return job


@pytest.mark.parametrize("arrivals", [None, {"tenant_b": 40.0}])
def test_session_simulate_two_wordcounts_matches_jax(arrivals):
    """``BENCH_compile.json``'s two-tenant fat-tree cell: combined and
    solo makespans, contention and finish ticks equal the reference's."""
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
        a = sess.compile(_tenant(ns, "tenant_a", [f"h{i}" for i in range(4)], "h15"),
                         name="tenant_a")
        b = sess.compile(_tenant(ns, "tenant_b", [f"h{i}" for i in range(4, 8)], "h12"),
                         name="tenant_b")
        ins = {n: {f"s{i}": np.arange(64.0) + i for i in range(4)} for n in ("tenant_a", "tenant_b")}
        rep = sess.simulate(ins, arrivals=arrivals)
        return (summary(a, ns), summary(b, ns), fields(rep.combined),
                {n: fields(r) for n, r in rep.solo.items()}, rep.solo_makespan_ticks,
                rep.contention_ticks, rep.finish_ticks, rep.arrivals, rep.summary(),
                {n: {k: v.tolist() for k, v in o.items()} for n, o in rep.outputs.items()})

    want, got = both(run)
    assert got == want
    solo = got[4]
    assert min(solo.values()) > 0 and got[5] >= 0


@pytest.mark.parametrize("objective", ["static", "streamed"])
def test_session_compile_best_matches_jax(objective):
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.TorusTopology(dims=(8,)))
        best = sess.compile_best(ns.wordcount.wordcount_program(8, 256), name="best",
                                 objective=objective)
        return summary(best, ns), sorted(sess.plans)

    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("objective", ["static", "streamed"])
def test_session_arbitrate_buckets_matches_jax(objective):
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
        plan = sess.arbitrate_buckets(
            lambda b: ns.wordcount.wordcount_shuffle_program(
                8, 256, num_buckets=b, weights=_weights(b, 1.0),
                hosts=[f"h{i}" for i in range(8)], sink_host="h15"),
            [1, 2, 4, 8], objective=objective)
        return summary(plan, ns), sorted(sess.plans)

    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("preset", ["unoptimized", "static_ecmp", "default"])
def test_session_compile_presets_match_jax(preset):
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.paper_topology(), options=preset)
        plan = sess.compile(ns.dag.paper_example())
        twin = sess.compile(ns.dag.paper_example())  # a second default-named job
        return summary(plan, ns), sorted(sess.plans), twin is not plan

    want, got = both(run)
    assert got == want


def test_session_verify_and_errors_match_jax():
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
        sess.compile(_tenant(ns, "a", [f"h{i}" for i in range(4)], "h15"), name="a")
        sess.compile(_tenant(ns, "b", [f"h{i}" for i in range(4, 8)], "h12"), name="b")
        diags = {k: [d.format() for d in v] for k, v in sess.verify(profile="tofino_like").items()}
        errors = []
        for call in (lambda: sess.simulate(names=["nope"]),
                     lambda: sess.simulate(arrivals={"zzz": 1.0}),
                     lambda: sess.simulate(arrivals={"a": -1.0}),
                     lambda: ns.p4mr.Session(ns.topology.fat_tree_topology(4)).simulate(),
                     lambda: ns.p4mr.CompileOptions(preset="nope"),
                     lambda: sess.compile(3.5)):
            try:
                call()
            except (KeyError, ValueError, TypeError) as e:
                errors.append(f"{type(e).__name__}: {e}")
        return diags, errors

    want, got = both(run)
    assert got == want
    assert len(got[1]) == 6


# ------------------------------------------------ the compiled word count --
@pytest.mark.parametrize("case", ["arbitrated", "arbitrated_skewed", "four_buckets",
                                  "torus_static"])
def test_wordcount_via_plan_matches_jax_bitwise(case):
    kw = {"arbitrated": {}, "arbitrated_skewed": {"weights": (8.0, 4.0, 2.0, 1.0)},
          "four_buckets": {"num_buckets": 4},
          "torus_static": {"passes": ("parse", "validate", "dead-node-elim", "lower-shuffle",
                                      "place", "route", "emit", "verify")}}[case]
    rs = np.random.RandomState(5)
    shards = [rs.randint(-1, 300, size=2000).astype(np.int32) for _ in range(8)]

    def run(ns):
        # the reference's only route is the host's; the port's default is the card
        host = {"backend": "simulate"} if ns is NS["torch"] else {}
        counts, sim = ns.wordcount.wordcount_via_plan(shards, 300, **kw, **host)
        return counts, fields(sim.report)

    (want, want_rep), (got, got_rep) = both(run)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, NS["torch"].wordcount.wordcount_reference(shards, 300))
    assert got_rep == want_rep
    # and its default route, the kernel histogram and the torch step (here
    # on the CPU), counts the same words with the same streamed timing
    counts, sim = NS["torch"].wordcount.wordcount_via_plan(shards, 300, **kw, device="cpu")
    assert counts.dtype == np.int64
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(sim.outputs["OUT"], want.astype(np.float64))
    assert fields(sim.report) == want_rep


def test_wordcount_via_plan_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shards = [np.arange(32, dtype=np.int32) % 16 for _ in range(4)]
    wc = NS["torch"].wordcount
    with pytest.raises(RuntimeError, match="CUDA.*device='cpu'"):
        wc.wordcount_via_plan(shards, 16)
    with pytest.raises(ValueError, match="one of 'torch', 'simulate'"):
        wc.wordcount_via_plan(shards, 16, backend="jax")
    counts, _ = wc.wordcount_via_plan(shards, 16, device="cpu")
    np.testing.assert_array_equal(counts, np.full(16, 8))


def _reference_wordcount_session(ns, vocab):
    """The reference's ``wordcount_via_plan`` compile, spelled out."""
    sess = ns.p4mr.Session(ns.topology.TorusTopology(dims=(8,)),
                           cost_model=ns.compiler.CostModel(max_fanin=4))
    return sess.arbitrate_buckets(
        lambda b: ns.wordcount.wordcount_shuffle_program(8, vocab, num_buckets=b),
        [1, 4, 8], name="wordcount")


def test_wordcount_plan_helper_is_the_reference_compile():
    """``_compile_wordcount_plan`` (which ``chip_smoke.py`` runs on the
    card) is the compile inside the reference's ``wordcount_via_plan``."""
    t = NS["torch"]
    got = summary(t.wordcount._compile_wordcount_plan(8, 50_000), t)
    assert got == summary(_reference_wordcount_session(NS["jax"], 50_000), NS["jax"])
    assert "BUCKET(" in got[1]


# ------------------------------------------------------- the §4 scenarios --
FULL = 25_557_032


@pytest.mark.parametrize("width", [64, FULL], ids=["narrow", "full"])
@pytest.mark.parametrize("scenario", ["s1_host", "s2_in_net", "s3_in_net_map"])
def test_compile_scenario_matches_jax(scenario, width):
    def run(ns):
        cm = ns.compiler.CostModel(switch_memory_bytes=1 << 29) if width == FULL else None
        plan = ns.scenarios.compile_scenario(8, scenario, state_width=width, cost_model=cm)
        return summary(plan, ns), fields(plan.simulate_timing())

    want, got = both(run)
    assert got == want
    if width == FULL:  # the plans chip_smoke.py runs: lowered shuffles
        buckets = {"s1_host": 8, "s2_in_net": 32, "s3_in_net_map": 64}[scenario]
        assert got[0][1].count("BUCKET(") == buckets


@pytest.mark.parametrize("topo", ["ring8", "torus_2x4", "torus_4x4"])
def test_plan_ring_order_matches_jax(topo):
    world, dims = {"ring8": (8, None), "torus_2x4": (8, (2, 4)), "torus_4x4": (16, (4, 4))}[topo]
    want, got = both(lambda ns: ns.scenarios.plan_ring_order(
        world, topo=ns.topology.TorusTopology(dims=dims) if dims else None))
    assert got == want
    assert sorted(got) == list(range(world))
    if topo == "torus_2x4":
        assert got == [0, 1, 2, 3, 7, 4, 5, 6]


@pytest.mark.parametrize("scenario", ["s1_host", "s2_in_net", "s3_in_net_map"])
def test_simulated_scenario_time_matches_jax(scenario):
    want, got = both(lambda ns: [ns.scenarios.simulated_scenario_time(w, scenario, state_width=s)
                                 for w, s in ((4, 1), (8, 100), (16, 1000))])
    assert got == want
    assert all(t > 0 for t in got)


# ---------------------------------------------------------- serialization --
def test_serialization_matches_jax_to_the_last_bit():
    def run(ns):
        ser = ns.serialization
        out = []
        for c in (1.0, 1000.0, 1e9, 123.456):
            out += [ser.equilibrium_ingest_rate(c), ser.throughput_penalty(c)]
            for n in (1, 7, 100, 10_000):
                out += [ser.compounding_equilibrium(c, n), ser.max_sustainable_ingest(c, n),
                        ser.simulate_recirculation(c, n, c / 3)]
            out += [ser.item_level_sustainable_ingest(c, k) for k in (1, 4, 32)]
        out.append(dataclasses.astuple(ser.choose_serialization(1e9, 5e8, 1e9,
                                                                header_overhead=1.4)))
        out.append(dataclasses.astuple(ser.choose_serialization(1e6, 1e10, 1e9)))
        for link in (ser.LinkModel(), ser.LinkModel(alpha_s=5e-6, beta_s_per_byte=1 / 25e9)):
            for nbytes, world in ((0.0, 8), (4e6, 1), (1e8, 8), (102_228_128.0, 8), (3e9, 256)):
                out += [ser.ring_all_reduce_time(nbytes, world, link, c) for c in (1, 3, 64)]
                out += [ser.optimal_chunks(nbytes, world, link),
                        ser.optimal_bucket_bytes(nbytes, world, link)]
        return out

    want, got = both(run)
    assert repr(got) == repr(want)


# ----------------------------------------------- verifier and deprecated shim --
def test_v105_holds_a_lowered_concat_to_its_bucket_reducers_as_in_jax():
    def run(ns):
        plan = _shuffle_cell(ns, "fat_tree_k4", 4, 1.0)
        concat = next(n for n in plan.program if isinstance(n, ns.prim.Concat))
        nodes = dict(plan.program.nodes)
        nodes[concat.name] = dataclasses.replace(concat, srcs=concat.srcs[:-1] + ("s0",))
        broken = dataclasses.replace(plan, program=ns.dag.Program(nodes=nodes), diagnostics=None)
        return ([d.format() for d in ns.verify.verify_plan(plan)],
                sorted(d.format() for d in ns.verify.verify_plan(broken) if d.code == "V105"))

    want, got = both(run)
    assert got == want
    assert got[0] == [] and len(got[1]) == 2


def test_compile_program_shim_warns_and_emits_the_plan_step():
    from repro_torch.core import codelet
    from repro_torch.mesh import Mesh

    t = NS["torch"]
    plan = t.wordcount._compile_wordcount_plan(8, 40)
    mesh = Mesh(("all",), (8,), device="cpu")
    with pytest.warns(DeprecationWarning, match="compile_program is deprecated"):
        step = codelet.compile_program(plan.program, plan.placement, plan.routes, mesh)
    rs = np.random.RandomState(2)
    inputs = {f"s{i}": rs.poisson(3.0, size=40).astype(np.float64) for i in range(8)}
    big = {k: torch.from_numpy(v).expand(8, 40) for k, v in inputs.items()}
    np.testing.assert_array_equal(step(big)["OUT@all"][0].double().numpy(),
                                  plan.run(inputs, backend="torch", device="cpu")["OUT"])


# -------------------------------------------- the torch backend on a lowered plan --
LOWERED = {
    "wordcount_session": lambda ns: _reference_wordcount_session(ns, 40),
    "skewed_keyby": lambda ns: ns.compiler.compile(
        ns.wordcount.wordcount_shuffle_program(8, 40, num_buckets=4, weights=(4.0, 2.0, 1.0, 1.0)),
        ns.topology.TorusTopology(dims=(8,))),
    # four workers, so the JAX side compiles small graphs; the switch memory
    # holds two 4096-wide tables, so S2/S3 lower to 16 bucket slices
    "s1": lambda ns: ns.scenarios.compile_scenario(4, "s1_host", state_width=4096),
    "s2": lambda ns: ns.scenarios.compile_scenario(
        4, "s2_in_net", state_width=4096,
        cost_model=ns.compiler.CostModel(switch_memory_bytes=1 << 15)),
    "s3": lambda ns: ns.scenarios.compile_scenario(
        4, "s3_in_net_map", state_width=4096,
        cost_model=ns.compiler.CostModel(switch_memory_bytes=1 << 15)),
}


def lowered_inputs(name, plan):
    rs = np.random.RandomState(sorted(LOWERED).index(name))
    out = {}
    for label in plan.program.sources():
        n = plan.program.nodes[label].items
        out[label] = (rs.poisson(3.0, size=n).astype(np.float64) if name in
                      ("wordcount_session", "skewed_keyby") else rs.randn(n) / 3.0)
    return out


JAX_SCRIPT = r"""
import sys, numpy as np
sys.path.insert(0, {tests!r})
import test_torch_session as T
out = {{}}
for name in T.LOWERED:
    plan = T.LOWERED[name](T.NS["jax"])
    for k, v in plan.run(T.lowered_inputs(name, plan), backend="jax").items():
        out[f"{{name}}/{{k}}"] = np.asarray(v)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_session") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path))
    with np.load(path) as f:
        return dict(f)


@pytest.mark.parametrize("name", sorted(LOWERED))
def test_lowered_plan_on_the_torch_backend_matches_jax_bitwise(jax_out, name):
    t = NS["torch"]
    plan = LOWERED[name](t)
    assert any(isinstance(n, t.prim.ShuffleBucket) for n in plan.program)
    inputs = lowered_inputs(name, plan)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = plan.run(inputs, backend="torch", device="cpu")
    for sink, v in got.items():
        want = jax_out[f"{name}/{sink}"]
        assert v.dtype == want.dtype == np.float64 and v.shape == want.shape
        np.testing.assert_array_equal(v.view(np.uint64), want.view(np.uint64))
    # and the simulator's outputs (the oracle's) agree with it
    tol = 3e-2 if name == "s3" else 1e-5
    np.testing.assert_allclose(plan.run(inputs, backend="simulate")["OUT"], got["OUT"],
                               rtol=tol, atol=tol)
