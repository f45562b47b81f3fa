"""The port's packet simulators and fabric/stream telemetry against the JAX
package's, on the same programs.

Both simulators are numpy on the host in both packages, so both run in
this process: every ``SimReport`` must equal the reference's field by
field (``repr`` of ``dataclasses.asdict``: values, float bits and dict
order), for the event engine and the vectorized VOQ core, on the
``BENCH_simulator.json`` fat_tree_k4 cells, the fan-in programs of
``tests/test_simulator_engines.py`` and seeded random chains; then under
``fifo`` fidelity, finite buffers (drop and backpressure), port caps,
link latency and fabric telemetry. The pressure/ranking surface and the
streamed windows must equal the reference's on the same runs, and the
vectorized core's torch step (``VoqParams(use_torch=True)``, here on the
CPU) must give the numpy path's report, and the reference's jax step's
makespan and busy ticks.

The JAX package is imported on first use (``NS["jax"]``), so the
``cuda``-marked test runs on a machine that has the card and no JAX.
"""
import dataclasses
import importlib
import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

_MODULES = {"compiler": "compiler", "simulator": "compiler.simulator",
            "vectorized": "compiler.vectorized", "fabric": "telemetry.fabric",
            "stream": "telemetry.stream", "dag": "core.dag", "topology": "core.topology",
            "wordcount": "core.wordcount"}


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
    """Every field of a ``SimReport`` (timeline included), exactly."""
    return repr(dataclasses.asdict(report))


# ----------------------------------------------------------------- cases --
def _fan_topology(ns):
    """``tests/test_simulator_engines.py``'s fan: flows A and B
    oversubscribe transit switch S1 while C rides SA's other port."""
    adj = {"SA": ("S1", "S4"), "SB": ("S1",), "S1": ("SA", "SB", "S2"),
           "S2": ("S1",), "S4": ("SA", "S5"), "S5": ("S4",)}
    hosts = {"ha": "SA", "hc": "SA", "hb": "SB", "hx": "S2", "hy": "S2", "hz": "S5"}
    return ns.topology.SwitchTopology(adjacency=adj, host_uplink=hosts)


def _fan_program(ns, packets):
    p = ns.dag.Program()
    for s in "ABC":
        p.store(s, host="h" + s.lower(), items=packets)
    p.collect("X", "A", sink_host="hx")
    p.collect("Y", "B", sink_host="hy")
    p.collect("Z", "C", sink_host="hz")
    return p


def _bench_cell(ns, k, mappers, vocab, buckets, skew):
    """A ``benchmarks/bench_simulator.py`` cell's plan."""
    topo = ns.topology.fat_tree_topology(k)
    weights = None if skew == 0.0 else tuple(1.0 / (b + 1) ** skew for b in range(buckets))
    prog = ns.wordcount.wordcount_shuffle_program(
        mappers, vocab, num_buckets=buckets, weights=weights,
        hosts=[f"h{i}" for i in range(mappers)], sink_host=f"h{len(topo.hosts) - 1}")
    return ns.compiler.compile(prog, topo, passes=ns.compiler.STATIC_ECMP_PASSES)


def _shuffle4(ns):
    """A skewed 4-mapper fat-tree shuffle (the simulator tests' telemetry case)."""
    topo = ns.topology.fat_tree_topology(4)
    raw = [(i + 1) ** 2.0 for i in range(4)]
    prog = ns.wordcount.wordcount_shuffle_program(
        4, 512, num_buckets=4, weights=[w / sum(raw) for w in raw],
        hosts=[f"h{i}" for i in range(4)], sink_host=f"h{len(topo.hosts) - 1}")
    return ns.compiler.compile(prog, topo, passes=ns.compiler.STATIC_ECMP_PASSES)


def _random_chain(ns, seed):
    """Seeded random multi-chain program on the 4x4 torus."""
    rng = random.Random(seed)
    p = ns.dag.Program()
    k = rng.randint(2, 4)
    for i in range(k):
        p.store(f"s{i}", host=f"d{rng.randrange(16)}", items=rng.randint(4, 60))
    for i in range(k):
        p.map(f"m{i}", f"s{i}")
    p.sum("r", *[f"m{i}" for i in range(k)])
    p.collect("out", "r", sink_host=f"d{rng.randrange(16)}")
    return ns.compiler.compile(p, ns.topology.TorusTopology(dims=(4, 4)),
                               passes=ns.compiler.STATIC_ECMP_PASSES)


def _with(plan, **knobs):
    return dataclasses.replace(plan, cost_model=dataclasses.replace(plan.cost_model, **knobs))


PLANS = {
    "k4_cap": lambda ns: _bench_cell(ns, 4, 8, 4096, 8, 2.0),
    "k4_per_packet": lambda ns: _with(_bench_cell(ns, 4, 8, 4096, 8, 2.0), sim_train_cap=10**9),
    "fan16": lambda ns: ns.compiler.compile(_fan_program(ns, 16), _fan_topology(ns),
                                            passes=ns.compiler.STATIC_ECMP_PASSES),
    "fan32": lambda ns: ns.compiler.compile(_fan_program(ns, 32), _fan_topology(ns),
                                            passes=ns.compiler.STATIC_ECMP_PASSES),
    "shuffle4": _shuffle4,
    "chain0": lambda ns: _random_chain(ns, 0),
    "chain1": lambda ns: _random_chain(ns, 1),
}

KNOBS = {
    "fifo": dict(sim_fidelity="fifo"),
    "buffer_drop": dict(sim_buffer_packets=8.0, sim_buffer_policy="drop"),
    "buffer_backpressure": dict(sim_buffer_packets=8.0, sim_buffer_policy="backpressure"),
    "port_cap": dict(sim_port_bw=0.5),
    "link_latency": dict(sim_link_latency_ticks=3),
    "telemetry": dict(sim_telemetry=True, sim_telemetry_interval=4.0),
}


# --------------------------------------------------------------- reports --
@pytest.mark.parametrize("engine", ["event", "vectorized"])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_sim_report_matches_jax_field_by_field(case, engine):
    want, got = both(lambda ns: PLANS[case](ns).simulate_timing(engine=engine))
    assert got.engine == engine
    assert fields(got) == fields(want)
    assert got.makespan_ticks > 0


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("case", ["fan32", "shuffle4"])
def test_sim_report_under_each_knob_matches_jax(case, knob):
    engines = ("event", "vectorized") if knob == "telemetry" else ("vectorized",)
    for engine in engines:
        want, got = both(lambda ns: _with(PLANS[case](ns), **KNOBS[knob])
                         .simulate_timing(engine=engine))
        assert fields(got) == fields(want), engine
    if knob == "buffer_drop" and case == "fan32":
        assert got.dropped_packets > 0 and got.port_drops
    if knob == "buffer_backpressure" and case == "fan32":
        assert got.port_blocked_ticks
    if knob == "telemetry":
        assert got.timeline is not None and got.timeline.hop_records
        NS["torch"].fabric.verify_timeline(got)


@pytest.mark.parametrize("engine", ["event", "vectorized"])
def test_simulated_outputs_are_the_oracles_and_match_jax(engine):
    def run(ns):
        plan = PLANS["shuffle4"](ns)
        rs = np.random.RandomState(3)
        inputs = {f"s{i}": rs.randint(0, 50, size=512).astype(np.float64) for i in range(4)}
        sim = plan.simulate(inputs, engine=engine)
        return sim, plan.run(inputs, backend="simulate"), inputs

    (want, want_run, inputs), (got, got_run, _) = both(run)
    assert fields(got.report) == fields(want.report)
    for out in (got.outputs, got_run):
        assert sorted(out) == ["OUT"]
        np.testing.assert_array_equal(out["OUT"], want.outputs["OUT"])
        np.testing.assert_array_equal(out["OUT"], sum(inputs.values()))


# ------------------------------------------------ fabric and stream telemetry --
@pytest.mark.parametrize("engine", ["event", "vectorized"])
def test_fabric_pressure_and_ranking_match_jax(engine):
    def surface(ns):
        plan = _with(PLANS["fan32"](ns), sim_buffer_packets=8.0, sim_buffer_policy="drop",
                     sim_telemetry=True, sim_telemetry_interval=4.0)
        rep = plan.simulate_timing(engine=engine)
        f = ns.fabric
        sw, ln = f.switch_pressure(rep), f.link_pressure(rep)
        keys = sorted(plan.topology.switches, key=str)
        return repr({
            "switch": sw, "link": ln, "norm_switch": f.normalized(sw),
            "norm_link": f.normalized(ln), "rank_hot": f.rank_hot(sw, f.measured_switch_pressure(rep)),
            "rank_hot_links": f.rank_hot(ln), "rank_cold": f.rank_cold(sw, keys),
            "hottest": f.hottest(sw), "hottest_link": f.hottest(ln),
            "measured": f.measured_switch_pressure(rep),
            "timeline": f.timeline_pressure(rep.timeline),
            "hot_switch": rep.hot_switch, "switch_drops": rep.switch_drops,
        })

    want, got = both(surface)
    assert got == want
    assert "'hottest': None" not in got


def test_rank_ties_and_empty_maps_match_jax():
    def ranks(ns):
        f = ns.fabric
        p = {"b": 1.0, "a": 1.0, 3: 2.0, "c": 0.0}
        return (f.rank_hot(p), f.rank_hot(p, {"a": 5.0}), f.rank_cold(p, ["z", "c", "a", 3]),
                f.hottest({}), f.normalized({}), f.normalized(p))

    want, got = both(ranks)
    assert got == want


@pytest.mark.parametrize("engine", ["event", "vectorized"])
def test_streamed_windows_match_jax(engine):
    def run(ns):
        rec = ns.stream.WindowRecorder()
        plan = _with(PLANS["shuffle4"](ns), sim_telemetry_window=32.0)
        rep = plan.simulate_timing(engine=engine, observers=[rec])
        return rep, rec

    (rep_w, want), (rep_g, got) = both(run)
    assert fields(rep_g) == fields(rep_w)
    assert len(got.windows) > 1
    assert [repr(dataclasses.asdict(w)) for w in got.windows] == \
        [repr(dataclasses.asdict(w)) for w in want.windows]
    assert got.nodes == want.nodes and got.makespan == want.makespan
    assert got.pressure() == want.pressure()


def test_stream_and_cost_model_reject_bad_widths_as_in_jax():
    for ns in NS.values():
        with pytest.raises(ValueError, match="window_ticks must be > 0"):
            ns.stream.WindowedStream([], window_ticks=0)
        for knob in ("sim_telemetry_interval", "sim_telemetry_window"):
            with pytest.raises(ValueError, match=f"CostModel.{knob} must be > 0"):
                ns.compiler.CostModel(**{knob: 0.0})


def test_cost_model_knobs_match_jax():
    want, got = both(lambda ns: ns.compiler.CostModel())
    w = {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    g = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)}
    # the reference's jax.jit step knob is the port's torch step knob
    assert w.pop("sim_use_jax") is False
    assert g.pop("sim_use_torch") is False
    assert repr(g) == repr(w)
    assert got.tick_s == want.tick_s


# ------------------------------------------------------ the torch step --
@pytest.mark.parametrize("case", ["fan16", "fan32", "shuffle4", "k4_cap", "chain1"])
def test_torch_step_matches_numpy_path_and_jax_step(case):
    jvec, tvec = NS["jax"].vectorized, NS["torch"].vectorized
    jplan, tplan = PLANS[case](NS["jax"]), PLANS[case](NS["torch"])
    numpy_rep = tvec.simulate_vectorized(tplan.program, tplan.flow_spec(), tplan.cost_model)
    tvec.STEPS["torch"] = 0
    params = dataclasses.replace(tvec.VoqParams.from_cost_model(tplan.cost_model),
                                 use_torch=True, device="cpu")
    step_rep = tvec.simulate_vectorized(tplan.program, tplan.flow_spec(), tplan.cost_model,
                                        params=params)
    assert tvec.STEPS["torch"] > 0  # the torch step ran, not the numpy path
    assert fields(step_rep) == fields(numpy_rep)
    jax_rep = jvec.simulate_vectorized(jplan.program, jplan.flow_spec(), jplan.cost_model,
                                       params=jvec.VoqParams(use_jax=True))
    assert step_rep.makespan_ticks == jax_rep.makespan_ticks
    assert step_rep.switch_busy_ticks == jax_rep.switch_busy_ticks


def test_torch_step_rides_the_cost_model_and_yields_to_port_caps(monkeypatch):
    """``sim_use_torch`` selects the step through ``plan.simulate_timing``:
    with no card it raises rather than run on the CPU. Under port caps, a
    finite buffer or fifo fidelity, where the reference's jax step leaves
    the work to numpy, the port raises instead of running numpy under the
    torch step's name; the same knobs without it still run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = PLANS["fan32"](NS["torch"])
    with pytest.raises(RuntimeError, match="CUDA.*device='cpu'"):
        _with(plan, sim_use_torch=True).simulate_timing()
    for knobs in ({"sim_port_bw": 0.5}, {"sim_buffer_packets": 8.0},
                  {"sim_fidelity": "fifo"}):
        other = _with(plan, **knobs)
        assert other.simulate_timing().makespan_ticks > 0
        with pytest.raises(ValueError, match="torch step.*only"):
            _with(other, sim_use_torch=True).simulate_timing()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fan32", "shuffle4", "k4_cap"])
def test_torch_step_on_the_card_matches_the_numpy_path(cuda, case):
    vec = NS["torch"].vectorized
    plan = PLANS[case](NS["torch"])
    numpy_rep = vec.simulate_vectorized(plan.program, plan.flow_spec(), plan.cost_model)
    vec.STEPS["torch"] = 0
    card_rep = vec.simulate_vectorized(
        plan.program, plan.flow_spec(), plan.cost_model,
        params=dataclasses.replace(vec.VoqParams.from_cost_model(plan.cost_model),
                                   use_torch=True))
    assert vec.STEPS["torch"] > 0
    assert card_rep.makespan_ticks == numpy_rep.makespan_ticks
    assert card_rep.switch_busy_ticks == numpy_rep.switch_busy_ticks
