"""The port's telemetry layer (metrics, anomaly detectors, SLO monitor, the
report dashboard and the ``Telemetry`` facade behind
``Session(telemetry=True)``) and its verify CLI, against the JAX package's.

All of it is host Python in both packages, so both run in this process
and every product must be *equal*: registry JSON, detector events
(``repr`` of every field), SLO statuses, the dashboard's text, the trace's
span names and attributes in order, and the CLI's exit codes and output.
The one thing two equal runs do not share is wall time: the pass and
compile wall histograms keep only their sample counts, and span times are
left out. The ``BENCH_telemetry.json`` cells (``benchmarks/bench_telemetry.py``)
are held to the reference too; the rest mirrors ``tests/test_telemetry.py``,
the anomaly/SLO half of ``tests/test_streaming.py`` and the telemetry and
CLI cases of ``tests/test_verify.py``.

The JAX package is imported on first use (``NS["jax"]``); nothing here
needs a device.
"""
import dataclasses
import importlib
import json
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

_MODULES = {"telemetry": "telemetry", "anomaly": "telemetry.anomaly", "slo": "telemetry.slo",
            "metrics": "telemetry.metrics", "report": "telemetry.report",
            "stream": "telemetry.stream", "compiler": "compiler", "simulator": "compiler.simulator",
            "topology": "core.topology", "wordcount": "core.wordcount", "p4mr": "p4mr",
            "cli": "verify.__main__"}


class _Packages(dict):
    """"jax" → the JAX package's modules, "torch" → the port's, each
    namespace imported when first asked for."""

    def __missing__(self, name):
        root = {"jax": "repro", "torch": "repro_torch"}[name]
        ns = self[name] = types.SimpleNamespace(**{
            k: importlib.import_module(f"{root}.{m}") for k, m in _MODULES.items()})
        ns.root = root
        return ns


NS = _Packages()


def both(fn):
    """``fn`` run on the JAX package and on the port: (want, got)."""
    return fn(NS["jax"]), fn(NS["torch"])


def events(evs) -> list[str]:
    """Every field of each ``AnomalyEvent``, exactly."""
    return [repr(dataclasses.asdict(e)) for e in evs]


def statuses(sts) -> list[str]:
    """Every field of each ``SloStatus`` and its verdicts, exactly."""
    return [repr((dataclasses.asdict(s), s.violated, s.margin_ticks)) for s in sts]


def registry(metrics) -> dict:
    """A registry's JSON, with each wall-time histogram cut to its count."""
    d = metrics.to_dict()
    d["histograms"] = {k: ({"count": v["count"]} if k.endswith("wall_us") else v)
                       for k, v in d["histograms"].items()}
    return d


def spans(tracer) -> list:
    """The tracer's spans (name and attributes but a pass's wall time, in
    order) and marks."""
    return ([(s.name, repr({k: v for k, v in s.attrs.items() if k != "wall_us"}))
             for s in tracer.spans], repr(tracer.marks))


# --------------------------------------------------------------- metrics --
def test_metrics_registry_json_matches_jax(tmp_path):
    def run(ns):
        reg = ns.metrics.MetricsRegistry()
        reg.counter("c").inc()
        reg.counter("c").inc(2)
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("c").inc(-1)
        reg.gauge("g").set(7)
        for v in (1.0, 2.0, 3.0, 10.0):
            reg.histogram("h").observe(v)
        reg.series("s").extend([0, 1, 2], [5.0, 6.0, 7.0])
        reg.table("t").add(("A", "B"), 3)
        reg.table("t").add(("A", "B"), 1)
        reg.table("t").add("other", 1)
        path = tmp_path / f"{ns.root}.json"
        reg.write(str(path))
        return reg.to_dict(), reg.table("t").top(1), path.read_text(), \
            ns.metrics.MetricsRegistry.load(str(path))

    want, got = both(run)
    assert got == want
    assert got[0]["counters"]["c"] == 3.0 and got[1] == [("('A', 'B')", 4.0)]


def _dashboard(ns):
    reg = ns.metrics.MetricsRegistry()
    reg.counter("session.compiles").inc()
    reg.histogram("pass.place.wall_us").observe(100.0)
    reg.histogram("pass.route.wall_us").observe(300.0)
    reg.table("fabric.port_packets").add("a→b", 12)
    reg.series("fabric.queue_depth").extend([0, 4, 8], [1.0, 9.0, 2.0])
    return reg


def _anomaly_slo_panel(ns):
    reg = ns.metrics.MetricsRegistry()
    reg.counter("anomaly.events").inc(3)
    reg.table("anomaly.by_kind").add("queue-growth", 2)
    reg.table("anomaly.by_kind").add("drop-spike", 1)
    reg.table("anomaly.by_switch").add("A1_1", 3)
    for lat in (64.0, 64.0, 32.0):
        reg.histogram("anomaly.detection_latency_ticks").observe(lat)
    reg.gauge("slo.heavy.margin_ticks").set(-120.0)
    reg.gauge("slo.burst.margin_ticks").set(35.0)
    reg.counter("slo.violations").inc()
    reg.table("slo.hot_switches").add("A1_1", 1)
    return reg


@pytest.mark.parametrize("panel", ["dashboard", "anomaly_slo"])
def test_report_dashboard_and_cli_match_jax(panel, tmp_path, capsys):
    """``report.render`` and ``python -m ... telemetry.report`` give the
    reference's text on ``tests/test_telemetry.py``'s registries."""
    def run(ns):
        reg = (_dashboard if panel == "dashboard" else _anomaly_slo_panel)(ns)
        path = tmp_path / f"{ns.root}.json"
        reg.write(str(path))
        rc = ns.report.main([str(path), "--top", "3"])
        return ns.report.render(reg.to_dict()), rc, capsys.readouterr().out

    want, got = both(run)
    assert got == want
    text = got[0]
    if panel == "dashboard":
        assert "per-pass compile time" in text and "peak 9 pkts" in text
    else:
        assert "== anomalies (3 events) ==" in text and "MISS" in text


@pytest.mark.parametrize("values,width", [([0, 1, 2, 3, 4, 5, 6, 7], 4), ([], 8),
                                           ([3.0] * 5, 10), ([1, 9, 2, 8, 3], 60)])
def test_sparkline_matches_jax(values, width):
    want, got = both(lambda ns: ns.report.sparkline(values, width=width))
    assert got == want


# --------------------------------------------------------------- anomaly --
def _win(ns, index, start, end, *, peak=None, mean=None, drops=None, blocked=None,
         served=None, port_peak=None, samples=1):
    """``tests/test_streaming.py``'s hand-built window."""
    return ns.stream.Window(
        index=index, start_tick=start, end_tick=end, engine="test", samples=samples,
        switch_depth_mean=mean or {}, switch_depth_peak=peak or {},
        port_depth_peak=port_peak or {}, port_drops=drops or {},
        port_blocked=blocked or {}, switch_served=served or {})


def _ewma(ns):
    det = ns.anomaly.EwmaDetector("drop-spike", lambda w: w.port_drops, ratio=4.0,
                                  min_value=1.0, switch_of=lambda p: p[0], port_of=lambda p: p)
    p = ("E0", "A0")
    drops = [1.0, 1.0, 1.0, 1.0, 20.0, 20.0, 1.0, 30.0]
    for i, d in enumerate(drops):
        det.on_window(_win(ns, i, i * 10.0, (i + 1) * 10.0, drops={p: d}))
    return det.events


def _ewma_seed(ns):
    det = ns.anomaly.EwmaDetector("drop-spike", lambda w: w.port_drops, ratio=4.0,
                                  min_value=1.0, port_of=lambda p: p)
    det.on_window(_win(ns, 0, 0.0, 10.0, drops={("E0", "A0"): 12.0}))
    return det.events


def _cusum(ns):
    det = ns.anomaly.CusumDetector("queue-growth", lambda w: w.switch_depth_peak,
                                   threshold=10.0, slack=1.0)
    for i, v in enumerate([5.0, 5.0, 10.0, 10.0, 10.0, 10.0]):
        det.on_window(_win(ns, i, i * 10.0, (i + 1) * 10.0, peak={"A": v}))
    return det.events


def _suite(ns):
    suite = ns.anomaly.DetectorSuite([
        ns.anomaly.CusumDetector("queue-growth", lambda w: w.switch_depth_peak,
                                 threshold=5.0, slack=0.0),
        ns.anomaly.EwmaDetector("drop-spike", lambda w: w.port_drops, ratio=2.0,
                                min_value=1.0, switch_of=lambda p: p[0], port_of=lambda p: p),
    ])
    seen = []
    suite.subscribe(seen.append)
    suite.on_window(_win(ns, 0, 0.0, 10.0, peak={"A": 2.0}))
    suite.on_window(_win(ns, 1, 10.0, 20.0, peak={"A": 10.0}, drops={("B", "C"): 6.0}))
    return suite.events + tuple(seen), suite.latency_by_kind()


def _collapse(ns, backlog):
    suite = ns.anomaly.default_detectors(collapse_ratio=0.5, min_backlog=2.0)
    det = next(d for d in suite.detectors if d.kind == "utilization-collapse")
    for i in range(3):
        det.on_window(_win(ns, i, i * 10.0, (i + 1) * 10.0, served={"A": 10.0}, peak={"A": 5.0}))
    det.on_window(_win(ns, 3, 30.0, 40.0, served={"A": 0.5}, peak={"A": backlog}))
    return det.events, sorted(d.kind for d in suite.detectors)


DETECTOR_CASES = {
    "ewma_rearms": lambda ns: events(_ewma(ns)),
    "ewma_seeds_at_zero": lambda ns: events(_ewma_seed(ns)),
    "cusum_onset": lambda ns: events(_cusum(ns)),
    "suite_order": lambda ns: (events(_suite(ns)[0]), _suite(ns)[1]),
    "collapse_idle": lambda ns: (events(_collapse(ns, 0.0)[0]), _collapse(ns, 0.0)[1]),
    "collapse_stuck": lambda ns: (events(_collapse(ns, 5.0)[0]), _collapse(ns, 5.0)[1]),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_detector_events_match_jax(case):
    want, got = both(DETECTOR_CASES[case])
    assert got == want
    if case == "ewma_rearms":
        assert len(got) == 2  # one event per excursion, re-armed once
    if case == "collapse_stuck":
        assert len(got[0]) == 1 and not both(DETECTOR_CASES["collapse_idle"])[1][0]


# ------------------------------------------------------------------- slo --
def _slo_finish(ns):
    mon = ns.slo.SloMonitor([
        ns.slo.SloTarget("a", deadline_ticks=50.0, sinks=("a/OUT1", "a/OUT2")),
        ns.slo.SloTarget("b", deadline_ticks=10.0, sinks=("b/OUT",)),
    ])
    mon.on_node("a/OUT1", 30.0)
    before = statuses([mon.status("a")])
    mon.on_node("unrelated", 35.0)
    mon.on_node("a/OUT2", 42.0)
    mon.on_finish(80.0)
    return before, statuses(mon.statuses().values()), [v.job for v in mon.violations()]


def _slo_risk(ns):
    mon = ns.slo.SloMonitor([ns.slo.SloTarget("a", deadline_ticks=100.0, sinks=("a/OUT",))])
    mon.on_window(_win(ns, 0, 0.0, 10.0, mean={"A": 2.0}, served={"A": 10.0}))
    green = statuses([mon.status("a")])
    mon.on_window(_win(ns, 1, 10.0, 20.0, mean={"A": 90.0, "B": 5.0}, served={"A": 1.0}))
    red, pressure = statuses([mon.status("a")]), mon.pressure()
    mon.on_node("a/OUT", 60.0)
    mon.on_finish(60.0)
    return green, red, pressure, statuses([mon.status("a")])


def _slo_duplicate(ns):
    with pytest.raises(ValueError, match="duplicate") as ei:
        ns.slo.SloMonitor([ns.slo.SloTarget("a", sinks=("a/OUT",)),
                           ns.slo.SloTarget("a", sinks=("a/X",))])
    return str(ei.value)


@pytest.mark.parametrize("case", ["finish_via_sinks", "projected_risk", "duplicate"])
def test_slo_statuses_match_jax(case):
    fn = {"finish_via_sinks": _slo_finish, "projected_risk": _slo_risk,
          "duplicate": _slo_duplicate}[case]
    want, got = both(fn)
    assert got == want
    if case == "finish_via_sinks":
        assert got[2] == ["b"]


# ------------------------------------------------------------ the facade --
def test_telemetry_of_and_records_match_jax():
    """``Telemetry.of`` coerces as the reference's; ``record_anomalies``
    and ``record_slo`` fold the same events and statuses into the same
    registry."""
    def run(ns):
        T = ns.telemetry.Telemetry
        assert T.of(None) is None and T.of(False) is None
        t = T.of(True)
        assert isinstance(t, T) and T.of(t) is t
        with pytest.raises(TypeError):
            T.of("yes")
        t.record_anomalies([*_ewma(ns), *_cusum(ns), *_suite(ns)[0]])
        mon = ns.slo.SloMonitor([ns.slo.SloTarget("a", deadline_ticks=100.0, sinks=("a/OUT",)),
                                 ns.slo.SloTarget("b", deadline_ticks=5.0, sinks=("b/OUT",))])
        mon.on_window(_win(ns, 1, 10.0, 20.0, mean={"A": 90.0, "B": 5.0}, served={"A": 1.0}))
        mon.on_finish(60.0)
        t.record_slo(mon.statuses().values())
        ns.anomaly.export_to_tracer(t.tracer, _cusum(ns), [_win(ns, 0, 0.0, 10.0, peak={"A": 3.0})])
        return registry(t.metrics), repr(t.tracer.marks), ns.report.render(t.metrics.to_dict())

    want, got = both(run)
    assert got == want
    assert got[0]["counters"]["anomaly.events"] > 0 and "slo.violations" in got[0]["counters"]


def _shuffle_program(ns):
    return ns.wordcount.wordcount_shuffle_program(
        4, 64, num_buckets=4, weights=(4.0, 1.0, 1.0, 1.0),
        hosts=[f"h{i}" for i in range(4)], sink_host="h15")


def test_session_telemetry_surface_matches_jax(tmp_path):
    """``tests/test_telemetry.py``'s end-to-end case: a ``Session`` with
    telemetry on, the ``autotuned`` preset and fabric telemetry compiles
    and simulates; its spans (every pass, tuning round and evaluation, the
    session calls), registry and timeline equal the reference's, and the
    written trace is valid Chrome-trace JSON."""
    def run(ns):
        cm = ns.compiler.CostModel(sim_telemetry=True, sim_telemetry_interval=8.0)
        sess = ns.p4mr.Session(
            ns.topology.fat_tree_topology(4), cost_model=cm, telemetry=True,
            options=ns.p4mr.CompileOptions(preset="autotuned", autotune_rounds=1))
        plan = sess.compile(_shuffle_program(ns), name="wc")
        rep = sess.simulate()
        trace = sess.telemetry.tracer.to_chrome_trace()
        assert ns.telemetry.validate_chrome_trace(trace) == []
        sess.telemetry.write_trace(str(tmp_path / f"{ns.root}.trace.json"))
        sess.telemetry.write_metrics(str(tmp_path / f"{ns.root}.metrics.json"))
        with open(tmp_path / f"{ns.root}.trace.json") as f:
            assert ns.telemetry.validate_chrome_trace(json.load(f)) == []
        tl = rep.combined.timeline
        return (spans(sess.telemetry.tracer), registry(sess.telemetry.metrics),
                json.dumps(plan.tuning.to_dict()), repr(dataclasses.asdict(rep.combined)),
                sum(tl.port_packets.values()), sorted({r.name for r in plan.pass_records}))

    want, got = both(run)
    assert got == want
    names = [n for n, _ in got[0][0]]
    assert {f"pass:{p}" for p in got[5]} <= set(names)
    assert any(n.startswith("tune:round-") for n in names)
    assert "session.compile" in names and "session.simulate" in names
    md = got[1]
    assert md["counters"]["session.compiles"] == 1.0 and md["counters"]["tune.rounds"] >= 1.0


@pytest.mark.parametrize("call", ["compile_best", "arbitrate_buckets", "verify", "simulate_observed",
                                  "shared_telemetry"])
def test_session_hooks_match_jax(call):
    """Each traced ``Session`` call opens the reference's span and feeds
    the reference's registry; detector suites and an ``SloMonitor`` ride
    ``Session.simulate`` as observers; one ``Telemetry`` shared by two
    sessions collects both."""
    def run(ns):
        topo = ns.topology.fat_tree_topology(4)
        sess = ns.p4mr.Session(topo, telemetry=True)
        out = None
        if call == "compile_best":
            sess.compile_best(_shuffle_program(ns), name="wc", objective="streamed")
        elif call == "arbitrate_buckets":
            sess.arbitrate_buckets(
                lambda b: ns.wordcount.wordcount_shuffle_program(
                    4, 64, num_buckets=b, hosts=[f"h{i}" for i in range(4)], sink_host="h15"),
                [1, 2, 4], name="wc")
        elif call == "verify":
            sess.compile(_shuffle_program(ns), name="wc")
            out = repr({k: [d.format() for d in v] for k, v in sess.verify().items()})
        elif call == "simulate_observed":
            sess = ns.p4mr.Session(topo, telemetry=True, cost_model=ns.compiler.CostModel(
                sim_telemetry_interval=4.0, sim_telemetry_window=16.0))
            sess.compile(_shuffle_program(ns), name="wc")
            suite = ns.anomaly.default_detectors(queue_threshold=4.0)
            mon = ns.slo.SloMonitor([ns.slo.SloTarget("wc", deadline_ticks=60.0,
                                                      sinks=("wc/OUT",))])
            rep = sess.simulate(observers=[suite, mon])
            sess.telemetry.record_anomalies(suite.events)
            sess.telemetry.record_slo(mon.statuses().values())
            out = (events(suite.events), statuses(mon.statuses().values()),
                   rep.combined.makespan_ticks)
        else:
            shared = ns.telemetry.Telemetry()
            for name in ("a", "b"):
                s = ns.p4mr.Session(topo, telemetry=shared)
                s.compile(_shuffle_program(ns), name=name)
            sess = types.SimpleNamespace(telemetry=shared)
        return spans(sess.telemetry.tracer), registry(sess.telemetry.metrics), out

    want, got = both(run)
    assert got == want
    assert got[0][0], "no span was recorded"


def test_telemetry_off_pays_nothing_as_in_jax():
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
        sess.compile(_shuffle_program(ns), name="wc")
        rep = sess.simulate()
        return sess.telemetry, rep.combined.timeline, repr(dataclasses.asdict(rep.combined))

    want, got = both(run)
    assert got == want and got[0] is None and got[1] is None


# ------------------------------------------------- BENCH_telemetry cells --
def _tenant(ns, name, hosts, sink, vocab):
    job = ns.p4mr.job(name)
    keyed = [job.store(f"s{i}", host=h, items=vocab).key_by(4) for i, h in enumerate(hosts)]
    keyed[0].reduce("SUM", *keyed[1:], label="R").collect(sink, label="OUT")
    return job


def _bench_cost(ns):
    return ns.compiler.CostModel(sim_telemetry_interval=8.0, sim_telemetry_window=32.0)


def _overhead_off(ns):
    """bench_telemetry.py's overhead_off cell: plain vs observed runs of
    the heavy plan on the vectorized engine."""
    cm = _bench_cost(ns)
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4), cost_model=cm)
    pl = sess.compile(_tenant(ns, "heavy", [f"h{i}" for i in range(8)], "h15", 512))
    spec = pl.flow_spec()
    plain = ns.simulator.simulate_timing(pl.program, pl.routes, cm, engine="vectorized", spec=spec)
    rec, suite = ns.stream.WindowRecorder(), ns.anomaly.default_detectors()
    mon = ns.slo.SloMonitor([ns.slo.SloTarget("heavy", deadline_ticks=2000.0, sinks=("OUT",))])
    observed = ns.simulator.simulate_timing(pl.program, pl.routes, cm, engine="vectorized",
                                            spec=spec, observers=[rec, suite, mon])
    return (plain.makespan_ticks, observed.makespan_ticks,
            repr([dataclasses.asdict(w) for w in rec.windows]), rec.makespan,
            events(suite.events), statuses(mon.statuses().values()))


def _bursty(ns, monitor):
    """bench_telemetry.py's bursty pair: a burst tenant lands at tick 200
    on the heavy tenant's fabric, scheduled with the monitor on or off."""
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4), cost_model=_bench_cost(ns))
    sched = ns.p4mr.Scheduler(sess, reroute_rounds=0, retune_rounds=2, monitor=monitor)
    sched.submit(_tenant(ns, "heavy", [f"h{i}" for i in range(8)], "h15", 512),
                 name="heavy", deadline=1500)
    sched.submit(_tenant(ns, "burst", [f"h{i}" for i in range(8, 12)], "h14", 64),
                 name="burst", at=200)
    rep = sched.run()
    return repr(dataclasses.asdict(rep)), rep.summary()


@pytest.mark.parametrize("cell", ["overhead_off", "bursty_detect", "bursty_threshold_only"])
def test_bench_telemetry_cells_match_jax(cell):
    """Makespans, windows, detector events and SLO statuses of the
    overhead cell; the whole ``ScheduleReport`` (anomalies, SLO statuses,
    hot swaps) of the bursty pair with the monitor on and off."""
    fn = {"overhead_off": _overhead_off,
          "bursty_detect": lambda ns: _bursty(ns, True),
          "bursty_threshold_only": lambda ns: _bursty(ns, False)}[cell]
    want, got = both(fn)
    assert got == want
    if cell == "overhead_off":
        assert got[0] == got[1]  # observers are read-only
    elif cell == "bursty_detect":
        assert "anomaly event(s)" in got[1]


# ------------------------------------------------------------ verify CLI --
def _cli_args(case, tmp_path):
    if case == "paper_fig2":
        return [str(EXAMPLES / "paper_fig2.p4mr")]
    if case == "missing_file":
        return [str(EXAMPLES / "no_such.p4mr")]
    if case == "broken_program":
        src = tmp_path / "broken.p4mr"
        src.write_text('A := store<uint_64>("ip_h9:x");\nB := SUM(A);\n')
        return [str(src)]
    if case == "syntax_error":
        src = tmp_path / "syntax.p4mr"
        src.write_text('A := store<uint_64>("ip_h1:x"\n')
        return [str(src)]
    if case == "profile_all_examples":
        return [str(p) for p in sorted(EXAMPLES.glob("*.p4mr"))] + ["--profile", "tofino_like"]
    if case == "scenarios":
        return ["--scenarios", "--world", "6"]
    return [str(EXAMPLES / "shuffle_sum.p4mr"), "--topology", "fat_tree:4"]


@pytest.mark.parametrize("case", ["paper_fig2", "missing_file", "broken_program", "syntax_error",
                                  "profile_all_examples", "scenarios", "fat_tree"])
def test_verify_cli_matches_jax(case, tmp_path, capsys):
    """``python -m repro_torch.verify``'s ``main`` gives the reference's
    exit code and output (diagnostic codes included) on the cases of
    ``tests/test_verify.py`` and a few more."""
    args = _cli_args(case, tmp_path)

    def run(ns):
        rc = ns.cli.main(args)
        return rc, capsys.readouterr().out

    want, got = both(run)
    assert got == want
    rc, out = got
    if case == "paper_fig2":
        assert rc == 0 and "clean" in out
    if case in ("missing_file", "broken_program", "syntax_error"):
        assert rc == 1 and "FAIL" in out
    if case == "broken_program":
        assert "V110" in out


def test_verify_cli_usage_error_matches_jax(capsys):
    def run(ns):
        with pytest.raises(SystemExit) as ei:
            ns.cli.main([])
        # the usage lines wrap at the program's name; the error line does not
        return ei.value.code, capsys.readouterr().err.splitlines()[-1].split(": ", 1)[1]

    want, got = both(run)
    assert got == want and got[0] == 2


def test_telemetry_counts_verify_runs_and_diagnostics_as_in_jax():
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.paper_topology(), telemetry=True)
        sess.compile(EXAMPLES.joinpath("paper_fig2.p4mr").read_text(), name="paper")
        m = sess.telemetry.metrics
        return m.counter("verify.runs").value, m.counter("verify.diagnostics").value

    want, got = both(run)
    assert got == want == (1, 0)
