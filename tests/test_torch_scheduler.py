"""The port's online multi-tenant scheduler (``repro_torch.p4mr.Scheduler``)
against the JAX package's.

The scheduler is host Python in both packages: admission against a
``FabricBudget``, contention-aware compiles, fleet reroutes and hot swaps,
all decided on simulator makespans whose ties ``heapq`` and dict order
break. So both packages run in this process and every ``ScheduleReport``
must be *equal* (``repr`` of every field: the merged ``SimReport``,
admissions, arrivals, finishes, solo makespans, hot swaps, anomalies and
SLO statuses), and so must the plans the session keeps. The two cells are
``BENCH_scheduler.json``'s (``benchmarks/bench_scheduler.py:44,72``); the
rest mirrors ``tests/test_scheduler.py`` and the monitored hot-swap case
of ``tests/test_streaming.py``.

The JAX package is imported on first use (``NS["jax"]``); nothing here
needs a device.
"""
import dataclasses
import importlib
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

_MODULES = {"compiler": "compiler", "simulator": "compiler.simulator", "topology": "core.topology",
            "p4mr": "p4mr", "anomaly": "telemetry.anomaly"}


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


def _tenant(ns, name, hosts, sink, vocab=64):
    job = ns.p4mr.job(name)
    keyed = [job.store(f"s{i}", host=h, items=vocab).key_by(4) for i, h in enumerate(hosts)]
    keyed[0].reduce("SUM", *keyed[1:], label="R").collect(sink, label="OUT")
    return job


def _pair(ns, vocab=64):
    """bench_scheduler.py's two-wordcount contention pair."""
    return (_tenant(ns, "tenant_a", [f"h{i}" for i in range(4)], "h15", vocab),
            _tenant(ns, "tenant_b", [f"h{i}" for i in range(4, 8)], "h12", vocab))


def report(rep, sess) -> tuple:
    """What two schedules must share: every field of the report, its
    summary, and the session's plans (``describe()`` without pass walls)."""
    plans = {n: re.sub(r" \(\d+us\)", "", p.describe()) for n, p in sess.plans.items()}
    return repr(dataclasses.asdict(rep)), rep.summary(), plans


# ----------------------------------------------------------------- cells --
def _two_wordcounts(ns):
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
    sched = ns.p4mr.Scheduler(sess, reroute_rounds=3)
    for job in _pair(ns):
        sched.submit(job, name=job.name)
    rep = sched.run()
    replay = sess.simulate(arrivals=rep.arrivals).combined.makespan_ticks
    return report(rep, sess), replay, rep, sess


def _staggered(ns):
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
    sched = ns.p4mr.Scheduler(sess, objective="deadline", reroute_rounds=2)
    sched.submit(_tenant(ns, "etl", [f"h{i}" for i in range(4)], "h15"), name="etl", at=0,
                 weight=1.0)
    sched.submit(_tenant(ns, "urgent", [f"h{i}" for i in range(4, 8)], "h12"), name="urgent",
                 at=30, deadline=150, weight=2.0)
    sched.submit(_tenant(ns, "batch", [f"h{i}" for i in range(8, 12)], "h0"), name="batch",
                 at=60, weight=0.5)
    rep = sched.run()
    return report(rep, sess), None, rep, sess


@pytest.mark.parametrize("cell", ["two_wordcounts", "staggered_arrivals"])
def test_bench_scheduler_cells_match_jax_exactly(cell):
    fn = {"two_wordcounts": _two_wordcounts, "staggered_arrivals": _staggered}[cell]
    (want, want_replay, _, jax_sess), (got, got_replay, rep, sess) = both(fn)
    assert got == want and got_replay == want_replay
    assert rep.makespan_ticks <= rep.unscheduled_makespan_ticks
    if cell == "two_wordcounts":
        assert rep.makespan_ticks < rep.unscheduled_makespan_ticks  # the acceptance bar
        assert got_replay == rep.makespan_ticks  # the session reproduces the schedule
    # each admitted plan on the torch backend (its fat-tree's integer view,
    # on the CPU) counts exactly what the JAX package's plan of that tenant
    # counts on its reference backend, and keeps the JAX plan's timing
    rs = np.random.RandomState(3)
    for name in rep.admitted:
        plan, jax_plan = sess.plans[name], jax_sess.plans[name]
        inputs = {s: rs.randint(0, 50, size=64).astype(np.float64)
                  for s in plan.program.sources()}
        got_run = plan.indexed().run(inputs, device="cpu")["OUT"]
        assert np.array_equal(got_run, jax_plan.run(inputs, backend="reference")["OUT"])
        assert (plan.indexed().simulate_timing().makespan_ticks
                == jax_plan.simulate_timing().makespan_ticks)


def test_two_wordcounts_at_the_chip_width_match_jax():
    """``chip_smoke.py``'s ``scheduler_two_tenants`` schedule: the same cell
    at a 50,000-word vocabulary."""
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
        sched = ns.p4mr.Scheduler(sess, reroute_rounds=3)
        for job in _pair(ns, vocab=50_000):
            sched.submit(job, name=job.name)
        rep = sched.run()
        return report(rep, sess), {n: p.simulate_timing().makespan_ticks
                                   for n, p in sess.plans.items()}

    want, got = both(run)
    assert got == want


# ------------------------------------------------ tests/test_scheduler.py --
def _late_arrival(ns):
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
    sched = ns.p4mr.Scheduler(sess)
    a, b = _pair(ns)
    sched.submit(a)
    sched.submit(b, at=500)
    return report(sched.run(), sess)


def _two_on_one_switch(ns, **kw):
    cm = kw.pop("cost_model", None)
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4), cost_model=cm)
    sched = ns.p4mr.Scheduler(sess, **kw)
    sched.submit(_tenant(ns, "a", [f"h{i}" for i in range(4)], "h15"))
    sched.submit(_tenant(ns, "b", [f"h{i}" for i in range(4)], "h15"))
    rep = sched.run()
    return report(rep, sess), rep.admitted, rep.rejected


def _memory_budget(ns):
    cm = dataclasses.replace(ns.compiler.CostModel(), switch_memory_bytes=700)
    return _two_on_one_switch(ns, cost_model=cm)


def _all_rejected(ns):
    sched = ns.p4mr.Scheduler(ns.p4mr.Session(ns.topology.fat_tree_topology(4)),
                              memory_headroom=1e-6)
    sched.submit(_tenant(ns, "a", [f"h{i}" for i in range(4)], "h15"))
    with pytest.raises(ValueError, match="no jobs admitted") as ei:
        sched.run()
    return str(ei.value)


def _submit_validation(ns):
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
    sched = ns.p4mr.Scheduler(sess)
    job = _tenant(ns, "a", [f"h{i}" for i in range(4)], "h15")
    sched.submit(job)
    msgs = []
    for kw in ({}, {"name": "b", "at": -1}, {"name": "b", "weight": 0},
               {"name": "b", "at": 10, "deadline": 10}):
        with pytest.raises(ValueError) as ei:
            sched.submit(job, **kw)
        msgs.append(str(ei.value))
    with pytest.raises(ValueError) as ei:
        ns.p4mr.Scheduler(sess, objective="fifo")
    msgs.append(str(ei.value))
    with pytest.raises(ValueError) as ei:
        ns.p4mr.Scheduler(sess).run()
    msgs.append(str(ei.value))
    for kw in ({"memory_headroom": 0}, {"load_cap": -1}):
        with pytest.raises(ValueError) as ei:
            ns.p4mr.FabricBudget(ns.compiler.CostModel(), **kw)
        msgs.append(str(ei.value))
    return msgs


def _deadline_edf(ns):
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
    sched = ns.p4mr.Scheduler(sess, objective="deadline", reroute_rounds=1)
    a, b = _pair(ns)
    sched.submit(a, deadline=10_000)
    sched.submit(b, deadline=120, weight=2.0)
    first = report(sched.run(), sess)
    sess2 = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
    sched2 = ns.p4mr.Scheduler(sess2, objective="deadline", reroute_rounds=0, retune_rounds=0)
    a2, b2 = _pair(ns)
    sched2.submit(a2)
    sched2.submit(b2, deadline=5)
    return first, report(sched2.run(), sess2)


def _hot_swap_drift(ns, retune_rounds):
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
    sched = ns.p4mr.Scheduler(sess, reroute_rounds=0, drift_threshold=0.0,
                              retune_rounds=retune_rounds)
    for job in _pair(ns):
        sched.submit(job)
    return report(sched.run(), sess)


def _monitored(ns, monitor):
    """``tests/test_streaming.py``'s monitored hot swap: a tight detector
    suite over the merged run steers the retunes (or, off, drift alone)."""
    sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4), cost_model=ns.compiler.CostModel(
        sim_telemetry_interval=4.0, sim_telemetry_window=16.0))
    kw = ({"detectors": lambda: ns.anomaly.default_detectors(queue_threshold=4.0)}
          if monitor else {"monitor": False})
    sched = ns.p4mr.Scheduler(sess, reroute_rounds=0, retune_rounds=1, **kw)
    sched.submit(_tenant(ns, "a", [f"h{i}" for i in range(4)], "h15"), name="a", deadline=400.0)
    sched.submit(_tenant(ns, "b", [f"h{i}" for i in range(4, 8)], "h12"), name="b", at=40.0)
    return report(sched.run(), sess)


CASES = {
    "late_arrival": _late_arrival,
    "memory_budget_rejects": _memory_budget,
    "load_cap_rejects": lambda ns: _two_on_one_switch(ns, load_cap=1.0),
    "all_rejected_raises": _all_rejected,
    "submit_validation": _submit_validation,
    "deadline_edf": _deadline_edf,
    "hot_swap_on_drift": lambda ns: _hot_swap_drift(ns, 2),
    "no_retune_no_swap": lambda ns: _hot_swap_drift(ns, 0),
    "monitored_hot_swap": lambda ns: _monitored(ns, True),
    "threshold_only_hot_swap": lambda ns: _monitored(ns, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_cases_match_jax(case):
    want, got = both(CASES[case])
    assert got == want
    if case == "memory_budget_rejects":
        assert got[1] == ["a"] and "reducer state" in got[2]["b"]
    if case == "load_cap_rejects":
        assert got[1] == ["a"] and "utilization cap" in got[2]["b"]
    if case == "monitored_hot_swap":
        assert "anomaly event(s)" in got[1]


@pytest.mark.parametrize("engine", ["event", "vectorized"])
def test_release_and_arrivals_match_jax(engine):
    """``tests/test_scheduler.py``'s release and arrival cases: staggered
    sources and session arrivals give the reference's reports."""
    def run(ns):
        sess = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
        pl = sess.compile(_tenant(ns, "a", [f"h{i}" for i in range(4)], "h15"))
        sim = lambda **kw: ns.simulator.simulate_timing(  # noqa: E731
            pl.program, pl.routes, sess.cost_model, engine=engine, **kw)
        reps = [sim(), sim(release={n: 40.0 for n in ("s0", "s1", "s2", "s3")}),
                sim(release={"s0": 40.0}), sim(release={"R": 500.0}),
                sim(release={"s0": 13.0, "s2": 29.0})]
        sess2 = ns.p4mr.Session(ns.topology.fat_tree_topology(4))
        for job in _pair(ns):
            sess2.compile(job)
        arrivals = [sess2.simulate(arrivals=a, engine=engine)
                    for a in (None, {"tenant_b": 500}, {"tenant_a": 0, "tenant_b": 0})]
        return ([repr(dataclasses.asdict(r)) for r in reps],
                [(repr(dataclasses.asdict(r.combined)), r.summary()) for r in arrivals])

    want, got = both(run)
    assert got == want
