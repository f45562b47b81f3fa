"""repro_torch.telemetry — one observability layer over the whole stack.

Three surfaces, one package (after the P4 INT literature):

* **fabric telemetry** (``fabric``): INT-style per-flow per-hop records
  and tick-sampled per-port series from both simulator engines, behind
  ``CostModel.sim_telemetry`` → ``SimReport.timeline``;
* **trace spans** (``trace``): a ``Tracer`` threaded ambiently through
  ``PassManager``, ``autotune.hill_climb``, ``Session`` and
  ``plan.run``, exported as Chrome trace-event JSON (Perfetto);
* **metrics** (``metrics``): a session-scoped registry of counters /
  gauges / histograms / series / tables with JSON export and the
  ``python -m repro_torch.telemetry.report`` text dashboard.

``Telemetry`` bundles a tracer + registry; ``Session(telemetry=True)``
owns one and feeds it from every compile/tune/simulate. The same
measurement surface the optimizers consume (``fabric.switch_pressure``
/ ``link_pressure`` / ``rank_hot``) is what users inspect — there is no
second, private set of peak dicts.

    sess = p4mr.Session(topo, cost_model=CostModel(sim_telemetry=True),
                        telemetry=True)
    sess.compile(job); rep = sess.simulate()
    rep.combined.timeline            # INT records + sampled series
    sess.telemetry.write_trace("trace.json")      # → Perfetto
    sess.telemetry.write_metrics("metrics.json")  # → report CLI
"""
from __future__ import annotations

from typing import Any

from repro_torch.telemetry.anomaly import (
    AnomalyEvent,
    CusumDetector,
    DetectorSuite,
    EwmaDetector,
    attribute_flows,
    default_detectors,
    export_to_tracer,
)
from repro_torch.telemetry.fabric import (
    EventCollector,
    HopRecord,
    Timeline,
    VoqCollector,
    hottest,
    link_pressure,
    measured_switch_pressure,
    normalized,
    rank_cold,
    rank_hot,
    switch_pressure,
    timeline_pressure,
    verify_timeline,
)
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.slo import SloMonitor, SloStatus, SloTarget
from repro_torch.telemetry.stream import Window, WindowedStream, WindowRecorder
from repro_torch.telemetry.trace import (
    Span,
    Tracer,
    activate,
    current_tracer,
    maybe_span,
    validate_chrome_trace,
)


class Telemetry:
    """A tracer + metrics registry, the unit a ``Session`` owns.

    ``activate()`` installs the tracer ambiently (``trace.activate``) so
    pass/tune/plan spans land here; the ``record_*`` helpers translate
    compiler and simulator artifacts into registry updates, keeping the
    call sites one line each.
    """

    def __init__(self, *, tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None):
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    @classmethod
    def of(cls, value: "Telemetry | bool | None") -> "Telemetry | None":
        """Coerce a ``Session(telemetry=...)`` argument: ``True`` builds a
        fresh bundle, ``None``/``False`` disables, an instance is shared
        (e.g. several sessions writing one trace)."""
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        raise TypeError(
            f"expected Telemetry, bool or None, got {type(value).__name__}"
        )

    def activate(self):
        """Context manager making ``self.tracer`` the ambient tracer for
        the block (``trace.activate``), so instrumented call sites land
        their spans here."""
        return activate(self.tracer)

    # ------------------------------------------------------------ feeding --
    def record_compile(self, plan, *, name: str | None = None) -> None:
        """Fold one compile's pass records + tuning report into metrics."""
        m = self.metrics
        m.counter("session.compiles").inc()
        total_us = 0.0
        for rec in getattr(plan, "pass_records", ()):
            m.histogram(f"pass.{rec.name}.wall_us").observe(rec.wall_us)
            total_us += rec.wall_us
        if total_us:
            m.histogram("compile.wall_us").observe(total_us)
        tuning = getattr(plan, "tuning", None)
        if tuning is not None:
            m.counter("tune.cache_hits").inc(tuning.cache_hits)
            m.counter("tune.cache_misses").inc(tuning.cache_misses)
            m.counter("tune.rounds").inc(tuning.rounds_run)
            m.counter("tune.accepted").inc(
                sum(1 for a in tuning.actions if a.accepted)
            )
            if getattr(tuning, "verify_rejections", 0):
                m.counter("verify.rejections").inc(tuning.verify_rejections)
        diags = getattr(plan, "diagnostics", None)
        if diags is not None:
            # None = the verify pass never ran; () = ran, found nothing
            m.counter("verify.runs").inc()
            if diags:
                m.counter("verify.diagnostics").inc(len(diags))
                by_code = m.table("verify.by_code")
                for d in diags:
                    by_code.add(d.code, 1)

    def record_simulation(self, report, *, label: str = "combined") -> None:
        """Fold one ``SimReport`` (+ its timeline, if fabric telemetry
        was on) into metrics."""
        m = self.metrics
        m.counter("session.simulations").inc()
        m.gauge(f"fabric.{label}.makespan_ticks").set(report.makespan_ticks)
        m.gauge(f"fabric.{label}.queue_delay_ticks").set(report.queue_delay_ticks)
        if report.dropped_packets:
            m.counter("fabric.dropped_packets").inc(report.dropped_packets)
        queued = m.table("fabric.switch_queued")
        for sw, v in report.queued_batches.items():
            queued.add(sw, v)
        tl = getattr(report, "timeline", None)
        if tl is not None:
            ports = m.table("fabric.port_packets")
            for port, pk in tl.port_packets.items():
                ports.add(f"{port[0]}→{port[1]}", pk)
            m.series("fabric.queue_depth").extend(tl.ticks, tl.total_depth_series())

    def record_anomalies(self, events) -> None:
        """Fold detector output (``anomaly.AnomalyEvent``s) into metrics:
        event count, per-kind and per-switch tables, and the
        detection-latency distribution the bench gates on."""
        m = self.metrics
        by_kind = m.table("anomaly.by_kind")
        by_switch = m.table("anomaly.by_switch")
        lat = m.histogram("anomaly.detection_latency_ticks")
        for ev in events:
            m.counter("anomaly.events").inc()
            by_kind.add(ev.kind, 1)
            by_switch.add(str(ev.switch), 1)
            lat.observe(ev.detection_latency_ticks)

    def record_slo(self, statuses) -> None:
        """Fold SLO monitor output (``slo.SloStatus``es) into metrics:
        per-job margin gauges, the violation count, and the blamed hot
        switches behind at-risk jobs."""
        m = self.metrics
        hot = m.table("slo.hot_switches")
        for st in statuses:
            margin = st.margin_ticks
            if margin is not None:
                m.gauge(f"slo.{st.job}.margin_ticks").set(margin)
            if st.violated:
                m.counter("slo.violations").inc()
            if st.at_risk:
                for sw in st.hot_switches:
                    hot.add(str(sw), 1)

    # ------------------------------------------------------------- export --
    def write_trace(self, path: str) -> None:
        """Write the collected spans as Chrome trace-event JSON (load in
        Perfetto or ``chrome://tracing``)."""
        self.tracer.write(path)

    def write_metrics(self, path: str) -> None:
        """Write the metrics registry as JSON for the
        ``python -m repro_torch.telemetry.report`` dashboard."""
        self.metrics.write(path)


__all__ = [
    "AnomalyEvent",
    "CusumDetector",
    "DetectorSuite",
    "EventCollector",
    "EwmaDetector",
    "HopRecord",
    "MetricsRegistry",
    "SloMonitor",
    "SloStatus",
    "SloTarget",
    "Span",
    "Telemetry",
    "Timeline",
    "Tracer",
    "VoqCollector",
    "Window",
    "WindowRecorder",
    "WindowedStream",
    "activate",
    "attribute_flows",
    "current_tracer",
    "default_detectors",
    "export_to_tracer",
    "hottest",
    "link_pressure",
    "maybe_span",
    "measured_switch_pressure",
    "normalized",
    "rank_cold",
    "rank_hot",
    "switch_pressure",
    "timeline_pressure",
    "validate_chrome_trace",
    "verify_timeline",
]
