"""Telemetry for the port: fabric telemetry, streaming windows and trace spans.

* ``fabric``: INT-style per-flow per-hop records and tick-sampled per-port
  series from both simulator engines, behind ``CostModel.sim_telemetry``
  → ``SimReport.timeline``; and the one pressure/ranking surface
  (``switch_pressure`` / ``link_pressure`` / ``rank_hot`` / ``hottest``)
  that ``reroute-feedback``, the seeded ``route`` and ``SimReport.hot_switch``
  read;
* ``stream``: windowed aggregates pushed to observers while a simulation
  runs (``simulate_timing(..., observers=[...])``);
* ``trace``: the ambient ``Tracer`` — compile passes (``pass:<name>``),
  the verifier (``verify.plan``), ``plan.run`` and ``plan.simulate_timing``
  open spans on the tracer ``activate()`` installs, written as
  Chrome-trace JSON.

The reference's metrics, anomaly, SLO and report modules and its
``Telemetry`` facade are not ported yet (ROADMAP.md, queue 1 item 7).
"""
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
from repro_torch.telemetry.stream import Window, WindowedStream, WindowRecorder
from repro_torch.telemetry.trace import (
    Span,
    Tracer,
    activate,
    current_tracer,
    maybe_span,
    validate_chrome_trace,
)

__all__ = [
    "EventCollector",
    "HopRecord",
    "Span",
    "Timeline",
    "Tracer",
    "VoqCollector",
    "Window",
    "WindowRecorder",
    "WindowedStream",
    "activate",
    "current_tracer",
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
