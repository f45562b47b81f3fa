"""Anomaly detection over streaming fabric windows (EWMA + CUSUM).

Consumes the ``repro_torch.telemetry.stream`` window feed and emits typed
``AnomalyEvent``s *while the simulation runs* — the "outputs of
monitoring change subsequent behavior" loop the data-plane-telemetry
literature asks for, and what ``p4mr.Scheduler``'s monitored hot-swap
phase subscribes to.

Two detector families, both O(keys) per window:

* ``EwmaDetector`` — an exponentially-weighted baseline per key; an
  excursion opens when the value exceeds ``max(baseline · ratio + slack,
  min_value)`` and one event is emitted at the window that opens it.
  Catches *spikes* (drops, blocked-tick bursts).
* ``CusumDetector`` — a one-sided cumulative sum of ``value − baseline −
  slack`` per key; an event fires when the sum crosses ``threshold``,
  with the onset pinned at the window where the sum first left zero.
  Catches *slow growth* a spike test misses (queue-depth creep), and its
  onset can predate detection by several windows — that gap is the
  ``detection_latency_ticks`` the bench reports.

Four stock detectors (``default_detectors()``), one per failure mode the
VOQ fabric model exhibits:

====================  ========  ==============================================
kind                  family    signal (per window)
====================  ========  ==============================================
queue-growth          cusum     per-switch peak queue depth
drop-spike            ewma      per-port dropped-packet delta
hol-blocking          ewma      per-port backpressure-blocked-tick delta
utilization-collapse  ewma      per-switch service utilization, inverted:
                                fires when a switch with standing backlog
                                serves well under its own baseline rate
====================  ========  ==============================================
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Hashable, Iterable, Mapping, Sequence

from repro_torch.telemetry.stream import Window

NodeId = Hashable
Port = tuple[NodeId, NodeId]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class AnomalyEvent:
    """One detected anomaly, attributed to a switch (and port, when the
    signal is per-port) with its onset and detection ticks.

    ``onset_tick`` is where the excursion *began* (CUSUM pins it at the
    start of the positive-drift run, which can be windows before the
    alarm); ``detect_tick`` is the close of the window that raised it.
    ``severity`` is value/threshold — ≥ 1.0 by construction, comparable
    across kinds.
    """

    kind: str  # "queue-growth" | "drop-spike" | "hol-blocking" | ...
    detector: str  # "ewma" | "cusum"
    switch: NodeId
    port: Port | None
    onset_tick: float
    detect_tick: float
    value: float
    threshold: float
    severity: float
    window_index: int

    @property
    def detection_latency_ticks(self) -> float:
        """Ticks between excursion onset and event emission — the
        number the bench cell gates per detector."""
        return self.detect_tick - self.onset_tick

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "detector": self.detector,
            "switch": str(self.switch),
            "port": None if self.port is None else f"{self.port[0]}→{self.port[1]}",
            "onset_tick": self.onset_tick,
            "detect_tick": self.detect_tick,
            "detection_latency_ticks": self.detection_latency_ticks,
            "value": self.value,
            "threshold": self.threshold,
            "severity": self.severity,
            "window_index": self.window_index,
        }


@dataclasses.dataclass
class _KeyState:
    baseline: float | None = None  # EWMA of the signal (None = unseeded)
    cusum: float = 0.0
    onset: float | None = None  # start tick of the open excursion/drift run
    alarmed: bool = False  # one event per excursion


class _DetectorBase:
    """Shared per-key state machine; subclasses decide when to alarm."""

    family = "base"

    def __init__(
        self,
        kind: str,
        signal: Callable[[Window], Mapping[Any, float]],
        *,
        switch_of: Callable[[Any], NodeId] | None = None,
        port_of: Callable[[Any], Port | None] | None = None,
        alpha: float = 0.3,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.kind = kind
        self.signal = signal
        self.alpha = float(alpha)
        self._switch_of = switch_of or (lambda k: k)
        self._port_of = port_of or (lambda k: None)
        self._state: dict[Any, _KeyState] = {}
        self.events: list[AnomalyEvent] = []

    def on_window(self, window: Window) -> None:
        for key, value in self.signal(window).items():
            st = self._state.setdefault(key, _KeyState())
            self._step(key, st, float(value), window)

    def _emit(self, key: Any, st: _KeyState, value: float,
              threshold: float, window: Window) -> None:
        onset = st.onset if st.onset is not None else window.start_tick
        self.events.append(
            AnomalyEvent(
                kind=self.kind,
                detector=self.family,
                switch=self._switch_of(key),
                port=self._port_of(key),
                onset_tick=onset,
                detect_tick=window.end_tick,
                value=round(value, 6),
                threshold=round(threshold, 6),
                severity=round(value / max(threshold, _EPS), 3),
                window_index=window.index,
            )
        )

    def _step(self, key, st, value, window):  # pragma: no cover - abstract
        raise NotImplementedError


class EwmaDetector(_DetectorBase):
    """Spike detector: value vs its own EWMA baseline.

    The baseline updates only on non-anomalous windows, so a sustained
    excursion does not teach the detector that the anomaly is normal;
    the excursion closes (and re-arms) when the value returns under the
    threshold. ``invert=True`` flips the test — fires when the value
    *collapses* below ``baseline · ratio`` — with ``guard`` gating on a
    second signal (e.g. "only while backlog is standing").
    """

    family = "ewma"

    def __init__(
        self,
        kind: str,
        signal: Callable[[Window], Mapping[Any, float]],
        *,
        ratio: float = 4.0,
        slack: float = 0.0,
        min_value: float = 1.0,
        invert: bool = False,
        guard: Callable[[Window, Any], bool] | None = None,
        **kw: Any,
    ):
        super().__init__(kind, signal, **kw)
        if ratio <= 0:
            raise ValueError(f"ratio must be > 0, got {ratio}")
        self.ratio = float(ratio)
        self.slack = float(slack)
        self.min_value = float(min_value)
        self.invert = invert
        self.guard = guard

    def _step(self, key: Any, st: _KeyState, value: float, window: Window) -> None:
        if st.baseline is None:
            # spike signals are sparse (a port appears the first window it
            # drops): seed at zero so a first-window burst still alarms
            # against min_value instead of teaching itself the burst
            st.baseline = 0.0
        if self.invert:
            threshold = st.baseline * self.ratio - self.slack
            anomalous = (
                st.baseline >= self.min_value
                and value < threshold
                and (self.guard is None or self.guard(window, key))
            )
            score_v, score_t = max(threshold, _EPS), max(value, _EPS)
        else:
            threshold = max(st.baseline * self.ratio + self.slack, self.min_value)
            anomalous = value > threshold
            score_v, score_t = value, threshold
        if anomalous:
            if st.onset is None:
                st.onset = window.start_tick
            if not st.alarmed:
                st.alarmed = True
                self._emit(key, st, score_v, score_t, window)
        else:
            st.onset = None
            st.alarmed = False
            st.baseline += self.alpha * (value - st.baseline)


class CusumDetector(_DetectorBase):
    """Drift detector: one-sided CUSUM of ``value − baseline − slack``.

    The positive sum accumulates while the signal runs hot; crossing
    ``threshold`` raises one event whose onset is the window the sum
    left zero, then the sum resets and stays quiet until the drift run
    actually ends (sum drains back to zero) — no alarm storms from one
    sustained excursion.
    """

    family = "cusum"

    def __init__(
        self,
        kind: str,
        signal: Callable[[Window], Mapping[Any, float]],
        *,
        threshold: float = 32.0,
        slack: float = 1.0,
        alpha: float = 0.1,
        **kw: Any,
    ):
        super().__init__(kind, signal, alpha=alpha, **kw)
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.threshold = float(threshold)
        self.slack = float(slack)

    def _step(self, key: Any, st: _KeyState, value: float, window: Window) -> None:
        if st.baseline is None:
            st.baseline = value
            return
        drift = value - st.baseline - self.slack
        prev = st.cusum
        st.cusum = max(0.0, st.cusum + drift)
        if st.cusum > _EPS and prev <= _EPS:
            st.onset = window.start_tick  # drift run opens here
        if st.cusum <= _EPS:
            st.onset = None
            st.alarmed = False
            st.baseline += self.alpha * (value - st.baseline)
        elif st.cusum > self.threshold and not st.alarmed:
            st.alarmed = True
            self._emit(key, st, st.cusum, self.threshold, window)
            st.cusum = 0.0


class DetectorSuite:
    """One stream observer fanning windows into several detectors.

    ``events`` merges every detector's emissions in (detect, onset) tick
    order; ``subscribe(callback)`` additionally delivers each event the
    moment its window closes — mid-run, which is the hook the scheduler
    uses to react at onset rather than at end of run.
    """

    def __init__(self, detectors: Sequence[_DetectorBase]):
        self.detectors = list(detectors)
        self._callbacks: list[Callable[[AnomalyEvent], None]] = []

    def subscribe(self, callback: Callable[[AnomalyEvent], None]) -> None:
        self._callbacks.append(callback)

    def on_window(self, window: Window) -> None:
        for det in self.detectors:
            before = len(det.events)
            det.on_window(window)
            for ev in det.events[before:]:
                for cb in self._callbacks:
                    cb(ev)

    @property
    def events(self) -> tuple[AnomalyEvent, ...]:
        merged = [ev for det in self.detectors for ev in det.events]
        merged.sort(key=lambda e: (e.detect_tick, e.onset_tick, e.kind, str(e.switch)))
        return tuple(merged)

    def latency_by_kind(self) -> dict[str, float]:
        """Worst detection latency (ticks) per anomaly kind — the
        per-detector number ``BENCH_telemetry.json`` reports."""
        out: dict[str, float] = {}
        for ev in self.events:
            lat = ev.detection_latency_ticks
            if lat > out.get(ev.kind, -1.0):
                out[ev.kind] = lat
        return out


def default_detectors(
    *,
    queue_threshold: float = 48.0,
    drop_ratio: float = 4.0,
    blocked_ratio: float = 4.0,
    collapse_ratio: float = 0.25,
    min_backlog: float = 4.0,
) -> DetectorSuite:
    """The stock suite: one detector per fabric failure mode, with
    thresholds scaled for packet-granularity fabrics (override per
    deployment)."""

    def backlog_guard(window: Window, key: Any) -> bool:
        # a quiet switch with nothing queued is idle, not collapsed
        return window.switch_depth_peak.get(key, 0.0) >= min_backlog

    return DetectorSuite(
        [
            CusumDetector(
                "queue-growth",
                lambda w: w.switch_depth_peak,
                threshold=queue_threshold,
                slack=1.0,
            ),
            EwmaDetector(
                "drop-spike",
                lambda w: w.port_drops,
                ratio=drop_ratio,
                min_value=1.0,
                switch_of=lambda p: p[0],
                port_of=lambda p: p,
            ),
            EwmaDetector(
                "hol-blocking",
                lambda w: w.port_blocked,
                ratio=blocked_ratio,
                min_value=1.0,
                switch_of=lambda p: p[0],
                port_of=lambda p: p,
            ),
            EwmaDetector(
                "utilization-collapse",
                lambda w: {
                    sw: w.utilization(sw) for sw in w.switch_served
                },
                ratio=collapse_ratio,
                min_value=0.5,
                invert=True,
                guard=backlog_guard,
            ),
        ]
    )


# --------------------------------------------------------- attribution --
def attribute_flows(event: AnomalyEvent, timeline) -> tuple[str, ...]:
    """Flow sources crossing the event's switch during its excursion
    window — the flow half of switch/port/flow attribution, read off the
    run's INT ``Timeline`` (available on the same profiling run that fed
    the stream). Sorted, deduplicated."""
    if timeline is None:
        return ()
    out = set()
    for rec in getattr(timeline, "hop_records", ()):
        if rec.switch != event.switch:
            continue
        if event.port is not None and rec.port != event.port:
            continue
        if rec.departure_tick < event.onset_tick or rec.arrival_tick > event.detect_tick:
            continue
        out.add(rec.src)
    return tuple(sorted(out))


def export_to_tracer(
    tracer,
    events: Iterable[AnomalyEvent],
    windows: Iterable[Window] = (),
    *,
    tid: int = 1,
) -> None:
    """Export anomalies as Perfetto instant events (``ph:"i"``) and the
    windowed fabric depth as a counter track (``ph:"C"``) on the session
    Chrome trace.

    The fabric track (``tid`` 1 by default) is in **simulated ticks**,
    not wall microseconds — a separate track, so it never interleaves
    with the wall-clock span track and ``validate_chrome_trace``'s
    per-track monotonicity holds for both.
    """
    for w in sorted(windows, key=lambda w: w.end_tick):
        tracer.counter(
            "fabric.queue_depth",
            ts_us=w.end_tick,
            values={"mean_pkts": round(w.total_depth_mean, 3),
                    "peak_pkts": round(w.total_depth_peak, 3)},
            tid=tid,
        )
    for ev in sorted(events, key=lambda e: (e.detect_tick, e.onset_tick)):
        tracer.instant(
            f"anomaly.{ev.kind}",
            ts_us=ev.detect_tick,
            tid=tid,
            switch=str(ev.switch),
            port=None if ev.port is None else f"{ev.port[0]}→{ev.port[1]}",
            onset_tick=ev.onset_tick,
            severity=ev.severity,
            detector=ev.detector,
        )
