"""Streaming fabric telemetry: windowed INT aggregation during the run.

The ``Timeline`` of ``telemetry.fabric`` is post-hoc: the engines buffer
every sample and a consumer walks the finished artifact. This module is
the *live* half of the INT story — per-switch/per-port state aggregated
into fixed-width tick windows and pushed to subscribers **while the
simulation runs**, which is what lets detectors
(``repro_torch.telemetry.anomaly``) and SLO monitors
(``repro_torch.telemetry.slo``) change behavior mid-flight instead of
diagnosing a corpse.

The protocol is duck-typed (``StreamObserver`` documents it): an
observer implements any subset of

* ``on_window(window)`` — one closed aggregation window (the signal
  surface: per-switch mean/peak queue depth, per-port peak depth,
  per-port drop/blocked deltas, per-switch packets served);
* ``on_node(label, tick)``  — a program node completed (sinks included:
  this is how an SLO monitor sees a job finish);
* ``on_finish(makespan)``   — the run ended; the trailing partial
  window is flushed *before* this fires.

Observers ride ``simulate_timing(..., observers=[...])`` /
``Session.simulate(observers=...)`` / the scheduler's monitored phase-D
run. Passing observers forces sample collection on for that run even
when ``CostModel.sim_telemetry`` is off; passing none keeps the default
fast path allocation-free (the zero-overhead-when-off property
``BENCH_telemetry.json`` gates).

Window width is ``CostModel.sim_telemetry_window`` ticks (validated at
construction); samples land every ``sim_telemetry_interval`` ticks, so
a window aggregates ``window / interval`` samples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Mapping, Protocol, Sequence, runtime_checkable

NodeId = Hashable
Port = tuple[NodeId, NodeId]

_EPS = 1e-9


@runtime_checkable
class StreamObserver(Protocol):
    """Structural protocol for streaming subscribers — implement any
    subset; the stream dispatches only the hooks an observer defines."""

    def on_window(self, window: "Window") -> None:  # pragma: no cover - doc
        ...


@dataclasses.dataclass(frozen=True)
class Window:
    """One closed aggregation window ``[start_tick, end_tick)``.

    Depth maps are packets (mean/peak over the window's samples);
    ``port_drops`` / ``port_blocked`` / ``switch_served`` are *deltas*
    over the window (cumulative counters differenced at the boundary),
    so a drop burst shows up in exactly the window it happened in.
    """

    index: int
    start_tick: float
    end_tick: float
    engine: str
    samples: int
    switch_depth_mean: Mapping[NodeId, float]
    switch_depth_peak: Mapping[NodeId, float]
    port_depth_peak: Mapping[Port, float]
    port_drops: Mapping[Port, float]
    port_blocked: Mapping[Port, float]
    switch_served: Mapping[NodeId, float]

    @property
    def duration_ticks(self) -> float:
        return self.end_tick - self.start_tick

    @property
    def total_depth_mean(self) -> float:
        """Fabric-wide mean queue depth (packets) over the window."""
        return sum(self.switch_depth_mean.values())

    @property
    def total_depth_peak(self) -> float:
        """Fabric-wide peak sampled queue depth (packets)."""
        return sum(self.switch_depth_peak.values())

    @property
    def total_served(self) -> float:
        """Packets served fabric-wide during the window."""
        return sum(self.switch_served.values())

    def utilization(self, switch: NodeId) -> float:
        """Share of the window the switch spent serving (1 pkt/tick
        service rate makes served/duration a [0, ~1] utilization)."""
        dur = self.duration_ticks
        if dur <= _EPS:
            return 0.0
        return self.switch_served.get(switch, 0.0) / dur

    def pressure(self) -> dict[NodeId, float]:
        """Per-switch depth integral over this window (packet-ticks) —
        the windowed slice of ``fabric.timeline_pressure``, in the same
        unit, so window pressures sum to the whole-run signal."""
        dur = self.duration_ticks
        return {
            sw: v * dur for sw, v in self.switch_depth_mean.items() if v > _EPS
        }


class WindowedStream:
    """The incremental sink both simulator engines drive.

    Collectors (``fabric.EventCollector`` / ``fabric.VoqCollector``)
    forward every emitted sample here; the stream accumulates the
    current window and, each time a sample crosses a window boundary,
    closes the window and fans it out to every observer *synchronously*
    (the simulation is single-threaded; observers see windows in tick
    order, before the run ends).

    Cumulative inputs (drops / blocked / served) are differenced against
    the snapshot taken at the previous window close, so observers see
    per-window deltas without keeping history themselves.
    """

    def __init__(
        self,
        observers: Sequence[Any],
        *,
        window_ticks: float,
        engine: str = "",
    ):
        if window_ticks <= 0:
            raise ValueError(
                f"window_ticks must be > 0, got {window_ticks}"
            )
        self.observers = [ob for ob in observers if ob is not None]
        self.window = float(window_ticks)
        self.engine = engine
        self.windows_emitted = 0
        self._start = 0.0  # current window's start tick
        self._samples = 0
        self._depth_sum: dict[NodeId, float] = {}
        self._depth_peak: dict[NodeId, float] = {}
        self._port_peak: dict[Port, float] = {}
        # cumulative snapshots at the last window close (for deltas) and
        # the latest cumulative values seen (become the close snapshot)
        self._prev_drops: dict[Port, float] = {}
        self._prev_blocked: dict[Port, float] = {}
        self._prev_served: dict[NodeId, float] = {}
        self._cum_drops: dict[Port, float] = {}
        self._cum_blocked: dict[Port, float] = {}
        self._cum_served: dict[NodeId, float] = {}
        self._finished = False

    # ------------------------------------------------------------ feeding --
    def add_sample(
        self,
        tick: float,
        switch_depth: Mapping[NodeId, float],
        port_depth: Mapping[Port, float] | None = None,
        cum_drops: Mapping[Port, float] | None = None,
        cum_blocked: Mapping[Port, float] | None = None,
        cum_served: Mapping[NodeId, float] | None = None,
    ) -> None:
        """Fold one sample (taken at ``tick``) into the current window,
        closing and emitting every window boundary crossed first.

        Samples arrive in tick order (the engines are time-ordered);
        cumulative maps are read synchronously — no references are kept.
        """
        while tick > self._start + self.window + _EPS:
            self._close(self._start + self.window)
        for sw, v in switch_depth.items():
            if v > _EPS:
                self._depth_sum[sw] = self._depth_sum.get(sw, 0.0) + v
                if v > self._depth_peak.get(sw, 0.0):
                    self._depth_peak[sw] = v
        if port_depth:
            for p, v in port_depth.items():
                if v > self._port_peak.get(p, 0.0):
                    self._port_peak[p] = v
        if cum_drops:
            self._cum_drops.update(cum_drops)
        if cum_blocked:
            self._cum_blocked.update(cum_blocked)
        if cum_served:
            self._cum_served.update(cum_served)
        self._samples += 1

    def on_node(self, label: str, tick: float) -> None:
        """A program node completed at ``tick`` — forwarded to observers
        that subscribe (``on_node``); sinks are how job completion is
        seen live."""
        for ob in self.observers:
            hook = getattr(ob, "on_node", None)
            if hook is not None:
                hook(label, tick)

    def finish(self, makespan: float) -> None:
        """Flush the trailing partial window, then fan out
        ``on_finish(makespan)``. Idempotent."""
        if self._finished:
            return
        self._finished = True
        if self._samples or makespan > self._start + _EPS:
            self._close(max(makespan, self._start + _EPS))
        for ob in self.observers:
            hook = getattr(ob, "on_finish", None)
            if hook is not None:
                hook(makespan)

    # ----------------------------------------------------------- internals --
    def _close(self, end: float) -> None:
        n = max(self._samples, 1)
        drops = _delta(self._cum_drops, self._prev_drops)
        blocked = _delta(self._cum_blocked, self._prev_blocked)
        served = _delta(self._cum_served, self._prev_served)
        win = Window(
            index=self.windows_emitted,
            start_tick=self._start,
            end_tick=end,
            engine=self.engine,
            samples=self._samples,
            switch_depth_mean={
                sw: s / n for sw, s in self._depth_sum.items()
            },
            switch_depth_peak=dict(self._depth_peak),
            port_depth_peak=dict(self._port_peak),
            port_drops=drops,
            port_blocked=blocked,
            switch_served=served,
        )
        self.windows_emitted += 1
        self._start = end
        self._samples = 0
        self._depth_sum = {}
        self._depth_peak = {}
        self._port_peak = {}
        self._prev_drops = dict(self._cum_drops)
        self._prev_blocked = dict(self._cum_blocked)
        self._prev_served = dict(self._cum_served)
        for ob in self.observers:
            hook = getattr(ob, "on_window", None)
            if hook is not None:
                hook(win)


def _delta(cur: Mapping, prev: Mapping) -> dict:
    out = {}
    for k, v in cur.items():
        d = v - prev.get(k, 0.0)
        if d > _EPS:
            out[k] = d
    return out


class WindowRecorder:
    """The simplest observer: keeps every window (and node/finish event)
    — the streaming analogue of ``Timeline`` for tests and notebooks."""

    def __init__(self) -> None:
        self.windows: list[Window] = []
        self.nodes: list[tuple[str, float]] = []
        self.makespan: float | None = None

    def on_window(self, window: Window) -> None:
        self.windows.append(window)

    def on_node(self, label: str, tick: float) -> None:
        self.nodes.append((label, tick))

    def on_finish(self, makespan: float) -> None:
        self.makespan = makespan

    def pressure(self) -> dict[NodeId, float]:
        """Whole-run per-switch depth integral accumulated from windows
        (matches ``fabric.timeline_pressure`` up to sampling grid)."""
        out: dict[NodeId, float] = {}
        for w in self.windows:
            for sw, v in w.pressure().items():
                out[sw] = out.get(sw, 0.0) + v
        return out
