"""INT-style fabric telemetry: per-flow per-hop records + sampled series.

In-band Network Telemetry attaches metadata at every hop a packet
crosses: hop latency, queue depth at dequeue, egress port utilization.
This module is that metadata set for the repo's two simulator engines,
plus the tick-sampled per-port time series that gives the repo's
measured signals a *time* dimension (``SimReport`` alone only carries
peaks and totals).

Everything here is opt-in behind ``CostModel.sim_telemetry``: the
engines construct a collector only when the knob is set, so the default
fast path allocates nothing and branches once per event/step.

* ``HopRecord``  — one flow's transit of one hop (the INT triple);
* ``Timeline``   — per-run container on ``SimReport.timeline``:
  hop records, exact per-port packet totals, and series sampled every
  ``CostModel.sim_telemetry_interval`` ticks — per-switch queue depth
  (both engines), per-port VOQ depth / cumulative drops / cumulative
  blocked ticks (vectorized engine);
* ``EventCollector`` / ``VoqCollector`` — the per-engine instrumentation
  the engines drive;
* ``switch_pressure`` / ``link_pressure`` / ``rank_hot`` / ``hottest``
  — the **unified measurement surface**: one definition of "how hot is
  this switch/link" and one deterministic tie-break, shared by
  ``SimReport.hot_switch``, the ``reroute-feedback`` pass and the
  autotune hotspot actions (previously each had a private variant with
  its own tie order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Mapping, Sequence

import numpy as np

NodeId = Hashable
Port = tuple[NodeId, NodeId]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class HopRecord:
    """One flow's transit of one hop — the INT metadata triple.

    ``queue_depth_at_dequeue`` is the deepest backlog the flow's packets
    dequeued behind at this switch (packets); ``utilization`` is the
    egress port's share of the run spent carrying this flow
    (packets served / makespan, at 1 pkt/tick ≤ 1 per flow)."""

    src: str
    dst: str
    hop: int  # hop index along the flow's path (0-based)
    switch: NodeId
    port: Port  # egress link (switch, next); (sw, sw) = recirculation
    packets: float
    arrival_tick: float
    departure_tick: float
    queue_depth_at_dequeue: float
    utilization: float

    @property
    def hop_latency_ticks(self) -> float:
        return self.departure_tick - self.arrival_tick


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Per-run fabric telemetry, attached as ``SimReport.timeline``.

    Series are aligned on ``ticks`` (every ``interval_ticks``).
    ``port_depth``/``port_cum_drops``/``port_cum_blocked`` are vectorized-
    engine signals (empty under the event engine, mirroring how
    ``SimReport.voq_depth`` behaves); ``port_cum_*`` are cumulative, so
    their last sample equals the corresponding ``SimReport`` total."""

    engine: str
    interval_ticks: float
    ticks: tuple[float, ...]
    # per-switch total queue depth (packets) at each sample tick
    switch_depth: Mapping[NodeId, tuple[float, ...]]
    # per-port effective waiting depth (the voq_depth signal, sampled)
    port_depth: Mapping[Port, tuple[float, ...]]
    port_cum_drops: Mapping[Port, tuple[float, ...]]
    port_cum_blocked: Mapping[Port, tuple[float, ...]]
    # exact packets forwarded per port over the whole run (both engines)
    port_packets: Mapping[Port, float]
    hop_records: tuple[HopRecord, ...] = ()

    def depth_integral(self, switch: NodeId | None = None) -> float:
        """∫ queue depth dt (packet-ticks), rectangle rule over samples —
        one switch, or the whole fabric."""
        if switch is not None:
            return sum(self.switch_depth.get(switch, ())) * self.interval_ticks
        return sum(sum(s) for s in self.switch_depth.values()) * self.interval_ticks

    def total_depth_series(self) -> list[float]:
        """Fabric-wide queue depth at each sample tick (the sparkline)."""
        out = [0.0] * len(self.ticks)
        for series in self.switch_depth.values():
            for i, v in enumerate(series):
                out[i] += v
        return out

    def final_drops(self) -> dict[Port, float]:
        """Cumulative dropped packets per port at end of run (>0 only)."""
        return {p: s[-1] for p, s in self.port_cum_drops.items() if s and s[-1] > 0}

    def final_blocked(self) -> dict[Port, float]:
        """Cumulative backpressure-blocked ticks per port (>0 only)."""
        return {p: s[-1] for p, s in self.port_cum_blocked.items() if s and s[-1] > 0}

    def to_dict(self) -> dict:
        """JSON-able dump (ports rendered ``a→b``)."""
        pk = lambda p: f"{p[0]}→{p[1]}"  # noqa: E731
        return {
            "engine": self.engine,
            "interval_ticks": self.interval_ticks,
            "ticks": list(self.ticks),
            "switch_depth": {str(k): list(v) for k, v in self.switch_depth.items()},
            "port_depth": {pk(k): list(v) for k, v in self.port_depth.items()},
            "port_cum_drops": {pk(k): list(v) for k, v in self.port_cum_drops.items()},
            "port_cum_blocked": {pk(k): list(v) for k, v in self.port_cum_blocked.items()},
            "port_packets": {pk(k): v for k, v in self.port_packets.items()},
            "hop_records": [
                {
                    "src": r.src, "dst": r.dst, "hop": r.hop,
                    "switch": str(r.switch), "port": pk(r.port),
                    "packets": r.packets,
                    "arrival_tick": r.arrival_tick,
                    "departure_tick": r.departure_tick,
                    "hop_latency_ticks": r.hop_latency_ticks,
                    "queue_depth_at_dequeue": r.queue_depth_at_dequeue,
                    "utilization": r.utilization,
                }
                for r in self.hop_records
            ],
        }


def _snap(v: float, tol: float = 1e-3) -> float:
    """Snap float-drift packet counts back to the integer they are."""
    r = round(v)
    return float(r) if abs(v - r) < tol else float(v)


# ------------------------------------------------------ event collector --
class EventCollector:
    """Telemetry sink for the event-ordered engine.

    The engine processes events in global time order, so sampling is a
    cursor: before handling an event at time ``t``, every sample tick
    still below ``t`` sees the *current* per-switch backlog, which
    between events decays linearly (``next_free - ts``, service runs
    down one packet per tick with no arrivals). Hop data aggregates per
    (flow, hop): first arrival, last departure, deepest backlog seen.
    """

    def __init__(self, interval: float, stream=None):
        self.interval = max(float(interval), _EPS)
        self._next = self.interval
        self.stream = stream  # optional stream.WindowedStream fan-out
        self.ticks: list[float] = []
        self._rows: list[dict[NodeId, float]] = []
        self.port_packets: dict[Port, float] = {}
        # (key) -> [src, dst, hop, sw, port, packets, first_t, last_t, maxdepth]
        self._hops: dict[tuple, list] = {}

    def advance(
        self,
        t: float,
        next_free: Mapping[NodeId, float],
        served: Mapping[NodeId, float] | None = None,
    ) -> None:
        """Emit per-switch queue-depth samples for every interval
        boundary at or before ``t`` (depth = each switch's backlog,
        ``next_free − sample tick``). ``served`` is the engine's
        cumulative per-switch busy-tick map, forwarded to the streaming
        sink when one is attached."""
        while self._next <= t + _EPS:
            ts = self._next
            row = {sw: nf - ts for sw, nf in next_free.items() if nf - ts > _EPS}
            self._rows.append(row)
            self.ticks.append(ts)
            self._next += self.interval
            if self.stream is not None:
                self.stream.add_sample(ts, row, cum_served=served)

    def on_service(
        self, key: tuple, src: str, dst: str, hop: int, sw: NodeId, port: Port,
        packets: float, t: float, done: float, depth: float,
    ) -> None:
        """Record one switch service: accumulates the flow-hop's packet
        count, first-start/last-done ticks and max queue depth seen —
        the raw material ``finish`` turns into ``HopRecord``s."""
        self.port_packets[port] = self.port_packets.get(port, 0.0) + packets
        rec = self._hops.get(key)
        if rec is None:
            self._hops[key] = [src, dst, hop, sw, port, packets, t, done, depth]
        else:
            rec[5] += packets
            rec[6] = min(rec[6], t)
            rec[7] = max(rec[7], done)
            rec[8] = max(rec[8], depth)

    def finish(self, makespan: float, engine: str) -> Timeline:
        """Assemble the accumulated samples + hop records into the
        immutable ``Timeline`` attached to ``SimReport.timeline``."""
        switches = sorted({sw for row in self._rows for sw in row}, key=str)
        total = makespan if makespan > 0 else 1.0
        return Timeline(
            engine=engine,
            interval_ticks=self.interval,
            ticks=tuple(self.ticks),
            switch_depth={
                sw: tuple(row.get(sw, 0.0) for row in self._rows) for sw in switches
            },
            port_depth={},
            port_cum_drops={},
            port_cum_blocked={},
            port_packets={p: _snap(v) for p, v in sorted(
                self.port_packets.items(), key=lambda kv: str(kv[0]))},
            hop_records=tuple(
                HopRecord(
                    src=r[0], dst=r[1], hop=r[2], switch=r[3], port=r[4],
                    packets=_snap(r[5]), arrival_tick=r[6], departure_tick=r[7],
                    queue_depth_at_dequeue=r[8], utilization=r[5] / total,
                )
                for r in self._hops.values()
            ),
        )


# -------------------------------------------------------- voq collector --
class VoqCollector:
    """Telemetry sink for the vectorized fluid engine.

    Queues move linearly within each closed-form step ``(t, t+dt]``, so a
    sample tick landing inside a step interpolates between the step's
    start and end state — two extra bincounts per *sampled* step, zero
    work on the (common) steps no sample lands in. Cumulative drop and
    blocked counters are stepwise, snapshotted at the step boundary.
    """

    def __init__(self, interval: float, esw: np.ndarray, pid: np.ndarray,
                 ns: int, nport: int, *, switches=None, ports=None, stream=None):
        self.interval = max(float(interval), _EPS)
        self._next = self.interval
        self._esw, self._pid, self._ns, self._nport = esw, pid, ns, nport
        self.stream = stream  # optional stream.WindowedStream fan-out
        # switch ids / (a, b) port index pairs, needed to name streamed
        # samples while the run is live (finish() also receives them)
        self._switches = list(switches) if switches is not None else None
        self._port_of = (
            [(switches[a], switches[b]) for a, b in ports]
            if switches is not None and ports is not None
            else None
        )
        self.ticks: list[float] = []
        self._sw_rows: list[np.ndarray] = []
        self._port_rows: list[np.ndarray] = []
        self._drop_rows: list[np.ndarray] = []
        self._blk_rows: list[np.ndarray] = []

    def pending(self, t: float, dt: float) -> bool:
        """Does any sample tick land in ``(t, t+dt]``? (Cheap pre-check so
        the engine only copies start-of-step state when needed.)"""
        return self._next <= t + dt + _EPS

    def sample(
        self, t: float, dt: float, q0: np.ndarray, q1: np.ndarray,
        qeff0: np.ndarray, qeff1: np.ndarray,
        drops_p: np.ndarray, blocked_p: np.ndarray,
        served_s: np.ndarray | None = None,
    ) -> None:
        """Emit samples for every interval boundary inside the closed-form
        step ``[t, t+dt)``: queue depths are interpolated linearly between
        the step's start/end vectors (the fluid core's state is exactly
        linear within a step), drop/blocked counters are carried as-is.
        ``served_s`` (cumulative per-switch service, only computed when a
        stream is attached) feeds the live windowed sink."""
        sw0 = np.bincount(self._esw, weights=q0, minlength=self._ns)
        sw1 = np.bincount(self._esw, weights=q1, minlength=self._ns)
        p0 = np.bincount(self._pid, weights=qeff0, minlength=self._nport)
        p1 = np.bincount(self._pid, weights=qeff1, minlength=self._nport)
        end = t + dt + _EPS
        while self._next <= end:
            frac = (self._next - t) / dt if dt > _EPS else 1.0
            frac = min(max(frac, 0.0), 1.0)
            self.ticks.append(self._next)
            sw_row = sw0 + (sw1 - sw0) * frac
            p_row = p0 + (p1 - p0) * frac
            self._sw_rows.append(sw_row)
            self._port_rows.append(p_row)
            self._drop_rows.append(drops_p.copy())
            self._blk_rows.append(blocked_p.copy())
            if self.stream is not None and self._switches is not None:
                sws, pof = self._switches, self._port_of
                self.stream.add_sample(
                    self._next,
                    {sws[s]: float(v) for s, v in enumerate(sw_row) if v > _EPS},
                    {pof[j]: float(v) for j, v in enumerate(p_row) if v > _EPS},
                    {pof[j]: float(v) for j, v in enumerate(drops_p) if v > _EPS},
                    {pof[j]: float(v) for j, v in enumerate(blocked_p) if v > _EPS},
                    None if served_s is None else
                    {sws[s]: float(v) for s, v in enumerate(served_s) if v > _EPS},
                )
            self._next += self.interval

    def finish(
        self, *, engine: str, makespan: float,
        switches: Sequence[NodeId], ports: Sequence[tuple[int, int]],
        served_tot: np.ndarray, pid_full: np.ndarray,
        hop_meta: Sequence[tuple],
        first_t: np.ndarray, done_t: np.ndarray, maxq: np.ndarray,
    ) -> Timeline:
        """Assemble the sampled series + per-entry aggregates into the
        same ``Timeline`` shape the event engine's collector produces."""
        ns, nport = self._ns, self._nport
        sw_mat = np.asarray(self._sw_rows) if self._sw_rows else np.zeros((0, ns))
        p_mat = np.asarray(self._port_rows) if self._port_rows else np.zeros((0, nport))
        d_mat = np.asarray(self._drop_rows) if self._drop_rows else np.zeros((0, nport))
        b_mat = np.asarray(self._blk_rows) if self._blk_rows else np.zeros((0, nport))
        pkt_p = np.bincount(pid_full, weights=served_tot, minlength=nport)
        port_of = [(switches[a], switches[b]) for a, b in ports]
        total = makespan if makespan > 0 else 1.0
        records = []
        for i, src, dst, hop, sw_i, p_i in hop_meta:
            arr = float(first_t[i]) if np.isfinite(first_t[i]) else 0.0
            records.append(
                HopRecord(
                    src=src, dst=dst, hop=hop,
                    switch=switches[sw_i], port=port_of[p_i],
                    packets=_snap(float(served_tot[i])),
                    arrival_tick=arr,
                    departure_tick=float(done_t[i]),
                    queue_depth_at_dequeue=float(maxq[i]),
                    utilization=float(served_tot[i]) / total,
                )
            )
        return Timeline(
            engine=engine,
            interval_ticks=self.interval,
            ticks=tuple(self.ticks),
            switch_depth={
                switches[s]: tuple(sw_mat[:, s].tolist())
                for s in range(ns)
                if len(sw_mat) and float(sw_mat[:, s].max(initial=0.0)) > _EPS
            },
            port_depth={
                port_of[j]: tuple(p_mat[:, j].tolist())
                for j in range(nport)
                if len(p_mat) and float(p_mat[:, j].max(initial=0.0)) > _EPS
            },
            port_cum_drops={
                port_of[j]: tuple(d_mat[:, j].tolist())
                for j in range(nport)
                if len(d_mat) and float(d_mat[-1, j]) > _EPS
            },
            port_cum_blocked={
                port_of[j]: tuple(b_mat[:, j].tolist())
                for j in range(nport)
                if len(b_mat) and float(b_mat[-1, j]) > _EPS
            },
            port_packets={
                port_of[j]: _snap(float(pkt_p[j]))
                for j in range(nport)
                if pkt_p[j] > _EPS
            },
            hop_records=tuple(records),
        )


# ------------------------------------------------------- reconciliation --
def verify_timeline(report, *, atol: float = 0.5) -> None:
    """Cross-check a report's ``Timeline`` against its own counters.

    The cumulative drop series' final samples must agree with the
    report's ``port_drops`` totals, and the timeline's exact
    ``port_packets`` must account for ``packet_hops`` plus
    recirculations. Disagreement means the collector and the engine
    diverged — a bug, not noise — so this *raises* (``ValueError``)
    rather than silently reconciling; the tolerance only absorbs the
    final sample landing up to one interval before the last drop.
    No-op when the report has no timeline (telemetry was off)."""
    tl = getattr(report, "timeline", None)
    if tl is None:
        return
    drops = tl.final_drops()
    reported = {p: float(v) for p, v in getattr(report, "port_drops", {}).items()}
    for port in sorted(set(drops) | set(reported), key=str):
        a, b = drops.get(port, 0.0), reported.get(port, 0.0)
        if abs(a - b) > atol + _EPS:
            raise ValueError(
                f"timeline/report drop mismatch at port {port[0]}→{port[1]}: "
                f"timeline cumulative series ends at {a:g} but the report "
                f"counted {b:g} dropped packets — the collector and engine "
                "disagree about this run"
            )
    total_pk = sum(tl.port_packets.values())
    expected = float(report.packet_hops + report.recirculations)
    if abs(total_pk - expected) > atol + _EPS:
        raise ValueError(
            f"timeline/report packet mismatch: timeline port_packets sum to "
            f"{total_pk:g} but the report counted {expected:g} "
            "(packet_hops + recirculations)"
        )


# ---------------------------------------------- unified hotspot surface --
def switch_pressure(report) -> dict[NodeId, float]:
    """How contended each switch measured: queued packets + packets its
    full buffer dropped. One definition, consumed by ``hot_switch``, the
    ``reroute-feedback`` pass and autotune's move-reducer targeting."""
    out: dict[NodeId, float] = {
        sw: float(v) for sw, v in report.queued_batches.items()
    }
    for sw, d in report.switch_drops().items():
        out[sw] = out.get(sw, 0.0) + d
    return out


def link_pressure(report) -> dict[Port, float]:
    """How contended each directed link measured: peak VOQ depth + drops
    + backpressure-blocked ticks (empty under the event engine, which has
    no per-port signals)."""
    out: dict[Port, float] = {}
    for signal in (report.voq_depth, report.port_drops, report.port_blocked_ticks):
        for link, v in signal.items():
            out[link] = out.get(link, 0.0) + float(v)
    return out


def timeline_pressure(timeline) -> dict[NodeId, float]:
    """Per-switch queue-depth integral (packet-ticks) from a sampled
    ``Timeline`` — the *time-weighted* contention signal: a switch that
    held a deep backlog for long reads hotter than one that spiked
    briefly, which ``switch_pressure``'s event counts cannot tell apart.
    Empty when ``timeline`` is None (telemetry was off) or has no
    samples."""
    if timeline is None or not getattr(timeline, "ticks", ()):
        return {}
    out: dict[NodeId, float] = {}
    for sw, series in timeline.switch_depth.items():
        v = float(sum(series)) * timeline.interval_ticks
        if v > _EPS:
            out[sw] = v
    return out


def measured_switch_pressure(report) -> dict[NodeId, float]:
    """``switch_pressure`` folded with the run's ``Timeline`` depth
    integral when fabric telemetry was on — the richest per-switch
    contention estimate one report offers, and the seed the p4mr
    scheduler feeds into the next tenant's contention-aware compile.
    Degrades gracefully to plain ``switch_pressure`` when the report has
    no timeline."""
    out = switch_pressure(report)
    for sw, v in timeline_pressure(getattr(report, "timeline", None)).items():
        out[sw] = out.get(sw, 0.0) + v
    return out


def normalized(pressure: Mapping[Any, float]) -> dict[Any, float]:
    """Scale a pressure map below 1.0 (``v / (max + 1)``) — the form the
    routers consume as a tie-steering penalty that never outweighs a
    whole packet of real traffic."""
    scale = max(pressure.values(), default=0.0) + 1.0
    return {k: v / scale for k, v in pressure.items()}


def rank_hot(
    pressure: Mapping[Any, float], secondary: Mapping[Any, float] | None = None
) -> list:
    """Keys hottest-first; ties by ``secondary`` (hotter first), then by
    stringified id ascending — THE deterministic tie order for every
    telemetry-driven selection, identical across engines and platforms."""
    sec = secondary or {}
    return sorted(
        pressure, key=lambda k: (-pressure[k], -sec.get(k, 0.0), str(k))
    )


def rank_cold(
    pressure: Mapping[Any, float],
    keys: Sequence,
    secondary: Mapping[Any, float] | None = None,
) -> list:
    """``keys`` coldest-first under ``pressure`` (missing = 0), ties by
    ``secondary`` then stringified id — the receiving end of rank_hot."""
    sec = secondary or {}
    return sorted(
        keys, key=lambda k: (pressure.get(k, 0.0), sec.get(k, 0.0), str(k))
    )


def hottest(pressure: Mapping[Any, float]):
    """The single hottest key (None when the map is empty)."""
    ranked = rank_hot(pressure)
    return ranked[0] if ranked else None
