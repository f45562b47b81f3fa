"""Per-packet streaming dataplane simulator backend.

Executes a ``CompiledPlan`` packet by packet without any devices, so §3
cost-model predictions can be validated against observed behaviour (the
role the paper's Mininet deployment plays). The model is deliberately
simple and deterministic, but — unlike the original one-batch-per-edge
form — it streams:

* every DAG edge emits a **packet train** sized by the cost model's
  dtype-aware packing (``CostModel.traffic``), not one opaque batch;
* each switch is a **service station**: forwarding one packet occupies
  the switch for one tick (the §3 ``C/e`` throttle as a service rate —
  ``CostModel.tick_s`` converts ticks back to seconds at line rate C),
  so a train crossing h hops finishes in ``h + packets − 1`` ticks
  instead of ``h``: hop latency overlaps with transmission and makespan
  is set by the bottleneck stage, the paper's pipelining argument;
* switch queues are **event-ordered** (one global time-ordered heap):
  packets from different trains interleave at shared switches in
  arrival order, the loser's wait is counted as queueing delay
  (``queue_delay_ticks`` / per-switch ``queued_batches``), and the
  per-switch backlog seen on arrival feeds ``max_queue_depth``;
* a Reduce merging k upstream trains holds state on its switch and
  **recirculates** the stored partial once per additional source
  (k−1 recirculations), the §3 stateful-processing penalty. The
  recirculated packets occupy the destination switch like any other
  service — they are counted in ``queued_batches`` and delay transit
  traffic through that switch, so stateful hotspots are visible to the
  ``reroute-feedback`` pass;
* a lowered shuffle's ``ShuffleBucket`` edges each carry only their
  bucket's slice of the traffic (skewed histograms → hot buckets put
  longer trains on the wire, and converging bucket trains contend in
  the destination-side switch queues);
* very long trains are coalesced into at most
  ``CostModel.sim_train_cap`` super-packets with integer weights, so
  event count stays bounded while tick arithmetic is unchanged (a
  super-packet of weight w behaves exactly like w back-to-back
  packets).

Two engines share this module's traffic model (``FlowSpec``, built once
per plan and memoized on ``CompiledPlan``):

* ``engine="event"`` — the per-packet event-ordered loop below, the
  reference implementation;
* ``engine="vectorized"`` — ``compiler.vectorized``'s batched-step core
  (dense per-switch × per-port queue arrays, virtual output queues,
  finite buffers, drop/backpressure counters). This is the default
  (``CostModel.sim_engine``): its step count scales with contention
  changes, not packet count, which is what makes autotune's dozens of
  candidate evaluations affordable.

Functional outputs come from ``codelet.execute_reference`` on the same
(rewritten) program, so simulator outputs are the values the reference
oracle produces — functional equivalence and timing come from one run.

``SimReport.edge_hops`` equals ``RoutingTable.total_hops`` by
construction (each route edge is traversed exactly once per train);
tests pin that invariant. ``simulate_timing`` exposes the timing half
alone (it needs no input arrays — timing depends on traffic shapes, not
payload values), which is what the ``reroute-feedback`` pass and
bucket-count arbitration consume.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Hashable, Mapping, Sequence

import numpy as np

from repro_torch.core import dag, primitives as prim
from repro_torch.core.routing import RoutingTable

NodeId = Hashable

ENGINES = ("event", "vectorized")


@dataclasses.dataclass(frozen=True)
class SimReport:
    """Timing half of one simulation run (both engines produce this).

    ``makespan_ticks`` is the tick the last program sink completed —
    measured from tick 0 of the shared clock, so under staggered-release
    traffic (``simulate_timing(..., release=...)``) it is an absolute
    completion time, not a duration. ``sink_finish_ticks`` carries the
    per-sink completion ticks, which is how a multi-job merged run
    (``Session.simulate`` / the p4mr scheduler) recovers per-job finish
    times from one shared simulation."""

    edge_hops: int  # Σ route hops (matches RoutingTable.total_hops)
    packet_hops: int  # hop traversals × packets per train
    recirculations: int
    makespan_ticks: int
    queue_delay_ticks: int
    # per-switch packets that had to wait, including the destination
    # switch's own recirculated packets (stateful hotspots)
    queued_batches: dict[NodeId, int]
    wire_bytes: float
    time_s: float  # modelled completion time (the cost scalar)
    switch_busy_ticks: dict[NodeId, int] = dataclasses.field(default_factory=dict)
    switch_utilization: dict[NodeId, float] = dataclasses.field(default_factory=dict)
    max_queue_depth: dict[NodeId, int] = dataclasses.field(default_factory=dict)
    # which engine produced this report ("event" or "vectorized")
    engine: str = "event"
    # ---- per-port signals (vectorized engine only; empty under "event").
    # A port is the directed link (switch, next_switch); the loopback
    # port (sw, sw) is a Reduce's recirculation path.
    # peak virtual-output-queue depth per port, in packets (pipeline
    # fill excluded — a saturated but wait-free port reads ~0)
    voq_depth: dict[tuple[NodeId, NodeId], float] = dataclasses.field(default_factory=dict)
    # packets dropped at a full downstream buffer (sim_buffer_policy="drop")
    port_drops: dict[tuple[NodeId, NodeId], float] = dataclasses.field(default_factory=dict)
    # ticks a VOQ head spent stalled on a full downstream buffer
    # (sim_buffer_policy="backpressure")
    port_blocked_ticks: dict[tuple[NodeId, NodeId], float] = dataclasses.field(
        default_factory=dict
    )
    dropped_packets: float = 0.0
    # INT-style fabric telemetry (repro_torch.telemetry.fabric.Timeline) when
    # CostModel.sim_telemetry was set; None on the default fast path
    timeline: Any = None
    # per-sink completion tick (absolute, shared clock) — how merged
    # multi-job runs recover each job's finish time
    sink_finish_ticks: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def hot_switch(self) -> NodeId | None:
        """Switch with the most measured pressure (None when idle) —
        queued + dropped packets, tie-broken by the one shared helper
        (``repro_torch.telemetry.fabric.hottest``) every telemetry-driven
        selector uses, so the pick is deterministic across engines."""
        from repro_torch.telemetry.fabric import hottest, switch_pressure

        return hottest(switch_pressure(self))

    def switch_drops(self) -> dict[NodeId, float]:
        """Packets dropped per upstream switch (aggregated over its ports)."""
        out: dict[NodeId, float] = {}
        for (sw, _nxt), n in self.port_drops.items():
            out[sw] = out.get(sw, 0.0) + n
        return out


@dataclasses.dataclass(frozen=True)
class SimResult:
    outputs: dict[str, np.ndarray]  # per program sink, numeric payloads
    report: SimReport


# ----------------------------------------------------------- flow spec --
@dataclasses.dataclass(frozen=True)
class FlowDef:
    """One routed DAG edge: a packet train travelling ``path``."""

    src: str
    dst: str
    path: tuple[NodeId, ...]
    packets: int
    train: tuple[int, ...]  # super-packet weights, sum == packets

    @property
    def hops(self) -> int:
        return len(self.path) - 1


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    """Traffic model shared by both engines, derived once from
    (program, routes, cost model): per-edge packet trains, the node
    dependency counts that gate injection, and the Reduce recirculation
    sites. ``CompiledPlan.flow_spec()`` memoizes it so repeated autotune
    evaluations of one plan skip the rebuild."""

    flows: tuple[FlowDef, ...]
    out_flows: dict[str, tuple[int, ...]]  # node label -> flow ids it feeds
    in_degree: dict[str, int]  # node label -> number of in-flows
    merges: dict[str, int]  # Reduce label -> k−1 recirculations (>0 only)
    dst_switch: dict[str, NodeId]  # dst label -> its arrival switch
    sinks: tuple[str, ...] = ()  # program sinks (``Program.sinks`` is
    # O(nodes²) — cached here so per-simulation reports don't re-scan)

    @property
    def total_packets(self) -> int:
        return sum(f.packets for f in self.flows)


def _train(packets: int, cap: int) -> tuple[int, ...]:
    """Split ``packets`` into ≤ ``cap`` integer-weight super-packets."""
    n = max(1, min(packets, cap))
    base, rem = divmod(packets, n)
    return (base + 1,) * rem + (base,) * (n - rem)


def build_flow_spec(program: dag.Program, routes: RoutingTable, cost_model) -> FlowSpec:
    """Derive the packet trains and node gating both engines stream."""
    traffic = cost_model.traffic(program)
    cap = max(1, getattr(cost_model, "sim_train_cap", 256))
    flows: list[FlowDef] = []
    out_flows: dict[str, list[int]] = {}
    in_degree: dict[str, int] = {name: 0 for name in program.nodes}
    dst_switch: dict[str, NodeId] = {}
    for r in routes.routes:
        pk = traffic[r.src_label].packets if r.src_label in traffic else 1
        out_flows.setdefault(r.src_label, []).append(len(flows))
        in_degree[r.dst_label] = in_degree.get(r.dst_label, 0) + 1
        dst_switch[r.dst_label] = r.path[-1]
        flows.append(
            FlowDef(
                src=r.src_label,
                dst=r.dst_label,
                path=tuple(r.path),
                packets=pk,
                train=_train(pk, cap),
            )
        )
    merges = {
        n.name: len(n.srcs) - 1
        for n in program
        if isinstance(n, prim.Reduce) and len(n.srcs) > 1
    }
    return FlowSpec(
        flows=tuple(flows),
        out_flows={k: tuple(v) for k, v in out_flows.items()},
        in_degree=in_degree,
        merges=merges,
        dst_switch=dst_switch,
        sinks=tuple(program.sinks()),
    )


def simulate_timing(
    program: dag.Program,
    routes: RoutingTable,
    cost_model,
    *,
    engine: str | None = None,
    spec: FlowSpec | None = None,
    release: Mapping[str, float] | None = None,
    observers: Sequence[Any] | None = None,
) -> SimReport:
    """Stream every routed edge's packet train through the fabric model;
    returns the timing report.

    ``engine`` selects the core: ``"vectorized"`` (batched-step VOQ
    engine, the default via ``CostModel.sim_engine``) or ``"event"``
    (per-packet event-ordered reference). ``spec`` reuses a prebuilt
    ``FlowSpec`` (``CompiledPlan.flow_spec()`` memoizes one per plan).

    ``release`` maps node labels to the earliest tick they may become
    ready: source nodes (Stores) listed here start emitting at that tick
    instead of tick 0, which is how the p4mr scheduler models jobs
    *arriving* at submit ticks in one shared simulation. Unlisted sources
    release at 0; labels of non-source nodes are ignored — a node's own
    floor is the max of its sources' release ticks, propagated down the
    program DAG (see ``_release_floors``).

    ``observers`` subscribes streaming-telemetry observers (see
    ``repro_torch.telemetry.stream``) to this run: windowed per-switch/port
    aggregates and node-completion events are pushed to them *during*
    the simulation. Passing observers forces sample collection on for
    this run even when ``CostModel.sim_telemetry`` is off; the default
    (no observers, telemetry off) pays nothing.
    """
    eng = engine if engine is not None else getattr(cost_model, "sim_engine", "vectorized")
    if eng not in ENGINES:
        raise ValueError(f"unknown simulator engine {eng!r}; one of {ENGINES}")
    if spec is None:
        spec = build_flow_spec(program, routes, cost_model)
    if eng == "event":
        return _simulate_event(
            program, spec, cost_model, release=release, observers=observers
        )
    from repro_torch.compiler.vectorized import simulate_vectorized

    return simulate_vectorized(
        program, spec, cost_model, release=release, observers=observers
    )


def _release_floors(
    program: dag.Program, release: Mapping[str, float] | None
) -> Mapping[str, float]:
    """Per-node earliest-ready floor: sources take their own release tick,
    every other node inherits the max over its dependencies' floors.

    The flow spec models same-switch in-edges as merges, not flows, so a
    node fed only by colocated producers has no in-flows and would seed
    at tick 0 regardless of when its upstream sources released. The
    propagated floor restores the dependency: such a node seeds no
    earlier than the sources it (transitively) reads."""
    if not release:
        return {}
    floors: dict[str, float] = {}
    for node in program.toposort():
        own = float(release.get(node.name, 0.0)) if not node.deps else 0.0
        floors[node.name] = max(
            own, 0.0, max((floors[d] for d in node.deps), default=0.0)
        )
    return floors


class _HeapScheduler:
    """Reference (t, seq) event ordering via one global heap."""

    def __init__(self):
        self._heap: list = []
        self._seq = 0

    def push(self, t: float, item) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, item))

    def __bool__(self) -> bool:
        return bool(self._heap)

    def pop(self):
        t, _, item = heapq.heappop(self._heap)
        return t, item


class _CalendarScheduler:
    """Tick-bucket calendar with FIFO buckets — the vectorized engine's
    FIFO compatibility scheduler. Every event lands in its tick's bucket
    in push order; buckets are drained in tick order. Because pushes are
    globally sequenced, bucket append order equals the heap's (t, seq)
    order, so this scheduler is bit-exact with ``_HeapScheduler`` while
    replacing per-event heap maintenance with O(1) appends (one heap
    entry per *distinct tick*, not per packet)."""

    def __init__(self):
        self._buckets: dict[float, list] = {}
        self._ticks: list[float] = []
        self._cur: list | None = None
        self._cur_tick = 0.0
        self._cur_i = 0

    def push(self, t: float, item) -> None:
        if self._cur is not None and t == self._cur_tick:
            self._cur.append(item)  # lands behind the event being served
            return
        b = self._buckets.get(t)
        if b is None:
            self._buckets[t] = b = []
            heapq.heappush(self._ticks, t)
        b.append(item)

    def __bool__(self) -> bool:
        return bool(self._ticks) or (self._cur is not None and self._cur_i < len(self._cur))

    def pop(self):
        while self._cur is None or self._cur_i >= len(self._cur):
            t = heapq.heappop(self._ticks)
            self._cur = self._buckets.pop(t)
            self._cur_tick = t
            self._cur_i = 0
        item = self._cur[self._cur_i]
        self._cur_i += 1
        t = self._cur_tick
        if self._cur_i >= len(self._cur):
            # bucket exhausted — a later push at this same tick starts a
            # fresh bucket (still drained before any strictly later tick)
            self._cur = None
        return t, item


@dataclasses.dataclass
class _Flow:
    """Mutable per-run state over a ``FlowDef``."""

    spec: FlowDef
    remaining: int = 0  # super-packets still crossing the last hop
    last_arrival: float = 0.0


def _simulate_event(
    program: dag.Program,
    spec: FlowSpec,
    cost_model,
    *,
    scheduler: str = "heap",
    release: Mapping[str, float] | None = None,
    observers: Sequence[Any] | None = None,
) -> SimReport:
    """The per-packet event-ordered core (see module docstring).

    ``scheduler="calendar"`` swaps the global heap for the tick-bucket
    calendar — identical event order, hence bit-identical reports; the
    vectorized engine's ``fidelity="fifo"`` compatibility mode runs this.
    ``release`` delays source readiness (see ``simulate_timing``);
    ``observers`` subscribes streaming sinks (windows + node events are
    pushed mid-run, and force sample collection on for this run).
    """
    cm = cost_model
    engine_label = "event" if scheduler == "heap" else "vectorized"
    stream = None
    if observers:
        from repro_torch.telemetry.stream import WindowedStream

        stream = WindowedStream(
            observers,
            window_ticks=getattr(cm, "sim_telemetry_window", 64.0),
            engine=engine_label,
        )
    tel = None
    if getattr(cm, "sim_telemetry", False) or stream is not None:
        from repro_torch.telemetry.fabric import EventCollector

        tel = EventCollector(
            getattr(cm, "sim_telemetry_interval", 16.0), stream=stream
        )
    flows = [_Flow(spec=fd) for fd in spec.flows]
    pending = dict(spec.in_degree)
    arrived: dict[str, float] = {}  # node -> latest in-flow last-packet arrival
    ready: dict[str, float] = {}

    next_free: dict[NodeId, float] = {}
    busy: dict[NodeId, float] = {}
    queued: dict[NodeId, int] = {}
    max_depth: dict[NodeId, float] = {}
    edge_hops = packet_hops = recirc = 0
    queue_delay = 0.0
    wire_bytes = 0.0

    # events: ("pkt", flow id, super-packet index, hop index) or
    # ("recirc", node label)
    sched = _HeapScheduler() if scheduler == "heap" else _CalendarScheduler()

    def serve(sw: NodeId, t: float, width: int) -> float:
        """One service of ``width`` packet-ticks at ``sw``: queue
        accounting + switch occupancy; returns the completion tick."""
        nonlocal queue_delay
        backlog = max(0.0, next_free.get(sw, 0.0) - t)
        if backlog > 0:
            queue_delay += backlog
            queued[sw] = queued.get(sw, 0) + width
            if backlog > max_depth.get(sw, 0.0):
                max_depth[sw] = backlog
        start = t + backlog
        next_free[sw] = start + width
        busy[sw] = busy.get(sw, 0.0) + width
        return start + width

    def node_ready(name: str, t: float) -> None:
        # fire-once guard: a zero-hop flow completes synchronously inside
        # inject(), so a colocated consumer can reach pending == 0 while
        # the seed loop is still walking program.nodes — without the guard
        # the loop would re-fire it and inject its out-flows twice
        if name in ready:
            return
        ready[name] = t
        if stream is not None:
            stream.on_node(name, t)
        for fid in spec.out_flows.get(name, ()):
            inject(fid, t)

    def inject(fid: int, t: float) -> None:
        nonlocal edge_hops
        f = flows[fid]
        hops = f.spec.hops
        edge_hops += hops
        if hops == 0:
            complete(fid, t)
            return
        f.remaining = len(f.spec.train)
        for k in range(len(f.spec.train)):
            sched.push(t, ("pkt", fid, k, 0))

    def complete(fid: int, t: float) -> None:
        d = flows[fid].spec.dst
        arrived[d] = max(arrived.get(d, 0.0), t)
        pending[d] -= 1
        if pending[d] == 0:
            finalize(d, arrived[d])

    def finalize(name: str, t: float) -> None:
        nonlocal recirc
        merges = spec.merges.get(name, 0)
        if merges > 0:
            recirc += merges
            if name in spec.dst_switch:
                # the stored partial re-enters the destination switch's
                # pipeline once per extra source: an event, so the
                # recirculated packets contend in time order with transit
                # traffic at that switch
                sched.push(t, ("recirc", name))
                return
            t += merges  # pragma: no cover - reduce with no routed in-edges
        node_ready(name, t)

    # seed: nodes with no in-flows (Stores, and merge-fed nodes whose
    # in-edges are all colocated) are ready at their propagated release
    # floor (0 unless staggered), in deterministic program order
    rel = _release_floors(program, release)
    for name in program.nodes:
        if pending[name] == 0:
            node_ready(name, rel.get(name, 0.0))

    while sched:
        t, ev = sched.pop()
        if tel is not None:
            tel.advance(t, next_free, busy)
        if ev[0] == "recirc":
            name = ev[1]
            merges = spec.merges[name]
            sw = spec.dst_switch[name]
            if next_free.get(sw, 0.0) <= t:
                # serve() counts the recirculated packets as queued only
                # when the switch is busy; count them here otherwise so
                # they always appear exactly once
                queued[sw] = queued.get(sw, 0) + merges
            depth = max(0.0, next_free.get(sw, 0.0) - t)
            done = serve(sw, t, merges)
            if tel is not None:
                # recirculation is INT traffic too: the loopback port
                tel.on_service(("recirc", name), name, name, 0, sw,
                               (sw, sw), merges, t, done, depth)
            node_ready(name, done)
            continue
        _, fid, k, hop = ev
        f = flows[fid]
        w = f.spec.train[k]
        sw = f.spec.path[hop]
        if tel is not None:
            depth = max(0.0, next_free.get(sw, 0.0) - t)
        done = serve(sw, t, w)
        if tel is not None:
            tel.on_service((fid, hop), f.spec.src, f.spec.dst, hop, sw,
                           (sw, f.spec.path[hop + 1]), w, t, done, depth)
        packet_hops += w
        wire_bytes += cm.wire_bytes(w)
        if hop + 2 == len(f.spec.path):  # crossed the last hop: at dst switch
            f.last_arrival = max(f.last_arrival, done)
            f.remaining -= 1
            if f.remaining == 0:
                complete(fid, f.last_arrival)
        else:
            # a super-packet pipelines internally too: its first
            # constituent packet lands on the next switch one tick after
            # service starts (the w-tick service there keeps causality),
            # so coalescing leaves the h + P − 1 arithmetic unchanged
            sched.push(done - w + 1, ("pkt", fid, k, hop + 1))

    undelivered = sorted(name for name, n in pending.items() if n > 0)
    if undelivered:
        raise ValueError(
            f"simulation did not deliver all traffic: {len(undelivered)} node(s) "
            f"never completed ({', '.join(undelivered[:5])}{'…' if len(undelivered) > 5 else ''}) "
            "— is the routing table missing edges for this program?"
        )
    sinks = spec.sinks if spec.sinks else tuple(program.sinks())
    makespan = max((ready.get(s, 0.0) for s in sinks), default=0.0)
    timeline = None
    if tel is not None:
        tel.advance(makespan, next_free, busy)  # trailing samples
        timeline = tel.finish(makespan, engine_label)
    if stream is not None:
        stream.finish(makespan)
    time_s = makespan * cm.tick_s + recirc * cm.recirculation_s
    total = makespan if makespan > 0 else 1.0
    return SimReport(
        edge_hops=edge_hops,
        packet_hops=packet_hops,
        recirculations=recirc,
        makespan_ticks=int(round(makespan)),
        queue_delay_ticks=int(round(queue_delay)),
        queued_batches=queued,
        wire_bytes=wire_bytes,
        time_s=time_s,
        switch_busy_ticks={sw: int(round(v)) for sw, v in busy.items()},
        switch_utilization={sw: v / total for sw, v in busy.items()},
        max_queue_depth={sw: int(round(v)) for sw, v in max_depth.items()},
        engine=engine_label,
        timeline=timeline,
        sink_finish_ticks={s: int(round(ready.get(s, 0.0))) for s in sinks},
    )


class SimulatorBackend:
    """Streamed execution of a ``CompiledPlan`` (no devices needed)."""

    def __init__(self, plan):
        self.plan = plan

    def run(self, inputs: Mapping[str, np.ndarray], *, engine: str | None = None) -> SimResult:
        plan = self.plan
        program = plan.program
        for name in program.sources():
            if isinstance(program.nodes[name], prim.Store) and name not in inputs:
                raise KeyError(
                    f"missing input for store {name!r}: simulate() needs "
                    f"one array per Store node ({sorted(program.sources())})"
                )
        from repro_torch.core.codelet import execute_reference

        outputs = execute_reference(program, inputs)
        return SimResult(outputs=outputs, report=plan.simulate_timing(engine=engine))
