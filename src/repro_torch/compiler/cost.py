"""§3-derived cost model the compiler optimizes against.

The paper prices data-plane computation by three resources:

* **wire bytes** — every item travels as a fixed-format packet
  (§5 Fig 11), so each traversed hop retransmits header + payload; the
  header overhead is ``1/goodput_fraction`` ≈ 2.4× for the 64-bit item.
* **hop latency** — each switch adds a forwarding delay; the placement
  objective ("minimize the average number of hops") is this term.
* **switch memory** — reducer state tables are scarce (§6); the budget
  bounds both placement and how wide a multi-way reduce may get.

``CostModel.edge_cost_fn`` converts those into the scoring hook
``core.placement.place`` uses instead of the bare hop distance, and
``plan_cost`` scores a finished placement+routing for the driver's emit
pass and the benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Mapping

from repro_torch.core import dag, primitives as prim

NodeId = Hashable

# On-the-wire bits per item, by Store dtype and by map transform. A MapFn
# that narrows the payload (S3's bf16 "serialization in transit") shrinks
# how many packets its downstream edges carry.
_DTYPE_BITS = {
    "uint64": 64, "float64": 64, "uint32": 32, "int32": 32,
    "float32": 32, "bfloat16": 16,
}
_MAP_WIRE_BITS = {"to_bf16": 16, "from_bf16": 32}


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Per-label wire footprint: semantic cardinality and packed packets."""

    items: int
    wire_bits_per_item: int
    packets: int


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Aggregate §3 cost of a compiled plan (lower is better)."""

    wire_bytes: float  # bytes put on wires, counting per-hop retransmission
    packet_hops: int  # hop traversals weighted by packet count
    serial_time_s: float  # Σ per-edge transfer time (serialized upper bound)
    state_bytes_total: int  # reducer state across all switches
    state_bytes_max: int  # hottest switch's reducer state

    @property
    def scalar(self) -> float:
        """Single comparison key: modelled completion time."""
        return self.serial_time_s


@dataclasses.dataclass(frozen=True)
class CostModel:
    packet: prim.PacketFormat = prim.DEFAULT_PACKET
    link_bps: float = 1e9  # per-port capacity C (GbE in the paper)
    hop_latency_s: float = 1e-6  # per-switch forwarding delay
    switch_memory_bytes: int = 1 << 20  # per-switch reducer state budget
    item_bytes: int = 8
    recirculation_s: float = 1e-6  # per stateful-merge recirculation
    max_fanin: int = 8  # cap on multi-way reduce width
    # streaming-simulator granularity: packet trains longer than this are
    # coalesced into integer-weight super-packets (bounds event count)
    sim_train_cap: int = 256
    # ---- streaming-simulator engine knobs (see compiler.vectorized) ----
    # which engine simulate_timing uses by default: the batched-step
    # "vectorized" core, or the per-packet "event" heap (reference)
    sim_engine: str = "vectorized"
    # vectorized-engine fidelity: "voq" = per-port virtual output queues
    # with finite buffers / drops / backpressure (the fast fluid core);
    # "fifo" = infinite-buffer single-FIFO compatibility mode, bit-exact
    # with the event engine (tick-calendar scheduling)
    sim_fidelity: str = "voq"
    # per-hop link latency in ticks (firesim's LINKLATENCY analogue):
    # a packet served at hop i is servable at hop i+1 this many ticks
    # after hop-i service starts
    sim_link_latency_ticks: int = 1
    # per-output-port bandwidth cap in packets/tick (the §3 C/e throttle
    # split per port, firesim's throttle_numer/denom); None = the port
    # never limits below the switch's 1 pkt/tick aggregate service rate
    sim_port_bw: float | None = None
    # finite per-switch transit buffer in packets (firesim's
    # LIMITED_BUFSIZE); None = infinite (the reference model). When
    # finite, arrivals beyond capacity follow ``sim_buffer_policy``
    sim_buffer_packets: float | None = None
    # "backpressure": a full downstream switch stalls the upstream VOQ
    # (credit-based; counted in port_blocked_ticks); "drop": overflow
    # packets vanish (counted in port_drops)
    sim_buffer_policy: str = "backpressure"
    # run the vectorized engine's dense per-step math as torch ops on the
    # card (the reference's ``sim_use_jax``: its jax.jit step; numpy is the
    # default; raises without CUDA). It covers the default knobs only: with
    # port caps, a finite buffer or fifo fidelity it raises, where the
    # reference's jax step quietly leaves the work to numpy
    sim_use_torch: bool = False
    # ---- INT-style fabric telemetry (repro_torch.telemetry.fabric) ----
    # collect per-flow per-hop records (hop latency, queue depth at
    # dequeue, egress utilization) plus tick-sampled per-port series on
    # SimReport.timeline. Off by default: the fast path must pay nothing
    sim_telemetry: bool = False
    # sample the fabric series every this many ticks
    sim_telemetry_interval: float = 16.0
    # streaming aggregation window (repro_torch.telemetry.stream), in ticks:
    # samples are folded into windows this wide and pushed to observers
    # passed via simulate_timing(..., observers=[...]) while the run is
    # live. A window normally spans several sample intervals
    sim_telemetry_window: float = 64.0

    def __post_init__(self) -> None:
        # a zero/negative sampling period would spin the collectors
        # forever (the boundary cursor never advances past t) — reject at
        # construction, naming the knob, instead of hanging a simulation
        for knob in ("sim_telemetry_interval", "sim_telemetry_window"):
            v = getattr(self, knob)
            if not v > 0:
                raise ValueError(
                    f"CostModel.{knob} must be > 0 ticks, got {v!r}"
                )

    # ------------------------------------------------------------ traffic --
    @property
    def tick_s(self) -> float:
        """Wall time of one streaming-simulator tick — one packet's
        service at a switch: serializing ``packet.total_bits`` at line
        rate C, floored by the forwarding latency. This is the §3 ``C/e``
        throttle expressed as a per-switch service rate."""
        return max(self.packet.total_bits / self.link_bps, self.hop_latency_s)

    def wire_bytes(self, packets: int) -> float:
        return packets * self.packet.total_bits / 8.0

    def edge_time_s(self, hops: float, packets: int) -> float:
        """Transfer time of one DAG edge routed over ``hops`` switches:
        packets pipeline hop-to-hop, so serialization is paid once and each
        hop adds forwarding latency."""
        if hops <= 0:
            return 0.0
        return self.wire_bytes(packets) * 8.0 / self.link_bps + hops * self.hop_latency_s

    # ------------------------------------------------------ cardinalities --
    def estimate_items(self, program: dag.Program) -> dict[str, int]:
        """Per-label output cardinality (items), propagated from Store
        declarations. Unknown stores default to 1 item; a Reduce emits its
        state table (``state_width`` items)."""
        return {k: t.items for k, t in self.traffic(program).items()}

    def traffic(self, program: dag.Program) -> dict[str, Traffic]:
        """Per-label wire footprint. Items propagate from Store declarations
        (Reduce emits its state table); per-item wire bits propagate from
        the Store dtype and narrowing MapFns, and multiple narrow items pack
        into the packet's 64-bit data field."""
        out: dict[str, Traffic] = {}
        data_bits = self.packet.data_bits
        for n in program.toposort():
            if isinstance(n, prim.Store):
                items = max(1, n.items)
                bits = _DTYPE_BITS.get(n.dtype, data_bits)
            elif isinstance(n, prim.Reduce):
                items = max(1, n.state_width)
                # reducer state accumulates at full precision
                bits = self.item_bytes * 8
            elif isinstance(n, prim.MapFn):
                up = out[n.deps[0]]
                items = up.items
                bits = _MAP_WIRE_BITS.get(n.fn_name, up.wire_bits_per_item)
            elif isinstance(n, prim.ShuffleBucket):
                # after a real shuffle the footprint splits across buckets:
                # each bucket edge carries only its key-space slice
                up = out[n.deps[0]]
                items = max(1, n.width)
                bits = up.wire_bits_per_item
            elif isinstance(n, prim.Concat):
                parts = [out[s] for s in n.deps]
                items = sum(t.items for t in parts)
                bits = max(t.wire_bits_per_item for t in parts)
            else:  # unlowered KeyBy / Collect preserve the upstream footprint
                up = out[n.deps[0]]
                items, bits = up.items, up.wire_bits_per_item
            packets = max(1, -(-items * bits // data_bits))  # ceil division
            out[n.name] = Traffic(items=items, wire_bits_per_item=bits, packets=packets)
        return out

    # ----------------------------------------------------------- scoring --
    def edge_cost_fn(
        self, topo, traffic: Mapping[str, Traffic]
    ) -> Callable[[NodeId, NodeId, str], float]:
        """Placement scoring hook: §3 transfer time of routing ``dep_label``'s
        traffic between two switches (replaces bare hop count)."""
        dist = getattr(topo, "weighted_distance", topo.hop_distance)

        def edge_cost(src_sw: NodeId, dst_sw: NodeId, dep_label: str) -> float:
            t = traffic.get(dep_label)
            return self.edge_time_s(dist(src_sw, dst_sw), t.packets if t else 1)

        return edge_cost

    def reduce_max_fanin(self, node: prim.Reduce) -> int:
        """Widest multi-way reduce a switch can host: each in-flight source
        needs its own state slot, so fan-in × state_bytes must fit the
        per-switch memory budget."""
        state = max(node.state_bytes(self.item_bytes), self.item_bytes)
        by_memory = self.switch_memory_bytes // state
        return max(2, min(self.max_fanin, by_memory))

    def plan_cost(self, program: dag.Program, topo, placement, routes) -> PlanCost:
        traffic = self.traffic(program)
        wire = 0.0
        pkt_hops = 0
        time_s = 0.0
        for r in routes.routes:
            pk = traffic[r.src_label].packets if r.src_label in traffic else 1
            wire += self.wire_bytes(pk) * r.hops
            pkt_hops += pk * r.hops
            time_s += self.edge_time_s(r.hops, pk)
        return PlanCost(
            wire_bytes=wire,
            packet_hops=pkt_hops,
            serial_time_s=time_s,
            state_bytes_total=sum(placement.state_used.values()),
            state_bytes_max=max(placement.state_used.values(), default=0),
        )
