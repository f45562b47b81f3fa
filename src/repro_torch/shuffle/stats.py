"""Shuffle inspection: per-bucket traffic and switch residency of a plan.

``plan_shuffle(plan)`` summarizes the lowered shuffle inside a
``CompiledPlan`` — per-bucket key-space widths, wire bytes actually put on
links (packets × route hops, from the same §3 cost model the placer
optimized), the bucket→switch assignment and the per-switch reducer-state
residency. This is the signal bucket-count arbitration minimizes: more
buckets spread reducer state across switches but pay more per-packet
header overhead; fewer buckets concentrate state until the hot switch's
memory budget (and queue) gives out.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Sequence

from repro_torch.core import dag, primitives as prim

NodeId = Hashable


@dataclasses.dataclass(frozen=True)
class ShuffleStats:
    num_buckets: int  # declared KeyBy bucket count (max across shuffles)
    bucket_items: dict[int, int]  # bucket -> items carried (slice width × mappers)
    bucket_wire_bytes: dict[int, float]  # bucket -> bytes on wires (x hop retransmission)
    bucket_switch: dict[int, NodeId]  # bucket -> reducer switch
    residency_by_switch: dict[NodeId, int]  # switch -> per-bucket reducer state bytes
    total_wire_bytes: float
    # streamed timing of the whole plan (per-packet simulator): skew-induced
    # queueing shows up here, not in the static wire-byte split
    streamed_makespan_ticks: int = 0
    streamed_queue_delay_ticks: int = 0

    @property
    def max_switch_residency_bytes(self) -> int:
        return max(self.residency_by_switch.values(), default=0)

    @property
    def hot_bucket(self) -> int | None:
        from repro_torch.telemetry.fabric import hottest

        return hottest(self.bucket_wire_bytes)


def plan_shuffle(plan) -> ShuffleStats | None:
    """Shuffle stats of a compiled plan; ``None`` when the plan has no
    lowered shuffle (no ``ShuffleBucket`` nodes)."""
    program = plan.program
    buckets = [n for n in program if isinstance(n, prim.ShuffleBucket)]
    if not buckets:
        return None
    traffic = plan.cost_model.traffic(program)

    # bucket_of resolves any shuffle-internal label to its bucket id:
    # a ShuffleBucket directly, or a Reduce (per-bucket reducer OR an
    # insert-combiners partial aggregate) whose sources all resolve to one
    # bucket. None for everything else (mappers, Concat, mixed reduces).
    bucket_of: dict[str, int | None] = {n.name: n.bucket for n in buckets}

    def resolve(label: str) -> int | None:
        if label in bucket_of:
            return bucket_of[label]
        node = program.nodes[label]
        b: int | None = None
        if isinstance(node, prim.Reduce):
            got = {resolve(s) for s in node.srcs}
            if len(got) == 1:
                b = got.pop()
        bucket_of[label] = b
        return b

    bucket_items: dict[int, int] = {}
    for n in buckets:
        bucket_items[n.bucket] = bucket_items.get(n.bucket, 0) + n.width

    # wire bytes of the shuffle fan-out: every routed edge that stays
    # inside one bucket's reduce tree (bucket edge → combiner → reducer);
    # the reducer→Concat flush is collection-phase traffic, not counted
    bucket_wire: dict[int, float] = {b: 0.0 for b in bucket_items}
    for r in plan.routes.routes:
        b = resolve(r.src_label)
        if b is not None and resolve(r.dst_label) == b:
            bucket_wire[b] = bucket_wire.get(b, 0.0) + (
                plan.cost_model.wire_bytes(traffic[r.src_label].packets) * r.hops
            )

    bucket_switch: dict[int, NodeId] = {}
    residency: dict[NodeId, int] = {}
    for n in program:
        if not isinstance(n, prim.Reduce):
            continue
        b = resolve(n.name)
        if b is None:
            continue
        sw = plan.placement.switch_of(n.name)
        residency[sw] = residency.get(sw, 0) + n.state_bytes(plan.cost_model.item_bytes)
        # the bucket's reducer is the root of its reduce tree (no consumer
        # still inside the same bucket)
        if not any(resolve(c) == b for c in program.consumers(n.name)):
            bucket_switch.setdefault(b, sw)

    streamed = plan.simulate_timing()
    return ShuffleStats(
        num_buckets=max(n.num_buckets for n in buckets),
        bucket_items=dict(sorted(bucket_items.items())),
        bucket_wire_bytes=dict(sorted(bucket_wire.items())),
        bucket_switch=dict(sorted(bucket_switch.items())),
        residency_by_switch=residency,
        total_wire_bytes=sum(bucket_wire.values()),
        streamed_makespan_ticks=streamed.makespan_ticks,
        streamed_queue_delay_ticks=streamed.queue_delay_ticks,
    )


def measured_bucket_packets(plan) -> dict[int, int]:
    """Per-bucket packet counts of a lowered plan's shuffle — the same
    dtype-packed trains the streaming simulator services, summed over all
    mappers feeding each bucket. This is the measured signal the autotune
    ``reweight`` action learns ``KeyBy.weights`` from (instead of trusting
    the declaration). Empty when the plan has no lowered shuffle."""
    traffic = plan.cost_model.traffic(plan.program)
    packets: dict[int, int] = {}
    for n in plan.program:
        if isinstance(n, prim.ShuffleBucket):
            packets[n.bucket] = packets.get(n.bucket, 0) + traffic[n.name].packets
    return dict(sorted(packets.items()))


def with_weights(program: dag.Program, weights: Sequence[float] | None) -> dag.Program:
    """Copy of ``program`` with every KeyBy's skew ``weights`` replaced
    (``None`` resets to uniform), for the autotune reweight action."""
    nodes = []
    for n in program:
        if isinstance(n, prim.KeyBy):
            if weights is not None and len(weights) != n.num_buckets:
                raise ValueError(
                    f"{len(weights)} weights for keyby {n.name!r} with {n.num_buckets} buckets"
                )
            n = prim.KeyBy(
                name=n.name,
                src=n.src,
                num_buckets=n.num_buckets,
                weights=tuple(weights) if weights is not None else None,
            )
        nodes.append(n)
    return dag.Program.from_nodes(nodes)


def with_num_buckets(program: dag.Program, num_buckets: int) -> dag.Program:
    """Copy of ``program`` with every KeyBy rewritten to ``num_buckets``
    (declared skew re-binned via ``resample_weights``), for bucket-count
    arbitration."""
    from repro_torch.shuffle.lower import resample_weights

    nodes = []
    for n in program:
        if isinstance(n, prim.KeyBy):
            weights = (
                resample_weights(n.weights, num_buckets) if n.weights is not None else None
            )
            n = prim.KeyBy(
                name=n.name, src=n.src, num_buckets=num_buckets, weights=weights
            )
        nodes.append(n)
    return dag.Program.from_nodes(nodes)


def arbitrate_buckets(
    program_or_factory,
    topology,
    candidates: Sequence[int],
    *,
    cost_model=None,
    pins=None,
    passes=None,
    options=None,
    objective: str = "streamed",
):
    """Compile one plan per candidate bucket count, keep the cheapest.

    The same move as ``compiler.compile_best``'s chain-vs-tree arbitration,
    applied to the shuffle's fan-out degree. With the default
    ``objective="streamed"`` each candidate is priced by its *streamed*
    makespan (the per-packet simulator's completion time, which sees
    skew-induced queueing and recirculation hotspots), tie-broken by the
    static §3 cost; ``objective="static"`` keeps the old analytic-only
    scoring (cheaper: no simulate round per candidate).
    ``program_or_factory`` is either a Program whose KeyBys are rewritten
    per candidate, or a callable ``(num_buckets) -> Program``; ``options``
    is the driver's per-pass options dict, applied to every candidate
    compile.

    Infeasible candidates don't win and don't crash the arbitration: a
    bucket count whose compile fails the static verifier (e.g. its
    per-bucket reducer state overbooks a switch — the V205 §3 memory
    check, not the lowering's soft budget) or cannot be placed at all is
    dropped from the race. Only when *every* candidate is infeasible does
    the arbitration raise, as a ``VerificationError`` aggregating each
    candidate's diagnostics.
    """
    from repro_torch import compiler, verify
    from repro_torch.core.placement import PlacementError

    if not candidates:
        raise ValueError("need at least one candidate bucket count")
    if objective not in ("streamed", "static"):
        raise ValueError(f"unknown objective {objective!r} (streamed or static)")
    make: Callable[[int], dag.Program]
    if callable(program_or_factory):
        make = program_or_factory
    else:
        make = lambda b: with_num_buckets(program_or_factory, b)  # noqa: E731
    plans = []
    rejected: list = []  # diagnostics of every infeasible candidate
    for b in dict.fromkeys(candidates):
        try:
            pl = compiler.compile(
                make(b),
                topology,
                cost_model=cost_model,
                pins=dict(pins) if pins else None,
                passes=passes,
                options=dict(options) if options else None,
            )
        except verify.VerificationError as e:
            rejected.extend(e.diagnostics)
            continue
        except PlacementError as e:
            rejected.append(
                verify.Diagnostic(
                    "V205", verify.Severity.ERROR, f"{b} bucket(s): {e}"
                )
            )
            continue
        # pipelines without the always-on pass (custom ``passes=``) still
        # get the static check before a candidate may win the arbitration
        diags = pl.diagnostics if pl.diagnostics is not None else verify.verify_plan(pl)
        errs = verify.errors_of(diags)
        if errs:
            rejected.extend(diags)
            continue
        plans.append(pl)
    if not plans:
        if rejected:
            raise verify.VerificationError(rejected)
        raise ValueError("no feasible bucket count among candidates")
    if objective == "static":
        return min(plans, key=lambda pl: pl.cost.scalar)
    return min(plans, key=lambda pl: (pl.simulate_timing().time_s, pl.cost.scalar))
