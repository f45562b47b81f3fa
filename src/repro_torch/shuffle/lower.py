"""``lower-shuffle`` — expand KeyBy fan-out into compiler-visible buckets.

The paper's Map-Reduce speed-up hinges on the data plane carrying the
mapper→reducer shuffle, but an unlowered ``KeyBy`` is a pass-through
annotation: one edge, no bucket routing, invisible to placement and the
§3 cost model. This pass rewrites every reduce fed exclusively by KeyBy
nodes (the MAP→KEYBY→REDUCE shape) into

    mapper_i ── K_i__b{b} ──▶ R__p{b} ──▶ R (Concat) ──▶ Collect
               ShuffleBucket   per-bucket      bucket-order
               (rides mapper)  Reduce, pinned  reassembly
                               by §3 CostModel

* each ``ShuffleBucket`` carries one contiguous slice of the key space
  (widths proportional to the KeyBy's declared ``weights`` — skew makes
  hot buckets genuinely heavier on the wire and in reducer state);
* the bucket→reducer-switch assignment is chosen greedily per bucket
  (hot buckets first) by the cost model's §3 edge-time, subject to the
  per-switch memory budget — the P4COM concern that the shuffle is where
  in-network computation wins or loses on switch memory;
* the reduce keeps its label as a ``Concat`` of the per-bucket reducers,
  so downstream consumers (and program sinks) are untouched and the
  lowered program is value-identical to the pass-through form.

A reduce is left unlowered (with a note in the pass summary) when its
sources are not all same-bucket-count KeyBys, when a KeyBy feeds more
than one consumer, when the upstream cardinality does not match the
reduce's key space (``state_width``), or when no bucket assignment fits
the memory budget.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable, Sequence

from repro_torch.compiler.driver import CompileCtx, register_pass
from repro_torch.core import dag, primitives as prim

NodeId = Hashable

# Reductions that may be split across per-bucket reducers (elementwise,
# associative & commutative — same set the rebalance pass restructures).
_ASSOCIATIVE = (
    prim.ReduceKind.SUM,
    prim.ReduceKind.COUNT,
    prim.ReduceKind.MAX,
    prim.ReduceKind.MIN,
)


def split_widths(total: int, num_buckets: int, weights: Sequence[float] | None = None) -> list[int]:
    """Contiguous per-bucket slice widths summing to ``total``.

    Proportional to ``weights`` (uniform when None) via largest-remainder
    rounding, so hot buckets get wider slices. Buckets may get width 0
    when ``total < num_buckets`` or a weight is 0.
    """
    if num_buckets < 1:
        raise ValueError("num_buckets must be >= 1")
    if weights is None:
        weights = [1.0] * num_buckets
    if len(weights) != num_buckets:
        raise ValueError(f"{len(weights)} weights for {num_buckets} buckets")
    wsum = float(sum(weights))
    if wsum <= 0 or any(w < 0 for w in weights):
        raise ValueError("weights must be >= 0 with a positive sum")
    quotas = [total * w / wsum for w in weights]
    widths = [int(q) for q in quotas]
    rem = total - sum(widths)
    # hand out the remainder by the largest fractional part (ties: lower id)
    order = sorted(range(num_buckets), key=lambda b: (-(quotas[b] - widths[b]), b))
    for b in order[:rem]:
        widths[b] += 1
    return widths


def resample_weights(weights: Sequence[float], new_buckets: int) -> tuple[float, ...]:
    """Re-bin a per-bucket traffic histogram to a different bucket count.

    Treats ``weights`` as a piecewise-constant density over the unit key
    space and integrates it over the new, equal-width bins — so arbitrating
    bucket counts preserves the declared skew shape.
    """
    old_b = len(weights)
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("weights must have a positive sum")
    cdf = [0.0]
    for w in weights:
        cdf.append(cdf[-1] + w / total)

    def cdf_at(x: float) -> float:
        # x in [0, 1]; linear within each old bin
        pos = min(max(x, 0.0), 1.0) * old_b
        i = min(int(pos), old_b - 1)
        frac = pos - i
        return cdf[i] + (cdf[i + 1] - cdf[i]) * frac

    edges = [cdf_at(j / new_buckets) for j in range(new_buckets + 1)]
    return tuple(edges[j + 1] - edges[j] for j in range(new_buckets))


@dataclasses.dataclass
class _Shuffle:
    """One lowerable reduce and everything the rewrite needs."""

    reduce: prim.Reduce
    keybys: list[prim.KeyBy]
    widths: list[int]
    offsets: list[int]
    bucket_switch: dict[int, NodeId]
    sink_switch: NodeId | None


def _fresh(program: dag.Program, taken: set[str], base: str) -> str:
    name = base
    i = 0
    while name in program.nodes or name in taken:
        i += 1
        name = f"{base}_{i}"
    taken.add(name)
    return name


def _mapper_switch(ctx: CompileCtx, p: dag.Program, label: str) -> NodeId | None:
    """Switch a label's output enters the network at (Store uplink, a pin,
    or a stateless transform riding on one) — mirrors the combiner pass."""
    node = p.nodes[label]
    if label in ctx.pins:
        return ctx.pins[label]
    if isinstance(node, prim.Store):
        return ctx.topology.attach_switch(node.host)
    if isinstance(node, (prim.MapFn, prim.KeyBy, prim.ShuffleBucket)):
        return _mapper_switch(ctx, p, node.deps[0])
    return None


def _single_collect_sink(ctx: CompileCtx, p: dag.Program, label: str) -> NodeId | None:
    cons = p.consumers(label)
    if len(cons) == 1 and isinstance(p.nodes[cons[0]], prim.Collect):
        return ctx.topology.attach_switch(p.nodes[cons[0]].sink_host)
    return None


def _assign_buckets(
    ctx: CompileCtx,
    widths: list[int],
    wire_bits: int,
    mapper_switches: list[NodeId],
    sink_switch: NodeId | None,
    budget_used: dict[NodeId, int],
    pinned_to: NodeId | None,
) -> dict[int, NodeId] | None:
    """Greedy bucket→reducer-switch assignment by §3 edge-time under the
    per-switch memory budget. Hot (widest) buckets pick first. Returns None
    when some bucket fits nowhere (caller skips lowering)."""
    cm = ctx.cost_model
    topo = ctx.topology
    dist = getattr(topo, "weighted_distance", topo.hop_distance)
    data_bits = cm.packet.data_bits
    trial = dict(budget_used)
    chosen: dict[int, NodeId] = {}
    inflow: dict[NodeId, int] = {}  # packets already converging on the switch
    for b in sorted(range(len(widths)), key=lambda b: (-widths[b], b)):
        w = widths[b]
        if w == 0:
            continue
        need = max(w * cm.item_bytes, cm.item_bytes)
        packets = max(1, -(-w * wire_bits // data_bits))

        def score(sw: NodeId) -> tuple[float, int, str]:
            t = sum(cm.edge_time_s(dist(m, sw), packets) for m in mapper_switches)
            if sink_switch is not None:
                t += cm.edge_time_s(dist(sw, sink_switch), packets)
            # §3 port contention: buckets already landing on this switch
            # serialize ahead of us, so a hot reducer switch costs real time
            # (this is what spreads buckets instead of piling on the sink)
            t += cm.wire_bytes(inflow.get(sw, 0)) * 8.0 / cm.link_bps
            return (t, inflow.get(sw, 0), str(sw))

        candidates = [pinned_to] if pinned_to is not None else sorted(topo.switches, key=score)
        placed = False
        for sw in candidates:
            if trial.get(sw, 0) + need <= cm.switch_memory_bytes:
                chosen[b] = sw
                trial[sw] = trial.get(sw, 0) + need
                inflow[sw] = inflow.get(sw, 0) + packets * max(1, len(mapper_switches))
                placed = True
                break
        if not placed:
            return None
    budget_used.update(trial)
    return chosen


@register_pass("lower-shuffle")
def lower_shuffle_pass(ctx: CompileCtx) -> str:
    p = ctx.require_program()
    cm = ctx.cost_model
    traffic = cm.traffic(p)

    budget_used: dict[NodeId, int] = {}
    for label, sw in ctx.pins.items():
        if label in p.nodes:
            budget_used[sw] = budget_used.get(sw, 0) + p.nodes[label].state_bytes(cm.item_bytes)

    shuffles: dict[str, _Shuffle] = {}  # reduce label -> rewrite
    lowered_keybys: set[str] = set()
    skipped = 0

    for node in p.toposort():
        if not isinstance(node, prim.Reduce) or node.kind not in _ASSOCIATIVE:
            continue
        srcs = [p.nodes[s] for s in dict.fromkeys(node.srcs)]
        if len(srcs) != len(node.srcs):  # duplicate sources: not a shuffle
            continue
        if not srcs or not all(isinstance(s, prim.KeyBy) for s in srcs):
            continue
        keybys = srcs
        buckets = {k.num_buckets for k in keybys}
        width = node.state_width
        if (
            len(buckets) != 1
            or any(len(p.consumers(k.name)) != 1 for k in keybys)
            or any(k.name in ctx.pins for k in keybys)
            or any(traffic[k.name].items != width for k in keybys)
        ):
            skipped += 1
            continue
        num_buckets = buckets.pop()
        weights = next((k.weights for k in keybys if k.weights is not None), None)
        widths = split_widths(width, num_buckets, weights)
        offsets = [0] * num_buckets
        for b in range(1, num_buckets):
            offsets[b] = offsets[b - 1] + widths[b - 1]
        mapper_switches = []
        for k in keybys:
            sw = _mapper_switch(ctx, p, k.src)
            if sw is not None:
                mapper_switches.append(sw)
        pinned_sw = ctx.pins.get(node.name)
        if pinned_sw is not None:
            # the pinned reduce becomes a stateless Concat after lowering:
            # release its pre-charged state so the per-bucket reducers are
            # budgeted against the memory actually used
            budget_used[pinned_sw] = budget_used.get(pinned_sw, 0) - node.state_bytes(
                cm.item_bytes
            )
        assigned = _assign_buckets(
            ctx,
            widths,
            traffic[keybys[0].name].wire_bits_per_item,
            mapper_switches,
            _single_collect_sink(ctx, p, node.name),
            budget_used,
            pinned_sw,
        )
        if assigned is None:
            if pinned_sw is not None:  # not lowered: the reduce keeps its state
                budget_used[pinned_sw] = budget_used.get(pinned_sw, 0) + node.state_bytes(
                    cm.item_bytes
                )
            skipped += 1
            continue
        shuffles[node.name] = _Shuffle(
            reduce=node,
            keybys=keybys,
            widths=widths,
            offsets=offsets,
            bucket_switch=assigned,
            sink_switch=_single_collect_sink(ctx, p, node.name),
        )
        lowered_keybys.update(k.name for k in keybys)

    if not shuffles:
        return f"no lowerable KeyBy shuffles ({skipped} skipped)" if skipped else "no KeyBy shuffles"

    taken: set[str] = set()
    nodes: list[prim.Node] = []
    n_buckets_out = 0
    # lowering record for downstream consumers (plan.shuffle_meta): the
    # autotune move-reducer action needs the per-bucket reducer labels and
    # reweight needs declared widths, without re-deriving them from the
    # rewritten DAG
    meta = ctx.options.setdefault("shuffle_lowering", {})
    for n in p:
        if n.name in lowered_keybys:
            continue  # replaced by its ShuffleBucket nodes (emitted below)
        if n.name not in shuffles:
            nodes.append(n)
            continue
        sh = shuffles[n.name]
        meta[n.name] = {
            "num_buckets": len(sh.widths),
            "widths": list(sh.widths),
            "offsets": list(sh.offsets),
            "keybys": [k.name for k in sh.keybys],
            "bucket_switch": dict(sh.bucket_switch),
            "bucket_reducers": {},
        }
        part_labels: list[str] = []
        for b, sw in sorted(sh.bucket_switch.items()):
            member_labels = []
            for k in sh.keybys:
                blabel = _fresh(p, taken, f"{k.name}__b{b}")
                nodes.append(
                    prim.ShuffleBucket(
                        name=blabel,
                        src=k.src,
                        bucket=b,
                        num_buckets=k.num_buckets,
                        offset=sh.offsets[b],
                        width=sh.widths[b],
                    )
                )
                member_labels.append(blabel)
                n_buckets_out += 1
            plabel = _fresh(p, taken, f"{n.name}__p{b}")
            nodes.append(
                prim.Reduce(
                    name=plabel,
                    srcs=tuple(member_labels),
                    kind=sh.reduce.kind,
                    state_width=sh.widths[b],
                )
            )
            ctx.pins[plabel] = sw
            meta[n.name]["bucket_reducers"][b] = plabel
            part_labels.append(plabel)
        nodes.append(prim.Concat(name=n.name, srcs=tuple(part_labels)))
        if sh.sink_switch is not None and n.name not in ctx.pins:
            ctx.pins[n.name] = sh.sink_switch  # reassemble at the collect sink
    ctx.program = dag.Program.from_nodes(nodes)

    per_reduce = ", ".join(
        f"{name}:{len(sh.bucket_switch)}/{len(sh.widths)} buckets" for name, sh in shuffles.items()
    )
    note = f", {skipped} skipped" if skipped else ""
    return f"lowered {len(shuffles)} shuffle(s) [{per_reduce}], {n_buckets_out} bucket edge(s){note}"
