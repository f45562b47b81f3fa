"""Plan-mutation action space for the profile-guided autotuner.

Every action turns one ``CompiledPlan`` into candidate mutated plans,
priced later by the streaming simulator (``search.hill_climb`` accepts
only measured improvements). Four families, each closing a loop the
``reroute-feedback`` pass left open (ROADMAP open items):

* ``reroute``       — replace one hot flow's path with a k-shortest-paths
                      alternative (``core.routing.k_shortest_paths``):
                      measured queueing may justify strictly *longer*
                      detours, which the ECMP tie-break can never propose;
* ``move-reducer``  — relocate a per-bucket reducer away from a switch the
                      simulator measured as queued (the placement analogue
                      of reroute-feedback), via the ``pins`` hook;
* ``rebucket``      — recompile at a different KeyBy bucket count, with
                      candidates pruned by an analytic bottleneck model
                      over the shuffle stats so only the promising counts
                      pay a simulate round;
* ``reweight``      — relearn ``KeyBy.weights`` from the *measured*
                      per-bucket packet counts instead of the declaration:
                      the lowering then re-slices the key space so
                      per-bucket load equalizes (declared skew self-reports
                      its own hot buckets; the measurement says how hot).

Mutations never change program semantics: reroute/move-reducer touch only
paths and placement, and rebucket/reweight re-slice the key space whose
bucket-order reassembly (``Concat``) is width-agnostic — value
preservation is pinned by tests.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable

from repro_torch.autotune.search import Candidate, SkipCandidate
from repro_torch.compiler import driver as _driver
from repro_torch.compiler.plan import CompiledPlan
from repro_torch.core import primitives as prim
from repro_torch.core.placement import PlacementError
from repro_torch.core.routing import RoutingTable, k_shortest_paths

NodeId = Hashable

# Action family names, in proposal order.
DEFAULT_ACTIONS: tuple[str, ...] = ("reroute", "move-reducer", "rebucket", "reweight")

# Backend-only recompile for mutations of an already-lowered program
# (move-reducer): re-place under the mutated pins, re-route, and let the
# feedback pass settle the new geometry. No optimization passes — the
# program rewrite already happened when the input plan was compiled.
_REPLACE_PASSES: tuple[str, ...] = (
    "parse",
    "validate",
    "place",
    "route",
    "reroute-feedback",
    "emit",
)


def _path_str(path: tuple[NodeId, ...]) -> str:
    return "→".join(str(s) for s in path)


# Cache keys: every Candidate carries a hashable key naming the MUTATION
# alone — ("reroute", flow, path), ("move-reducer", label, switch), … —
# not the incumbent state it mutates. Earlier keys fingerprinted the full
# routing table / program, which churn after every accepted action, so
# identical re-proposed mutations never hit (BENCH_autotune measured 0/31
# hits on fat-tree cells). A hit serves the score measured earlier in the
# SAME climb and is never accepted (see ``search.hill_climb``), so the
# never-worse guarantee is untouched; the accepted tradeoff is that a
# mutation whose value changed under a new incumbent is not re-measured
# within that climb.


def _with_routes(plan: CompiledPlan, routes: RoutingTable) -> CompiledPlan:
    """Same plan, different routing table (cost re-scored, timing memo
    dropped with the new instance)."""
    cost = plan.cost_model.plan_cost(plan.program, plan.topology, plan.placement, routes)
    return dataclasses.replace(plan, routes=routes, cost=cost, tuning=None)


def reroute_candidates(
    plan: CompiledPlan, *, max_flows: int = 3, max_paths: int = 4
) -> list[Candidate]:
    """Detour the flows most exposed to measured queueing.

    Flows are ranked by exposure × their own packet train length, where
    exposure is the measured contention along the flow's path: per-switch
    queued packets and buffer drops, plus the VOQ engine's per-port peak
    depth on the exact links the flow crosses (a flow sharing a switch
    through an uncontended port no longer looks hot). For each of the top
    ``max_flows`` every k-shortest-paths alternative (including strictly
    longer ones) becomes a candidate replacing just that flow's path.
    """
    from repro_torch.telemetry.fabric import link_pressure, switch_pressure

    rep = plan.simulate_timing()
    sw_pressure = switch_pressure(rep)
    lk_pressure = link_pressure(rep)
    if not sw_pressure:
        return []
    traffic = plan.cost_model.traffic(plan.program)
    scored = []
    for idx, r in enumerate(plan.routes.routes):
        if r.hops == 0:
            continue
        exposure = sum(sw_pressure.get(sw, 0.0) for sw in r.path)
        exposure += sum(lk_pressure.get(link, 0.0) for link in zip(r.path, r.path[1:]))
        if exposure <= 0:
            continue
        pk = traffic[r.src_label].packets if r.src_label in traffic else 1
        scored.append((exposure * pk, idx))
    scored.sort(key=lambda t: (-t[0], t[1]))

    out: list[Candidate] = []
    for _, idx in scored[:max_flows]:
        r = plan.routes.routes[idx]
        try:
            alts = k_shortest_paths(plan.topology, r.path[0], r.path[-1], max_paths)
        except ValueError:
            continue
        for alt in alts:
            if alt == r.path:
                continue

            def build(idx=idx, alt=alt):
                routes = list(plan.routes.routes)
                routes[idx] = dataclasses.replace(routes[idx], path=alt)
                return _with_routes(plan, RoutingTable(routes=routes))

            out.append(
                Candidate(
                    kind="reroute",
                    detail=(
                        f"{r.src_label}→{r.dst_label}: {r.hops} hops "
                        f"[{_path_str(r.path)}] ⇒ {len(alt) - 1} hops [{_path_str(alt)}]"
                    ),
                    build=build,
                    # the mutation alone: which flow, which new path
                    cache_key=("reroute", r.src_label, r.dst_label, idx, alt),
                )
            )
    return out


def _pinned_reducers(plan: CompiledPlan) -> list[str]:
    """Relocatable reducer labels: the lowered shuffle's per-bucket
    reducers when metadata is present, else any pinned Reduce."""
    if plan.shuffle_meta:
        labels = [
            lbl
            for meta in plan.shuffle_meta.values()
            for lbl in meta["bucket_reducers"].values()
        ]
        return [lbl for lbl in labels if lbl in plan.program.nodes]
    return sorted(
        lbl
        for lbl in plan.pins
        if isinstance(plan.program.nodes.get(lbl), prim.Reduce)
    )


def move_reducer_candidates(
    plan: CompiledPlan, *, max_reducers: int = 2, max_switches: int = 2
) -> list[Candidate]:
    """Relocate the reducers sitting on the most-queued switches.

    Targets are chosen by the simulator's per-switch queue-depth
    histograms plus measured buffer drops at the switch (packets a finite
    buffer discarded are stronger evidence of overload than backlog
    alone): hottest reducers move, coldest switches (by queued+dropped
    packets, then max backlog) receive. The rebuild recompiles the
    lowered program under the mutated pin through place → route →
    reroute-feedback, so routes follow the reducer; a move that overflows
    the target switch's memory budget is skipped, not fatal.
    """
    from repro_torch.telemetry.fabric import rank_cold, rank_hot, switch_pressure

    reducers = _pinned_reducers(plan)
    if not reducers:
        return []
    rep = plan.simulate_timing()
    queued, depth = rep.queued_batches, rep.max_queue_depth
    pressure = switch_pressure(rep)

    # rank the reducer labels by their host switch's unified pressure
    # (queued + dropped packets), breaking ties by max backlog then label
    label_pressure = {
        lbl: pressure.get(plan.placement.switch_of(lbl), 0.0) for lbl in reducers
    }
    label_depth = {
        lbl: depth.get(plan.placement.switch_of(lbl), 0) for lbl in reducers
    }
    hot = rank_hot(label_pressure, secondary=label_depth)[:max_reducers]
    out: list[Candidate] = []
    for label in hot:
        cur = plan.placement.switch_of(label)
        if pressure.get(cur, 0.0) <= 0:
            continue  # nothing measured against this switch: leave it
        targets = rank_cold(
            pressure,
            (sw for sw in plan.topology.switches if sw != cur),
            secondary=depth,
        )[:max_switches]
        for sw in targets:

            def build(label=label, sw=sw):
                try:
                    new = _driver.compile(
                        plan.program,
                        plan.topology,
                        cost_model=plan.cost_model,
                        pins={**plan.pins, label: sw},
                        passes=_REPLACE_PASSES,
                    )
                except PlacementError as e:
                    raise SkipCandidate(str(e)) from None
                # carry pre-lowering provenance through the backend-only
                # recompile so later rebucket/reweight rounds still work
                new.source_program = plan.source_program
                new.user_pins = dict(plan.user_pins)
                new.shuffle_meta = _moved_meta(plan.shuffle_meta, label, sw)
                return new

            out.append(
                Candidate(
                    kind="move-reducer",
                    detail=f"{label}: {cur} ⇒ {sw} (queued {queued.get(cur, 0)} pkt)",
                    build=build,
                    # the mutation alone: which reducer, which new switch
                    cache_key=("move-reducer", label, sw),
                )
            )
    return out


def _recompile_or_skip(make_program, plan: CompiledPlan) -> CompiledPlan:
    """Full-pipeline recompile of a mutated source program; infeasible
    mutations (a bucket count whose reducers overflow every switch's
    memory budget, inconsistent KeyBy shapes) skip instead of aborting
    the search — the never-worse guarantee must survive a bad candidate."""
    try:
        return _driver.compile(
            make_program(),
            plan.topology,
            cost_model=plan.cost_model,
            pins=dict(plan.user_pins),
        )
    except (PlacementError, ValueError) as e:
        raise SkipCandidate(str(e)) from None


def _moved_meta(meta: dict | None, label: str, sw: NodeId) -> dict | None:
    if meta is None:
        return None
    out = {}
    for red, m in meta.items():
        m = {**m, "bucket_switch": dict(m["bucket_switch"])}
        for b, plabel in m["bucket_reducers"].items():
            if plabel == label:
                m["bucket_switch"][b] = sw
        out[red] = m
    return out


def _shuffle_shape(plan: CompiledPlan):
    """(source program, keybys, reduce width, wire bits) of the shuffle in
    the plan's pre-lowering program; None when there is none."""
    src = plan.source_program
    if src is None:
        return None
    keybys = [n for n in src if isinstance(n, prim.KeyBy)]
    if not keybys:
        return None
    widths = []
    for n in src:
        if isinstance(n, prim.Reduce) and any(
            isinstance(src.nodes[s], prim.KeyBy) for s in n.srcs
        ):
            widths.append(n.state_width)
    if not widths:
        return None
    traffic = plan.cost_model.traffic(src)
    return src, keybys, max(widths), traffic[keybys[0].name].wire_bits_per_item


def rebucket_candidates(plan: CompiledPlan, *, n_sim: int = 2) -> list[Candidate]:
    """Change the KeyBy fan-out degree, pruning candidates analytically.

    Candidate counts (half / double the current) are ranked by a bottleneck
    model over the shuffle stats — the hottest bucket's total packet train
    (every mapper's dtype-packed slice) plus per-bucket pipeline fill —
    and only the best ``n_sim`` pay a real compile + simulate round.
    """
    from repro_torch.shuffle.lower import resample_weights, split_widths
    from repro_torch.shuffle.stats import with_num_buckets

    shape = _shuffle_shape(plan)
    if shape is None:
        return []
    src, keybys, width, wire_bits = shape
    cur_b = max(k.num_buckets for k in keybys)
    weights = next((k.weights for k in keybys if k.weights is not None), None)
    mappers = len(keybys)
    data_bits = plan.cost_model.packet.data_bits

    def bottleneck(b: int) -> int:
        w = resample_weights(weights, b) if weights is not None else None
        per_bucket = split_widths(width, b, w)
        packets = [
            mappers * max(1, -(-wb * wire_bits // data_bits)) for wb in per_bucket if wb > 0
        ]
        # hottest reducer's inbound train + merge recirculations + the
        # per-bucket pipeline fill the extra routes cost
        return max(packets, default=1) + (mappers - 1) + b

    counts = sorted(
        {max(1, cur_b // 2), min(width, cur_b * 2)} - {cur_b, 0}
    )
    ranked = sorted(counts, key=lambda b: (bottleneck(b), b))[:n_sim]

    out: list[Candidate] = []
    for b in ranked:

        def build(b=b):
            return _recompile_or_skip(lambda: with_num_buckets(src, b), plan)

        out.append(
            Candidate(
                kind="rebucket",
                detail=f"{cur_b} ⇒ {b} buckets (analytic bottleneck {bottleneck(b)} pkt)",
                build=build,
                # full recompile from the pre-lowering source program at
                # bucket count b — src and user pins are fixed per climb
                cache_key=("rebucket", b),
            )
        )
    return out


def reweight_candidates(plan: CompiledPlan) -> list[Candidate]:
    """Learn ``KeyBy.weights`` from measured per-bucket packet counts.

    The declared skew histogram sizes the key-space slices; the simulator
    streams the resulting per-bucket trains. Correcting each declared
    share by its measured share (``learned ∝ declared / measured``) makes
    the lowering re-slice toward equal per-bucket load — hot buckets
    shrink, cold buckets widen, and the reassembled Concat is unchanged.
    """
    from repro_torch.shuffle.lower import split_widths
    from repro_torch.shuffle.stats import measured_bucket_packets

    shape = _shuffle_shape(plan)
    if shape is None:
        return []
    src, keybys, width, _ = shape
    num_buckets = max(k.num_buckets for k in keybys)
    measured = measured_bucket_packets(plan)
    total_packets = sum(measured.values())
    if total_packets <= 0:
        return []
    cur_widths = [0] * num_buckets
    for n in plan.program:
        if isinstance(n, prim.ShuffleBucket) and n.bucket < num_buckets:
            cur_widths[n.bucket] = n.width
    if sum(cur_widths) <= 0:
        return []
    learned = []
    for b in range(num_buckets):
        declared_share = cur_widths[b] / sum(cur_widths)
        measured_share = measured.get(b, 0) / total_packets
        learned.append(
            declared_share / measured_share / num_buckets
            if measured_share > 0
            else 1.0 / num_buckets
        )
    if split_widths(width, num_buckets, learned) == split_widths(
        width, num_buckets, [w or 1e-9 for w in cur_widths]
    ):
        return []  # measurement agrees with the current slicing: no-op

    def build(learned=tuple(learned)):
        from repro_torch.shuffle.stats import with_weights

        return _recompile_or_skip(lambda: with_weights(src, learned), plan)

    hot = max(range(num_buckets), key=lambda b: measured.get(b, 0))
    return [
        Candidate(
            kind="reweight",
            detail=(
                f"learned {num_buckets}-bucket weights from measured packets "
                f"(hot bucket {hot}: {measured.get(hot, 0)} pkt)"
            ),
            build=build,
            # the learned weight vector is the mutation; src and user
            # pins are fixed per climb
            cache_key=("reweight", tuple(learned)),
        )
    ]


_GENERATORS = {
    "reroute": reroute_candidates,
    "move-reducer": move_reducer_candidates,
    "rebucket": rebucket_candidates,
    "reweight": reweight_candidates,
}


def propose(plan: CompiledPlan, actions: tuple[str, ...] = DEFAULT_ACTIONS) -> list[Candidate]:
    """All candidates of the enabled action families, in family order."""
    out: list[Candidate] = []
    for kind in actions:
        try:
            gen = _GENERATORS[kind]
        except KeyError:
            raise ValueError(
                f"unknown autotune action {kind!r}; one of {sorted(_GENERATORS)}"
            ) from None
        out.extend(gen(plan))
    return out
