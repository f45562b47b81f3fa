"""Built-in compiler passes.

Each pass is ``(CompileCtx) -> str | None`` registered under a stable
name; the returned string is a one-line summary recorded in the pass
trace. Frontend: ``parse``, ``validate``. Optimization: ``dead-node-elim``,
``rebalance-reduce-tree`` (chains of binary reduces → balanced multi-way
trees bounded by the per-switch state budget), ``insert-combiners``
(SwitchAgg-style partial aggregation at each store's uplink switch).
Backend: ``place`` (§3 cost-model-driven), ``route``,
``reroute-feedback`` (route → streaming-simulate → re-route on measured
queueing, to a fixed point), ``emit``. ``lower-shuffle`` lives in
``repro_torch.shuffle.lower``.
"""
from __future__ import annotations

from typing import Hashable

from repro_torch.compiler.driver import CompileCtx, register_pass
from repro_torch.compiler.plan import CompiledPlan
from repro_torch.core import dag, dsl, primitives as prim
from repro_torch.core.placement import PlacementError, place as core_place
from repro_torch.core.routing import build_routes

NodeId = Hashable

# Kinds whose combine is associative+commutative, hence tree-restructurable.
_ASSOCIATIVE = (
    prim.ReduceKind.SUM,
    prim.ReduceKind.COUNT,  # combines with +, same as SUM
    prim.ReduceKind.MAX,
    prim.ReduceKind.MIN,
)


def _fresh(program: dag.Program, taken: set[str], base: str) -> str:
    name = base
    i = 0
    while name in program.nodes or name in taken:
        i += 1
        name = f"{base}_{i}"
    taken.add(name)
    return name


def _verify_fail(code: str, msg: str, **loc) -> "Exception":
    """One coded diagnostic as a raisable ``VerificationError`` — how the
    passes report their own failures in the verifier's vocabulary
    (satellite of repro_torch.verify; parse keeps ``DSLSyntaxError``)."""
    from repro_torch.verify import Diagnostic, Severity, VerificationError

    return VerificationError([Diagnostic(code, Severity.ERROR, msg, **loc)])


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------
@register_pass("parse")
def parse_pass(ctx: CompileCtx) -> str:
    if ctx.program is not None:
        ctx.source_program = ctx.program.copy()
        return "input is already a Program"
    if ctx.ast is None:
        if ctx.source is None:
            raise ValueError("nothing to parse: no source, AST or Program")
        ctx.ast = dsl.parse_ast(ctx.source)
    ctx.program = dsl.ast_to_program(ctx.ast)
    # pre-rewrite snapshot: autotune's rebucket/reweight recompile from
    # this (a lowered program cannot be re-lowered at a new bucket count)
    ctx.source_program = ctx.program.copy()
    return f"{len(ctx.program)} nodes"


@register_pass("validate")
def validate_pass(ctx: CompileCtx) -> str:
    """Frontend validation as coded diagnostics, ALL collected in one run.

    Structure (V101/V102/V106) plus host attachment against the target
    topology (V110) — a program with three bad hosts reports all three,
    not just the first. Deliberately no cost model: fan-in bounds (V103)
    belong to the post-optimization ``verify`` pass, after
    ``rebalance-reduce-tree`` has had its chance to fix wide reduces.
    """
    from repro_torch.verify import VerificationError, errors_of, verify_program

    p = ctx.require_program()
    diags = verify_program(p, topology=ctx.topology)
    if errors_of(diags):
        raise VerificationError(diags)
    return f"ok: {len(p)} nodes, depth {p.depth()}"


# ---------------------------------------------------------------------------
# optimization
# ---------------------------------------------------------------------------
@register_pass("dead-node-elim")
def dead_node_elim_pass(ctx: CompileCtx) -> str:
    """Drop nodes no collection point (or, absent Collects, no sink)
    transitively depends on."""
    p = ctx.require_program()
    roots = [n.name for n in p if isinstance(n, prim.Collect)] or p.sinks()
    live: set[str] = set()
    stack = list(roots)
    while stack:
        name = stack.pop()
        if name in live:
            continue
        live.add(name)
        stack.extend(p.nodes[name].deps)
    dead = [name for name in p.nodes if name not in live]
    if not dead:
        return "no dead nodes"
    ctx.program = dag.Program.from_nodes(n for n in p if n.name in live)
    return f"removed {len(dead)}: {', '.join(sorted(dead))}"


def _collapsible(p: dag.Program, child_label: str, parent: prim.Reduce, pins) -> bool:
    child = p.nodes[child_label]
    return (
        isinstance(child, prim.Reduce)
        and child.kind is parent.kind
        and child.kind in _ASSOCIATIVE
        and child_label not in pins
        and len(p.consumers(child_label)) == 1
    )


@register_pass("rebalance-reduce-tree")
def rebalance_reduce_tree_pass(ctx: CompileCtx) -> str:
    """Chains of binary reduces → balanced multi-way trees.

    A naive frontend (and the paper's §5.2 source) emits left-deep chains
    like ``E = SUM(C, SUM(A, B))``: depth p−1, one wire round per link.
    Since the kinds are associative we gather each maximal single-consumer
    same-kind subtree's leaves and rebuild a balanced tree whose fan-in is
    bounded by the per-switch state budget (``CostModel.reduce_max_fanin``):
    depth drops to ⌈log_k p⌉ and intermediate hop traffic shrinks.
    The subtree root keeps its label, so downstream consumers are untouched.
    """
    p = ctx.require_program()
    cm = ctx.cost_model
    absorbed: set[str] = set()
    rewrites: dict[str, prim.Reduce] = {}  # root label -> new root node
    extra: dict[str, list[prim.Reduce]] = {}  # root label -> tree nodes
    taken: set[str] = set()

    def leaves_of(r: prim.Reduce) -> list[str]:
        out: list[str] = []
        for s in r.srcs:
            if _collapsible(p, s, r, ctx.pins):
                absorbed.add(s)
                out.extend(leaves_of(p.nodes[s]))
            else:
                out.append(s)
        return out

    for node in p.toposort():
        if not isinstance(node, prim.Reduce) or node.kind not in _ASSOCIATIVE:
            continue
        if node.name in ctx.pins:
            continue
        # roots only: a reduce that is itself absorbed into its consumer is
        # handled when the consumer is visited
        cons = p.consumers(node.name)
        if (
            len(cons) == 1
            and isinstance(p.nodes[cons[0]], prim.Reduce)
            and _collapsible(p, node.name, p.nodes[cons[0]], ctx.pins)
        ):
            continue
        leaves = leaves_of(node)
        k = cm.reduce_max_fanin(node)
        if leaves == list(node.srcs) and len(leaves) <= k:
            continue  # nothing collapsed, fan-in already fine
        tree_nodes: list[prim.Reduce] = []
        frontier = leaves
        while len(frontier) > k:
            nxt: list[str] = []
            for i in range(0, len(frontier), k):
                group = frontier[i : i + k]
                if len(group) == 1:
                    nxt.append(group[0])
                    continue
                name = _fresh(p, taken, f"{node.name}__t{len(tree_nodes)}")
                tree_nodes.append(
                    prim.Reduce(
                        name=name,
                        srcs=tuple(group),
                        kind=node.kind,
                        state_width=node.state_width,
                    )
                )
                nxt.append(name)
            frontier = nxt
        rewrites[node.name] = prim.Reduce(
            name=node.name,
            srcs=tuple(frontier),
            kind=node.kind,
            state_width=node.state_width,
        )
        extra[node.name] = tree_nodes

    if not rewrites:
        return "no chains to rebalance"

    nodes: list[prim.Node] = []
    for n in p:
        if n.name in absorbed:
            continue
        if n.name in rewrites:
            nodes.extend(extra[n.name])
            nodes.append(rewrites[n.name])
        else:
            nodes.append(n)
    ctx.program = dag.Program.from_nodes(nodes)
    return (
        f"rebalanced {len(rewrites)} tree(s), absorbed {len(absorbed)} "
        f"intermediate reduce(s), added {sum(len(v) for v in extra.values())} node(s)"
    )


def _ingress_switch(ctx: CompileCtx, p: dag.Program, label: str) -> NodeId | None:
    """Switch a label's output is statically known to sit on: a Store's
    uplink, a pinned node's pin, or a stateless transform riding on one."""
    node = p.nodes[label]
    if label in ctx.pins:
        return ctx.pins[label]
    if isinstance(node, prim.Store):
        return ctx.topology.attach_switch(node.host)
    if isinstance(node, (prim.MapFn, prim.KeyBy, prim.ShuffleBucket)):
        return _ingress_switch(ctx, p, node.deps[0])
    return None


@register_pass("insert-combiners")
def insert_combiners_pass(ctx: CompileCtx) -> str:
    """SwitchAgg-style partial aggregation at the ingress switch.

    When several sources of one reduce enter the network at the same
    uplink switch, their items would all travel the full path to the
    reducer. Insert a partial-aggregation (combiner) reduce pinned to the
    shared uplink: the group's traffic collapses to one state table's
    worth before leaving the edge switch. Insertion is skipped when the
    combiner's state would overflow the switch's memory budget.
    """
    p = ctx.require_program()
    cm = ctx.cost_model
    budget_used: dict[NodeId, int] = {}
    for label, sw in ctx.pins.items():
        if label in p.nodes:
            budget_used[sw] = budget_used.get(sw, 0) + p.nodes[label].state_bytes(cm.item_bytes)

    inserted: list[prim.Reduce] = []
    before: dict[str, list[prim.Reduce]] = {}
    rewrites: dict[str, prim.Reduce] = {}
    skipped = 0
    pinned_roots = 0
    taken: set[str] = set()

    for node in p.toposort():
        if not isinstance(node, prim.Reduce) or node.kind not in _ASSOCIATIVE:
            continue
        groups: dict[NodeId, list[str]] = {}
        for s in node.srcs:
            sw = _ingress_switch(ctx, p, s)
            if sw is not None:
                groups.setdefault(sw, []).append(s)
        shared = {sw: mem for sw, mem in groups.items() if len(mem) >= 2}
        if not shared:
            continue
        need = max(node.state_bytes(cm.item_bytes), cm.item_bytes)
        new_srcs = list(node.srcs)
        local: list[prim.Reduce] = []
        for sw, members in sorted(shared.items(), key=lambda kv: str(kv[0])):
            if len(members) == len(node.srcs) and node.name not in ctx.pins:
                # every source enters at one switch: pin the reduce itself
                # there instead of duplicating it as a combiner
                if budget_used.get(sw, 0) + need <= cm.switch_memory_bytes:
                    ctx.pins[node.name] = sw
                    budget_used[sw] = budget_used.get(sw, 0) + need
                    pinned_roots += 1
                continue
            if budget_used.get(sw, 0) + need > cm.switch_memory_bytes:
                skipped += 1
                continue
            name = _fresh(p, taken, f"{node.name}__c{len(inserted) + len(local)}")
            comb = prim.Reduce(
                name=name,
                srcs=tuple(members),
                kind=node.kind,
                state_width=node.state_width,
            )
            local.append(comb)
            ctx.pins[name] = sw
            budget_used[sw] = budget_used.get(sw, 0) + need
            # combiner replaces its members at the first member's position
            first = new_srcs.index(members[0])
            new_srcs = [s for s in new_srcs if s not in members]
            new_srcs.insert(min(first, len(new_srcs)), name)
        if local:
            inserted.extend(local)
            before[node.name] = local
            rewrites[node.name] = prim.Reduce(
                name=node.name,
                srcs=tuple(new_srcs),
                kind=node.kind,
                state_width=node.state_width,
            )

    if not inserted and not skipped and not pinned_roots:
        return "no shared-ingress groups"
    if rewrites:
        nodes: list[prim.Node] = []
        for n in p:
            if n.name in rewrites:
                nodes.extend(before[n.name])
                nodes.append(rewrites[n.name])
            else:
                nodes.append(n)
        ctx.program = dag.Program.from_nodes(nodes)
    return (
        f"inserted {len(inserted)} combiner(s), pinned {pinned_roots} "
        f"single-ingress reduce(s), skipped {skipped} (memory budget)"
    )


# ---------------------------------------------------------------------------
# backend
# ---------------------------------------------------------------------------
@register_pass("place")
def place_pass(ctx: CompileCtx) -> str:
    p = ctx.require_program()
    cm = ctx.cost_model
    try:
        ctx.placement = core_place(
            p,
            ctx.topology,
            memory_budget_bytes=cm.switch_memory_bytes,
            item_bytes=cm.item_bytes,
            edge_cost=cm.edge_cost_fn(ctx.topology, cm.traffic(p)),
            pins=ctx.pins,
        )
    except PlacementError as e:
        # memory-infeasible placement, in the verifier's vocabulary
        raise _verify_fail("V205", str(e)) from e
    return f"total_hops={ctx.placement.total_hops:g}, pinned={len(ctx.pins)}"


@register_pass("route")
def route_pass(ctx: CompileCtx) -> str:
    """Static routing, optionally *seeded* with external contention.

    ``options["switch_penalty_seed"]`` / ``options["link_penalty_seed"]``
    (per-switch / per-link pressure maps, e.g. another tenant's measured
    ``telemetry.fabric`` pressure) bias equal-cost tie-breaks away from
    fabric another job is already loading. Seeds are re-normalized below
    packet scale, so they steer ties without overriding this job's own
    traffic — the p4mr scheduler's contention-aware compile hook.
    """
    if ctx.placement is None:
        raise _verify_fail(
            "V001", "route pass requires a placement (run 'place' first)"
        )
    seed = ctx.options.get("switch_penalty_seed") or None
    link_seed = ctx.options.get("link_penalty_seed") or None
    if seed or link_seed:
        from repro_torch.telemetry.fabric import normalized

        ctx.routes = build_routes(
            ctx.require_program(), ctx.topology, ctx.placement,
            switch_penalty=normalized(seed) if seed else None,
            link_penalty=normalized(link_seed) if link_seed else None,
        )
        return (
            f"{len(ctx.routes.routes)} routes, total_hops={ctx.routes.total_hops}, "
            f"seeded ({len(seed or ())} switch / {len(link_seed or ())} link)"
        )
    ctx.routes = build_routes(ctx.require_program(), ctx.topology, ctx.placement)
    return f"{len(ctx.routes.routes)} routes, total_hops={ctx.routes.total_hops}"


@register_pass("reroute-feedback")
def reroute_feedback_pass(ctx: CompileCtx) -> str:
    """Close the route → simulate → reroute loop on *measured* queueing.

    The ``route`` pass spreads equal-cost ties by static route counts —
    blind to how many packets each route actually carries and to stateful
    recirculation hotspots. This pass runs the streaming simulator on the
    current routes, then re-runs ``build_routes`` with (a) per-edge
    *packet* weights from the cost model's traffic (a hot shuffle bucket
    claims more of a link than a cold one), (b) per-switch penalties
    from the simulator's measured queueing plus per-switch buffer drops,
    and (c) per-link penalties from the VOQ engine's per-port signals
    (peak VOQ depth, drops, backpressure-blocked ticks) — contention a
    switch-level number can't localize: one saturated output port must
    not repel traffic from the switch's other ports. All penalties are
    normalized below packet scale so they steer ties rather than
    override traffic. It iterates to a routing fixed point or
    ``options["reroute_rounds"]`` (default 3), keeping the best-makespan
    table seen — so the emitted plan's streamed makespan never exceeds
    the static-ECMP plan's.
    """
    if ctx.placement is None or ctx.routes is None:
        raise _verify_fail(
            "V001", "reroute-feedback requires routes (run 'route' first)"
        )
    from repro_torch.compiler.simulator import simulate_timing

    p = ctx.require_program()
    cm = ctx.cost_model
    max_rounds = int(ctx.options.get("reroute_rounds", 3))
    static_rep = simulate_timing(p, ctx.routes, cm)
    stats = {
        "rounds": 0,
        "converged": False,
        "static_makespan_ticks": static_rep.makespan_ticks,
        "static_time_s": static_rep.time_s,
        "makespan_ticks": static_rep.makespan_ticks,
        "time_s": static_rep.time_s,
    }
    ctx.options["reroute_feedback"] = stats
    if max_rounds <= 0:
        return "disabled (reroute_rounds=0)"

    traffic = cm.traffic(p)
    weights = {lbl: float(t.packets) for lbl, t in traffic.items()}
    cur, cur_rep = ctx.routes, static_rep
    best, best_rep = cur, cur_rep
    from repro_torch.telemetry.fabric import link_pressure, normalized, switch_pressure

    # external contention seeds (see route_pass): folded into every
    # round's measured penalties so tie-breaks keep avoiding fabric other
    # tenants load even as this job's own feedback evolves
    seed = normalized(ctx.options.get("switch_penalty_seed") or {})
    link_seed = normalized(ctx.options.get("link_penalty_seed") or {})

    def _fold(measured: dict, extern: dict) -> dict:
        if not extern:
            return measured
        keys = set(measured) | set(extern)
        return normalized(
            {k: measured.get(k, 0.0) + extern.get(k, 0.0) for k in keys}
        )

    for round_no in range(1, max_rounds + 1):
        # per-switch: measured queueing + packets dropped at the switch's
        # full buffer (the latter is zero under the infinite default);
        # per-link: the VOQ engine's per-port contention (empty when the
        # report came from the event engine). Both read the unified
        # telemetry pressure surface and are normalized below packet
        # scale so they steer ties rather than override traffic.
        penalty = _fold(normalized(switch_pressure(cur_rep)), seed)
        link_penalty = _fold(normalized(link_pressure(cur_rep)), link_seed)
        nxt = build_routes(
            p, ctx.topology, ctx.placement,
            edge_weight=weights, switch_penalty=penalty, link_penalty=link_penalty,
        )
        stats["rounds"] = round_no
        if [r.path for r in nxt.routes] == [r.path for r in cur.routes]:
            stats["converged"] = True
            break
        cur, cur_rep = nxt, simulate_timing(p, nxt, cm)
        if cur_rep.time_s < best_rep.time_s:
            best, best_rep = cur, cur_rep
    ctx.routes = best
    stats["makespan_ticks"] = best_rep.makespan_ticks
    stats["time_s"] = best_rep.time_s
    return (
        f"{stats['rounds']} round(s), "
        f"{'fixed point' if stats['converged'] else 'round cap'}, "
        f"makespan {static_rep.makespan_ticks}→{best_rep.makespan_ticks} ticks"
    )


@register_pass("emit")
def emit_pass(ctx: CompileCtx) -> str:
    if ctx.placement is None or ctx.routes is None:
        raise _verify_fail("V001", "emit pass requires placement and routes")
    p = ctx.require_program()
    cost = ctx.cost_model.plan_cost(p, ctx.topology, ctx.placement, ctx.routes)
    ctx.plan = CompiledPlan(
        program=p,
        topology=ctx.topology,
        placement=ctx.placement,
        routes=ctx.routes,
        cost_model=ctx.cost_model,
        cost=cost,
        pins=dict(ctx.pins),
        trace=tuple(ctx.trace),
        feedback=ctx.options.get("reroute_feedback"),
        source_program=ctx.source_program,
        user_pins=dict(ctx.user_pins),
        shuffle_meta=ctx.options.get("shuffle_lowering"),
    )
    return f"plan: {len(p)} nodes, cost={cost.serial_time_s * 1e6:.2f}us"
