"""The checkers — static analysis over ``dag.Program`` + ``CompiledPlan``.

Three entry points, all returning ``list[Diagnostic]`` (never raising):

* ``verify_program(program, cost_model=None)`` — the V1xx IR/dataflow
  checks. Safe on *any* program, including un-optimized input (pass
  ``cost_model`` only for post-rebalance programs: V103 bounds reduce
  fan-in, which the rebalance pass legitimately fixes later).
* ``verify_plan(plan, profile=None)`` — V1xx on the emitted program plus
  the V2xx placement/routing checks; a ``TargetProfile`` adds the V3xx
  feasibility checks.
* ``verify_merged(plans, cost_model=None, memory_headroom=1.0)`` — the
  V4xx multi-tenant check: merged plans must not double-book a switch's
  register region (the static counterpart of ``p4mr.FabricBudget``).

Checker catalog (codes are stable; full descriptions in docs/verify.md):

  V101  program DAG has a cycle
  V102  dangling dependency / label-key mismatch (single-definition)
  V103  reduce fan-in exceeds the CostModel bound
  V104  ShuffleBucket key-space coverage not exactly-once (gap/overlap)
  V105  Concat drops or invents a bucket reducer (vs shuffle_meta)
  V106  structural: empty program, reduce without sources, orphan node
  V110  Store/Collect host not attached to the target topology
  V201  node placed on a nonexistent switch / never placed
  V202  placement pin not honored
  V203  route cyclic, link-invalid, or endpoint-mismatched
  V204  black hole: a DAG edge has no route (data never arrives)
  V205  per-switch §3 memory budget exceeded (incl. bucket-reducer state)
  V301  more stateful tables on a switch than pipeline stages
  V302  a state table overflows a stage / switch SRAM (profile)
  V303  per-switch recirculation budget exceeded (profile)
  V401  merged tenants double-book one switch's register region
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Hashable, Mapping

from repro_torch.core import dag, primitives as prim
from repro_torch.verify.diagnostics import Diagnostic, Severity
from repro_torch.verify.profiles import TargetProfile

NodeId = Hashable

_ERR = Severity.ERROR
_WARN = Severity.WARNING


# ---------------------------------------------------------------------------
# V1xx — IR / dataflow
# ---------------------------------------------------------------------------
def _find_cycle(program: dag.Program) -> list[str] | None:
    """One concrete dependency cycle (labels, first repeated last), or
    None. Iterative coloring DFS; dangling deps are V102's problem."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {name: WHITE for name in program.nodes}
    # the DFS revisits a node once per dep; filter each dep list once
    filtered: dict[str, list[str]] = {}

    def _deps(name: str) -> list[str]:
        got = filtered.get(name)
        if got is None:
            got = [d for d in program.nodes[name].deps if d in program.nodes]
            filtered[name] = got
        return got

    for root in program.nodes:
        if color[root] != WHITE:
            continue
        stack: list[tuple[str, int]] = [(root, 0)]
        path: list[str] = []
        while stack:
            name, i = stack.pop()
            if i == 0:
                color[name] = GRAY
                path.append(name)
            deps = _deps(name)
            if i < len(deps):
                stack.append((name, i + 1))
                d = deps[i]
                if color[d] == GRAY:
                    return path[path.index(d):] + [d]
                if color[d] == WHITE:
                    stack.append((d, 0))
            else:
                color[name] = BLACK
                path.pop()
    return None


def _check_structure(program: dag.Program, out: list[Diagnostic]) -> None:
    """V101 / V102 / V106: the invariants ``Program.add`` guarantees but
    direct ``Program(nodes=...)`` construction (and mutation) can break."""
    if not program.nodes:
        out.append(Diagnostic("V106", _ERR, "empty program"))
        return
    for key, node in program.nodes.items():
        if node.name != key:
            out.append(Diagnostic(
                "V102", _ERR,
                f"node registered under label {key!r} names itself {node.name!r} "
                "(labels must be single-definition)",
                subject=key,
            ))
        for d in node.deps:
            if d not in program.nodes:
                out.append(Diagnostic(
                    "V102", _ERR,
                    f"depends on undefined label {d!r}",
                    subject=node.name,
                ))
        if isinstance(node, prim.Reduce) and not node.srcs:
            out.append(Diagnostic(
                "V106", _ERR, "reduce has no sources", subject=node.name,
            ))
        elif not isinstance(node, prim.Store) and not node.deps:
            out.append(Diagnostic(
                "V106", _ERR,
                f"{type(node).__name__} node has no dependencies",
                subject=node.name,
            ))
    cycle = _find_cycle(program)
    if cycle is not None:
        out.append(Diagnostic(
            "V101", _ERR,
            "dependency cycle: " + " -> ".join(cycle),
            subject=cycle[0],
        ))


def _check_fanin(program: dag.Program, cost_model: Any, out: list[Diagnostic]) -> None:
    """V103: fan-in × per-source state must fit one switch (error) and
    respect the configured ``max_fanin`` cap (warning)."""
    for node in program:
        if not isinstance(node, prim.Reduce) or not node.srcs:
            continue
        fanin = len(node.srcs)
        bound = cost_model.reduce_max_fanin(node)
        if fanin <= bound:
            continue
        # warning, not error: the bound is the optimizer's restructuring
        # heuristic — pinned bucket reducers legitimately exceed it, and
        # the hard §3 memory limit is V205's (and the placer's) job
        out.append(Diagnostic(
            "V103",
            _WARN,
            f"reduce fan-in {fanin} exceeds the CostModel bound {bound} "
            f"({node.state_bytes(cost_model.item_bytes)}B state vs "
            f"{cost_model.switch_memory_bytes}B switch memory)",
            subject=node.name,
        ))


def _check_bucket_coverage(program: dag.Program, out: list[Diagnostic]) -> None:
    """V104: per upstream label, ShuffleBucket slices must tile the key
    space exactly once — start at 0, contiguous, no overlap. (Zero-width
    buckets are never emitted as nodes, and cumulative offsets keep the
    surviving slices contiguous, so their absence is not a gap.)"""
    groups: dict[str, list[prim.ShuffleBucket]] = {}
    for node in program:
        if isinstance(node, prim.ShuffleBucket):
            groups.setdefault(node.src, []).append(node)
    for src, buckets in groups.items():
        seen: dict[int, str] = {}
        for b in buckets:
            if b.width < 0:
                out.append(Diagnostic(
                    "V104", _ERR, f"negative slice width {b.width}", subject=b.name,
                ))
            prev = seen.get(b.bucket)
            if prev is not None:
                out.append(Diagnostic(
                    "V104", _ERR,
                    f"bucket {b.bucket} of {src!r} defined by both {prev!r} "
                    f"and {b.name!r}",
                    subject=b.name,
                ))
            seen[b.bucket] = b.name
        ordered = sorted(buckets, key=lambda n: (n.offset, n.bucket))
        cursor = 0
        for b in ordered:
            if b.offset > cursor:
                out.append(Diagnostic(
                    "V104", _ERR,
                    f"key range [{cursor}, {b.offset}) of {src!r} is covered "
                    f"by no bucket (gap before {b.name!r})",
                    subject=b.name,
                ))
            elif b.offset < cursor:
                out.append(Diagnostic(
                    "V104", _ERR,
                    f"key range [{b.offset}, {min(cursor, b.offset + b.width)}) "
                    f"of {src!r} is covered more than once (overlap at {b.name!r})",
                    subject=b.name,
                ))
            cursor = max(cursor, b.offset + max(b.width, 0))
        # a per-bucket reducer's state table is sized to its slice; a
        # mismatch means lowering and state accounting disagree
        for b in ordered:
            for c in program.consumers(b.name):
                consumer = program.nodes[c]
                if (
                    isinstance(consumer, prim.Reduce)
                    and all(
                        isinstance(program.nodes[s], prim.ShuffleBucket)
                        and program.nodes[s].width == b.width
                        for s in consumer.srcs
                        if s in program.nodes
                    )
                    and consumer.state_width != b.width
                ):
                    out.append(Diagnostic(
                        "V104", _WARN,
                        f"bucket reducer state_width {consumer.state_width} != "
                        f"slice width {b.width} of {b.name!r}",
                        subject=c,
                    ))


def _check_concat(
    program: dag.Program, shuffle_meta: Mapping | None, out: list[Diagnostic]
) -> None:
    """V105: Concat completeness — no duplicate sources, and (when the
    lowering recorded its bucket reducers) the reassembling Concat must
    consume exactly those reducers."""
    for node in program:
        if isinstance(node, prim.Concat):
            dup = [s for s, n in Counter(node.srcs).items() if n > 1]
            if dup:
                out.append(Diagnostic(
                    "V105", _ERR,
                    f"concat lists source(s) {sorted(dup)} more than once",
                    subject=node.name,
                ))
    for label, meta in (shuffle_meta or {}).items():
        expected = set(meta.get("bucket_reducers", {}).values())
        node = program.nodes.get(label)
        if node is None or not isinstance(node, prim.Concat) or not expected:
            continue
        got = set(node.srcs)
        for missing in sorted(expected - got):
            b = next(
                b for b, lbl in meta["bucket_reducers"].items() if lbl == missing
            )
            out.append(Diagnostic(
                "V105", _ERR,
                f"drops bucket reducer {missing!r} (bucket {b}): its key "
                "slice would never be reassembled",
                subject=label,
            ))
        for extra in sorted(got - expected):
            out.append(Diagnostic(
                "V105", _ERR,
                f"consumes {extra!r} which is not a bucket reducer of this shuffle",
                subject=label,
            ))


def _check_hosts(program: dag.Program, topology: Any, out: list[Diagnostic]) -> None:
    """V110: every Store/Collect host must attach to the topology."""
    for node in program:
        host = None
        if isinstance(node, prim.Store):
            host = node.host
        elif isinstance(node, prim.Collect):
            host = node.sink_host
        if host is None:
            continue
        try:
            topology.attach_switch(host)
        except (KeyError, ValueError) as e:
            # KeyError str() is the repr of its message — unwrap args
            msg = e.args[0] if e.args else str(e)
            out.append(Diagnostic("V110", _ERR, str(msg), subject=node.name))


def verify_program(
    program: dag.Program,
    *,
    cost_model: Any = None,
    topology: Any = None,
    shuffle_meta: Mapping | None = None,
) -> list[Diagnostic]:
    """All V1xx IR/dataflow diagnostics of ``program`` in one run.

    ``cost_model`` enables V103 (fan-in bounds) — only pass it for
    programs the rebalance pass has already processed; ``topology``
    enables V110 (host attachment); ``shuffle_meta`` enables the
    meta-backed half of V105.
    """
    out: list[Diagnostic] = []
    _check_structure(program, out)
    if any(d.code in ("V101", "V102") for d in out):
        return out  # downstream checks assume a well-formed DAG
    if cost_model is not None:
        _check_fanin(program, cost_model, out)
    _check_bucket_coverage(program, out)
    _check_concat(program, shuffle_meta, out)
    if topology is not None:
        _check_hosts(program, topology, out)
    return out


# ---------------------------------------------------------------------------
# V2xx — placement / routing
# ---------------------------------------------------------------------------
def _switch_set(topology: Any) -> set | None:
    try:
        return set(topology.switches)
    except Exception:
        return None


def _check_placement(plan: Any, out: list[Diagnostic]) -> None:
    """V201 (existence) + V202 (pins honored)."""
    assignment = plan.placement.assignment
    switches = _switch_set(plan.topology)
    for node in plan.program:
        sw = assignment.get(node.name)
        if sw is None:
            out.append(Diagnostic(
                "V201", _ERR, "node was never placed", subject=node.name,
            ))
        elif switches is not None and sw not in switches:
            out.append(Diagnostic(
                "V201", _ERR,
                f"placed on nonexistent switch {sw!r} "
                f"(topology has {len(switches)} switches)",
                subject=node.name, switch=sw,
            ))
    for label, sw in sorted(plan.pins.items()):
        got = assignment.get(label)
        if got is None:
            out.append(Diagnostic(
                "V202", _WARN,
                f"pin to switch {sw!r} references a label absent from the "
                "emitted program",
                subject=label, switch=sw,
            ))
        elif got != sw:
            out.append(Diagnostic(
                "V202", _ERR,
                f"pinned to switch {sw!r} but placed on {got!r}",
                subject=label, switch=got,
            ))


def _check_routes(plan: Any, out: list[Diagnostic]) -> None:
    """V203 (each route simple, link-valid, endpoint-consistent) + V204
    (every DAG edge routed — no black holes)."""
    topo = plan.topology
    assignment = plan.placement.assignment
    has_links = hasattr(topo, "neighbors")
    # routes revisit the same switches constantly; memoize the (possibly
    # computed, e.g. torus coordinate arithmetic) neighbor sets per call
    neighbor_sets: dict[Any, frozenset] = {}

    def _neighbors(u: Any) -> frozenset:
        got = neighbor_sets.get(u)
        if got is None:
            try:
                got = frozenset(topo.neighbors(u))
            except Exception:
                got = frozenset()
            neighbor_sets[u] = got
        return got

    for r in plan.routes.routes:
        edge = (r.src_label, r.dst_label)
        if not r.path:
            out.append(Diagnostic("V203", _ERR, "empty route path", edge=edge))
            continue
        if len(set(r.path)) != len(r.path):
            out.append(Diagnostic(
                "V203", _ERR,
                "route visits a switch twice (cyclic): "
                + " -> ".join(str(s) for s in r.path),
                edge=edge,
            ))
        src_sw, dst_sw = assignment.get(r.src_label), assignment.get(r.dst_label)
        if src_sw is not None and r.path[0] != src_sw:
            out.append(Diagnostic(
                "V203", _ERR,
                f"route starts at {r.path[0]!r} but {r.src_label!r} is "
                f"placed on {src_sw!r}",
                edge=edge, switch=r.path[0],
            ))
        if dst_sw is not None and r.path[-1] != dst_sw:
            out.append(Diagnostic(
                "V203", _ERR,
                f"route ends at {r.path[-1]!r} but {r.dst_label!r} is "
                f"placed on {dst_sw!r}",
                edge=edge, switch=r.path[-1],
            ))
        if has_links:
            for a, b in zip(r.path, r.path[1:]):
                if b not in _neighbors(a):
                    out.append(Diagnostic(
                        "V203", _ERR,
                        f"hop {a!r} -> {b!r} is not a link in the topology",
                        edge=edge, switch=a,
                    ))
    want = Counter(
        (d, node.name) for node in plan.program for d in node.deps
    )
    have = Counter((r.src_label, r.dst_label) for r in plan.routes.routes)
    for edge, n in sorted(want.items()):
        missing = n - have.get(edge, 0)
        if missing > 0:
            out.append(Diagnostic(
                "V204", _ERR,
                f"no route for this edge: {edge[1]!r} never receives "
                f"{edge[0]!r}'s data (black hole)",
                edge=edge,
            ))
    for edge, n in sorted(have.items()):
        if n > want.get(edge, 0):
            out.append(Diagnostic(
                "V204", _WARN,
                "route exists for an edge not in the program "
                "(stale routing entry)",
                edge=edge,
            ))


def switch_state_bytes(program: dag.Program, assignment: Mapping[str, NodeId],
                       item_bytes: int) -> dict[NodeId, int]:
    """Per-switch stateful-memory demand recomputed from the program —
    deliberately *not* trusting ``Placement.state_used``, which a mutated
    plan may carry stale."""
    used: dict[NodeId, int] = {}
    for node in program:
        need = node.state_bytes(item_bytes)
        sw = assignment.get(node.name)
        if need and sw is not None:
            used[sw] = used.get(sw, 0) + need
    return used


def _check_memory(plan: Any, out: list[Diagnostic]) -> None:
    """V205: the §3 per-switch memory budget, bucket-reducer state
    included (per-bucket reducers are ordinary Reduce nodes)."""
    cm = plan.cost_model
    used = switch_state_bytes(plan.program, plan.placement.assignment, cm.item_bytes)
    for sw in sorted(used, key=str):
        if used[sw] > cm.switch_memory_bytes:
            holders = sorted(
                lbl for lbl, s in plan.placement.assignment.items()
                if s == sw and lbl in plan.program.nodes
                and plan.program.nodes[lbl].state_bytes(cm.item_bytes)
            )
            out.append(Diagnostic(
                "V205", _ERR,
                f"reducer state {used[sw]}B exceeds the switch memory "
                f"budget {cm.switch_memory_bytes}B "
                f"(holders: {', '.join(holders[:6])}"
                + (", ..." if len(holders) > 6 else "") + ")",
                switch=sw,
            ))


# ---------------------------------------------------------------------------
# V3xx — target feasibility
# ---------------------------------------------------------------------------
def _check_profile(plan: Any, profile: TargetProfile, out: list[Diagnostic]) -> None:
    cm = plan.cost_model
    tables: dict[NodeId, list[prim.Reduce]] = {}
    for node in plan.program:
        if isinstance(node, prim.Reduce):
            sw = plan.placement.assignment.get(node.name)
            if sw is not None:
                tables.setdefault(sw, []).append(node)
    for sw in sorted(tables, key=str):
        nodes = tables[sw]
        if profile.pipeline_stages is not None and len(nodes) > profile.pipeline_stages:
            out.append(Diagnostic(
                "V301", _ERR,
                f"{len(nodes)} stateful tables on one switch but the "
                f"{profile.name} target has {profile.pipeline_stages} "
                f"pipeline stages (tables: "
                f"{', '.join(n.name for n in nodes[:6])}"
                + (", ..." if len(nodes) > 6 else "") + ")",
                switch=sw,
            ))
        if profile.stage_memory_bytes is not None:
            for n in nodes:
                need = n.state_bytes(cm.item_bytes)
                if need > profile.stage_memory_bytes:
                    out.append(Diagnostic(
                        "V302", _ERR,
                        f"state table {need}B cannot span stages: a "
                        f"{profile.name} stage holds "
                        f"{profile.stage_memory_bytes}B",
                        subject=n.name, switch=sw,
                    ))
        total_cap = profile.total_memory_bytes
        if total_cap is not None:
            total = sum(n.state_bytes(cm.item_bytes) for n in nodes)
            if total > total_cap:
                out.append(Diagnostic(
                    "V302", _ERR,
                    f"total stateful memory {total}B exceeds the "
                    f"{profile.name} switch SRAM "
                    f"{profile.pipeline_stages}×{profile.stage_memory_bytes}B"
                    f" = {total_cap}B",
                    switch=sw,
                ))
        if profile.recirculation_budget is not None:
            recirc = sum(max(0, len(n.srcs) - 1) for n in nodes)
            if recirc > profile.recirculation_budget:
                out.append(Diagnostic(
                    "V303", _ERR,
                    f"stateful merges need {recirc} recirculations but the "
                    f"{profile.name} budget is {profile.recirculation_budget}",
                    switch=sw,
                ))


def verify_plan(
    plan: Any, *, profile: TargetProfile | None = None
) -> list[Diagnostic]:
    """Every applicable diagnostic of one ``CompiledPlan`` in one run:
    V1xx over the emitted program, V2xx against placement/routes/topology,
    and — when a ``TargetProfile`` is given — the V3xx feasibility checks.
    Returns the (possibly empty) diagnostic list; never raises."""
    from repro_torch.telemetry.trace import current_tracer, maybe_span

    with maybe_span(current_tracer(), "verify.plan") as attrs:
        out = verify_program(
            plan.program,
            cost_model=plan.cost_model,
            topology=plan.topology,
            shuffle_meta=plan.shuffle_meta,
        )
        if not any(d.code in ("V101", "V102") for d in out):
            _check_placement(plan, out)
            _check_routes(plan, out)
            _check_memory(plan, out)
            if profile is not None:
                _check_profile(plan, profile, out)
        attrs["diagnostics"] = len(out)
    return out


# ---------------------------------------------------------------------------
# V4xx — multi-tenant
# ---------------------------------------------------------------------------
def verify_merged(
    plans: Mapping[str, Any],
    *,
    cost_model: Any = None,
    memory_headroom: float = 1.0,
) -> list[Diagnostic]:
    """V401: tenants merged onto one fabric must not double-book a
    switch's register region past ``switch_memory_bytes × headroom`` —
    the static counterpart of ``p4mr.FabricBudget.check`` (which also
    prices offered load; this check is memory-only and needs no
    simulation)."""
    if not plans:
        return []
    if cost_model is None:
        cost_model = next(iter(plans.values())).cost_model
    limit = cost_model.switch_memory_bytes * memory_headroom
    used: dict[NodeId, float] = {}
    holders: dict[NodeId, list[str]] = {}
    for name, pl in plans.items():
        per_switch = switch_state_bytes(
            pl.program, pl.placement.assignment, cost_model.item_bytes
        )
        for sw, b in per_switch.items():
            used[sw] = used.get(sw, 0.0) + b
            holders.setdefault(sw, []).append(f"{name}:{b}B")
    out: list[Diagnostic] = []
    for sw in sorted(used, key=str):
        if used[sw] > limit:
            out.append(Diagnostic(
                "V401", _ERR,
                f"merged tenants book {used[sw]:.0f}B of register state "
                f"but the fabric budget is {limit:.0f}B "
                f"({'; '.join(holders[sw])})",
                switch=sw,
            ))
    return out
