"""Routing generation (§5: "the compiler then adds appropriate routing for
the packets containing data items").

Given a ``Placement``, emit one ``Route`` per DAG edge: the concrete switch
path the data travels, plus aggregate metrics the compiler's objective is
judged on. On a ``TorusTopology`` each consecutive pair in a path is one
ICI hop, so a Route lowers directly to a ``ppermute`` step sequence — this
is the artifact ``codelet.py`` consumes.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Hashable, Mapping

from repro_torch.core import dag
from repro_torch.core.placement import Placement

NodeId = Hashable


@dataclasses.dataclass(frozen=True)
class Route:
    src_label: str
    dst_label: str
    path: tuple[NodeId, ...]  # inclusive of endpoints

    @property
    def hops(self) -> int:
        return len(self.path) - 1


@dataclasses.dataclass
class RoutingTable:
    routes: list[Route]

    @property
    def total_hops(self) -> int:
        return sum(r.hops for r in self.routes)

    @property
    def max_hops(self) -> int:
        return max((r.hops for r in self.routes), default=0)

    def per_switch_transit(self) -> dict[NodeId, int]:
        """How many routes transit each switch (congestion proxy)."""
        load: dict[NodeId, int] = {}
        for r in self.routes:
            for sw in r.path[1:-1]:
                load[sw] = load.get(sw, 0) + 1
        return load

    def forwarding_rules(self) -> dict[NodeId, list[tuple[str, NodeId]]]:
        """Per-switch match→next-hop rules (the P4 table entries analogue).

        Key: switch. Value: list of (routing_id == dst_label, next hop).
        """
        rules: dict[NodeId, list[tuple[str, NodeId]]] = {}
        for r in self.routes:
            for here, nxt in zip(r.path, r.path[1:]):
                rules.setdefault(here, []).append((r.dst_label, nxt))
        return rules


def _dist_to(topo, dst: NodeId) -> dict[NodeId, int]:
    """Hop distance of every reachable switch to ``dst`` — one BFS over the
    undirected switch graph (shared by all edges targeting ``dst``, instead
    of re-running shortest-path per candidate neighbor)."""
    from collections import deque

    dist = {dst: 0}
    q = deque([dst])
    while q:
        u = q.popleft()
        for v in topo.neighbors(u):
            if v not in dist:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def _bfs_path(
    topo,
    src: NodeId,
    dst: NodeId,
    banned_nodes: frozenset | set,
    banned_links: set,
) -> list[NodeId] | None:
    """Deterministic BFS shortest path avoiding ``banned_nodes`` and the
    directed ``banned_links``; None when ``dst`` is unreachable. Neighbor
    order is fixed by switch id so ties resolve identically across runs."""
    from collections import deque

    if src == dst:
        return [src]
    prev: dict[NodeId, NodeId] = {src: src}
    q = deque([src])
    while q:
        u = q.popleft()
        for v in sorted(topo.neighbors(u), key=str):
            if v in prev or v in banned_nodes or (u, v) in banned_links:
                continue
            prev[v] = u
            if v == dst:
                path = [v]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return path[::-1]
            q.append(v)
    return None


def k_shortest_paths(
    topo,
    src: NodeId,
    dst: NodeId,
    max_paths: int,
    *,
    max_stretch: int | None = None,
) -> list[tuple[NodeId, ...]]:
    """Up to ``max_paths`` loop-free paths ``src → dst``, shortest first.

    Yen's algorithm over the undirected switch graph: candidate k+1-th
    paths branch off each spur node of the k-th path with the already-used
    continuations banned, so every returned path is simple (no repeated
    switch) and the list is sorted by hop count (ties broken by switch-id
    sequence, deterministically). This is the detour candidate generator
    the ``autotune.reroute`` action prices by streamed makespan — unlike
    the ECMP tie-break, it may propose strictly *longer* paths, which
    measured queueing can justify.

    ``max_stretch`` drops paths more than that many hops longer than the
    shortest. Topologies without a ``neighbors`` method fall back to the
    single fixed ``shortest_path`` (same degradation as ``build_routes``).
    """
    if max_paths < 1:
        raise ValueError(f"max_paths must be >= 1, got {max_paths}")
    if not hasattr(topo, "neighbors"):
        return [tuple(topo.shortest_path(src, dst))]
    first = _bfs_path(topo, src, dst, frozenset(), set())
    if first is None:
        raise ValueError(f"no path {src} -> {dst}")
    shortest_hops = len(first) - 1
    paths: list[list[NodeId]] = [first]
    # candidate heap ordered by (hops, id-sequence) for deterministic pops
    candidates: list[tuple[int, tuple[str, ...], list[NodeId]]] = []
    seen = {tuple(first)}
    while len(paths) < max_paths:
        prev = paths[-1]
        for i in range(len(prev) - 1):
            root = prev[: i + 1]
            banned_links = {
                (p[i], p[i + 1]) for p in paths if len(p) > i + 1 and p[: i + 1] == root
            }
            banned_nodes = set(root[:-1])
            spur = _bfs_path(topo, prev[i], dst, banned_nodes, banned_links)
            if spur is None:
                continue
            total = root[:-1] + spur
            key = tuple(total)
            if key in seen:
                continue
            seen.add(key)
            if max_stretch is not None and len(total) - 1 > shortest_hops + max_stretch:
                continue
            heapq.heappush(
                candidates, (len(total) - 1, tuple(str(s) for s in total), total)
            )
        if not candidates:
            break
        paths.append(heapq.heappop(candidates)[2])
    return [tuple(p) for p in paths]


def _load_aware_shortest_path(
    topo,
    src: NodeId,
    dst: NodeId,
    dist: dict[NodeId, int],
    link_load: dict[tuple[NodeId, NodeId], float],
    switch_penalty: Mapping[NodeId, float] | None = None,
    switch_load: Mapping[NodeId, float] | None = None,
    link_penalty: Mapping[tuple[NodeId, NodeId], float] | None = None,
) -> list[NodeId]:
    """Shortest path that breaks equal-cost ties by current link load.

    BFS distance admits many minimal paths (ECMP); the classic fixed choice
    sends every route between one switch pair down the same links. Instead
    pick each next hop greedily among the distance-decreasing neighbors,
    preferring the least-loaded outgoing link (then the smallest switch id,
    for determinism) — so two trains between the same endpoints spread
    over distinct equal-cost paths and contend less in the simulator.
    ``switch_penalty`` adds a per-switch term to the link key — the
    ``reroute-feedback`` pass feeds the simulator's *measured* queueing
    through it, steering ties away from observed hotspots.
    ``switch_load`` adds the traffic already routed *through* a switch
    this round (greedy next-hop choice is otherwise blind to load one
    hop downstream: a heavy train avoids link A→B while walking into the
    same congested B→C that made A→B bad).
    ``link_penalty`` adds a per-directed-link term — the VOQ engine's
    measured per-port contention (drops, blocked ticks, depth), which a
    per-switch penalty can't express: one saturated output port must not
    repel traffic using the switch's other ports.
    """
    if src == dst:
        return [src]
    penalty = switch_penalty or {}
    transit = switch_load or {}
    link_pen = link_penalty or {}
    path = [src]
    cur = src
    remaining = dist.get(src)
    if remaining is None:  # disconnected under neighbors — fixed fallback
        return list(topo.shortest_path(src, dst))
    while cur != dst:
        best = None
        for v in topo.neighbors(cur):
            if dist.get(v) != remaining - 1:
                continue
            key = (
                link_load.get((cur, v), 0.0)
                + link_pen.get((cur, v), 0.0)
                + penalty.get(v, 0.0)
                + transit.get(v, 0.0),
                str(v),
            )
            if best is None or key < best[0]:
                best = (key, v)
        if best is None:  # inconsistent metric — fall back to the fixed path
            return list(topo.shortest_path(src, dst))
        cur = best[1]
        path.append(cur)
        remaining -= 1
    return path


def build_routes(
    program: dag.Program,
    topo,
    placement: Placement,
    *,
    edge_weight: Mapping[str, float] | None = None,
    switch_penalty: Mapping[NodeId, float] | None = None,
    link_penalty: Mapping[tuple[NodeId, NodeId], float] | None = None,
) -> RoutingTable:
    """One ``Route`` per DAG edge, spreading equal-cost ties by link load.

    By default every route claims weight 1 on each link it crosses
    (route-count ECMP, the static first pass). ``edge_weight`` maps a
    source label to the weight its route adds instead — the
    ``reroute-feedback`` pass passes per-edge *packet counts* so a hot
    shuffle bucket claims proportionally more of a link than a cold one.
    ``switch_penalty`` biases tie-breaks away from given switches (the
    simulator's measured queueing, normalized below packet scale so
    traffic weights dominate and penalties only break ties);
    ``link_penalty`` does the same per directed link (the VOQ engine's
    per-port drop/backpressure signals).

    In feedback mode (either keyword given) routed traffic also
    accumulates per-*switch* transit load consulted by later next-hop
    choices, so a train sees congestion one hop downstream instead of
    only on its immediate outgoing link. The static route-count pass
    keeps the original link-only behavior.
    """
    routes = []
    # per-link weights accumulated while routing: later edges avoid links
    # earlier equal-cost edges already claimed (queue-aware ECMP)
    link_load: dict[tuple[NodeId, NodeId], float] = {}
    feedback_mode = (
        edge_weight is not None
        or switch_penalty is not None
        or link_penalty is not None
    )
    switch_load: dict[NodeId, float] = {}
    dist_maps: dict[NodeId, dict[NodeId, int]] = {}  # one BFS per destination
    load_aware = hasattr(topo, "neighbors")
    for node in program:
        for d in node.deps:
            src_sw = placement.switch_of(d)
            dst_sw = placement.switch_of(node.name)
            if load_aware:
                if dst_sw not in dist_maps:
                    dist_maps[dst_sw] = _dist_to(topo, dst_sw)
                path = tuple(
                    _load_aware_shortest_path(
                        topo,
                        src_sw,
                        dst_sw,
                        dist_maps[dst_sw],
                        link_load,
                        switch_penalty,
                        switch_load if feedback_mode else None,
                        link_penalty,
                    )
                )
            else:
                path = tuple(topo.shortest_path(src_sw, dst_sw))
            w = float(edge_weight.get(d, 1.0)) if edge_weight else 1.0
            for a, b in zip(path, path[1:]):
                link_load[(a, b)] = link_load.get((a, b), 0.0) + w
            if feedback_mode:
                for sw in path[1:-1]:
                    switch_load[sw] = switch_load.get(sw, 0.0) + w
            routes.append(Route(src_label=d, dst_label=node.name, path=path))
    return RoutingTable(routes=routes)
