"""Placement of a p4mr program onto a topology (§5: "the compiler attempts
to place the primitives to the network of programmable switches").

Faithful to the paper's preliminary design: a **greedy algorithm that
assigns the minimum-burdened switch to new labels**, with the objective of
minimizing the average number of hops the workflow's packets traverse.
We extend it with the paper's own §6 future-work concern — a per-switch
**memory budget** (operational memory is precious): a Reduce's state table
must fit the remaining budget of its switch or placement fails over to the
next candidate.

``place`` returns a ``Placement`` mapping every node label to a switch id.
Store nodes are pinned to their host's uplink switch; Collect nodes to the
sink host's uplink. MapFn/KeyBy nodes ride with their upstream (they are
stateless per-packet transforms — placing them anywhere else only adds
hops). Reduce nodes are placed greedily in topological order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Mapping

from repro_torch.core import dag, primitives as prim
from repro_torch.core.topology import SwitchTopology, TorusTopology

NodeId = Hashable

# Candidate-scoring hook: edge_cost(src_switch, dst_switch, dep_label) → cost
# of routing the dep's traffic between the two switches. The default is the
# topology's (weighted) hop distance; the pass-based compiler supplies a
# §3-derived CostModel term instead (header overhead × traffic + hop latency).
EdgeCost = Callable[[NodeId, NodeId, str], float]


class PlacementError(RuntimeError):
    pass


@dataclasses.dataclass
class Placement:
    assignment: dict[str, NodeId]  # label -> switch
    burden: dict[NodeId, int]  # switch -> #labels placed
    state_used: dict[NodeId, int]  # switch -> bytes of reducer state
    total_hops: float  # sum over DAG edges of hop distance

    def switch_of(self, label: str) -> NodeId:
        return self.assignment[label]


def _edge_hops(topo, program: dag.Program, assignment: dict[str, NodeId]) -> float:
    hops = 0.0
    dist = getattr(topo, "weighted_distance", topo.hop_distance)
    for node in program:
        for d in node.deps:
            hops += dist(assignment[d], assignment[node.name])
    return hops


def place(
    program: dag.Program,
    topo: SwitchTopology | TorusTopology,
    *,
    memory_budget_bytes: int = 1 << 20,
    item_bytes: int = 8,
    edge_cost: EdgeCost | None = None,
    pins: Mapping[str, NodeId] | None = None,
) -> Placement:
    """Greedy min-burden/min-cost placement with memory constraints.

    For each Reduce (in topo order): consider all switches, rank by
    (added cost from placed deps, current burden, switch id) and take the
    first whose remaining state budget fits. The paper's greedy 'minimum
    burdened switch' is the burden tie-break; routing cost dominates
    because it is the paper's stated objective. ``edge_cost`` defaults to
    the bare (weighted) hop distance; the pass-based compiler supplies the
    §3 cost model instead. ``pins`` force specific labels onto specific
    switches (combiner nodes are pinned to their store's uplink) — a
    pinned Reduce that does not fit its switch's budget is an error.
    """
    program.validate()
    pins = dict(pins or {})
    assignment: dict[str, NodeId] = {}
    burden: dict[NodeId, int] = {s: 0 for s in topo.switches}
    state_used: dict[NodeId, int] = {s: 0 for s in topo.switches}
    dist = getattr(topo, "weighted_distance", topo.hop_distance)
    if edge_cost is None:
        edge_cost = lambda a, b, _label: dist(a, b)  # noqa: E731

    def commit(label: str, sw: NodeId, state: int = 0) -> None:
        assignment[label] = sw
        burden[sw] += 1
        state_used[sw] += state

    for node in program.toposort():
        if node.name in pins:
            need = node.state_bytes(item_bytes)
            sw = pins[node.name]
            if state_used[sw] + need > memory_budget_bytes:
                raise PlacementError(
                    f"pinned node {node.name!r} needs {need}B on switch {sw!r} "
                    f"but only {memory_budget_bytes - state_used[sw]}B remain"
                )
            commit(node.name, sw, state=need)
        elif isinstance(node, prim.Store):
            commit(node.name, topo.attach_switch(node.host))
        elif isinstance(node, prim.Collect):
            sink = topo.attach_switch(node.sink_host)
            commit(node.name, sink)
        elif isinstance(node, (prim.MapFn, prim.KeyBy, prim.ShuffleBucket, prim.Concat)):
            # stateless per-packet: ride with the (first) upstream switch.
            # The lower-shuffle pass pins Concat nodes to the collect sink
            # when it can, so this fallback rarely fires for Concat.
            commit(node.name, assignment[node.deps[0]])
        elif isinstance(node, prim.Reduce):
            need = node.state_bytes(item_bytes)
            dep_sw = [(assignment[d], d) for d in node.deps]

            def score(sw: NodeId) -> tuple[float, int, str]:
                added = sum(edge_cost(s, sw, d) for s, d in dep_sw)
                return (added, burden[sw], str(sw))

            placed = False
            for sw in sorted(topo.switches, key=score):
                if state_used[sw] + need <= memory_budget_bytes:
                    commit(node.name, sw, state=need)
                    placed = True
                    break
            if not placed:
                raise PlacementError(
                    f"no switch has {need}B free for reducer {node.name!r} "
                    f"(budget {memory_budget_bytes}B)"
                )
        else:  # pragma: no cover - future node types
            raise PlacementError(f"unplaceable node type {type(node).__name__}")

    return Placement(
        assignment=assignment,
        burden=burden,
        state_used=state_used,
        total_hops=_edge_hops(topo, program, assignment),
    )
