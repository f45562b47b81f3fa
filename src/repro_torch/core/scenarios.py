"""§4 scenarios as gradient-aggregation strategies, on the world-dim mesh.

The port of the mesh half of ``repro/core/scenarios.py``:

* ``S1_HOST``      — Map+Reduce at the endpoints: all-gather every worker's
                     gradient, reduce locally. p× wire bytes; the baseline.
* ``S2_IN_NET``    — Reduce in the network: ring reduce-scatter+all-gather
                     built from explicit ppermute hops; every hop accumulates.
* ``S3_IN_NET_MAP``— Map+Reduce in the network: bf16 on the wire, each hop
                     one ``ring_fused_step`` kernel launch.
* ``NATIVE``       — one fused all-reduce (psum).
* ``HIERARCHICAL`` — multi-pod: ring within the pod, one small exchange
                     across pods, gather back.

All strategies give the same means (S3 within compression tolerance).
``scenario_program`` states S1/S2/S3 as p4mr programs for the compiler;
``compile_scenario`` compiles them through a ``p4mr.Session``,
``plan_ring_order`` derives ``aggregate``'s ring order from a compiled
plan, and ``simulated_scenario_time`` prices one round on the packet
simulator.
"""
from __future__ import annotations

import enum
from typing import Any

from repro_torch.core import collectives as coll, dag
from repro_torch.mesh import Mesh


class Scenario(enum.Enum):
    S1_HOST = "s1_host"
    S2_IN_NET = "s2_in_net"
    S3_IN_NET_MAP = "s3_in_net_map"
    NATIVE = "native"
    HIERARCHICAL = "hierarchical"


def _tree_map(f, tree):
    """Apply ``f`` to every tensor of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(f, v) for v in tree)
    return f(tree)


def aggregate(
    grads: Any,
    mesh: Mesh,
    scenario: Scenario | str,
    *,
    data_axis: str = "data",
    pod_axis: str | None = None,
    rep_groups=None,
    rep_axis: str | None = None,
    ring_order: list[int] | None = None,
) -> Any:
    """Aggregate (mean) a gradient nest across the DP axes, in-network or
    at the endpoint per ``scenario``.

    ``rep_groups``/``rep_axis``: optional replica subgroups of a model axis
    whose gradients also need summing; they always use a psum.

    ``ring_order``: optional device order (a permutation of the
    ``data_axis`` indices) the S2/S3 in-transit rings follow instead of
    rank order ``i → i+1``. Any permutation preserves the aggregated
    values; the order only changes which links each hop crosses.
    """
    scenario = Scenario(scenario)
    axes = [data_axis] + ([pod_axis] if pod_axis else [])
    n = 1
    for a in axes:
        n *= mesh.axis_size(a)
    scale = 1.0 / n
    ring_groups = None
    if ring_order is not None:
        order = [int(i) for i in ring_order]
        if sorted(order) != list(range(mesh.axis_size(data_axis))):
            raise ValueError(
                f"ring_order must be a permutation of range({mesh.axis_size(data_axis)}), "
                f"got {order}"
            )
        ring_groups = [order]

    def _ring(g, a, **kw):
        groups = ring_groups if a == data_axis else None
        return coll.ring_all_reduce(g, mesh, a, groups=groups, **kw)

    if rep_axis is not None and rep_groups is not None:
        grads = _tree_map(lambda g: mesh.psum(g, rep_axis, axis_index_groups=rep_groups), grads)

    if scenario is Scenario.NATIVE:
        return _tree_map(lambda g: mesh.psum(g, tuple(axes)) * scale, grads)

    if scenario is Scenario.S1_HOST:
        def host_reduce(g):
            for a in axes:
                g = mesh.all_gather(g, a).sum(dim=mesh.ndim)  # endpoint compute
            return g * scale
        return _tree_map(host_reduce, grads)

    if scenario is Scenario.S2_IN_NET:
        def in_net(g):
            for a in axes:
                g = _ring(g, a)
            return g * scale
        return _tree_map(in_net, grads)

    if scenario is Scenario.S3_IN_NET_MAP:
        def in_net_mapped(g):
            for a in axes:
                g = _ring(g, a, wire_map=coll.bf16_wire, unmap=coll.fp32_unwire)
            return g * scale
        return _tree_map(in_net_mapped, grads)

    if scenario is Scenario.HIERARCHICAL:
        if not pod_axis:
            # degenerates to S2 on a single pod
            return _tree_map(lambda g: coll.ring_all_reduce(g, mesh, data_axis) * scale, grads)
        return _tree_map(
            lambda g: coll.hierarchical_all_reduce(g, mesh, data_axis, pod_axis) * scale, grads
        )

    raise ValueError(scenario)  # pragma: no cover


def wire_bytes_per_device(nbytes: float, world: int, scenario: Scenario | str) -> float:
    """Analytic wire cost (per device) of aggregating ``nbytes``."""
    scenario = Scenario(scenario)
    if world <= 1:
        return 0.0
    if scenario is Scenario.S1_HOST:
        return nbytes * (world - 1)  # receive everyone else's full tensor
    if scenario in (Scenario.S2_IN_NET, Scenario.NATIVE, Scenario.HIERARCHICAL):
        return 2.0 * nbytes * (world - 1) / world
    if scenario is Scenario.S3_IN_NET_MAP:
        return 1.0 * nbytes * (world - 1) / world  # bf16 wire halves bytes
    raise ValueError(scenario)


# ---------------------------------------------------------------------------
# The scenarios as p4mr programs, lowered by the pass-based compiler and run
# by ``plan.run(backend="torch")`` on the world-dim mesh.
# ---------------------------------------------------------------------------
def scenario_program(
    world: int,
    scenario: Scenario | str,
    *,
    state_width: int = 1,
    shuffle_buckets: int | None = None,
    hosts: "list[str] | None" = None,
):
    """Gradient aggregation over ``world`` workers as a p4mr Program.

    * S1_HOST       — one endpoint reduce (pinned at the sink's switch by
                      the caller): all raw traffic to the host.
    * S2_IN_NET     — in-network reduce. Chain form (``shuffle_buckets
                      =None``): left-deep binary SUMs, the naive frontend
                      output the rebalance pass restructures. Shuffle form
                      (``shuffle_buckets=B``): every worker KEYBYs its
                      gradient into B buckets and one SUM reduces them —
                      the ``lower-shuffle`` pass turns that into B pinned
                      per-bucket reducers, i.e. an in-network
                      reduce-scatter with a gather at the sink.
    * S3_IN_NET_MAP — S2 plus an in-transit bf16 wire map per store (the
                      bucket edges inherit the narrowed wire format).
    """
    scenario = Scenario(scenario)
    if scenario not in (Scenario.S1_HOST, Scenario.S2_IN_NET, Scenario.S3_IN_NET_MAP):
        raise ValueError(f"no DAG form for {scenario} (native/hierarchical are mesh collectives)")
    if hosts is None:
        hosts = [f"d{i}" for i in range(world)]
    elif len(hosts) != world:
        raise ValueError(f"{world} workers but {len(hosts)} hosts")
    p = dag.Program()
    leaves = []
    for i in range(world):
        p.store(f"g{i}", host=hosts[i], items=state_width)
        if scenario is Scenario.S3_IN_NET_MAP:
            p.map(f"w{i}", f"g{i}", fn_name="to_bf16")
            leaves.append(f"w{i}")
        else:
            leaves.append(f"g{i}")
    if shuffle_buckets is not None:
        buckets = max(1, min(shuffle_buckets, state_width))
        keybys = []
        for i, leaf in enumerate(leaves):
            p.key_by(f"k{i}", leaf, num_buckets=buckets)
            keybys.append(f"k{i}")
        p.sum("R", *keybys, state_width=state_width)
    elif scenario is Scenario.S1_HOST or len(leaves) == 1:
        p.sum("R", *leaves, state_width=state_width)
    else:
        acc = leaves[0]
        for i, leaf in enumerate(leaves[1:]):
            name = "R" if i == len(leaves) - 2 else f"r{i}"
            p.sum(name, acc, leaf, state_width=state_width)
            acc = name
    out = "R"
    if scenario is Scenario.S3_IN_NET_MAP:
        p.map("U", "R", fn_name="from_bf16")
        out = "U"
    p.collect("OUT", out, sink_host=hosts[0])
    return p


def compile_scenario(
    world: int,
    scenario: Scenario | str,
    *,
    state_width: int = 1,
    topo=None,
    cost_model=None,
):
    """Compile a scenario's aggregation DAG to a ``CompiledPlan``.

    S1 expresses its fan-in through the shuffle subsystem too (a single
    KEYBY bucket whose reducer is pinned to the sink's uplink — endpoint
    compute stays the point of the baseline, no optimization passes).
    S2/S3 let the §3 cost model arbitrate between the chain form (via
    ``compile_best``: chain vs rebalanced tree) and the compiled-shuffle
    form at several bucket counts (``shuffle.arbitrate_buckets``) — the
    same move, applied to the fan-out degree. Note the plan simulator
    prices wire + hop latency only: the paper's S1 penalty (endpoint CPU
    serialize/reduce rates) is out of model, so S1-vs-S2 crossover
    happens at larger worlds here than in Fig 4. Compiles through a
    ``repro_torch.p4mr.Session`` (the framework API).
    """
    from repro_torch import p4mr
    from repro_torch.core.topology import TorusTopology

    scenario = Scenario(scenario)
    topo = topo if topo is not None else TorusTopology(dims=(world,))
    sess = p4mr.Session(topo, cost_model=cost_model)
    if scenario is Scenario.S1_HOST:
        sink = topo.attach_switch("d0")
        program = scenario_program(world, scenario, state_width=state_width, shuffle_buckets=1)
        return sess.compile(
            program,
            name="s1",
            pins={"R": sink},
            options=p4mr.CompileOptions(
                passes=("parse", "validate", "lower-shuffle", "place", "route", "emit")
            ),
        )
    chain = sess.compile_best(
        scenario_program(world, scenario, state_width=state_width), name="chain"
    )
    # clamp to the key space before dedup: tiny state_width collapses the
    # candidates, so we don't compile the same 1-bucket program twice
    candidates = sorted({max(1, min(b, state_width)) for b in (world // 2, world)})
    shuffled = sess.arbitrate_buckets(
        lambda b: scenario_program(world, scenario, state_width=state_width, shuffle_buckets=b),
        candidates,
        name="shuffled",
    )
    return min((chain, shuffled), key=lambda pl: pl.cost.scalar)


def plan_ring_order(
    world: int,
    *,
    topo=None,
    state_width: int = 8,
) -> list[int]:
    """Ring device order for ``aggregate``'s S2/S3 in-transit rings,
    derived from a compiled plan instead of the hardcoded rank order.

    Compiles the S2 aggregation DAG on ``topo`` (default: the
    ``world``-device torus; named ``SwitchTopology`` fabrics are embedded
    via ``as_indexed`` so switch ids are mesh indices) and chains the
    workers' placed stores by the plan's own distance metric: starting
    from the plan's collection sink, each hop goes to the nearest
    not-yet-visited worker switch (``weighted_distance``, the same metric
    the placer scored — so a DCN-penalized pod dim is walked last). On a
    multi-dim torus this yields the snake order whose ring hops are
    physical neighbor links, where the hardcoded rank order pays
    wrap-around detours. The result is a permutation of ``range(world)``:
    any order is value-preserving, this one follows the plan's cheap
    edges.
    """
    from repro_torch import p4mr
    from repro_torch.core import primitives as prim
    from repro_torch.core.topology import TorusTopology

    topo = topo if topo is not None else TorusTopology(dims=(world,))
    if hasattr(topo, "as_indexed"):
        topo = topo.as_indexed()
    hosts = list(topo.hosts)
    if world > len(hosts):
        raise ValueError(f"{world} workers but topology has {len(hosts)} hosts")
    # one static-pipeline compile: the walk below only needs the plan's
    # placement and metric, so the chain-vs-shuffle arbitration of
    # compile_best and the reroute-feedback simulate rounds (which only
    # move routes, fixed after placement) would both be wasted here
    plan = p4mr.Session(topo, options="static_ecmp").compile(
        scenario_program(
            world, Scenario.S2_IN_NET, state_width=state_width, hosts=hosts[:world]
        ),
        name="ring-order",
    )
    devices = sorted(
        int(plan.placement.switch_of(n.name))
        for n in plan.program
        if isinstance(n, prim.Store)
    )
    if devices != list(range(world)):
        raise ValueError(
            f"workers on {type(topo).__name__} do not map to devices "
            f"0..{world - 1}: {devices} (one uplink switch per worker required)"
        )
    sink = next(
        int(plan.placement.switch_of(n.name))
        for n in plan.program
        if isinstance(n, prim.Collect)
    )
    dist = getattr(topo, "weighted_distance", topo.hop_distance)
    order: list[int] = []
    remaining = devices
    cur = sink
    while remaining:
        nxt = min(remaining, key=lambda d: (dist(cur, d), d))
        order.append(nxt)
        remaining = [d for d in remaining if d != nxt]
        cur = nxt
    return order


def simulated_scenario_time(
    world: int,
    scenario: Scenario | str,
    *,
    state_width: int = 1,
    topo=None,
    cost_model=None,
) -> float:
    """Packet-simulator completion time of one aggregation round."""
    import numpy as np

    plan = compile_scenario(
        world, scenario, state_width=state_width, topo=topo, cost_model=cost_model
    )
    inputs = {
        f"g{i}": np.ones((state_width,), np.float64) for i in range(world)
    }
    return plan.simulate(inputs).report.time_s
