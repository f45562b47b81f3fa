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
"""
from __future__ import annotations

import enum
from typing import Any

from repro_torch.core import collectives as coll
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

