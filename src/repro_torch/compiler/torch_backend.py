"""Torch backend: a placed+routed program → one step over the world-dim mesh.

The paper's compiler emits one P4 codelet per switch. The reference runs
one SPMD program on every device, each acting only on the packets
addressed to it. Here every device is a row of the mesh's world dim
(``repro_torch.mesh.Mesh``) on one card, and forwarding a value along a
route's hop sequence is one ``Mesh.ppermute`` per hop with a single
(src, dst) pair: rows off the pair receive zeros, i.e. no packet.

Switch ids are mesh indices along ``axis_name`` (a ``TorusTopology`` or a
``SwitchTopology.as_indexed`` view guarantees this).
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core import dag, primitives as prim
from repro_torch.core.placement import Placement
from repro_torch.core.routing import RoutingTable
from repro_torch.mesh import Mesh


def _route_value(value, mesh: Mesh, axis_name: str, path):
    """Forward ``value`` hop by hop along ``path`` (one wire hop each)."""
    for a, b in zip(path, path[1:]):
        if a != b:
            value = mesh.ppermute(value, axis_name, [(int(a), int(b))])
    return value


def emit_step(
    program: dag.Program,
    placement: Placement,
    routes: RoutingTable,
    mesh: Mesh,
    *,
    axis_name: str = "all",
    item_dtype=torch.float32,
):
    """Emit the step function.

    Returned ``step(inputs)``: ``inputs[label]`` is every Store's value on
    the mesh, leading with the mesh dims (contents off the Store's own
    switch are ignored, so an expanded view of one row will do). A float64
    input is read as float32 first, as the reference's arrays are, then
    cast to ``item_dtype``. Returns ``{sink_label: value}`` where the value
    is valid on the sink's switch (zeros elsewhere), plus the sum over the
    world dim, on every row, under ``label + "@all"``.
    """
    program.validate()
    route_of = {(r.src_label, r.dst_label): r.path for r in routes.routes}
    order = list(program.toposort())
    sinks = program.sinks()
    dim = mesh.dim(axis_name)

    def row(label: str) -> tuple:
        """Index of the mesh row of the switch ``label`` is placed on."""
        return (slice(None),) * dim + (int(placement.switch_of(label)),)

    def on_switch(label: str, shape, own: torch.Tensor, dtype) -> torch.Tensor:
        """``own`` on the switch ``label`` is placed on, zeros elsewhere."""
        out = torch.zeros(shape, dtype=dtype, device=own.device)
        out[row(label)] = own
        return out

    def step(inputs: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        values: dict[str, torch.Tensor] = {}

        def routed(src: str, dst: str) -> torch.Tensor:
            return _route_value(values[src], mesh, axis_name, route_of[(src, dst)])

        for node in order:
            if isinstance(node, prim.Store):
                x = inputs[node.name]
                own = x[row(node.name)]
                if own.dtype == torch.float64:
                    own = own.to(torch.float32)
                values[node.name] = on_switch(node.name, x.shape, own, item_dtype)
            elif isinstance(node, prim.MapFn):
                values[node.name] = prim.MAP_FNS[node.fn_name](routed(node.src, node.name))
            elif isinstance(node, prim.KeyBy):
                # unlowered KeyBy: pass-through. Compile with the
                # lower-shuffle pass (DEFAULT_PASSES) to get per-bucket
                # ShuffleBucket edges routed below; the fused-collective
                # equivalent is repro_torch.shuffle.spmd (all_to_all).
                values[node.name] = routed(node.src, node.name)
            elif isinstance(node, prim.ShuffleBucket):
                # this bucket's key-space window of the mapper's value
                v = routed(node.src, node.name)
                values[node.name] = v[..., node.offset : node.offset + node.width]
            elif isinstance(node, prim.Concat):
                values[node.name] = torch.cat([routed(s, node.name) for s in node.srcs], dim=-1)
            elif isinstance(node, prim.Reduce):
                # a left fold in srcs order, one combine per source, so a
                # bf16 sum rounds after every add as the reference's does
                acc = None
                for s in node.srcs:
                    v = routed(s, node.name)
                    acc = v if acc is None else node.kind.combine(acc, v)
                # reducer state lives only on its own switch
                values[node.name] = on_switch(node.name, acc.shape, acc[row(node.name)], acc.dtype)
            elif isinstance(node, prim.Collect):
                values[node.name] = routed(node.src, node.name)
            else:  # pragma: no cover
                raise TypeError(type(node))
        out = {}
        for s in sinks:
            out[s] = values[s]
            out[s + "@all"] = mesh.psum(values[s], axis_name)  # collection broadcast
        return out

    return step
