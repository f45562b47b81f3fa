"""Codelet generation shim + the reference interpreter of a p4mr program.

The device step lives in the compiler
(``repro_torch.compiler.torch_backend.emit_step``, reachable as
``CompiledPlan.torch_step()``). ``compile_program`` remains here as a thin
deprecated wrapper, as in the reference.

``execute_reference`` is the oracle the compiled plan's backends (the
torch step and the packet simulator) are held to.
"""
from __future__ import annotations

import warnings
from typing import Mapping

import numpy as np
import torch

from repro_torch.core import dag, primitives as prim
from repro_torch.core.placement import Placement
from repro_torch.core.routing import RoutingTable


def compile_program(
    program: dag.Program,
    placement: Placement,
    routes: RoutingTable,
    mesh,
    *,
    axis_name: str = "all",
    item_dtype=torch.float32,
):
    """Deprecated: use ``repro_torch.p4mr.Session(...).compile(job)`` and
    ``plan.torch_step(mesh)`` / ``plan.run(backend="torch")`` (or
    ``repro_torch.compiler.emit_step`` when placement/routes are
    precomputed). ``mesh`` is the ``repro_torch.mesh.Mesh`` the step runs
    over, where the reference's step is shard_mapped by its caller."""
    warnings.warn(
        "repro_torch.core.codelet.compile_program is deprecated; compile through "
        "repro_torch.p4mr (Session.compile(...).torch_step(mesh) or "
        "plan.run(backend='torch'))",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.compiler.torch_backend import emit_step

    return emit_step(
        program, placement, routes, mesh, axis_name=axis_name, item_dtype=item_dtype
    )


def _float64(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise ValueError(
                f"the reference interpreter (plan.run backend 'reference' or "
                f"'simulate') runs on the host and takes host arrays, got a tensor "
                f"on {value.device}; run it there with backend='torch'"
            )
        return value.detach().to(torch.float64)
    return torch.from_numpy(np.array(value, dtype=np.float64))


def execute_reference(program: dag.Program, inputs: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Reference oracle: same semantics, no devices, on the CPU. ``inputs``
    are numpy arrays or CPU tensors; a tensor on another device raises.

    Stores and reduces hold float64, but a ``MapFn`` sees its input through
    float32 and so returns float32 (``to_bf16``: float64 → float32 → bf16).
    This is the reference package's own arithmetic, which hands every map
    input to its map function as a JAX array, with float64 off; matching
    it keeps this oracle's values and dtypes equal to the reference's. A
    sink that holds bf16 comes back as float32 (numpy has no bf16), which
    holds its values exactly.
    """
    program.validate()
    values: dict[str, torch.Tensor] = {}
    for node in program.toposort():
        if isinstance(node, prim.Store):
            values[node.name] = _float64(inputs[node.name])
        elif isinstance(node, prim.MapFn):
            v = values[node.src]
            if v.dtype == torch.float64:
                v = v.to(torch.float32)
            values[node.name] = prim.MAP_FNS[node.fn_name](v)
        elif isinstance(node, prim.KeyBy):
            values[node.name] = values[node.src]
        elif isinstance(node, prim.ShuffleBucket):
            values[node.name] = values[node.src][..., node.offset : node.offset + node.width]
        elif isinstance(node, prim.Concat):
            values[node.name] = torch.cat([values[s] for s in node.srcs], dim=-1)
        elif isinstance(node, prim.Reduce):
            acc = values[node.srcs[0]].to(torch.float64)
            for s in node.srcs[1:]:
                acc = node.kind.combine(acc, values[s])
            values[node.name] = acc
        elif isinstance(node, prim.Collect):
            values[node.name] = values[node.src]
    out = {}
    for s in program.sinks():
        v = values[s]
        out[s] = (v.to(torch.float32) if v.dtype == torch.bfloat16 else v).numpy()
    return out
