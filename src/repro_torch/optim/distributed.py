"""Gradient synchronisation and norms over the mesh's ranks on one card.

The port of ``repro/optim/distributed.py``. In the reference most gradients
leave the backward already aggregated (the scenario-selected transpose of
the weight fetch: the rep-group reduce-scatter along the TP dim, then the
FSDP one over (pod, data)) and ``sync_gradients`` sums the rest: leaves
without an FSDP dim over (pod, data), leaves without a TP dim over the
model axis, kv heads and experts over their copies (``dup_sync_groups``).
Here every rank's gradient is held in one tensor (the mesh dims, then the
leaf) and ``sync_gradients`` runs both, leaf by leaf, through
``models.parallel.aggregate_leaf``. The norm and the clip are over the
aggregated logical gradient: the reference weights each stored element by
1 / its copies (``LeafPlace.copies``), which counts every logical element
once, as this does.
"""
from __future__ import annotations

import torch

from repro_torch.core.scenarios import Scenario
from repro_torch.mesh import Mesh
from repro_torch.models.parallel import aggregate_leaf


def sync_gradients(rank_grads: dict[str, torch.Tensor], places: dict, mesh: Mesh,
                   scenario: Scenario | str, tp: int = 1) -> dict[str, torch.Tensor]:
    """Every rank's gradients ({name: (mesh dims, *leaf)}) → each leaf's
    aggregated gradient under ``scenario``. ``mesh``: the data world, with
    the model axis's rep ranks last when there is one; ``tp``: the tp ranks
    folded into each. ``places``: {name: ``specs.LeafPlace``}."""
    out = {}
    for k, g in rank_grads.items():
        pl = places[k]
        out[k] = aggregate_leaf(g, mesh, scenario, fsdp_dim=pl.fsdp_dim, tp_dim=pl.tp_dim,
                                dup_of=pl.dup_of, tp=tp)
    return out


def global_grad_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm of all leaves together (a 0-dim tensor)."""
    total = sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """(grads × min(1, max_norm / norm), norm)."""
    norm = global_grad_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm
