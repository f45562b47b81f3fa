"""Gradient synchronisation and norms over a data world on one card.

The port of ``repro/optim/distributed.py`` at tp = 1. In the reference most
gradients leave the backward already aggregated (the scenario-selected
transpose of the FSDP weight fetch) and ``sync_gradients`` sums the rest
over (pod, data); here every rank's gradient is held in one tensor (the
mesh dims, then the leaf) and ``sync_gradients`` runs both, leaf by leaf,
through ``models.parallel.fsdp_aggregate``. The norm and the clip are over
the aggregated gradient: the reference weights each stored element by
1 / its copies, which counts every logical element once, as this does.
"""
from __future__ import annotations

import torch

from repro_torch.core.scenarios import Scenario
from repro_torch.mesh import Mesh
from repro_torch.models.parallel import fsdp_aggregate


def sync_gradients(rank_grads: dict[str, torch.Tensor], dims: dict[str, int | None],
                   mesh: Mesh, scenario: Scenario | str) -> dict[str, torch.Tensor]:
    """Every rank's gradients ({name: (mesh dims, *leaf)}) → the aggregated
    gradient of each leaf along its FSDP dim under ``scenario`` (``dims``;
    None: summed over the world)."""
    return {k: fsdp_aggregate(g, mesh, dims[k], scenario) for k, g in rank_grads.items()}


def global_grad_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm of all leaves together (a 0-dim tensor)."""
    total = sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """(grads × min(1, max_norm / norm), norm)."""
    norm = global_grad_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm
