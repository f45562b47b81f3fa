"""Gradient synchronisation and norms over the mesh's ranks.

The port of ``repro/optim/distributed.py``. In the reference most gradients
leave the backward already aggregated (the scenario-selected transpose of
the weight fetch: the rep-group reduce-scatter along the TP dim, then the
FSDP one over (pod, data)) and ``sync_gradients`` sums the rest: leaves
without an FSDP dim over (pod, data), leaves without a TP dim over the
model axis, kv heads and experts over their copies (``dup_sync_groups``).

On world dims every rank's gradient is held in one tensor (the mesh dims,
then the leaf) and ``sync_gradients`` runs both, leaf by leaf, through
``models.parallel.aggregate_leaf``; the norm and the clip are over the
aggregated logical gradient. On a process mesh (``ProcessMesh``) a
process's gradients are its storage shards, which the fetch's backward has
aggregated: ``sync_gradients`` runs the reference's sums as process-group
calls, and ``global_grad_norm`` weights each stored element by 1 / its
copies (``copies_per_element``) and all-reduces the sum over the mesh, as
the reference does. Both count every logical element once.
"""
from __future__ import annotations

import torch

from repro_torch.core.scenarios import Scenario
from repro_torch.mesh import Mesh, ProcessMesh
from repro_torch.models.parallel import LeafPlace, ShardEnv, aggregate_leaf, psum


def sync_gradients(rank_grads: dict[str, torch.Tensor], places: dict, mesh: Mesh,
                   scenario: Scenario | str, tp: int = 1) -> dict[str, torch.Tensor]:
    """Every rank's gradients ({name: (mesh dims, *leaf)}) → each leaf's
    aggregated gradient under ``scenario``. ``mesh``: the data world, with
    the model axis's rep ranks last when there is one; ``tp``: the tp ranks
    folded into each. ``places``: {name: ``specs.LeafPlace``}.

    On a ``ProcessMesh`` (the launcher's mesh, model axis included) the
    gradients are this process's storage shards ({name: shard}), already
    reduce-scattered by the fetch's backward, and each is summed where the
    reference's ``sync_gradients`` sums it: over (pod, data) without an
    FSDP dim, over the model axis without a TP dim, over ``dup_sync_groups``
    for kv heads and experts with copies."""
    if isinstance(mesh, ProcessMesh):
        return _sync_shards(rank_grads, places, process_env(mesh, scenario, tp))
    out = {}
    for k, g in rank_grads.items():
        pl = places[k]
        out[k] = aggregate_leaf(g, mesh, scenario, fsdp_dim=pl.fsdp_dim, tp_dim=pl.tp_dim,
                                dup_of=pl.dup_of, tp=tp)
    return out


def process_env(mesh: ProcessMesh, scenario: Scenario | str, tp: int) -> ShardEnv:
    """The ``ShardEnv`` of a launcher's process mesh at ``tp``."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return ShardEnv(model_size=sizes["model"], data_size=sizes["data"],
                    pod_size=sizes.get("pod", 1), tp=tp, scenario=Scenario(scenario),
                    pod_axis="pod" if "pod" in sizes else None, mesh=mesh)


def _sync_shards(grads: dict[str, torch.Tensor], places: dict, env: ShardEnv) -> dict:
    m = env.mesh
    out = {}
    for k, g in grads.items():  # in one order on every process
        pl = places[k]
        if pl.fsdp_dim is None and env.fsdp_size > 1:
            g = psum(env._lead(g), m, env.fsdp_axes).reshape(g.shape)
        groups = None if pl.tp_dim is None else env.dup_sync_groups(pl.dup_of)
        if env.model_size > 1 and (pl.tp_dim is None or (pl.dup_of and groups is not None)):
            g = psum(env._lead(g), m, env.model_axis, groups).reshape(g.shape)
        out[k] = g
    return out


def copies_per_element(place: LeafPlace, env: ShardEnv) -> float:
    """How many devices hold each storage element of a leaf (the
    reference's ``copies_per_element``)."""
    c = 1.0
    if place.fsdp_dim is None:
        c *= env.fsdp_size
    if place.tp_dim is None:
        c *= env.model_size
    elif place.dup_of:  # model_size · per_rank slots hold dup_of logical entities
        c *= env.model_size * max(1, place.dup_of // env.tp) / place.dup_of
    return c


def global_grad_norm(grads: dict[str, torch.Tensor], places: dict | None = None,
                     env: ShardEnv | None = None) -> torch.Tensor:
    """The fp32 L2 norm of all leaves together (a 0-dim tensor). With a
    process mesh's ``env`` the leaves are this process's shards: each
    one's sum of squares is weighted by 1 / its copies and the total is
    all-reduced over the whole mesh."""
    if env is None or env.mesh is None:
        total = sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values())
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    m = env.mesh
    total = torch.zeros((), dtype=torch.float32, device=m.device)
    for k, g in grads.items():
        total = total + torch.sum(g.to(torch.float32) ** 2) * (
            1.0 / copies_per_element(places[k], env))
    return torch.sqrt(m.psum(total.reshape(m.block), m.axis_names).reshape(()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float,
                        places: dict | None = None, env: ShardEnv | None = None):
    """(grads × min(1, max_norm / norm), norm); ``places`` and ``env`` as
    ``global_grad_norm`` takes them."""
    norm = global_grad_norm(grads, places, env)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm
