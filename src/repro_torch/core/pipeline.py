"""Pipeline parallelism: microbatches streaming through a stage ring.

The p4mr view of GPipe: each device is a switch holding one *stage* of
the program; activations are the packets, forwarded to the next hop with
one ``ppermute`` per tick and transformed at every hop — computation in
transit, applied to model layers instead of word counts.

``pipeline_apply`` runs the classic fill-drain schedule (n_micro + p − 1
ticks, bubble fraction (p−1)/(n_micro+p−1)) over the world-dim mesh
(``repro_torch.mesh``): a tick is one stage application batched over
every device, then one ``Mesh.ppermute`` to the next stage.
Forward-only (serving / encoder towers). ``pipeline_stats`` gives the
analytic bubble/throughput model used when choosing pod-axis roles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.mesh import Mesh


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    mesh: Mesh,
    axis_name: str,
) -> torch.Tensor:
    """Run ``n`` microbatches through p pipeline stages (p = axis size).

    stage_fn(params, x) -> y, same shape (stages must be shape-preserving,
    e.g. transformer blocks), applied to every device at once: ``x`` has
    the mesh dims first, then one microbatch's shape. ``stage_params``:
    each device's stage params, mesh dims first (stage id = axis index).
    ``microbatches``: (n, ...) — the same array for every device; stage 0
    feeds microbatch t at tick t.

    Returns the mesh dims, then the (n, ...) outputs of the LAST stage,
    broadcast to every device along ``axis_name`` (a view, not a copy).
    """
    p = mesh.axis_size(axis_name)
    a = mesh.dim(axis_name)
    n = microbatches.shape[0]
    local = tuple(microbatches.shape[1:])
    ticks = n + p - 1
    perm = [(i, i + 1) for i in range(p - 1)]  # forward chain (no wrap)
    s = mesh.axis_index(axis_name).view(mesh.shape + (1,) * len(local))

    buf = microbatches.new_zeros(mesh.shape + local)  # what my predecessor sent
    emitted = []
    for t in range(ticks):
        x0 = microbatches[min(t, n - 1)]
        x = torch.where(s == 0, x0, buf)
        active = (t >= s) & (t - s < n)
        y = torch.where(active, stage_fn(stage_params, x), 0)
        buf = mesh.ppermute(y, axis_name, perm)  # packet to next switch
        if t >= p - 1:  # micro t - (p - 1) leaves the last stage this tick
            emitted.append(y.select(a, p - 1))
    # (other mesh dims, n, ...): the last stage's outputs in micro order
    out = torch.stack(emitted, dim=mesh.ndim - 1)
    # only the last stage emits, so the reference's psum is a broadcast
    return out.unsqueeze(a).expand(mesh.shape + (n,) + local)


@dataclasses.dataclass(frozen=True)
class PipelineStats:
    stages: int
    n_micro: int

    @property
    def ticks(self) -> int:
        return self.n_micro + self.stages - 1

    @property
    def bubble_fraction(self) -> float:
        return (self.stages - 1) / self.ticks

    @property
    def efficiency(self) -> float:
        return self.n_micro / self.ticks


def pipeline_stats(stages: int, n_micro: int) -> PipelineStats:
    return PipelineStats(stages=stages, n_micro=n_micro)
