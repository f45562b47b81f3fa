"""Training input shapes on a data world: the training half of
``repro/launch/shapes.py``.

Batched tensors are world-major: the mesh dims (``(W,)`` for ``("data",)``,
``(pod, data)`` for a two-level mesh), then each rank's ``(b_loc, ...)``.
The reference's device-major layout carries a model dim too, which is 1 on
one card (tp = 1, no rep groups): the same numbers without it. The serving
shapes and the pod-scale shape table wait for the dry run (ROADMAP 5(c)).
"""
from __future__ import annotations

import torch

from repro_torch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.parallel import local_batch


def batch_layout(mesh: Mesh, global_batch: int) -> tuple[tuple[int, ...], int]:
    """(the batch's leading mesh dims, each rank's rows)."""
    return mesh.shape, local_batch(global_batch, mesh.size)


def train_input_specs(cfg: ModelConfig, mesh: Mesh, seq: int, global_batch: int
                      ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{input name: (shape, dtype)} of one training batch; enc-dec splits
    ``seq`` between encoder frames and decoder tokens."""
    dims, b_loc = batch_layout(mesh, global_batch)
    lead = dims + (b_loc,)
    if cfg.enc_layers:
        s = seq // 2
        return {"labels": (lead + (s,), torch.int32), "tokens": (lead + (s,), torch.int32),
                "enc_embeds": (lead + (s, cfg.d_model), torch.bfloat16),
                "enc_positions": (lead + (s,), torch.int32)}
    specs = {"labels": (lead + (seq,), torch.int32)}
    if cfg.embed_input:
        specs["embeds"] = (lead + (seq, cfg.d_model), torch.bfloat16)
        if cfg.mrope_sections is not None:
            specs["positions"] = (lead + (seq, 3), torch.int32)
    else:
        specs["tokens"] = (lead + (seq,), torch.int32)
    return specs
