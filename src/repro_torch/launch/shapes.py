"""The assigned input shapes, which archs run them, and the input specs of
each step on a data world: the port of ``repro/launch/shapes.py``.

    train_4k    → the train step  (tokens + labels)
    prefill_32k → the prefill step (a prompt)
    decode_32k  → the serve step  (one new token, a cache of seq_len)
    long_500k   → the serve step  (sub-quadratic archs only)

Batched tensors lead with the mesh dims, then each rank's ``(b_loc, ...)``.
A ``ShardEnv`` (training, and serving on a launcher's mesh) leads with the
reference's device-major dims: (pod,) data, and a model dim that is the
model axis when the batch also splits over the rep groups and 1 otherwise.
A data world (a ``Mesh`` of ``("data",)`` or ``("pod", "data")``, which the
dry run's serving cells take) leads with its own dims, the device-major
layout without its model dim of 1. On a process mesh (a ``ShardEnv`` whose
``mesh`` is a ``ProcessMesh``) a process holds its own block: a dim of 1 per
mesh axis, then its rows. A spec is {input name: (shape, dtype)}.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.parallel import ShardEnv, local_batch

World = Mesh | ShardEnv


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# the reference's microbatch counts for train_4k (activations per device
# under remat)
TRAIN_MICROBATCHES = {
    "grok-1-314b": 16,
    "phi3-medium-14b": 8,
    "qwen2-vl-7b": 8,
    "granite-8b": 8,
    "minicpm3-4b": 4,
    "recurrentgemma-2b": 4,
    "mamba2-1.3b": 2,
    "seamless-m4t-large-v2": 2,
    "granite-moe-1b-a400m": 2,
    "qwen1.5-0.5b": 1,
}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, the reason where it is skipped): long_500k needs
    sub-quadratic sequence mixing."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "O(L^2) full attention at 524k ctx — skipped per assignment"
    return True, ""


def batch_layout(world: World, global_batch: int) -> tuple[tuple[int, ...], int]:
    """(the batch's leading mesh dims, each rank's rows). Over a
    ``ShardEnv`` the model dim is the model axis when the batch splits over
    the rep groups too, and tiny batches (fewer rows than the fsdp world)
    replicate, one row a rank; on a process mesh, the process's block."""
    if isinstance(world, Mesh):
        return world.shape, local_batch(global_batch, world.size)
    if world.mesh is not None:
        return world.mesh.block, world.local_batch(global_batch)
    md = world.model_size if world.batch_split_rep(global_batch) else 1
    dims = (world.data_size, md) if world.pod_axis is None else (
        world.pod_size, world.data_size, md)
    return dims, world.local_batch(global_batch)


def train_input_specs(cfg: ModelConfig, mesh: World, seq: int, global_batch: int
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


def prefill_input_specs(cfg: ModelConfig, mesh: World, seq: int, global_batch: int
                        ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The prefill's inputs: the training batch's without ``labels``."""
    specs = train_input_specs(cfg, mesh, seq, global_batch)
    specs.pop("labels")
    return specs


def decode_input_specs(cfg: ModelConfig, mesh: World, global_batch: int
                       ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """One decode step's inputs: a token a sequence and the cache length."""
    dims, b_loc = batch_layout(mesh, global_batch)
    return {"tokens": (dims + (b_loc,), torch.int32), "cache_len": ((), torch.int32)}
