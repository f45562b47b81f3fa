"""Carry parameters and caches between the JAX model and the port.

The JAX model keeps its parameters as a pytree with the layers stacked
along a leading dim (``blocks/0_attn_mlp/attn/wq`` is (n_layers, d, H·hd));
the port keeps one module per layer with the same per-layer layout. Both
functions here work on numpy arrays, so neither package imports the other.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model, block_pattern

_BLOCK = "blocks/0_attn_mlp"


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested mapping → {"a/b/c": leaf}; a mapping that is flat already
    (keys joined by "/") comes back as it is."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def params_from_jax(tree: Mapping, cfg: ModelConfig, *, device=None) -> Model:
    """A ``Model`` of ``cfg`` holding the JAX model's parameters ``tree`` (its
    pytree with numpy leaves, nested or flat with "/" keys). Every leaf must
    be used and have the shape the port expects; the bf16 weight copies are
    made after loading."""
    unit, tail, _ = block_pattern(cfg)
    if unit != ("attn_mlp",) or tail:
        raise NotImplementedError(f"only attn_mlp models load yet, not {unit + tail}")
    model = Model(cfg, device=device)
    flat = flatten(tree)
    targets: dict[str, list[tuple[torch.Tensor, int | None]]] = {
        "embed": [(model.embed, None)],
        "final_norm": [(model.final_norm.scale, None)],
    }
    if not cfg.tie_embeddings:
        targets["head"] = [(model.head, None)]
    for i, blk in enumerate(model.blocks):
        for name, p in (("ln1", blk.ln1.scale), ("ln2", blk.ln2.scale)):
            targets.setdefault(f"{_BLOCK}/{name}", []).append((p, i))
        for sub, mod in (("attn", blk.attn), ("mlp", blk.mlp)):
            for pname, p in mod.named_parameters(recurse=False):
                targets.setdefault(f"{_BLOCK}/{sub}/{pname}", []).append((p, i))
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise ValueError(f"JAX tree does not fit {cfg.name}: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, dests in targets.items():
            arr = np.asarray(flat[name], dtype=np.float32)
            if dests[0][1] is not None and arr.shape[:1] != (cfg.n_layers,):
                raise ValueError(f"{name}: shape {arr.shape}, need {cfg.n_layers} stacked layers")
            for p, layer in dests:
                src = arr if layer is None else arr[layer]
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {src.shape}, the port needs {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    model.cast_weights()
    return model


def cache_to_jax(cache: dict, mesh_dims: int = 0) -> dict:
    """The port's KV cache → the JAX cache pytree of an ``attn_mlp`` model,
    as float32 numpy (bf16 values are exact in it): ``{"blocks":
    {"0_attn_mlp": {"attn": {"k", "v"}}}}``, each (n_layers, b, S, KV, hd)
    behind ``mesh_dims`` leading dims of 1 (the device-major layout of a
    (1, 1) mesh has two)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        a = t.detach().to(torch.float32).cpu().numpy()
        return a.reshape((1,) * mesh_dims + a.shape)

    return {"blocks": {"0_attn_mlp": {"attn": {"k": leaf(cache["k"]), "v": leaf(cache["v"])}}}}
