"""Carry parameters and caches between the JAX model and the port.

The JAX model keeps its parameters as a pytree whose superblock leaves are
stacked along a leading dim (``blocks/0_attn_mlp/attn/wq`` is (n_layers, d,
H·hd); ``blocks/2_attn_local/...`` is (n_superblocks, ...)), tail blocks
unstacked (``tail/0_rec/...``) and encoder layers stacked
(``enc_blocks/...``); the port keeps one module per layer with the same
per-layer layout. Both functions here work on numpy arrays, so neither
package imports the other.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model


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


def jax_leaf(name: str) -> str:
    """A port parameter's name within its layer → the JAX leaf's path: an
    ``RMSNorm``'s ``scale`` is the JAX leaf itself (``ln1.scale`` →
    ``ln1``, ``attn.q_norm.scale`` → ``attn/q_norm``)."""
    return name.removesuffix(".scale").replace(".", "/")


def params_from_jax(tree: Mapping, cfg: ModelConfig, *, device=None) -> Model:
    """A ``Model`` of ``cfg`` holding the JAX model's parameters ``tree`` (its
    pytree with numpy leaves, nested or flat with "/" keys). Every leaf must
    be used and have the shape the port expects; the bf16 weight copies are
    made after loading."""
    model = Model(cfg, device=device)
    flat = flatten(tree)
    targets: dict[str, list[tuple[torch.Tensor, int | None]]] = {
        "embed": [(model.embed, None)],
        "final_norm": [(model.final_norm.scale, None)],
    }
    if not cfg.tie_embeddings:
        targets["head"] = [(model.head, None)]
    if cfg.enc_layers:
        targets["enc_norm"] = [(model.enc_norm.scale, None)]
    places = list(model.layout) + [("enc_blocks", None, i) for i in range(cfg.enc_layers)]
    for blk, (group, key, i) in zip(list(model.blocks) + list(model.enc_blocks), places):
        prefix = group if key is None else f"{group}/{key}"
        for name, p in blk.named_parameters():
            targets.setdefault(f"{prefix}/{jax_leaf(name)}", []).append((p, i))
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise ValueError(f"JAX tree does not fit {cfg.name}: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, dests in targets.items():
            arr = np.asarray(flat[name], dtype=np.float32)
            if dests[0][1] is not None and arr.shape[:1] != (len(dests),):
                raise ValueError(f"{name}: shape {arr.shape}, need {len(dests)} stacked layers")
            for p, layer in dests:
                src = arr if layer is None else arr[layer]
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {src.shape}, the port needs {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    model.cast_weights()
    return model


def cache_to_jax(cache: Mapping, mesh_dims: int = 0) -> dict:
    """The port's cache → the JAX cache pytree (the same tree), as float32
    numpy (bf16 values are exact in it), each leaf behind ``mesh_dims``
    leading dims of 1 (the device-major layout of a (1, 1) mesh has two)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        a = t.detach().to(torch.float32).cpu().numpy()
        return a.reshape((1,) * mesh_dims + a.shape)

    return {k: cache_to_jax(v, mesh_dims) if isinstance(v, Mapping) else leaf(v)
            for k, v in cache.items()}
