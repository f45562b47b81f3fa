"""Carry parameters, gradients, optimizer state and caches between the JAX
model and the port.

The JAX model keeps its parameters as a pytree whose superblock leaves are
stacked along a leading dim (``blocks/0_attn_mlp/attn/wq`` is (n_layers, d,
H·hd); ``blocks/2_attn_local/...`` is (n_superblocks, ...)), tail blocks
unstacked (``tail/0_rec/...``) and encoder layers stacked
(``enc_blocks/...``); the port keeps one module per layer with the same
per-layer layout. ``leaf_paths`` maps one onto the other; the functions
here work on numpy arrays, so neither package imports the other. Leaves keep
their dtype: numpy has no bf16 of its own, so a bf16 leaf comes out as
``ml_dtypes.bfloat16`` (the type the JAX package's arrays convert to; it
comes with JAX) and goes in from one, or as a tensor (``stack_leaves``,
``unstack_leaves``).
"""
from __future__ import annotations

from collections import Counter
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


def leaf_paths(model: Model) -> dict[str, tuple[str, int | None]]:
    """Every port parameter's place in the JAX tree: {port name: (JAX leaf
    path, index along its stacked-layer dim, or None for an unstacked
    leaf)}, in the port's parameter order."""
    cfg = model.cfg
    out = {"embed": ("embed", None), "final_norm.scale": ("final_norm", None)}
    if not cfg.tie_embeddings:
        out["head"] = ("head", None)
    if cfg.enc_layers:
        out["enc_norm.scale"] = ("enc_norm", None)
    groups = [("blocks", model.blocks, model.layout),
              ("enc_blocks", model.enc_blocks,
               [("enc_blocks", None, i) for i in range(cfg.enc_layers)])]
    for attr, blocks, places in groups:
        for j, (blk, (group, key, i)) in enumerate(zip(blocks, places)):
            prefix = group if key is None else f"{group}/{key}"
            for name, _ in blk.named_parameters():
                out[f"{attr}.{j}.{name}"] = (f"{prefix}/{jax_leaf(name)}", i)
    return out


def stack_leaves(model: Model, tensors: Mapping[str, torch.Tensor | None],
                 dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Tensors keyed by port parameter name → {JAX leaf path: tensor}, the
    layers of a stacked leaf stacked again (a new tensor on their device,
    in their dtype), an unstacked leaf as it is. A missing or None tensor (a
    parameter the loss does not reach) counts as zeros of ``dtype`` (the
    parameter's by default)."""
    params = dict(model.named_parameters())
    layers: dict[str, dict] = {}
    for name, (path, i) in leaf_paths(model).items():
        t = tensors.get(name)
        if t is None:
            p = params[name]
            t = torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)
        layers.setdefault(path, {})[i] = t.detach()
    return {path: ls[None] if None in ls else torch.stack([ls[i] for i in sorted(ls)])
            for path, ls in layers.items()}


def unstack_leaves(model: Model, tree: Mapping[str, torch.Tensor],
                   like: Mapping[str, tuple] | None = None) -> dict[str, torch.Tensor]:
    """``stack_leaves``' inverse: {JAX leaf path: tensor} (flat, or nested)
    → {port parameter name: a view of its layer}. Every leaf must be used
    and fit: each layer shaped as its parameter, or as ``like`` says ({port
    name: shape}, for leaves that are not shaped like the parameters)."""
    flat = flatten(tree)
    paths = leaf_paths(model)
    want = {path for path, _ in paths.values()}
    missing, extra = sorted(want - set(flat)), sorted(set(flat) - want)
    if missing or extra:
        raise ValueError(f"JAX tree does not fit {model.cfg.name}: missing {missing}, "
                         f"unexpected {extra}")
    stacked = Counter(path for path, i in paths.values() if i is not None)
    out = {}
    for name, p in model.named_parameters():
        path, i = paths[name]
        t = flat[path]
        if i is not None and tuple(t.shape[:1]) != (stacked[path],):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, need {stacked[path]} stacked "
                             "layers")
        src = t if i is None else t[i]
        shape = tuple(p.shape if like is None else like[name])
        if tuple(src.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the port needs {shape}"
                             + ("" if i is None else " per stacked layer"))
        out[name] = src
    return out


def numpy_leaf(t: torch.Tensor) -> np.ndarray:
    """A tensor → numpy on the host in its dtype (bf16 as
    ``ml_dtypes.bfloat16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tensor_leaf(a) -> torch.Tensor:
    """A numpy leaf → a host tensor: bf16 from ``ml_dtypes.bfloat16``
    (bitwise), fp32 from any other float."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def to_jax(model: Model, tensors: Mapping[str, torch.Tensor | None]) -> dict[str, np.ndarray]:
    """Tensors keyed by port parameter name (the parameters, their
    gradients, optimizer moments) → {JAX leaf path: numpy in the tensors'
    dtype}, the layers of a stacked leaf stacked again. A missing or None
    tensor (a parameter the loss does not reach) counts as fp32 zeros."""
    return {path: numpy_leaf(t)
            for path, t in stack_leaves(model, tensors, torch.float32).items()}


def params_to_jax(model: Model) -> dict[str, np.ndarray]:
    """The model's parameters as the JAX tree's leaves ({path: numpy})."""
    return to_jax(model, dict(model.named_parameters()))


def from_jax(model: Model, tree: Mapping) -> dict[str, torch.Tensor]:
    """A JAX tree shaped like the parameters (nested, or flat with "/"
    keys; numpy leaves) → {port parameter name: tensor on the model's
    device, bf16 for a bf16 leaf and fp32 otherwise}: ``to_jax``'s inverse.
    Every leaf must be used and fit."""
    tensors = {path: tensor_leaf(a) for path, a in flatten(tree).items()}
    return {name: t.contiguous().to(model.device)
            for name, t in unstack_leaves(model, tensors).items()}


def params_from_jax(tree: Mapping, cfg: ModelConfig, *, device=None) -> Model:
    """A ``Model`` of ``cfg`` holding the JAX model's parameters ``tree`` (its
    pytree with numpy leaves, nested or flat with "/" keys), stored in the
    config's ``param_dtype`` (fp32 leaves are rounded to a bf16 one). Every
    leaf must be used and have the shape the port expects; the bf16 weight
    copies are made after loading."""
    model = Model(cfg, device=device)
    values = from_jax(model, tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(values[name])
    model.cast_weights()
    return model


def opt_state_from_jax(state: Mapping, model: Model):
    """The reference's ``OptState`` (``count``, and fp32 moments ``m``/``v``
    shaped like the parameters, as numpy) → the port's ``optim.OptState``.
    8-bit moments are cut into blocks per stacked leaf there and per layer
    here, so they do not carry over."""
    from repro_torch.optim.adamw import OptState

    if isinstance(state["m"], (tuple, list)) or any(
            isinstance(v, (tuple, list)) for v in flatten(state["m"]).values()):
        raise ValueError("8-bit moments do not carry over: the reference cuts their blocks "
                         "from stacked leaves, the port from each layer")
    return OptState(count=int(np.asarray(state["count"])), m=from_jax(model, state["m"]),
                    v=from_jax(model, state["v"]))


def cache_to_jax(cache: Mapping, mesh_dims: int = 0) -> dict:
    """The port's cache → the JAX cache pytree (the same tree), as float32
    numpy (bf16 values are exact in it), each leaf behind ``mesh_dims``
    leading dims of 1 (the device-major layout of a (1, 1) mesh has two)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        a = t.detach().to(torch.float32).cpu().numpy()
        return a.reshape((1,) * mesh_dims + a.shape)

    return {k: cache_to_jax(v, mesh_dims) if isinstance(v, Mapping) else leaf(v)
            for k, v in cache.items()}
