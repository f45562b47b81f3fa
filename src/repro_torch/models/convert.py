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

Under a ``ShardEnv`` the reference lays kv heads and experts out in slots
with duplicate copies (``specs``) and pads the vocab to its model axis:
``params_from_jax(..., env=...)`` reads the logical leaves out of the slots
(and refuses copies that differ), and ``cache_to_jax(..., env=...)`` lays
the port's caches, held once, out device-major as the reference's serving
steps return them. ``to_slots``/``from_slots`` do the same for a stacked
tree of tensors (parameters, gradients, fp32 moments: the reference's
checkpoint tree on a mesh).

On a process mesh a process holds one device's shard of every leaf:
``rank_shards`` cuts it from the reference's global tree (slots laid out)
or from the port's logical leaves, as ``jax.device_put`` with the leaf's
partition spec places it, and ``params_from_jax(..., env=)`` with a process
mesh's env loads it, ``gather_shards`` puts the processes' shards back
into whole leaves (a checkpoint's); ``cache_block`` cuts a device's block out of a
world-dim cache held once, which is what that process's cache holds
(``cache_to_jax(block, mesh_dims)`` puts it behind its mesh dims).
"""
from __future__ import annotations

from collections import Counter
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.parallel import ONE, ShardEnv, shard_leaf


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


def _slot_dims(tree: Mapping, cfg: ModelConfig):
    """(path, slot dim, logical entities) of each slot-laid leaf of a
    stacked tree."""
    from repro_torch.models import specs

    for path in tree:
        key = specs.layer_leaf(path)
        n = specs.dup_of(key, cfg)
        if n:
            yield path, specs.TP_DIM[key] + (path.split("/")[0] in ("blocks", "enc_blocks")), n


def to_slots(tree: Mapping[str, torch.Tensor], cfg: ModelConfig, env: ShardEnv
             ) -> dict[str, torch.Tensor]:
    """A stacked tree of logical tensors ({JAX leaf path: tensor},
    ``stack_leaves``') → the reference's storage under ``env``: kv heads and
    experts copied into their slots (``dup_map``); other leaves as they
    are."""
    out = dict(tree)
    for path, dim, n in _slot_dims(tree, cfg):
        t = tree[path]
        out[path] = t.index_select(dim, torch.tensor(env.dup_map(n), device=t.device))
    return out


def from_slots(tree: Mapping[str, torch.Tensor], cfg: ModelConfig, env: ShardEnv
               ) -> dict[str, torch.Tensor]:
    """``to_slots``' inverse: each entity's first slot, where every copy of
    it must be equal (else it raises)."""
    out = dict(tree)
    for path, dim, n in _slot_dims(tree, cfg):
        t = tree[path]
        dm = env.dup_map(n)
        if t.shape[dim] != len(dm):
            raise ValueError(f"{path}: shape {tuple(t.shape)} holds {t.shape[dim]} slots along "
                             f"dim {dim}; tp {env.tp} over a model axis of {env.model_size} "
                             f"lays {n} out in {len(dm)}")
        logical = t.index_select(dim, torch.tensor([dm.index(e) for e in range(n)],
                                                   device=t.device))
        if not torch.equal(logical.index_select(dim, torch.tensor(dm, device=t.device)), t):
            raise ValueError(f"{path}: the duplicate copies of a slot are not equal")
        out[path] = logical
    return out


def rank_shards(tree: Mapping, cfg: ModelConfig, env: ShardEnv, *, slots: bool,
                at: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """A stacked tree ({JAX leaf path: array or tensor}, nested or flat) →
    one device's shard of each leaf (``parallel.shard_leaf``), as
    ``jax.device_put(params, NamedSharding(mesh, partition spec))`` places
    it: the FSDP slice and the model-axis slice of the TP dim. ``slots``:
    the tree holds kv heads and experts in their slots (the reference's
    storage), else logically (the port's, laid out here). ``at``: the
    device's (index in the (pod, data) world, index on the model axis);
    by default the env's process."""
    from repro_torch.models import specs

    if at is None:
        at = (env.fsdp_index, env.model_index)
    out = {}
    for path, t in flatten(tree).items():
        t = t if isinstance(t, torch.Tensor) else tensor_leaf(t)
        stacked = int(path.split("/")[0] in ("blocks", "enc_blocks"))
        pl = specs.place(specs.layer_leaf(path), cfg).shifted(stacked)
        out[path] = shard_leaf(t, pl, env.world(), *at, slots=slots)
    return out


def gather_shards(tree: Mapping[str, torch.Tensor], cfg: ModelConfig, env: ShardEnv, *,
                  root: int = 0) -> dict[str, torch.Tensor]:
    """``rank_shards``' inverse over a process mesh (``env.mesh``): every
    process's shard of each leaf of a stacked tree ({JAX leaf path: this
    process's shard}, as ``stack_leaves`` gives it from the model's
    parameters or moments) gathered to process ``root``, leaf by leaf in
    path order, and laid back there into the whole leaf as the reference
    stores it (kv heads and experts in their slots). Every process must
    call it; the others get {}."""
    from repro_torch.models import specs

    m = env.mesh
    out = {}
    for path in sorted(tree):
        t = tree[path]
        every = m.gather(t.contiguous(), root)
        if every is None:
            continue
        stacked = int(path.split("/")[0] in ("blocks", "enc_blocks"))
        pl = specs.place(specs.layer_leaf(path), cfg).shifted(stacked)
        every = every.reshape((env.fsdp_size, env.model_size) + tuple(t.shape))
        if pl.tp_dim is None:
            x = every[:, 0]
        else:
            x = torch.cat(list(every.unbind(1)), dim=1 + pl.tp_dim)
        out[path] = torch.cat(list(x.unbind(0)), dim=pl.fsdp_dim) if pl.fsdp_dim is not None \
            else x[0]
    return out


def params_from_jax(tree: Mapping, cfg: ModelConfig, *, env: ShardEnv | None = None,
                    device=None) -> Model:
    """A ``Model`` of ``cfg`` under ``env`` (a (1, 1) mesh by default)
    holding the JAX model's parameters ``tree`` (its pytree with numpy
    leaves, nested or flat with "/" keys) as ``init_params(param_specs(cfg,
    env), ...)`` lays them out: kv heads and experts in slots (read back to
    the logical leaves; their duplicate copies must be equal), the vocab
    padded to the model axis. Under a process mesh's env, the process's
    device's shard of each leaf (``rank_shards``). Stored in the config's
    ``param_dtype`` (fp32 leaves are rounded to a bf16 one). Every leaf must
    be used and have the shape the port expects; the bf16 weight copies are
    made after loading."""
    env = ONE if env is None else env
    flat = {path: tensor_leaf(a) for path, a in flatten(tree).items()}
    flat = (from_slots(flat, cfg, env) if env.mesh is None
            else rank_shards(flat, cfg, env, slots=True))
    model = Model(cfg, device=device, env=env)
    values = unstack_leaves(model, flat)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(values[name])
    model.cast_weights()
    return model


def opt_state_from_jax(state: Mapping, model: Model):
    """The reference's ``OptState`` (``count``, and fp32 moments ``m``/``v``
    shaped like the parameters, as numpy) → the port's ``optim.OptState``;
    under a process mesh's env (the model's), each moment's shard of this
    process's device, from the reference's storage (kv heads and experts in
    their slots: ``rank_shards``). 8-bit moments do not carry over: the
    reference keeps a row of (codes, scales) for every device, the port one
    for each distinct device shard (a process its own)."""
    from repro_torch.optim.adamw import OptState

    if isinstance(state["m"], (tuple, list)) or any(
            isinstance(v, (tuple, list)) for v in flatten(state["m"]).values()):
        raise ValueError("8-bit moments do not carry over: the reference keeps a row for "
                         "every device, the port one for each distinct device shard")

    def moments(tree):
        if model.env.mesh is None:
            return from_jax(model, tree)
        shards = rank_shards(tree, model.cfg, model.env, slots=True)
        return {k: t.contiguous().to(model.device)
                for k, t in unstack_leaves(model, shards).items()}

    return OptState(count=int(np.asarray(state["count"])), m=moments(state["m"]),
                    v=moments(state["v"]))


def cache_to_jax(cache: Mapping, mesh_dims: int = 0, *, env: ShardEnv | None = None) -> dict:
    """The port's cache → the JAX cache pytree (the same tree), as float32
    numpy (bf16 values are exact in it), each leaf behind ``mesh_dims``
    leading dims of 1 (the device-major layout of a (1, 1) mesh has two; a
    process's block of its mesh). With ``env``: the device-major layout of
    the reference's serving steps on that mesh, (pod,) data, model, then
    each device's leaf (``cache_block``)."""
    def leaf(t: torch.Tensor, name: str, rows_dim: int) -> np.ndarray:
        if env is None:
            a = t.detach().to(torch.float32).cpu().numpy()
            return a.reshape((1,) * mesh_dims + a.shape)
        fsdp = (env.pod_size, env.data_size) if env.pod_axis else (env.data_size,)
        blocks = [_block_leaf(t, name, rows_dim, env, f, m).detach().to(torch.float32).cpu()
                  for f in range(env.fsdp_size) for m in range(env.model_size)]
        return torch.stack(blocks).reshape(fsdp + (env.model_size,) + blocks[0].shape).numpy()

    return _walk(cache, leaf)


def cache_block(cache: Mapping, env: ShardEnv, fsdp_index: int, model_index: int) -> dict:
    """A world-dim cache held once (``env``'s, without a process mesh) →
    the block of device (``fsdp_index`` in the (pod, data) world,
    ``model_index`` on the model axis), which a process of the process
    mesh holds: its rows (of the rows held once, ``ShardEnv.row_groups``),
    its kv slots (``dup_map``), its tp slice of the SSM's heads and x
    channels and of the RG-LRU's channels; MLA's latent cache is every
    rank's alike. Views where no slots are made."""
    return _walk(cache, lambda t, name, rows_dim: _block_leaf(t, name, rows_dim, env,
                                                              fsdp_index, model_index))


def _walk(cache: Mapping, leaf) -> dict:
    def walk(tree: Mapping, rows_dim: int) -> dict:
        return {k: walk(v, rows_dim) if isinstance(v, Mapping) else leaf(v, k, rows_dim)
                for k, v in tree.items()}

    # superblock leaves lead with the stacked superblocks, tail leaves with the rows
    return {k: walk(v, int(k == "blocks")) for k, v in cache.items()}


def _block_leaf(t: torch.Tensor, name: str, rows_dim: int, env: ShardEnv, fsdp_index: int,
                model_index: int) -> torch.Tensor:
    rep, b_loc = env.row_groups(t.shape[rows_dim])
    tp_rank, r = divmod(model_index, env.rep)
    x = t.narrow(rows_dim, (fsdp_index * rep + (r if rep > 1 else 0)) * b_loc, b_loc)
    if name in ("k", "v"):  # the rank's kv slots
        kv_loc = max(1, x.shape[-2] // env.tp)
        slots = env.dup_map(x.shape[-2])[model_index * kv_loc:(model_index + 1) * kv_loc]
        return x.index_select(x.dim() - 2, torch.tensor(slots, device=x.device))
    if name in ("conv_x", "conv", "h"):  # the rank's channels (SSM's x, the RG-LRU's)
        c = x.shape[-1] // env.tp
        return x.narrow(-1, tp_rank * c, c)
    if name == "ssm":  # the rank's heads
        h = x.shape[-3] // env.tp
        return x.narrow(x.dim() - 3, tp_rank * h, h)
    return x
