"""Each parameter's storage facts of ``LeafSpec``: its FSDP dim, its TP dim,
and the slot layout of kv heads and experts with duplicate copies.

The reference stores every leaf with an FSDP dim sharded over (pod, data)
(``models/common.py`` ``LeafSpec.fsdp_dim``, set by ``param_specs`` and the
block kinds' ``*_specs``), and the backward of its weight fetch aggregates
the gradient along that dim (``models/parallel.py`` ``_sag_bwd``). Leaves
without one (``None``: biases, norms of the latent and SSM paths, the
recurrences' vectors, convolutions) are summed over the world
(``optim/distributed.py`` ``sync_gradients``). Dims here count within one
layer's parameter: the reference's stacked-layer dim is dropped.

The TP dim is sharded over the whole model axis in storage; each tp rank
computes with its slice of it (``parallel.fetch_weight``). The kv heads of
GQA and the experts are stored in slots, ``model_size · per_rank`` of them,
``per_rank = max(1, n // tp)``: ``ShardEnv.dup_map`` names the logical head
or expert of each slot, duplicated over the rep replicas and, when tp > n,
over the span of tp ranks that read one head (``attention.py:77-89``
``finalize_kv_specs``, ``moe.py:32-43`` ``moe_specs``). The port holds the
logical leaves; ``convert`` lays them out in slots and back.
"""
from __future__ import annotations

from repro_torch.models.convert import leaf_paths
from repro_torch.models.model import Model
from repro_torch.models.parallel import LeafPlace

_GQA = {"wq": 0, "wk": 0, "wv": 0, "wo": 1, "bq": None, "bk": None, "bv": None}
_MLA = {"wq_a": 0, "q_norm": None, "wq_b": 0, "wkv_a": 0, "kv_norm": None, "wkv_b": 0, "wo": 1}
# JAX leaf path (within a layer, or at the top of the tree) → FSDP dim
FSDP_DIM: dict[str, int | None] = {
    "embed": 1, "head": 1, "final_norm": 0, "enc_norm": 0,
    "ln1": 0, "ln2": 0, "lnx": 0,
    **{f"attn/{k}": v for k, v in {**_GQA, **_MLA}.items()},
    **{f"cross/{k}": v for k, v in _GQA.items()},
    "mlp/wi_gate": 0, "mlp/wi_up": 0, "mlp/wo": 1,
    "moe/router": 0, "moe/wi_gate": 1, "moe/wi_up": 1, "moe/wo": 2,
    **{f"ssm/{k}": 0 for k in ("w_z", "w_x", "w_bc", "w_dt")}, "ssm/w_out": 1,
    **{f"ssm/{k}": None for k in ("conv_x", "conv_bc", "A_log", "dt_bias", "D", "out_norm")},
    "rec/w_gate": 0, "rec/w_in": 0, "rec/w_out": 1,
    **{f"rec/{k}": None for k in ("conv", "lam", "gate_a_w", "gate_a_b", "gate_i_w",
                                   "gate_i_b")},
}


_GQA_TP = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0}
_MLA_TP = {"wq_a": None, "q_norm": None, "wq_b": 1, "wkv_a": None, "kv_norm": None, "wkv_b": 1,
           "wo": 0}
# JAX leaf path (as FSDP_DIM's keys) → TP dim
TP_DIM: dict[str, int | None] = {
    "embed": 0, "head": 0, "final_norm": None, "enc_norm": None,
    "ln1": None, "ln2": None, "lnx": None,
    **{f"attn/{k}": v for k, v in {**_GQA_TP, **_MLA_TP}.items()},
    **{f"cross/{k}": v for k, v in _GQA_TP.items()},
    "mlp/wi_gate": 1, "mlp/wi_up": 1, "mlp/wo": 0,
    "moe/router": None, "moe/wi_gate": 0, "moe/wi_up": 0, "moe/wo": 0,
    "ssm/w_z": 1, "ssm/w_x": 1, "ssm/w_bc": None, "ssm/w_dt": 1, "ssm/w_out": 0,
    "ssm/conv_x": 0, "ssm/conv_bc": None, "ssm/A_log": 0, "ssm/dt_bias": 0, "ssm/D": 0,
    "ssm/out_norm": 0,
    "rec/w_gate": 1, "rec/w_in": 1, "rec/w_out": 0, "rec/conv": 0,
    **{f"rec/{k}": 0 for k in ("lam", "gate_a_w", "gate_a_b", "gate_i_w", "gate_i_b")},
}
_KV_SLOTS = ("wk", "wv", "bk", "bv")


def dup_of(key: str, cfg) -> int:
    """``LeafSpec.dup_of`` of a leaf (a key of ``TP_DIM``): the logical kv
    heads or experts that its TP dim holds in slots, 0 for a plain leaf.
    MLA has no kv heads to duplicate."""
    group, _, leaf = key.rpartition("/")
    if group in ("attn", "cross") and leaf in _KV_SLOTS and cfg.mla is None:
        return cfg.n_kv_heads
    if group == "moe" and leaf != "router":
        return cfg.moe.n_experts
    return 0


def layer_leaf(path: str) -> str:
    """A JAX leaf path → its key in ``FSDP_DIM``: the path within its layer
    (``blocks/0_attn_mlp/attn/wq`` → ``attn/wq``, ``enc_blocks/ln1`` →
    ``ln1``), or the top-level name."""
    parts = path.split("/")
    if parts[0] in ("blocks", "tail"):
        return "/".join(parts[2:])
    if parts[0] == "enc_blocks":
        return "/".join(parts[1:])
    return path


def place(key: str, cfg) -> LeafPlace:
    """The ``LeafPlace`` of a leaf key (``FSDP_DIM``'s keys) under ``cfg``."""
    return LeafPlace(FSDP_DIM[key], TP_DIM[key], dup_of(key, cfg))


def leaf_places(model: Model) -> dict[str, LeafPlace]:
    """{port parameter name: its ``LeafPlace``}, in parameter order."""
    out = {}
    for name, (path, _) in leaf_paths(model).items():
        out[name] = place(layer_leaf(path), model.cfg)
    return out
