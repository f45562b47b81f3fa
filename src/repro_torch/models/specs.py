"""Each parameter's FSDP dim: the one fact of ``LeafSpec`` that a data world
on one card needs.

The reference stores every leaf with an FSDP dim sharded over (pod, data)
(``models/common.py`` ``LeafSpec.fsdp_dim``, set by ``param_specs`` and the
block kinds' ``*_specs``), and the backward of its weight fetch aggregates
the gradient along that dim (``models/parallel.py`` ``_sag_bwd``). Leaves
without one (``None``: biases, norms of the latent and SSM paths, the
recurrences' vectors, convolutions) are summed over the world
(``optim/distributed.py`` ``sync_gradients``). Dims here count within one
layer's parameter: the reference's stacked-layer dim is dropped. The TP
dims and ``dup_of`` copies wait until the port runs across cards.
"""
from __future__ import annotations

from repro_torch.models.convert import leaf_paths
from repro_torch.models.model import Model

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


def fsdp_dims(model: Model) -> dict[str, int | None]:
    """{port parameter name: its FSDP dim, or None}, in parameter order."""
    return {name: FSDP_DIM[layer_leaf(path)] for name, (path, _) in leaf_paths(model).items()}
