"""Model configuration and the parameter init law, shared by the model zoo.

The counterpart of ``repro/models/common.py``. Parameters are
``nn.Parameter``s of the modules in ``layers``, ``attention`` and ``model``,
laid out as the JAX leaves of a (1, 1) mesh are, held whole on the card
(``convert`` maps one onto the other). Each leaf's storage facts (FSDP dim,
TP dim, the slot layout of duplicated kv heads and experts) are in
``specs``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dispatch: str = "a2a"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 8
    conv_width: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE
    window: int | None = None  # local-attention window
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    pattern: tuple[str, ...] | None = None  # hybrid superblock, e.g. ("rec","rec","attn")
    pattern_tail: tuple[str, ...] = ()  # layers after the scanned superblocks
    enc_layers: int = 0  # >0 → encoder-decoder
    embed_input: bool = False  # modality frontend stub feeds embeddings
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    act: str = "silu"
    tp: int = 0  # preferred TP degree; 0 → auto (max valid divisor)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    opt_state_8bit: bool = False
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def resolve_tp(self, model_size: int) -> int:
        """Largest valid tp ≤ model_size (heads/kv/width divisibility)."""
        if self.tp:
            return min(self.tp, model_size)
        for tp in (16, 8, 4, 2, 1):
            if tp > model_size or model_size % tp:
                continue
            if self.family == "ssm":
                if ((self.d_model * self.ssm.expand) // self.ssm.head_dim) % tp == 0:
                    return tp
                continue
            if self.n_heads % tp:
                continue
            kv = self.n_kv_heads
            if self.mla is not None or kv == 0 or kv % tp == 0 or tp % kv == 0:
                return tp
        return 1

    def param_count(self) -> int:
        """Total logical parameters (approx; excludes dup copies)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family != "ssm":
            if self.mla is not None:
                m = self.mla
                per_layer += d * m.q_lora_rank + m.q_lora_rank * H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                per_layer += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                per_layer += H * m.v_head_dim * d
            else:
                per_layer += d * hd * (H + 2 * KV) + H * hd * d
        if self.moe is not None:
            per_layer += d * self.moe.n_experts  # router
            per_layer += self.moe.n_experts * 3 * d * self.moe.d_expert
        elif ff:
            per_layer += 3 * d * ff  # gated mlp
        if self.family == "ssm":
            s = self.ssm
            d_in = d * s.expand
            heads = d_in // s.head_dim
            per_layer += d * (2 * d_in + 2 * s.n_groups * s.d_state + heads)  # in_proj
            per_layer += d_in * s.conv_width + d_in * d + 2 * heads
        layers = L + self.enc_layers
        return emb + layers * per_layer

    def active_param_count(self) -> int:
        """Active per-token parameters (MoE: top_k of n_experts), as the
        roofline's model FLOPs count them."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        expert = self.n_layers * self.moe.n_experts * 3 * self.d_model * self.moe.d_expert
        active = expert * self.moe.top_k // self.moe.n_experts
        return total - expert + active


def init_tensor(shape, law: str, generator: torch.Generator, device,
                scale: float = 0.02) -> torch.Tensor:
    """One fp32 parameter by ``init_leaf``'s law (``repro/models/common.py``):
    ``normal`` × ``scale``, ``ones`` (norms) or ``zeros`` (biases). The numbers
    come from ``generator``, not from ``jax.random``: to compare with the JAX
    model, load its parameters (``convert.params_from_jax``)."""
    if law == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if law == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if law != "normal":
        raise ValueError(f"unknown init law {law!r}")
    # scaled in place: one tensor of the leaf's size (the same numbers as ``* scale``)
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device).mul_(scale)
