"""grok-1-314b — 8 experts top-2 MoE. [hf:xai-org/grok-1]
64L d=6144 48H (GQA kv=8) expert d_ff=32768 vocab=131072."""
import dataclasses

from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768),
    tie_embeddings=False, opt_state_8bit=True,
    # the JAX package stores this model in bf16 (with int8 Adam moments) to
    # fit a 256-chip pod; the port keeps fp32 masters and bf16 copies, which
    # no single card holds (ROADMAP.md)
    param_dtype="bfloat16",
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="grok-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, head_dim=8, d_ff=64, vocab=64, opt_state_8bit=False,
        moe=MoEConfig(n_experts=2, top_k=2, d_expert=64, capacity_factor=4.0),
    )
