"""granite-moe-1b-a400m — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d=1024 16H (GQA kv=8)
expert d_ff=512 vocab=49155."""
import dataclasses

from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    tie_embeddings=True,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="granite-moe-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=64,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, capacity_factor=4.0),
    )
