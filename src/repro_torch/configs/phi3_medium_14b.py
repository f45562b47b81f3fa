"""phi3-medium-14b — RoPE SwiGLU GQA. [arXiv:2404.14219]
40L d=5120 40H (GQA kv=10) d_ff=17920 vocab=100352. tp=2 (40H,10kv)."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab=100352, head_dim=128, tp=2, tie_embeddings=False,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="phi3-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, head_dim=8, d_ff=64, vocab=64, tp=0,
    )
