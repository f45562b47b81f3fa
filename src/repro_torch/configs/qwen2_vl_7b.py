"""qwen2-vl-7b — M-RoPE, dynamic resolution VLM backbone. [arXiv:2409.12191]
28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. Vision frontend is a
STUB: input_specs feeds precomputed patch embeddings + (t,h,w) position
grids; the backbone (this config) is exercised end-to-end."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, head_dim=128, rope_theta=1e6,
    mrope_sections=(16, 24, 24), embed_input=True, tie_embeddings=False,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="qwen2vl-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, head_dim=8, d_ff=64, vocab=64, mrope_sections=(2, 1, 1),
    )
