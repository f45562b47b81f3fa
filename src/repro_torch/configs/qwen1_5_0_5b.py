"""qwen1.5-0.5b — QKV bias. [hf:Qwen/Qwen1.5-0.5B]
24L d=1024 16H (kv=16) d_ff=2816 vocab=151936."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="qwen1.5-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=64,
    )
