"""granite-8b — llama-arch code model. [arXiv:2405.04324]
36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152, head_dim=128, rope_theta=1e7, tie_embeddings=False,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="granite8b-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, head_dim=8, d_ff=64, vocab=64,
    )
