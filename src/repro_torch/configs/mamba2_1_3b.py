"""mamba2-1.3b — SSD (state-space duality), attention-free.
[arXiv:2405.21060] 48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128."""
import dataclasses

from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=64, n_kv_heads=0, d_ff=0,
    vocab=50280, head_dim=64,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1, conv_width=4, chunk=256),
    tie_embeddings=True, subquadratic=True,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=32, n_heads=4,
        head_dim=16, vocab=64,
        ssm=SSMConfig(d_state=8, expand=2, head_dim=16, n_groups=1, conv_width=4, chunk=8),
    )
