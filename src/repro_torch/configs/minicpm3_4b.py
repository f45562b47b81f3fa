"""minicpm3-4b — MLA (multi-head latent attention). [hf:openbmb/MiniCPM3-4B]
62L d=2560 40H d_ff=6400 vocab=73448; q_lora=768 kv_lora=256
qk_nope=64 qk_rope=32 v=64."""
import dataclasses

from repro_torch.models.common import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    tp=8, tie_embeddings=True,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="minicpm3-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=64, tp=0,
        mla=MLAConfig(q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                      qk_rope_head_dim=4, v_head_dim=8),
    )
