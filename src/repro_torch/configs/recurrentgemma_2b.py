"""recurrentgemma-2b — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427] 26L d=2560 10H (MQA kv=1) d_ff=7680 window=2048
vocab=256000. 26 = 8×(rec,rec,attn_local) + (rec,rec). tp=2 (10H).
Simplification (DESIGN.md): diagonal RG-LRU input/recurrence gates
(Griffin uses block-diagonal)."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, window=2048, act="gelu",
    pattern=("rec", "rec", "attn_local"), pattern_tail=("rec", "rec"),
    tp=2, tie_embeddings=True, subquadratic=True,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="rg-smoke", n_layers=8, d_model=32, n_heads=4,
        n_kv_heads=1, head_dim=8, d_ff=64, vocab=64, window=16, tp=0,
        pattern=("rec", "rec", "attn_local"), pattern_tail=("rec", "rec"),
    )
