"""seamless-m4t-large-v2 — enc-dec, multimodal (speech→text backbone).
[arXiv:2308.11596] 24L enc + 24L dec, d=1024 16H (kv=16) d_ff=8192
vocab=256206. Speech frontend is a STUB: input_specs feeds precomputed
frame embeddings to the encoder; the text decoder trains/decodes normally.
Simplification (DESIGN.md): RMSNorm in place of LayerNorm; rotary in place
of learned positions."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, embed_input=True, tie_embeddings=True,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="seamless-smoke", n_layers=2, enc_layers=2, d_model=32,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab=64,
    )
