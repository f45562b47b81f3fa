"""Model assembly: the dense decoder LM and its prefill and decode steps.

The counterpart of ``repro/models/model.py`` on one card. ``Model`` owns the
parameters (fp32, with bf16 copies of the matmul weights: ``layers.
CastOnce``); the JAX model's ``lax.scan`` over stacked layers is a Python
loop over ``Model.blocks``. Only the ``attn_mlp`` block kind is ported:
every other kind raises and names the ``ROADMAP.md`` item that holds it.

The KV cache is a dict of two stacked tensors, ``{"k", "v"}`` of shape
(n_layers, b, S_max, KV, hd) in the compute dtype, updated in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.mesh import resolve_device
from repro_torch.models.attention import GQAAttention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import MLP, CastOnce, RMSNorm, rope_angles
from repro_torch.models.parallel import argmax_logits, embed_lookup, logits, pad_vocab

_NOT_PORTED = "is not ported yet: ROADMAP.md queue 1 item 8 lists it"


def block_pattern(cfg: ModelConfig) -> tuple[tuple[str, ...], tuple[str, ...], int]:
    """(superblock pattern, tail pattern, n_superblocks)."""
    if cfg.pattern:
        unit = cfg.pattern
        n_sb = cfg.n_layers // len(unit)
        tail = cfg.pattern_tail
        if n_sb * len(unit) + len(tail) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: pattern does not tile {cfg.n_layers} layers")
        return unit, tail, n_sb
    if cfg.family == "ssm":
        return ("ssm",), (), cfg.n_layers
    if cfg.family == "moe":
        return ("attn_moe",), (), cfg.n_layers
    if cfg.family == "encdec":
        return ("dec",), (), cfg.n_layers
    return ("attn_mlp",), (), cfg.n_layers


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config that needs what the port
    does not have yet."""
    unit, tail, _ = block_pattern(cfg)
    for kind in unit + tail:
        if kind != "attn_mlp":
            raise NotImplementedError(f"block kind {kind!r} {_NOT_PORTED}")
    for what, present in (("MLA attention", cfg.mla is not None),
                          ("the encoder stack", cfg.enc_layers > 0),
                          ("embedding input", cfg.embed_input),
                          ("M-RoPE", cfg.mrope_sections is not None),
                          ("local attention", cfg.window is not None)):
        if present:
            raise NotImplementedError(f"{what} {_NOT_PORTED}")


class Block(nn.Module):
    """One ``attn_mlp`` block: pre-norm attention, then pre-norm MLP."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, generator, device)
        self.attn = GQAAttention(cfg, generator, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, generator, device)
        self.mlp = MLP(cfg, generator, device)


def block_apply(kind: str, block: Block, x: torch.Tensor, ctx: dict):
    """Apply one block. ctx: rope, cache, cache_len, prefill_cache, impl.
    Returns (x, new_cache)."""
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} {_NOT_PORTED}")
    y, c = block.attn(block.ln1(x), rope=ctx["rope"], cache=ctx.get("cache"),
                      cache_len=ctx.get("cache_len"), prefill_cache=ctx.get("prefill_cache"),
                      causal=True, window=None, impl=ctx["impl"])
    x = x + y
    x = x + block.mlp(block.ln2(x))
    return x, c


def rope_for(cfg: ModelConfig, positions: torch.Tensor, rope_dim: int):
    """positions (b, s) → (cos, sin) (b, s, dim/2)."""
    if positions.dim() == 3:
        if cfg.mrope_sections is not None:
            raise NotImplementedError(f"M-RoPE {_NOT_PORTED}")
        positions = positions[..., 0]
    return rope_angles(positions, rope_dim, cfg.rope_theta)


class Model(CastOnce):
    """The dense decoder LM: embedding, ``n_layers`` blocks, final norm and a
    head tied to the embedding (or its own). Parameters are made on
    ``device`` (``None``: the card) by the init law of the JAX model
    (``common.init_tensor``) from a ``torch.Generator`` seeded with
    ``seed``; ``convert.params_from_jax`` loads the JAX model's instead."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device, "Model()")
        gen = torch.Generator(device=device).manual_seed(seed)
        self.cfg = cfg
        self.vocab_padded = pad_vocab(cfg.vocab)
        self.embed = self.param((self.vocab_padded, cfg.d_model), "normal", gen, device)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, gen, device)
        self.compute = ("embed",)
        if not cfg.tie_embeddings:
            self.head = self.param((self.vocab_padded, cfg.d_model), "normal", gen, device)
            self.compute = ("embed", "head")
        self.blocks = nn.ModuleList(Block(cfg, gen, device) for _ in range(cfg.n_layers))
        self.cast_weights()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def cast_weights(self) -> None:
        """Remake every bf16 weight copy from the fp32 parameters."""
        for m in self.modules():
            if isinstance(m, CastOnce):
                CastOnce.cast_weights(m)

    def head_table(self) -> torch.Tensor:
        return self.embed_c if self.cfg.tie_embeddings else self.head_c

    def init_cache(self, batch: int, seq_max: int) -> dict:
        """An empty KV cache for ``batch`` sequences of up to ``seq_max``."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, seq_max, cfg.n_kv_heads, cfg.hd)
        dt = getattr(torch, cfg.compute_dtype)
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    def backbone(self, x: torch.Tensor, ctx: dict, caches: dict | None = None,
                 prefill_cache: dict | None = None) -> torch.Tensor:
        """Run all blocks over x (b, s, d). ``caches`` (decode) is read and
        written at ``ctx["cache_len"]``; ``prefill_cache`` takes the prompt's
        k/v at its first s slots."""
        for i, block in enumerate(self.blocks):
            c = dict(ctx)
            c["cache"] = None if caches is None else {"k": caches["k"][i], "v": caches["v"][i]}
            c["prefill_cache"] = (None if prefill_cache is None else
                                  {"k": prefill_cache["k"][i], "v": prefill_cache["v"][i]})
            x, _ = block_apply("attn_mlp", block, x, c)
        return x

    def prefill_hidden(self, tokens: torch.Tensor, *, impl: str = "masked",
                       cache: dict | None = None) -> tuple[dict, torch.Tensor]:
        """Fill a KV cache from prompts ``tokens`` (b, s). Returns (cache,
        final-normed hidden state at the last prompt position (b, d)).
        ``cache`` may be longer than s (room for decoding); it is filled in
        place, and a cache of length s is made when none is given."""
        b, s = tokens.shape
        if cache is None:
            cache = self.init_cache(b, s)
        x = embed_lookup(tokens, self.embed_c)
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        ctx = {"rope": rope_for(self.cfg, pos, self.cfg.hd), "impl": impl}
        x = self.backbone(x, ctx, prefill_cache=cache)
        return cache, self.final_norm(x[:, -1])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits over the padded vocab, padding at -inf."""
        return logits(h, self.head_table(), self.cfg.vocab)

    def greedy(self, h: torch.Tensor) -> torch.Tensor:
        return argmax_logits(h, self.head_table(), self.cfg.vocab)


def prefill(model: Model, tokens: torch.Tensor, *, impl: str = "masked",
            cache: dict | None = None) -> tuple[dict, torch.Tensor]:
    """Fill caches from prompts (b, s). Returns (cache, next tokens (b,) int32)."""
    cache, h = model.prefill_hidden(tokens, impl=impl, cache=cache)
    return cache, model.greedy(h)


def decode_step(model: Model, cache: dict, tokens: torch.Tensor,
                cache_len: int) -> tuple[torch.Tensor, dict]:
    """One-token decode: tokens (b,) at position ``cache_len``, written into
    the cache in place. Returns (next tokens (b,) int32, cache)."""
    cache_len = int(cache_len)
    x = embed_lookup(tokens[:, None], model.embed_c)  # (b, 1, d)
    b = x.shape[0]
    pos = torch.full((b, 1), cache_len, device=x.device)
    ctx = {"rope": rope_for(model.cfg, pos, model.cfg.hd), "impl": "masked",
           "cache_len": cache_len}
    x = model.backbone(x, ctx, caches=cache)
    return model.greedy(model.final_norm(x))[:, 0], cache
