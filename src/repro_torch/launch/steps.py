"""Serving steps on one card: prefill and one-token decode.

The serving half of ``repro/launch/steps.py``. There the steps are
``jax.jit``-compiled ``shard_map``s over a mesh with fixed shapes; here they
are plain callables over a ``Model`` that check the shapes they were built
for and run under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M


def make_prefill_step(model: M.Model, *, global_batch: int, seq: int, impl: str = "masked"):
    """``step(tokens (global_batch, seq) int32, cache=None) → (cache, next
    tokens (global_batch,) int32)``. A ``cache`` longer than ``seq`` (from
    ``model.init_cache``) is filled in place at its first ``seq`` slots."""

    @torch.inference_mode()
    def step(tokens: torch.Tensor, cache: dict | None = None):
        if tuple(tokens.shape) != (global_batch, seq):
            raise ValueError(f"prefill step built for {(global_batch, seq)}, got "
                             f"{tuple(tokens.shape)}")
        return M.prefill(model, tokens, impl=impl, cache=cache)

    return step


def make_serve_step(model: M.Model, *, global_batch: int, seq_max: int):
    """``step(cache, tokens (global_batch,), cache_len) → (next tokens,
    cache)``: one greedy decode step over a ``seq_max`` KV cache, written in
    place at ``cache_len``."""

    @torch.inference_mode()
    def step(cache: dict, tokens: torch.Tensor, cache_len: int):
        if tuple(tokens.shape) != (global_batch,) or cache["k"].shape[2] != seq_max:
            raise ValueError(f"serve step built for batch {global_batch} and cache {seq_max}, "
                             f"got {tuple(tokens.shape)} and {cache['k'].shape[2]}")
        if not 0 <= int(cache_len) < seq_max:
            raise ValueError(f"cache_len {cache_len} outside the cache of {seq_max}")
        return M.decode_step(model, cache, tokens, cache_len)

    return step
