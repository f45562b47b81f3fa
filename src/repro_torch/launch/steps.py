"""Serving steps on one card: prefill and one-token decode.

The serving half of ``repro/launch/steps.py``. There the steps are
``jax.jit``-compiled ``shard_map``s over a mesh with fixed shapes; here they
are plain callables over a ``Model`` that check the shapes they were built
for and run under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M


def batch_shape(batch) -> tuple[int, int]:
    """(b, s) of a prompt batch: tokens (b, s), or a dict of ``tokens`` or
    ``embeds`` (b, s, d) and the other inputs of ``Model.prefill_hidden``."""
    if isinstance(batch, torch.Tensor):
        return tuple(batch.shape)
    return tuple((batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[:2])


def make_prefill_step(model: M.Model, *, global_batch: int, seq: int, impl: str = "masked"):
    """``step(batch, cache=None) → (cache, next tokens (global_batch,)
    int32)``; ``batch`` is prompt tokens (global_batch, seq) or a dict of
    the model's inputs (``Model.prefill_hidden``). A ``cache`` longer than
    ``seq`` (from ``model.init_cache``) is filled in place."""

    @torch.inference_mode()
    def step(batch, cache: dict | None = None):
        if batch_shape(batch) != (global_batch, seq):
            raise ValueError(f"prefill step built for {(global_batch, seq)}, got "
                             f"{batch_shape(batch)}")
        return M.prefill(model, batch, impl=impl, cache=cache)

    return step


def make_serve_step(model: M.Model, *, global_batch: int, seq_max: int):
    """``step(cache, tokens (global_batch,), cache_len) → (next tokens,
    cache)``: one greedy decode step at position ``cache_len`` of a cache
    allocated for ``seq_max`` positions, written in place."""

    @torch.inference_mode()
    def step(cache: dict, tokens: torch.Tensor, cache_len: int):
        if tuple(tokens.shape) != (global_batch,):
            raise ValueError(f"serve step built for batch {global_batch}, got "
                             f"{tuple(tokens.shape)}")
        if not 0 <= int(cache_len) < seq_max:
            raise ValueError(f"cache_len {cache_len} outside the cache of {seq_max}")
        return M.decode_step(model, cache, tokens, cache_len)

    return step
