"""The single-device part of ``repro/models/parallel.py``.

On one card tp = 1 and fsdp = 1: a column- or row-parallel product is one
bf16 matmul, the vocab is padded to a multiple of 1, and the sharded
embedding, logits and argmax see the whole vocab. The sharded and
compute-at-data variants wait until the port runs across cards.
"""
from __future__ import annotations

import torch

COMPUTE_DTYPE = torch.bfloat16


def col_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) in bf16, bf16 out."""
    return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))


# x (..., f) @ w (f, d) in bf16: the psum over a tp group of one is the identity
row_parallel = col_parallel


def pad_vocab(vocab: int, model_size: int = 1) -> int:
    return ((vocab + model_size - 1) // model_size) * model_size


def embed_lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ids (...) int → (..., d) bf16 rows of ``table`` (V_pad, d); ids
    outside ``[0, V_pad)`` give zero rows, as the sharded lookup does."""
    per = table.shape[0]
    ok = (ids >= 0) & (ids < per)
    emb = table[ids.clamp(0, per - 1).long()]
    return torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                       device=emb.device)).to(COMPUTE_DTYPE)


def logits(x: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """x (..., d) → fp32 logits (..., V_pad) from a bf16 product with the
    tied table, vocab padding columns set to -inf."""
    out = torch.matmul(x.to(COMPUTE_DTYPE), table.to(COMPUTE_DTYPE).t()).to(torch.float32)
    if out.shape[-1] > vocab:
        out[..., vocab:] = float("-inf")
    return out


def argmax_logits(x: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy next token (..., ) int32 over the vocab; ties go to the
    smallest index (``torch.argmax`` returns the first maximum)."""
    return torch.argmax(logits(x, table, vocab), dim=-1).to(torch.int32)
