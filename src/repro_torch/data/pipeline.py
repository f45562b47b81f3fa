"""Deterministic word lists for the paper's Word-Count experiments (§2/§4).

The word-count half of ``repro/data/pipeline.py``, numpy only: the same
seed gives the same shards, bit for bit, in both packages. Every shard is a
pure function of the seed.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=step))


def zipf_tokens(rng, vocab: int, size, alpha: float = 1.3) -> np.ndarray:
    """Zipf-distributed token ids in [0, vocab) (bounded rejection-free)."""
    # inverse-CDF over a truncated zipf
    ranks = rng.random(size=size)
    toks = np.floor(np.exp(ranks * np.log(vocab)) - 1).astype(np.int64)
    return np.clip(toks, 0, vocab - 1).astype(np.int32)


def wordcount_shards(total_items: int, n_shards: int, vocab: int, seed: int = 0,
                     alpha: float = 1.3) -> list[np.ndarray]:
    """The paper's word lists: Zipf words split evenly over n servers."""
    rng = _rng(seed, 0)
    per = total_items // n_shards
    return [zipf_tokens(rng, vocab, per) for _ in range(n_shards)]
