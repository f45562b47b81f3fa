"""Word-Count on the world-dim mesh (§2, Fig 1) — the paper's running example.

The port of the mesh half of ``repro/core/wordcount.py``.
Map: each device ("mapper") histograms its local word list.
Shuffle: counts travel to their reducers in one ``all_to_all`` over the axis
(``shuffle.spmd.shuffle_reduce``).
Reduce: each device ("reducer") sums the partial counts it received, as part
of the shuffle's arrival processing, i.e. in transit.

Word ids are dense ints in [0, vocab); bucket(word) = word // (vocab/p).
``kernel_histogram`` runs the ``segment_reduce`` kernel as the mapper
histogram; ``local_histogram`` is the plain scatter-add the reference uses
by default and for its S1 baseline. ``wordcount_token_shuffle`` is the
other data plane: raw words travel to the reducer of their hash bucket and
are counted there.
"""
from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.mesh import Mesh

# fp32 atomics count exactly while every count stays at or below 2**24
MAX_EXACT_COUNT = 2**24


def local_histogram(words: torch.Tensor, vocab: int) -> torch.Tensor:
    """Map: count words in each device's shard. (..., n) int32 → (..., vocab)
    int32. -1 entries are padding and are not counted."""
    valid = (words >= 0).to(torch.int32)
    hist = torch.zeros(words.shape[:-1] + (vocab,), dtype=torch.int32, device=words.device)
    return hist.scatter_add_(-1, words.clamp(0, vocab - 1).to(torch.int64), valid)


def kernel_histogram(words: torch.Tensor, vocab: int) -> torch.Tensor:
    """``local_histogram`` through the ``segment_reduce`` kernel: a count of
    ones (a broadcast, never materialized) per word, one launch for every
    device. Words must lie in [-1, vocab); exact while each shard holds at
    most 2**24 words."""
    n = words.shape[-1]
    if n > MAX_EXACT_COUNT:
        raise ValueError(f"{n} words per shard: fp32 counts are exact only up to {MAX_EXACT_COUNT}")
    ones = torch.ones((1, 1), dtype=torch.float32, device=words.device)
    counts = ops.segment_reduce(ones.expand(words.shape + (1,)), words, vocab)
    return counts[..., 0].to(torch.int32)


def wordcount_step(
    words: torch.Tensor,
    vocab: int,
    mesh: Mesh,
    axis_name: str = "all",
    *,
    histogram_fn: Callable[[torch.Tensor, int], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Deprecated SPMD word-count: every reducer's (vocab/p,) counts.

    Device k ends up owning the final counts of words
    [k·vocab/p, (k+1)·vocab/p): data is reduced while being shuffled (the
    S2/S3 path of the paper). Requires vocab % p == 0 (pad upstream).

    Deprecated as an entry point, as in the reference: call
    ``shuffle.spmd.shuffle_reduce`` on the local histogram directly.
    """
    from repro_torch.shuffle.spmd import shuffle_reduce

    warnings.warn(
        "repro_torch.core.wordcount.wordcount_step is deprecated; call "
        "repro_torch.shuffle.spmd.shuffle_reduce on the local histogram",
        DeprecationWarning,
        stacklevel=2,
    )
    hist = (histogram_fn or local_histogram)(words, vocab)  # map
    return shuffle_reduce(hist, mesh, axis_name)  # keyby + reduce in transit


def wordcount_token_shuffle(
    words: torch.Tensor, vocab: int, mesh: Mesh, axis_name: str = "all"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Word count by shuffling raw words: the mapper hashes every word to
    the reducer that owns its bucket (``hash_partition``), one
    capacity-sized ``all_to_all`` carries the words there
    (``shuffle.spmd.token_shuffle``), and each reducer counts what it
    received with ``segment_reduce``.

    The capacity is the largest bucket of any mapper, so no word is dropped.
    Returns (each reducer's (vocab,) int32 counts, nonzero only for the
    words it owns; the received words, -1 padded). Counting in fp32 is exact
    below 2**24 a word; a count that reaches it raises.
    """
    from repro_torch.shuffle.spmd import token_shuffle

    _, hist = ops.hash_partition(words, mesh.axis_size(axis_name))
    recv, _ = token_shuffle(words, mesh, axis_name, capacity=max(1, int(hist.max())))
    ones = torch.ones((1, 1), dtype=torch.float32, device=words.device)
    counts = ops.segment_reduce(ones.expand(recv.shape + (1,)), recv, vocab)[..., 0]
    if float(counts.max()) >= MAX_EXACT_COUNT:
        raise ValueError(f"a word count reaches {MAX_EXACT_COUNT}: fp32 counts are no longer exact")
    return counts.to(torch.int32), recv


def wordcount_host_baseline(
    words: torch.Tensor, vocab: int, mesh: Mesh, axis_name: str = "all"
) -> torch.Tensor:
    """Scenario-1 baseline: ship ALL raw histograms to every endpoint
    (all_gather) and reduce locally — endpoint compute, p× the wire bytes."""
    hist = local_histogram(words, vocab)
    gathered = mesh.all_gather(hist, axis_name)  # (p, vocab) per device
    full = gathered.sum(dim=mesh.ndim, dtype=torch.int32)
    p = mesh.axis_size(axis_name)
    k = mesh.axis_index(axis_name)
    return mesh.dynamic_slice_in_dim(full, k * (vocab // p), vocab // p)


def wordcount_reference(word_shards: list[np.ndarray], vocab: int) -> np.ndarray:
    """Oracle: plain counting over all shards. (vocab,)"""
    out = np.zeros((vocab,), np.int64)
    for ws in word_shards:
        ws = np.asarray(ws)
        ws = ws[ws >= 0]
        np.add.at(out, ws, 1)
    return out
