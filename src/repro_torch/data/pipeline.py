"""Deterministic synthetic data: the LM's training batches and the word
lists of the paper's Word-Count experiments (§2/§4).

The port of ``repro/data/pipeline.py``, numpy only: the same seed gives the
same batches and shards, bit for bit, in both packages. Every batch is a
pure function of (seed, step), so a restart at step k sees batch k.
Training batches take the reference's device-major layout of a
``ShardEnv`` (``launch.shapes.batch_layout``), bit for bit; under a process
mesh's env a process cuts its block out of it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.common import ModelConfig
from repro_torch.models.parallel import ShardEnv


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=step))


def zipf_tokens(rng, vocab: int, size, alpha: float = 1.3) -> np.ndarray:
    """Zipf-distributed token ids in [0, vocab) (bounded rejection-free)."""
    # inverse-CDF over a truncated zipf
    ranks = rng.random(size=size)
    toks = np.floor(np.exp(ranks * np.log(vocab)) - 1).astype(np.int64)
    return np.clip(toks, 0, vocab - 1).astype(np.int32)


def markov_tokens(rng, vocab: int, batch: int, seq: int) -> np.ndarray:
    """Tokens with first-order structure: next = (prev*a + noise) % vocab.
    A model that learns the transition drops below ln(vocab) quickly."""
    a = 31
    x = np.empty((batch, seq), np.int32)
    x[:, 0] = rng.integers(0, vocab, size=batch)
    noise = rng.integers(0, max(2, vocab // 64), size=(batch, seq))
    for t in range(1, seq):
        x[:, t] = (x[:, t - 1] * a + noise[:, t]) % vocab
    return x


@dataclasses.dataclass
class TrainPipeline:
    """Yields batches matching ``launch.shapes.train_input_specs`` of
    ``env`` (numpy; the train step's ``step.env``): Markov tokens and next-token labels; seeded
    embeddings (and an M-RoPE position grid) for an embedding-input model;
    for enc-dec, half the sequence as encoder frames and half as decoder
    tokens."""

    cfg: ModelConfig
    env: ShardEnv
    global_batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """The batch of ``step``: the world's device-major batch, or under a
        process mesh's env the process's block of it (the same global rows
        at any data world, so a restart keeps the stream)."""
        from repro_torch.launch.shapes import batch_layout

        env = self.env
        if env.mesh is not None:
            world = dataclasses.replace(self, env=env.world()).batch_at(step)
            dims, _ = batch_layout(env.world(), self.global_batch)
            m = env.mesh
            at = tuple(m.coords[m.dim(a)] for a in m.axis_names if a != env.model_axis)
            at += (env.model_index if dims[-1] > 1 else 0,)
            return {k: np.ascontiguousarray(v[at]).reshape(m.block + v.shape[len(dims):])
                    for k, v in world.items()}
        rng = _rng(self.seed, step)
        dims, b_loc = batch_layout(self.env, self.global_batch)
        cfg = self.cfg
        n = int(np.prod(dims)) * b_loc
        if cfg.enc_layers:
            s = self.seq // 2
            toks = markov_tokens(rng, cfg.vocab, n, s + 1).reshape(dims + (b_loc, s + 1))
            return {
                "tokens": toks[..., :-1],
                "labels": toks[..., 1:].copy(),
                "enc_embeds": rng.standard_normal(dims + (b_loc, s, cfg.d_model),
                                                  np.float32).astype(np.float32),
                "enc_positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                                 dims + (b_loc, s)).copy(),
            }
        toks = markov_tokens(rng, cfg.vocab, n, self.seq + 1).reshape(dims + (b_loc, self.seq + 1))
        batch = {"labels": toks[..., 1:].copy()}
        if cfg.embed_input:
            batch["embeds"] = rng.standard_normal(
                dims + (b_loc, self.seq, cfg.d_model)).astype(np.float32)
            if cfg.mrope_sections is not None:
                pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32)[:, None], (self.seq, 3))
                batch["positions"] = np.broadcast_to(pos, dims + (b_loc, self.seq, 3)).copy()
        else:
            batch["tokens"] = toks[..., :-1]
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over any batch iterator.
    The thread starts when the object is made and stops after the iterator
    ends; it is a daemon, so an endless iterator does not keep the process
    alive."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def wordcount_shards(total_items: int, n_shards: int, vocab: int, seed: int = 0,
                     alpha: float = 1.3) -> list[np.ndarray]:
    """The paper's word lists: Zipf words split evenly over n servers."""
    rng = _rng(seed, 0)
    per = total_items // n_shards
    return [zipf_tokens(rng, vocab, per) for _ in range(n_shards)]
