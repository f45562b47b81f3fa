"""Synthetic data for the port (``pipeline``: training batches and
word-count shards)."""
from repro_torch.data import pipeline
from repro_torch.data.pipeline import (Prefetcher, TrainPipeline, markov_tokens,
                                       wordcount_shards, zipf_tokens)

__all__ = ["pipeline", "Prefetcher", "TrainPipeline", "markov_tokens", "wordcount_shards",
           "zipf_tokens"]
