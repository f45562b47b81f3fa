"""Synthetic data for the port (``pipeline``: word-count shards)."""
from repro_torch.data import pipeline
from repro_torch.data.pipeline import wordcount_shards, zipf_tokens

__all__ = ["pipeline", "wordcount_shards", "zipf_tokens"]
