"""repro_torch.shuffle — the mapper→reducer KeyBy fan-out as a compiled
subsystem.

* ``lower``  — the ``lower-shuffle`` pass: KEYBY-fed reduces become
  per-bucket ``ShuffleBucket`` edges + per-bucket reducers whose
  bucket→switch assignment the §3 CostModel picks under per-switch
  memory budgets. Part of ``compiler.DEFAULT_PASSES``.
* ``stats``  — ``plan_shuffle(plan)``: per-bucket wire bytes and switch
  residency of a compiled plan; ``arbitrate_buckets`` picks the cheapest
  bucket count the same way ``compile_best`` picks chain-vs-tree.
* ``spmd``   — the world-dim mesh form: the ``hash_partition`` mapper and
  a capacity-sized ``all_to_all`` (``shuffle_reduce`` /
  ``token_shuffle``), shared by word count and the scenarios.
"""
from repro_torch.shuffle import spmd
from repro_torch.shuffle.lower import lower_shuffle_pass, resample_weights, split_widths
from repro_torch.shuffle.spmd import partition_tokens, shuffle_reduce, token_shuffle
from repro_torch.shuffle.stats import (
    ShuffleStats,
    arbitrate_buckets,
    measured_bucket_packets,
    plan_shuffle,
    with_num_buckets,
    with_weights,
)

__all__ = [
    "ShuffleStats",
    "arbitrate_buckets",
    "lower_shuffle_pass",
    "measured_bucket_packets",
    "partition_tokens",
    "plan_shuffle",
    "resample_weights",
    "shuffle_reduce",
    "split_widths",
    "spmd",
    "token_shuffle",
    "with_num_buckets",
    "with_weights",
]
