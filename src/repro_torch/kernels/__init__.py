"""Hopper kernels of the port, with their plain PyTorch versions in ref.py.

segment_reduce   — the p4mr REDUCER (fp32 atomic scatter)
hash_partition   — the p4mr MAPPER (routing-id hash + histogram)
ring_fused_step  — Scenario-3 fused in-transit hop (accumulate + compress)
flash_attention  — the LM stack's prefill attention (online-softmax blocks)
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (
    COPIES,
    LAUNCHES,
    flash_attention,
    hash_partition,
    reset_launches,
    ring_fused_step,
    segment_reduce,
)

__all__ = [
    "ops",
    "ref",
    "COPIES",
    "LAUNCHES",
    "flash_attention",
    "hash_partition",
    "reset_launches",
    "ring_fused_step",
    "segment_reduce",
]
