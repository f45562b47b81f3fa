"""Roofline terms of a step on one H100, counted on the ``meta`` device.

The port of ``repro/analysis/roofline.py``. The reference reads XLA's
``cost_analysis`` and the HLO text of compiled probes; the port has no
compiler to ask, so ``cost_vector(fn)`` runs ``fn`` (on ``meta`` tensors:
shapes, no values, no memory) and counts what it does. Every op runs once
(no loop bodies counted once, as XLA's are), so a step at full depth could
be counted directly; the dry run still takes the reference's probes and
linear solve (``solve_train``, ``solve_inference``), which keeps its cost
to a few layers, and checks the solve against a direct count:

    cost(L, mb) = opt_fixed + mb · (micro_fixed + L · per_layer [+ Le · per_enc])

Terms, per card (``lower_cell``'s record sums the whole data world held on
the card):
    compute    = FLOPs / 989 TFLOP/s         (bf16 dense, H100 SXM data sheet)
    memory     = HBM bytes / 3.35 TB/s       (H100 SXM data sheet)
    collective = wire bytes / 450 GB/s        (NVLink 4, each way, H100 SXM
                 data sheet); the pod fraction over INTER_HOST_BW

MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.mesh import COLLECTIVES, count_collectives
from repro_torch.models.parallel import local_batch

PEAK_FLOPS = 989e12  # bf16 dense on the tensor cores, H100 SXM data sheet
HBM_BW = 3.35e12  # bytes/s, H100 SXM data sheet
NVLINK_BW = 450e9  # bytes/s each way, NVLink 4 (900 GB/s both ways), H100 SXM data sheet
# bytes/s between hosts: one 400 Gb/s ConnectX-7 InfiniBand port a GPU, the
# NVIDIA DGX H100 data sheet
INTER_HOST_BW = 50e9
HBM_BYTES = 80e9  # the H100 SXM's memory, data sheet

# ops that move no bytes: views, and allocations that write nothing
_FREE = {torch.ops.aten.detach.default, torch.ops.aten.alias.default,
         torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default,
         torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Σ (operand bytes + result bytes) of every aten op that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in _FREE):
            self.bytes += _nbytes(tree_flatten((args, kwargs))[0]) + _nbytes(tree_flatten(out)[0])
        return out


# cost vector layout: [flops, hbm_bytes, ag, ar, rs, a2a, cp]
NCOST = 7


def cost_vector(fn: Callable[[], Any]) -> np.ndarray:
    """Run ``fn`` and count [FLOPs, HBM bytes, and the output bytes of each
    collective (all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute)]. FLOPs: ``FlopCounterMode`` (matmuls, convolutions,
    attention). HBM bytes: every aten op's operand bytes plus its result
    bytes, views excepted. That is the unfused count, each op reading its
    inputs from memory and writing its outputs back: more than XLA's
    ``bytes accessed`` for a fused program, and more than the card moves
    where an op's operands stay in cache. Collectives: ``mesh.
    count_collectives`` (every rank's output)."""
    counter = _ByteCounter()
    with count_collectives() as coll, FlopCounterMode(display=False) as flops, counter:
        fn()
    return np.array([float(flops.get_total_flops()), float(counter.bytes)]
                    + [float(coll[k]) for k in COLLECTIVES])


@dataclasses.dataclass
class ExactCosts:
    flops: float
    hbm_bytes: float
    coll: dict[str, float]

    @classmethod
    def from_vector(cls, v: np.ndarray) -> "ExactCosts":
        return cls(flops=float(v[0]), hbm_bytes=float(v[1]),
                   coll=dict(zip(COLLECTIVES, [float(x) for x in v[2:]])))


def solve_train(c11, c21, c1m2, n_units, microbatches, c_enc2=None, enc_units=0, c22=None):
    """Bilinear cost model over (L, mb) at fixed TOTAL tokens T:

        c(L, mb) = α + mb·β + L·mb·γ + L·δ  [+ Le·enc]

    α: step-fixed (optimizer etc.) + per-token non-layer work (T-dependent
    but mb-invariant); β: per-micro fixed; γ: per-(micro, layer) fixed;
    δ: per-layer token work (T·λ — the dominant term, mb-invariant because
    each micro processes T/mb tokens). Probes at (1,1), (2,1), (1,2), (2,2).

    Eval at (n_units, microbatches). Enc layers process T tokens once per
    step regardless of mb: enc_total = Le·(c_enc2 − c11).
    """
    enc = (c_enc2 - c11) if c_enc2 is not None else 0.0
    if c1m2 is None or c22 is None:  # microbatches == 1: γ, β fold into α/δ
        delta = c21 - c11
        alpha = c11 - delta - (enc if c_enc2 is not None else 0.0)
        total = alpha + n_units * delta
    else:
        gamma = c22 - c1m2 - c21 + c11
        delta = (c21 - c11) - gamma
        beta = (c1m2 - c11) - gamma
        alpha = c11 - beta - gamma - delta - (enc if c_enc2 is not None else 0.0)
        total = (alpha + microbatches * beta
                 + n_units * microbatches * gamma + n_units * delta)
    return total + enc_units * enc


def solve_inference(c1, c2, n_units, c_enc2=None, enc_units=0):
    layer = c2 - c1
    enc = (c_enc2 - c1) if c_enc2 is not None else 0.0
    fixed = c1 - layer - (enc if c_enc2 is not None else 0.0)
    return fixed + n_units * layer + enc_units * enc


# ---------------------------------------------------------------------------
# analytic attention block-area adjustment
# ---------------------------------------------------------------------------
def attn_layers_per_unit_and_tail(cfg) -> tuple[int, int]:
    from repro_torch.models.model import block_pattern

    unit, tail, _ = block_pattern(cfg)

    def att(kinds):
        return sum(k in ("attn_mlp", "attn_local", "attn_moe", "dec", "enc") for k in kinds)

    return att(unit), att(tail)


def analytic_attn_area(cfg, seq: int, impl: str, *, chunk: int = 512,
                       causal: bool = True) -> tuple[float, float]:
    """(area_impl, area_direct) in score-entries per (batch, head) for ONE
    self-attention layer at ``seq``, using the kernel's own pair schedule."""
    from repro_torch.models.attention import attention_pairs

    nq = -(-seq // chunk)
    nk = nq
    window = cfg.window if cfg.pattern else None
    # NB: window layers are banded in every impl; dense layers are banded
    # only under 'triangle'
    pairs = attention_pairs(nq, nk, chunk, chunk, causal=causal,
                            window=window, q_offset=0,
                            impl=impl if impl != "direct" else "masked")
    area_sched = (len(pairs) * chunk * chunk if seq * seq > 2 * chunk * chunk
                  else seq * seq)
    return float(area_sched), float(seq * seq)


def attn_flops_adjustment(cfg, shape, world: int, impl: str, *, train: bool,
                          rows: int | None = None) -> float:
    """Per-rank FLOP delta of ``rows`` rows a rank (a train rank's local
    batch, or a serving step's rows) with every tp rank's heads folded, or
    without ``rows`` of a data world of ``world`` ranks at tp 1: replace the
    direct-attention probe FLOPs with the block schedule's FLOPs. 0 for
    decode (no pair scan)."""
    if shape.kind == "decode":
        return 0.0
    seq = shape.seq_len // (2 if cfg.enc_layers else 1)
    per_unit, tail_n = attn_layers_per_unit_and_tail(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        mm_dims = (m.qk_nope_head_dim + m.qk_rope_head_dim) + m.v_head_dim
    else:
        mm_dims = 2 * cfg.hd
    heads_loc = cfg.n_heads  # tp 1, or every tp rank's heads folded
    from repro_torch.models.model import block_pattern
    unit, tail, n_sb = block_pattern(cfg)
    n_attn = per_unit * n_sb + tail_n + (cfg.enc_layers if cfg.enc_layers else 0)
    area_impl, area_direct = analytic_attn_area(cfg, seq, impl)
    # summed over microbatches
    b_loc = local_batch(shape.global_batch, world) if rows is None else rows
    # per (b, head): 2 matmuls (qk^T, pv) over the block area
    delta_per_layer = 2.0 * mm_dims * (area_impl - area_direct) * heads_loc * b_loc
    factor = 4.0 if train else 1.0  # fwd + remat-recompute + 2×bwd
    return n_attn * delta_per_layer * factor


def wire_and_terms(costs: ExactCosts, *, world_hint: int = 16,
                   pod_fraction: float = 0.0) -> dict[str, Any]:
    """Ring-factor wire bytes + three roofline terms."""
    w = max(2, world_hint)
    f = (w - 1) / w
    wire = (costs.coll["all-gather"] * f
            + costs.coll["reduce-scatter"] * f
            + costs.coll["all-reduce"] * 2 * f
            + costs.coll["all-to-all"] * f
            + costs.coll["collective-permute"])
    t_compute = costs.flops / PEAK_FLOPS
    t_memory = costs.hbm_bytes / HBM_BW
    t_coll = wire * (1 - pod_fraction) / NVLINK_BW + wire * pod_fraction / INTER_HOST_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    return {
        "wire_bytes_per_dev": wire,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": bottleneck,
    }


def model_flops(cfg, shape, n_dev: int) -> float:
    n_active = cfg.active_param_count()
    # enc-dec shapes split seq between encoder frames and decoder tokens;
    # each side sees seq/2 positions
    seq = shape.seq_len // (2 if cfg.enc_layers else 1)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * seq / n_dev
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * seq / n_dev
    return 2.0 * n_active * shape.global_batch / n_dev
