"""RG-LRU recurrent block (RecurrentGemma / Griffin) on one card.

The counterpart of ``repro/models/rglru.py``:
h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t),
a_t = exp(−c · softplus(Λ) · r_t), r/i = σ(diagonal gates on x_t), with the
JAX model's diagonal gates. The prefill scans the sequence with
``core.ring_scan.inclusive_linear_scan`` (log₂ s doubling steps of
whole-tensor ops, where the JAX model calls ``lax.associative_scan``; the
fp32 sums round in another order); decode carries the (b, lru) state one
step. Over tp ranks each rank holds lru/tp channels; the gates, the conv
and the scan are per channel, so folded they are the tp = 1 computation, and
the output projection is row-parallel, its partials summed
(``parallel.row_parallel``). The state is held once. Every leaf comes
through ``fetch`` (``group = "rec"``): on a process mesh the rank's
channels of each projection, of the conv and of the fp32 gate vectors, and
its state holds those channels.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.core.ring_scan import inclusive_linear_scan
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import CastOnce, causal_conv1d
from repro_torch.models.parallel import ShardEnv, row_parallel

RG_C = 8.0
CONV_WIDTH = 4


class RGLRU(CastOnce):
    """Parameters as the JAX leaves (lru width = d_model): w_gate, w_in (d,
    lru), conv (lru, 4), lam, gate_a_w, gate_a_b, gate_i_w, gate_i_b (lru,),
    w_out (lru, d)."""

    compute = ("w_gate", "w_in", "w_out")
    group = "rec"

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d = lru = cfg.d_model
        self.cfg = cfg
        self.w_gate = self.param((d, lru), "normal", generator, device)
        self.w_in = self.param((d, lru), "normal", generator, device)
        self.conv = self.param((lru, CONV_WIDTH), "normal", generator, device, scale=0.1)
        self.lam = self.param((lru,), "ones", generator, device)
        self.gate_a_w = self.param((lru,), "normal", generator, device, scale=1.0)
        self.gate_a_b = self.param((lru,), "zeros", generator, device)
        self.gate_i_w = self.param((lru,), "normal", generator, device, scale=1.0)
        self.gate_i_b = self.param((lru,), "zeros", generator, device)
        self.w_out = self.param((lru, d), "normal", generator, device)

    def forward(self, x: torch.Tensor, *, state: dict | None = None,
                prefill_state: dict | None = None,
                env: ShardEnv | None = None) -> torch.Tensor:
        """x (b, s, d) → (b, s, d). ``state`` {"conv", "h"}: one decode step
        (s = 1) from the state, which is then overwritten in place.
        ``prefill_state``: a state of that form that takes the prompt's last
        conv inputs and hidden state in place. ``env``: the tp ranks (folded:
        every channel; on a process mesh the rank's)."""
        b, s, _ = x.shape
        if state is not None and s != 1:
            raise ValueError(f"an RG-LRU decode step takes one position, got {s}")

        def vec(name):
            return self.fetch(name, env).to(torch.float32)

        gate = x @ self.fetch("w_gate", env)
        xin, conv = causal_conv1d(x @ self.fetch("w_in", env), self.fetch("conv", env),
                                  None if state is None else state["conv"])
        xf = xin.to(torch.float32)
        r = torch.sigmoid(xf * vec("gate_a_w") + vec("gate_a_b"))
        i = torch.sigmoid(xf * vec("gate_i_w") + vec("gate_i_b"))
        a = torch.exp(-RG_C * F.softplus(vec("lam")) * r)
        gated_x = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
        if state is not None:
            y = (a[:, 0] * state["h"] + gated_x[:, 0])[:, None]
            out_state = state
        else:
            _, y = inclusive_linear_scan(a, gated_x, 1)
            out_state = prefill_state
        if out_state is not None:
            out_state["conv"].copy_(conv)
            out_state["h"].copy_(y[:, -1])
        y = (y * F.gelu(gate.to(torch.float32), approximate="tanh")).to(x.dtype)
        return row_parallel(y, self.fetch("w_out", env), env)
