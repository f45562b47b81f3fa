"""Mixture-of-Experts on one card: token → expert dispatch as the word
count's map → shuffle → reduce.

The counterpart of ``repro/models/moe.py`` (tp = 1). The router is the
mapper's hash, the shuffle brings each expert's tokens together, and the
gate-weighted combine is the reducer: ``kernels.ops.segment_reduce`` sums the
weighted expert rows into their tokens (the CUDA reducer on the card, its
plain version on the CPU).

On one device the JAX model's ``moe_apply_a2a`` falls through to
``moe_apply_replicated`` (``moe.py:114-115``), which runs every expert on
every token and masks by gate. The prefill here computes the same function
dropless, each expert on its own tokens only; decode keeps the replicated
form (a few tokens, plain ops). Both sum the experts' outputs in fp32 where
the JAX model adds each expert's bf16 contribution to a bf16 total, so the
two agree to bf16 rounding, and the kernel's fp32 atomics make the last
bits depend on their order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import CastOnce, act_fn


def expert_counts(experts: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many of the (token, choice) pairs ``experts`` each expert takes,
    int64 (n_experts,). On the meta device, which holds shapes and no values
    (the dry run), the result is shape only: see ``group_sizes``."""
    if experts.device.type == "meta":
        return torch.empty((n_experts,), dtype=torch.int64, device="meta")
    return torch.bincount(experts.reshape(-1), minlength=n_experts)


def group_sizes(experts: torch.Tensor, n_experts: int) -> list[int]:
    """Each expert's row count on the host (one sync). On the meta device
    there are no choices to count, and the dry run takes BALANCED routing:
    top_k · tokens / n_experts rows an expert, the remainder one each to the
    first experts."""
    if experts.device.type == "meta":
        q, r = divmod(experts.numel(), n_experts)
        return [q + (e < r) for e in range(n_experts)]
    return expert_counts(experts, n_experts).tolist()


BALANCED = ("balanced routing on the meta device: top_k · tokens / n_experts rows an expert "
            "(moe.group_sizes)")


class MoE(CastOnce):
    """Top-k routed gated-MLP experts. Parameters as the JAX leaves (tp = 1):
    router (d, E), wi_gate/wi_up (E, d, d_expert), wo (E, d_expert, d), in the
    config's ``param_dtype``."""

    compute = ("wi_gate", "wi_up", "wo")

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        self.cfg = cfg
        self.router = self.param((d, m.n_experts), "normal", generator, device)
        self.wi_gate = self.param((m.n_experts, d, m.d_expert), "normal", generator, device)
        self.wi_up = self.param((m.n_experts, d, m.d_expert), "normal", generator, device)
        self.wo = self.param((m.n_experts, m.d_expert, d), "normal", generator, device)

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """x (n, d) → the router's fp32 softmax (n, E)."""
        return torch.softmax(x.to(torch.float32) @ self.router.to(torch.float32), dim=-1)

    def route(self, x: torch.Tensor):
        """x (n, d) → (gates (n, k) in x's dtype, experts (n, k) int64):
        ``_router``'s fp32 softmax, top-k and renormalisation."""
        gates, experts = torch.topk(self.probs(x), self.cfg.moe.top_k, dim=-1)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return gates.to(x.dtype), experts

    def aux_loss(self, x: torch.Tensor) -> torch.Tensor:
        """``_router``'s third output, the switch-style load-balance loss of
        tokens x (n, d): E · Σ_e mean(probs)_e · count_e / (n·k) ·
        ``router_aux_weight``, fp32. The counts of top-k choices carry no
        gradient; the mean probabilities do. Training adds it to the loss;
        serving does not compute it."""
        m = self.cfg.moe
        probs = self.probs(x)
        experts = torch.topk(probs, m.top_k, dim=-1).indices.reshape(-1)
        ce = expert_counts(experts, m.n_experts).to(torch.float32) / max(1, experts.numel())
        return m.n_experts * torch.sum(probs.mean(0) * ce) * m.router_aux_weight

    def expert(self, x: torch.Tensor, w: tuple[torch.Tensor, ...], e: int) -> torch.Tensor:
        """Expert ``e``'s gated MLP on rows x (m, d), bf16; ``w``: the bf16
        (wi_gate, wi_up, wo) of every expert."""
        wg, wu, wo = w
        h = act_fn(self.cfg.act)(x @ wg[e]) * (x @ wu[e])
        return h @ wo[e]

    def forward(self, x: torch.Tensor, *, decode: bool = False) -> torch.Tensor:
        """x (b, s, d) bf16 → (b, s, d): dispatched (prefill and training) or
        replicated (``decode``)."""
        b, s, d = x.shape
        flat = x.reshape(-1, d)
        gates, experts = self.route(flat)
        out = self.replicated(flat, gates, experts) if decode else self.dispatched(
            flat, gates, experts)
        return out.reshape(b, s, d)

    def replicated(self, flat, gates, experts) -> torch.Tensor:
        """``moe_apply_replicated``: every expert on every token, weighted by
        its gate where chosen (0 elsewhere). The experts run as one batched
        product per weight and their weighted outputs are summed at once
        (fp32 accumulation, one bf16 rounding), where the JAX model loops
        over the experts and adds in bf16: a few tokens at decode, so the
        loop's launches, not the products, would set the step's time."""
        ids = torch.arange(self.cfg.moe.n_experts, device=flat.device)[:, None, None]
        w = torch.where(experts[None] == ids, gates.to(torch.float32)[None], 0.0).sum(-1)  # (E, n)
        h = act_fn(self.cfg.act)(torch.einsum("nd,edf->enf", flat, self.cw("wi_gate"))) * \
            torch.einsum("nd,edf->enf", flat, self.cw("wi_up"))
        y = torch.bmm(h, self.cw("wo"))  # (E, n, d)
        return (y * w[..., None].to(y.dtype)).sum(0)

    def dispatched(self, flat, gates, experts) -> torch.Tensor:
        """Map: the router's (token, expert) pairs. Shuffle: a stable sort by
        expert puts each expert's rows together. Reduce: each row's expert
        output times its gate, summed into its token by ``segment_reduce``
        (differentiable: its gradient gathers each token's gradient back to
        its rows). The group sizes reach the host (one sync) to slice the
        sorted rows."""
        n, k = experts.shape
        order = torch.argsort(experts.reshape(-1), stable=True)
        tok = torch.div(order, k, rounding_mode="floor")
        sizes = group_sizes(experts, self.cfg.moe.n_experts)
        rows = flat[tok]
        g = gates.reshape(-1)[order, None]
        w = (self.cw("wi_gate"), self.cw("wi_up"), self.cw("wo"))
        parts = []
        start = 0
        for e, size in enumerate(sizes):
            if size:
                sl = slice(start, start + size)
                parts.append(self.expert(rows[sl], w, e) * g[sl])
                start += size
        y = torch.cat(parts) if parts else rows[:0]
        return ops.segment_reduce(y, tok.to(torch.int32), n).to(flat.dtype)
