"""Shared neural layers: RMSNorm, RoPE, activations and the gated MLP.

The counterpart of ``repro/models/layers.py`` on one card (tp = 1). The
arithmetic follows the JAX functions step by step, with bf16 where they
compute in bf16 and fp32 where they upcast, so the two round alike.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.common import ModelConfig, init_tensor
from repro_torch.models.parallel import COMPUTE_DTYPE, col_parallel, row_parallel


class CastOnce(nn.Module):
    """A module with fp32 parameters (the config's ``param_dtype``) whose
    matmul weights, named in ``compute``, also live as bf16 copies
    (``<name>_c``, buffers kept out of the state dict). The JAX model casts
    each fp32 weight to bf16 at every use (``w.astype(compute_dtype)``);
    casting once, when the parameters are set, gives the same numbers
    without the per-call cast. ``Model.cast_weights`` remakes the copies and
    must run after any change to the parameters."""

    compute: tuple[str, ...] = ()

    def param(self, shape, law: str, generator, device) -> nn.Parameter:
        # serving only: no gradients (training comes with the port of optim/)
        return nn.Parameter(init_tensor(shape, law, generator, device), requires_grad=False)

    @torch.no_grad()
    def cast_weights(self) -> None:
        for name in self.compute:
            self.register_buffer(f"{name}_c", getattr(self, name).to(COMPUTE_DTYPE),
                                 persistent=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, result in x's dtype. x (..., d), scale (d,)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)  # jax.nn.silu's two ops, each rounded in x's dtype


def act_fn(name: str):
    return {"silu": _silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) → cos, sin (..., dim/2), fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., s, h, d), rotate-half convention; cos/sin (..., s, d/2).
    The rotation runs in fp32 (bf16 x times fp32 angles), then rounds to
    x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


class RMSNorm(CastOnce):
    def __init__(self, d: int, eps: float, generator, device):
        super().__init__()
        self.scale = self.param((d,), "ones", generator, device)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


class MLP(CastOnce):
    """Gated MLP (SwiGLU/GeGLU): ``wo(act(x·wi_gate) * x·wi_up)``, bf16."""

    compute = ("wi_gate", "wi_up", "wo")

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.wi_gate = self.param((d, ff), "normal", generator, device)
        self.wi_up = self.param((d, ff), "normal", generator, device)
        self.wo = self.param((ff, d), "normal", generator, device)
        self.act = cfg.act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = col_parallel(x, self.wi_gate_c)
        u = col_parallel(x, self.wi_up_c)
        return row_parallel(act_fn(self.act)(g) * u, self.wo_c)
