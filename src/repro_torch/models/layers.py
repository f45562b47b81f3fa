"""Shared neural layers: RMSNorm, RoPE and M-RoPE, activations, the gated
MLP and the depthwise causal conv1d.

The counterpart of ``repro/models/layers.py``. The arithmetic follows the
JAX functions step by step, with bf16 where they compute in bf16 and fp32
where they upcast, so the two round alike. The MLP takes a ``ShardEnv``:
column- then row-parallel over its tp ranks, or the compute-at-data route
when serving asks for it over an fsdp world.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.mesh import counting
from repro_torch.models.common import ModelConfig, init_tensor
from repro_torch.models.parallel import (COMPUTE_DTYPE, NORM, LeafPlace, ShardEnv, col_parallel,
                                         fetch_weight, row_parallel, serve_col_matmul,
                                         serve_row_matmul, shard_leaf)

# the process mesh's env whose device's shard each parameter keeps as it is
# made (``cutting``), None elsewhere
_CUT: contextvars.ContextVar[ShardEnv | None] = contextvars.ContextVar("cut", default=None)


@contextlib.contextmanager
def cutting(env: ShardEnv | None):
    """While open, every parameter a ``CastOnce`` module is given is cut to
    the shard of ``env``'s device (``env.mesh``'s process) as it is
    assigned: drawn whole, then at once replaced by its shard
    (``parallel.shard_leaf`` with the leaf's place), so that a process holds
    one whole leaf at a time while it builds a model. ``None``: nothing is
    cut."""
    token = _CUT.set(env)
    try:
        yield
    finally:
        _CUT.reset(token)


class CastOnce(nn.Module):
    """A module whose parameters are made in fp32 (``Model`` then stores them
    in the config's ``param_dtype``) and whose matmul weights, named in
    ``compute``, are read in bf16 through ``cw``.
    The JAX model casts each fp32 weight to bf16 at every use
    (``w.astype(compute_dtype)``). While autograd records and the weight
    requires a gradient (training), ``cw`` casts it so too, inside the graph;
    otherwise it returns a bf16 copy made once (``<name>_c``, a buffer kept
    out of the state dict), the same numbers without the per-call cast.
    A parameter stored in bf16 is its own copy: ``<name>_c`` is the
    parameter's storage, not a second tensor.
    Parameters are made with ``requires_grad=False``, so a served model keeps
    no autograd state; a trainer turns them on (``requires_grad_()``).
    ``Model.cast_weights`` remakes the copies and must run after any change
    to the parameters. ``fetch`` reads a parameter through the
    reference's weight fetch: its working slice under a ``ShardEnv``
    (gathered on a process mesh, where the module holds its device's
    shard). While ``work`` holds working slices ({parameter name: fp32
    slice}, set by ``Model.working`` for a process train step, which
    fetches every leaf once a step), ``fetch`` reads them instead. Under
    ``cutting`` a parameter is cut to its device's shard as it is assigned."""

    compute: tuple[str, ...] = ()
    group = ""  # the module's subtree in a JAX layer ("attn", "mlp", ...): its leaves' keys
    work: dict | None = None

    def __setattr__(self, name: str, value) -> None:
        env = _CUT.get()
        if env is not None and isinstance(value, nn.Parameter):
            value.data = shard_leaf(value.data, self.leaf_place(name), env, env.fsdp_index,
                                    env.model_index).clone()
        super().__setattr__(name, value)

    def leaf_place(self, name: str) -> LeafPlace:
        """Parameter ``name``'s ``LeafPlace`` (``specs``), resolved once a module."""
        places = self.__dict__.setdefault("_places", {})
        if name not in places:
            from repro_torch.models import specs

            places[name] = specs.place(f"{self.group}/{name}" if self.group else name, self.cfg)
        return places[name]

    def fetch(self, name: str, env: ShardEnv | None, *, fsdp: bool = True,
              stored: bool = False) -> torch.Tensor:
        """Parameter ``name`` (its bf16 copy where it has one; ``stored``:
        the parameter as stored, fp32) under ``env``:
        ``parallel.fetch_weight`` with the leaf's place (``specs``);
        ``fsdp=False`` leaves the FSDP dim sharded (compute at data). On
        world dims the leaf itself, noted as the fetch when counted. From
        ``work`` where it is set: the slice, cast to bf16 in the graph
        for a matmul weight."""
        copy = name in self.compute and not stored
        if self.work is not None:
            w = self.work[name]
            return w.to(COMPUTE_DTYPE) if copy else w
        w = self.cw(name) if copy else getattr(self, name)
        if env is None or (env.mesh is None and not counting()):
            return w
        return fetch_weight(w, env, self.leaf_place(name), fsdp=fsdp)

    def param(self, shape, law: str, generator, device, scale: float = 0.02) -> nn.Parameter:
        return nn.Parameter(init_tensor(shape, law, generator, device, scale),
                            requires_grad=False)

    def cw(self, name: str) -> torch.Tensor:
        """Parameter ``name`` in bf16: cast in the graph while training, else
        the cached copy."""
        p = getattr(self, name)
        if p.requires_grad and torch.is_grad_enabled():
            return p.to(COMPUTE_DTYPE)
        return getattr(self, f"{name}_c")

    @torch.no_grad()
    def cast_weights(self) -> None:
        for name in self.compute:  # detach: a bf16 parameter aliases, not copies
            self.register_buffer(f"{name}_c", getattr(self, name).detach().to(COMPUTE_DTYPE),
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


def mrope_angles(positions: torch.Tensor, dim: int, theta: float, sections: tuple[int, ...]):
    """M-RoPE (qwen2-vl): positions (..., s, 3), the (t, h, w) grids; each
    band of ``sections`` (summing to dim/2) takes its angle from its grid.
    Returns cos, sin (..., s, dim/2), fp32."""
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {dim // 2}")
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    cos_parts, sin_parts = [], []
    off = 0
    for i, sec in enumerate(sections):
        ang = positions[..., i].to(torch.float32)[..., None] * inv[off:off + sec]
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        off += sec
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


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
    """RMSNorm with an fp32 scale, fetched under ``env`` from its storage at
    ``place``: FSDP-sharded (``NORM``: a layer's norms, the final and the
    encoder's), or held whole (MLA's latent norms)."""

    def __init__(self, d: int, eps: float, generator, device, place: LeafPlace = NORM):
        super().__init__()
        self.place = place
        self.scale = self.param((d,), "ones", generator, device)
        self.eps = eps

    def leaf_place(self, name: str) -> LeafPlace:
        return self.place

    def forward(self, x: torch.Tensor, env: ShardEnv | None = None) -> torch.Tensor:
        if self.work is not None:
            scale = self.work["scale"]
        else:
            scale = self.scale if env is None else fetch_weight(self.scale, env, self.place)
        return rms_norm(x, scale, self.eps)


class MLP(CastOnce):
    """Gated MLP (SwiGLU/GeGLU): ``wo(act(x·wi_gate) * x·wi_up)``, bf16."""

    compute = ("wi_gate", "wi_up", "wo")
    group = "mlp"

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.wi_gate = self.param((d, ff), "normal", generator, device)
        self.wi_up = self.param((d, ff), "normal", generator, device)
        self.wo = self.param((ff, d), "normal", generator, device)
        self.act = cfg.act

    def forward(self, x: torch.Tensor, env: ShardEnv | None = None) -> torch.Tensor:
        """``mlp_apply``: with ``env.compute_at_data`` over an fsdp world the
        products run at the weights' d-slices (``serve_col_matmul``, then
        ``serve_row_matmul``'s at-data form), without the weights' FSDP
        gather; else on the fetched weights. The row product's tp partials
        are summed either way."""
        if env is not None and env.compute_at_data and env.fsdp_size > 1:
            g = serve_col_matmul(x, self.fetch("wi_gate", env, fsdp=False), env)
            u = serve_col_matmul(x, self.fetch("wi_up", env, fsdp=False), env)
            y = serve_row_matmul(act_fn(self.act)(g) * u, self.fetch("wo", env, fsdp=False), env,
                                 at_data=True)
            return env.psum_tp(y) if env.tp > 1 else y[0]
        g = col_parallel(x, self.fetch("wi_gate", env))
        u = col_parallel(x, self.fetch("wi_up", env))
        return row_parallel(act_fn(self.act)(g) * u, self.fetch("wo", env), env)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv: x (b, s, c), w (c, width) → (silu(y) in x's
    dtype, new state). ``state`` (b, width-1, c) holds the inputs before x
    (zeros when None); the new state is the last width-1 inputs. The taps
    are summed in fp32 in the JAX function's order."""
    b, s, c = x.shape
    width = w.shape[1]
    if state is None:
        state = x.new_zeros((b, width - 1, c))
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (b, s + width - 1, c)
    wf = w.to(torch.float32)
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for k in range(width):
        y = y + xp[:, k:k + s].to(torch.float32) * wf[:, k]
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return (y * torch.sigmoid(y)).to(x.dtype), new_state
