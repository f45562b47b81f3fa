"""Mamba-2 (SSD, state-space duality) block on one card.

The counterpart of ``repro/models/ssm.py``. The prefill runs the
chunked SSD algorithm (arXiv:2405.21060): within a chunk the recurrence is a
causal-masked quadratic form, across chunks the (N × P) states propagate
through a linear scan; decode takes one step of the recurrence over the
cached state. Every step follows the JAX function with its dtypes (bf16
projections, fp32 decays, states and scan). The inter-chunk scan is
``core.ring_scan.inclusive_linear_scan``, a doubling scan in place of
``lax.associative_scan``, so its fp32 sums round in another order.

Over tp ranks each rank holds heads/tp of the heads (and their d_in/tp
channels of z, x and the conv); B/C are per group and every rank computes
them whole. The ranks' heads run as one, except two steps that see the
rank: the gated RMSNorm normalises over the rank's d_in/tp features (so at
tp > 1 the function differs from tp = 1's), and the down projection is
row-parallel, its tp partials summed in bf16. On a process mesh a process
runs its rank's heads from its fetched slices and holds their conv and SSD
state; the heads and channels are read off the fetched weights.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.core.ring_scan import inclusive_linear_scan
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import CastOnce, causal_conv1d, rms_norm
from repro_torch.models.parallel import ShardEnv, row_parallel


def ssm_dims(cfg: ModelConfig, env: ShardEnv | None = None) -> tuple[int, int]:
    """(d_inner, heads) held: all of them folded, the rank's on a process mesh."""
    d_in = cfg.d_model * cfg.ssm.expand
    shards = 1 if env is None else env.tp // env.held_tp
    return d_in // shards, d_in // cfg.ssm.head_dim // shards


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan (``_ssd_chunked``). x (b, s, h, p), dt (b, s, h) fp32
    after softplus, A (h,) negative, B, C (b, s, h, N). Returns (y (b, s, h,
    p) fp32, the last state (b, h, N, p) fp32)."""
    b, s, h, p = x.shape
    N = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = (F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad)) for v in (x, dt, B, C))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p).to(torch.float32)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, h, N)
    Cc = C.reshape(b, nc, chunk, h, N)

    lcum = torch.cumsum(dtc * A, dim=2)  # within-chunk cumulative log decay (b, nc, Q, h)
    ltot = lcum[:, :, -1]  # (b, nc, h)

    # intra-chunk: score[i, j] = C_i·B_j · exp(lcum_i − lcum_j) · dt_j for j <= i
    sc = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc).to(torch.float32)
    li = lcum.transpose(2, 3)  # (b, nc, h, Q)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    w = torch.exp(torch.where(causal, li[..., :, None] - li[..., None, :], float("-inf")))
    w = w * dtc.transpose(2, 3)[:, :, :, None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", sc * w, xc)

    # chunk states: S_c = Σ_j exp(ltot − lcum_j) dt_j B_j ⊗ x_j  (b, nc, h, N, p)
    wj = torch.exp(ltot[:, :, None, :] - lcum) * dtc
    states = torch.einsum("bcjhn,bcjhp->bchnp", wj[..., None] * Bc.to(torch.float32), xc)

    # inter-chunk scan: the state leaving chunk c, then the state entering it
    _, s_incl = inclusive_linear_scan(torch.exp(ltot)[..., None, None], states, 1)
    s_in = torch.cat([torch.zeros_like(s_incl[:, :1]), s_incl[:, :-1]], dim=1)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Cc.to(torch.float32), s_in)
    y = y + y_inter * torch.exp(lcum)[..., None]
    return y.reshape(b, nc * chunk, h, p)[:, :s], s_incl[:, -1]


class SSM(CastOnce):
    """The Mamba-2 mixer: projections, depthwise conv on x and on B/C, SSD,
    the D skip, a gated RMSNorm and the down projection. Parameters as the
    JAX leaves: w_z, w_x (d, d_in), w_bc (d, 2·G·N), w_dt (d, heads),
    conv_x (d_in, width), conv_bc (2·G·N, width), A_log, dt_bias, D (heads,),
    out_norm (d_in,), w_out (d_in, d)."""

    compute = ("w_z", "w_x", "w_bc", "w_dt", "w_out")
    group = "ssm"

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_in, heads = ssm_dims(cfg)
        gN = 2 * s.n_groups * s.d_state
        self.cfg = cfg
        self.w_z = self.param((d, d_in), "normal", generator, device)
        self.w_x = self.param((d, d_in), "normal", generator, device)
        self.w_bc = self.param((d, gN), "normal", generator, device)
        self.w_dt = self.param((d, heads), "normal", generator, device)
        self.conv_x = self.param((d_in, s.conv_width), "normal", generator, device, scale=0.1)
        self.conv_bc = self.param((gN, s.conv_width), "normal", generator, device, scale=0.1)
        self.A_log = self.param((heads,), "zeros", generator, device)
        self.dt_bias = self.param((heads,), "zeros", generator, device)
        self.D = self.param((heads,), "ones", generator, device)
        self.out_norm = self.param((d_in,), "ones", generator, device)
        self.w_out = self.param((d_in, d), "normal", generator, device)

    def forward(self, x: torch.Tensor, *, state: dict | None = None,
                prefill_state: dict | None = None, env: ShardEnv | None = None) -> torch.Tensor:
        """x (b, s, d) → (b, s, d). ``state`` {"conv_x", "conv_bc", "ssm"}:
        one decode step (s = 1) from the state, which is then overwritten in
        place. ``prefill_state``: a state of that form that takes the
        prompt's final conv inputs and SSM state in place. ``env``: the tp
        ranks (folded: the states held once, all heads; on a process mesh
        the rank's heads)."""
        cfg = self.cfg
        sc = cfg.ssm
        b, s, _ = x.shape
        N, G, hd = sc.d_state, sc.n_groups, sc.head_dim
        if state is not None and s != 1:
            raise ValueError(f"an SSM decode step takes one position, got {s}")
        st = state or {}
        z = x @ self.fetch("w_z", env)
        xin, conv_x = causal_conv1d(x @ self.fetch("w_x", env), self.fetch("conv_x", env),
                                    st.get("conv_x"))
        bc, conv_bc = causal_conv1d(x @ self.fetch("w_bc", env), self.fetch("conv_bc", env),
                                    st.get("conv_bc"))
        A = -torch.exp(self.fetch("A_log", env).to(torch.float32))
        dt = torch.clamp(F.softplus((x @ self.fetch("w_dt", env)).to(torch.float32)
                                    + self.fetch("dt_bias", env).to(torch.float32)),
                         sc.dt_min, sc.dt_max * 100)
        heads = dt.shape[-1]  # the heads held: all folded, the rank's on a process mesh
        d_in = heads * hd
        first = 0 if env is None else env.tp_offset(heads)
        xh = xin.view(b, s, heads, hd)
        # head → group, by the head's global index
        gidx = ((first + torch.arange(heads, device=x.device)) * G) // ssm_dims(cfg)[1]
        Bh = bc[..., :G * N].view(b, s, G, N)[:, :, gidx]
        Ch = bc[..., G * N:].view(b, s, G, N)[:, :, gidx]

        if state is not None:  # one step of the recurrence
            dt0 = dt[:, 0, :, None, None]
            a = torch.exp(dt0 * A[None, :, None, None])
            x0 = xh[:, 0, :, None, :].to(torch.float32)
            new = a * state["ssm"] + dt0 * Bh[:, 0, :, :, None] * x0
            y = torch.einsum("bhn,bhnp->bhp", Ch[:, 0].to(torch.float32), new)[:, None]
            out_state = state
        else:
            y, new = ssd_chunked(xh, dt, A, Bh, Ch, sc.chunk)
            out_state = prefill_state
        if out_state is not None:
            out_state["conv_x"].copy_(conv_x)
            out_state["conv_bc"].copy_(conv_bc)
            out_state["ssm"].copy_(new)

        y = y + xh.to(torch.float32) * self.fetch("D", env)[None, None, :, None]
        y = y.reshape(b, s, d_in).to(x.dtype)
        z = z.to(torch.float32)
        y = y * (z * torch.sigmoid(z)).to(y.dtype)
        norm, w_out = self.fetch("out_norm", env), self.fetch("w_out", env)
        if env is None or env.tp == 1:
            return rms_norm(y, norm, cfg.norm_eps) @ w_out
        # each rank's gated norm over its own d_in/tp features
        n = env.held_tp
        y = rms_norm(y.unflatten(-1, (n, -1)), norm.view(n, -1), cfg.norm_eps)
        return row_parallel(y.flatten(-2), w_out, env)
