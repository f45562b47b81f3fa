"""Attention: grouped-query attention with the chunked online-softmax core.

The counterpart of ``repro/models/attention.py`` on one card (tp = 1).
Sequence mixing is chosen per step, as in the JAX model:
  * ``masked``   — every (q-chunk, kv-chunk) block pair, causal by mask;
  * ``triangle`` — only the block pairs that meet the causal triangle;
  * ``direct``   — one block over the whole sequence;
  * ``flash``    — the port's own: causal self-attention prefill through
                   the ``flash_attention`` Hopper kernel (``kernels.ops``;
                   its plain version on the CPU). It is exactly the
                   kernel's function, so it takes no other case.
``masked``/``triangle``/``direct`` repeat the JAX arithmetic: q scaled in the
compute dtype, scores from a bf16 product, p cast to v's dtype before the
P·V product. The kernel scales in fp32 and keeps p in fp32 until its own
bf16 P·V product, so ``flash`` and ``masked`` agree to bf16 rounding only.
Cross-attention and the rolling window cache are not on a ported model's
path and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import CastOnce, apply_rope
from repro_torch.models.parallel import COMPUTE_DTYPE

NEG_INF = -1e30
IMPLS = ("masked", "triangle", "direct", "flash")


def gqa_dims(cfg: ModelConfig):
    """(q heads, kv slots, group, q heads per kv slot) on one card (tp = 1)."""
    group = cfg.n_heads // cfg.n_kv_heads
    return cfg.n_heads, cfg.n_kv_heads, group, group


# ---------------------------------------------------------------------------
# chunked softmax attention core
# ---------------------------------------------------------------------------
def _block(q, k, v, mask):
    """One (cq, ck) block: returns (scores_max, exp_sum, out_unnorm)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)  # noqa: E741 — the online-softmax denominator
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(torch.float32)
    return m, l, o


def _merge(m1, l1, o1, m2, l2, o2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2  # noqa: E741
    o = o1 * a1.movedim(1, -1)[..., None] + o2 * a2.movedim(1, -1)[..., None]
    return m, l, o


def attention_pairs(nq, nk, chunk_q, chunk_k, *, causal, window, q_offset, impl):
    """The (q-chunk, kv-chunk) block schedule.

    ``masked``: all nq×nk blocks (2× causal FLOPs).
    ``triangle``: only blocks intersecting the causal triangle (exact).
    window: only blocks intersecting the sliding band.
    """
    if window is not None:
        pairs = []
        for i in range(nq):
            lo = max(0, (q_offset + i * chunk_q - (window - 1)) // chunk_k)
            hi = min(nk - 1, (q_offset + (i + 1) * chunk_q - 1) // chunk_k) if causal else nk - 1
            for j in range(lo, hi + 1):
                pairs.append((i, j))
        return pairs
    if causal and impl == "triangle":
        pairs = []
        for i in range(nq):
            hi = min(nk - 1, (q_offset + (i + 1) * chunk_q - 1) // chunk_k)
            for j in range(hi + 1):
                pairs.append((i, j))
        return pairs
    return [(i, j) for i in range(nq) for j in range(nk)]


def _pad_to(x, mult, dim):
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x, 0
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), pad


def chunked_attention(q, k, v, *, scale: float, causal: bool = True, q_offset: int = 0,
                      window: int | None = None, impl: str = "masked", chunk_q: int = 512,
                      chunk_k: int = 512, kv_len: int | None = None):
    """q (b, sq, h, d), k/v (b, sk, h, d) — h already per q head (kv expanded).

    ``q_offset``: absolute position of q[0] (decode/prefill continuation).
    ``kv_len``: valid length of k/v (cache decode).
    """
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    dev = q.device
    # the JAX model multiplies by a weakly typed scalar: rounded to q's dtype first
    q = q * torch.tensor(scale, dtype=q.dtype, device=dev)
    if impl == "direct" or sq * sk <= chunk_q * chunk_k * 2:
        qpos = q_offset + torch.arange(sq, device=dev)
        kpos = torch.arange(sk, device=dev)
        mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        m, l, o = _block(q, k, v, mask[None, None])
        return (o / l.movedim(1, -1)[..., None]).to(q.dtype)

    dv = v.shape[-1]
    q, _ = _pad_to(q, chunk_q, 1)
    k, _ = _pad_to(k, chunk_k, 1)
    v, _ = _pad_to(v, chunk_k, 1)
    nq, nk = q.shape[1] // chunk_q, k.shape[1] // chunk_k
    qc = q.reshape(b, nq, chunk_q, h, dh)
    kc = k.reshape(b, nk, chunk_k, h, dh)
    vc = v.reshape(b, nk, chunk_k, h, dv)

    def block_mask(i, j):
        qpos = q_offset + i * chunk_q + torch.arange(chunk_q, device=dev)
        kpos = j * chunk_k + torch.arange(chunk_k, device=dev)
        mask = (kpos[None, :] < sk).expand(chunk_q, chunk_k)  # kv padding
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        if kv_len is not None:
            mask = mask & (kpos[None, :] < kv_len)
        return mask[None, None]

    out = torch.zeros((b, nq, chunk_q, h, dv), dtype=torch.float32, device=dev)
    M = torch.full((b, h, nq, chunk_q), NEG_INF, dtype=torch.float32, device=dev)
    L = torch.zeros((b, h, nq, chunk_q), dtype=torch.float32, device=dev)
    # the JAX model's lax.scan over the block list, as a loop
    for i, j in attention_pairs(nq, nk, chunk_q, chunk_k, causal=causal, window=window,
                                q_offset=q_offset, impl=impl):
        m2, l2, o2 = _block(qc[:, i], kc[:, j], vc[:, j], block_mask(i, j))
        m, l, o = _merge(M[:, :, i], L[:, :, i], out[:, i], m2, l2, o2)
        out[:, i] = o
        M[:, :, i] = m
        L[:, :, i] = l
    Lm = L.movedim(1, -1)[..., None]  # (b, nq, cq, h, 1)
    out = (out / torch.clamp_min(Lm, 1e-30)).to(q.dtype)
    return out.reshape(b, nq * chunk_q, h, dv)[:, :sq]


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------
class GQAAttention(CastOnce):
    """Grouped-query self-attention with QKV bias, RoPE and a KV cache.
    Parameters are laid out as the JAX leaves are (tp = 1): wq (d, H·hd),
    wk/wv (d, KV, hd), wo (H·hd, d), bq (H·hd,), bk/bv (KV, hd)."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.cfg = cfg
        self.wq = self.param((d, H * hd), "normal", generator, device)
        self.wk = self.param((d, KV, hd), "normal", generator, device)
        self.wv = self.param((d, KV, hd), "normal", generator, device)
        self.wo = self.param((H * hd, d), "normal", generator, device)
        names = ["wq", "wk", "wv", "wo"]
        if cfg.qkv_bias:
            self.bq = self.param((H * hd,), "zeros", generator, device)
            self.bk = self.param((KV, hd), "zeros", generator, device)
            self.bv = self.param((KV, hd), "zeros", generator, device)
            names += ["bq", "bk", "bv"]
        self.compute = tuple(names)

    def forward(self, x, *, rope, cache=None, cache_len=None, prefill_cache=None,
                causal=True, window=None, impl="masked", cross_kv=None, cross_cache=None):
        """x (b, s, d) → (y (b, s, d), new_cache).

        ``cache``: {"k", "v"} (b, S_max, KV, hd), written in place at
        ``cache_len`` (decode); attention then runs over the cache up to
        ``cache_len + s``. ``prefill_cache``: a cache of the same form whose
        first s slots take this prompt's k/v in place, while attention runs
        over the fresh k/v (what the JAX model's ``want_cache`` prefill
        computes, without a second copy of the cache). With neither, no
        cache is kept (``new_cache`` is None). ``rope``: (cos, sin) for the
        q positions."""
        if cross_kv is not None or cross_cache is not None:
            raise NotImplementedError(
                "cross-attention (enc-dec) is not ported yet: ROADMAP.md queue 1, the LM stack")
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.hd
        hq, kv, _, rep_q = gqa_dims(cfg)
        q = torch.matmul(x, self.wq_c.to(x.dtype))
        k = torch.matmul(x, self.wk_c.to(x.dtype).flatten(1)).view(b, s, kv, hd)
        v = torch.matmul(x, self.wv_c.to(x.dtype).flatten(1)).view(b, s, kv, hd)
        if cfg.qkv_bias:
            q = q + self.bq_c.to(x.dtype)
            k = k + self.bk_c.to(x.dtype)
            v = v + self.bv_c.to(x.dtype)
        q = q.view(b, s, hq, hd)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        new_cache = None
        kv_valid = None
        if cache is not None:
            ck, cv = cache["k"], cache["v"]
            if window is not None and ck.shape[1] <= window:
                raise NotImplementedError(
                    "the rolling window cache is not ported yet: ROADMAP.md queue 1, the LM stack")
            ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
            cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
            kv_valid = cache_len + s
            new_cache = cache
            k_all, v_all = ck, cv
        else:
            if prefill_cache is not None:
                prefill_cache["k"][:, :s] = k.to(prefill_cache["k"].dtype)
                prefill_cache["v"][:, :s] = v.to(prefill_cache["v"].dtype)
                new_cache = prefill_cache
            k_all, v_all = k, v
        q_offset = 0 if cache is None else cache_len

        cd = COMPUTE_DTYPE
        if impl == "flash":
            if cache is not None or not causal or window is not None:
                raise ValueError("impl='flash' runs causal self-attention prefill only "
                                 "(no window, no cache offset or kv_len, sq == sk)")
            # the kernel reads the (b, s, h, d) tensors through strides, and kv
            # head i // rep_q directly: no transposed or repeated copy
            y = ops.flash_attention(q.to(cd).transpose(1, 2), k_all.to(cd).transpose(1, 2),
                                    v_all.to(cd).transpose(1, 2), causal=True).transpose(1, 2)
        else:
            if rep_q > 1:  # expand kv slots to per-q-head (a copy: skipped when 1:1)
                k_all = torch.repeat_interleave(k_all, rep_q, dim=2)
                v_all = torch.repeat_interleave(v_all, rep_q, dim=2)
            y = chunked_attention(q.to(cd), k_all.to(cd), v_all.to(cd),
                                  scale=1.0 / math.sqrt(hd), causal=causal, q_offset=q_offset,
                                  window=window, impl=impl, kv_len=kv_valid)
        y = y.reshape(b, s, hq * hd)
        return torch.matmul(y, self.wo_c.to(y.dtype)), new_cache
