"""Attention: grouped-query attention with the chunked online-softmax core,
and multi-head latent attention (MLA).

The counterpart of ``repro/models/attention.py``. Over tp ranks each rank
holds H/tp query heads and its kv slots (``gqa_dims``); when kv < tp, rank
t reads logical kv head t // (tp / kv), which is the head its queries read
at tp = 1, so the ranks' attention folded together is the whole model's:
one launch over every rank's heads. On a process mesh a process computes
its own rank's heads, from its fetched slices of the projections, and
holds its kv slots in its cache (``kv_held``); the heads a layer runs are
read off the fetched weights, so the code is the same. The output projection is row-parallel,
its tp partials summed in bf16 (``parallel.row_parallel``). The same holds
for cross-attention, for the local-attention rolling cache and for MLA's
heads.
Sequence mixing is chosen per step, as in the JAX model:
  * ``masked``   — every (q-chunk, kv-chunk) block pair, causal by mask;
  * ``triangle`` — only the block pairs that meet the causal triangle;
  * ``direct``   — one block over the whole sequence;
  * ``flash``    — the port's own: self-attention prefill (causal, or the
                   encoder's non-causal) through the ``flash_attention``
                   Hopper kernel (``kernels.ops``; its plain version on the
                   CPU). It is exactly the kernel's function, so it takes
                   no window, cache or cross-attention.
``masked``/``triangle``/``direct`` repeat the JAX arithmetic: q scaled in the
compute dtype, scores from a bf16 product, p cast to v's dtype before the
P·V product. The kernel scales in fp32 and keeps p in fp32 until its own
bf16 P·V product, so ``flash`` and ``masked`` agree to bf16 rounding only.
GQA also runs cross-attention (enc-dec: k/v from the encoder's memory, no
RoPE, no mask) and the local-attention rolling window cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import CastOnce, RMSNorm, apply_rope
from repro_torch.models.parallel import COMPUTE_DTYPE, LeafPlace, ShardEnv, row_parallel

NEG_INF = -1e30
IMPLS = ("masked", "triangle", "direct", "flash")
TRAIN_IMPLS = ("masked", "triangle", "direct")  # the flash kernel has no backward


def gqa_dims(cfg: ModelConfig, env: ShardEnv | None = None):
    """(a rank's q heads, its kv slots, group, q heads per kv slot)."""
    tp = 1 if env is None else env.tp
    hq_loc = cfg.n_heads // tp
    kv_loc = max(1, cfg.n_kv_heads // tp)
    return hq_loc, kv_loc, cfg.n_heads // cfg.n_kv_heads, hq_loc // kv_loc


def kv_held(cfg: ModelConfig, env: ShardEnv | None = None) -> int:
    """The kv heads a cache holds: every logical head folded, the rank's
    slots on a process mesh."""
    if env is None or env.mesh is None or not cfg.n_kv_heads:
        return cfg.n_kv_heads
    return gqa_dims(cfg, env)[1]


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
    kc = k.reshape(b, nk, chunk_k, h, dh)
    vc = v.reshape(b, nk, chunk_k, h, dv)

    def block_mask(r0, r1, j):
        qpos = q_offset + r0 + torch.arange(r1 - r0, device=dev)
        kpos = j * chunk_k + torch.arange(chunk_k, device=dev)
        mask = (kpos[None, :] < sk).expand(r1 - r0, chunk_k)  # kv padding
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        if kv_len is not None:
            mask = mask & (kpos[None, :] < kv_len)
        return mask[None, None]

    # the JAX model's lax.scan over the block list, as a loop over kv chunks:
    # the q chunks that pair with kv chunk j (a run of them in every schedule)
    # take their (i, j) blocks as one block of rows, and each q chunk still
    # merges its blocks in ascending j, so every element sees the same
    # arithmetic in the same order
    runs: dict[int, list[int]] = {}
    for i, j in attention_pairs(nq, nk, chunk_q, chunk_k, causal=causal, window=window,
                                q_offset=q_offset, impl=impl):
        runs.setdefault(j, []).append(i)
    f32, n = torch.float32, nq * chunk_q
    # the rows' running (max, sum, output), replaced (not written in place)
    # at every merge, so that autograd can record the loop
    M = torch.full((b, h, n), NEG_INF, dtype=f32, device=dev)
    L = torch.zeros((b, h, n), dtype=f32, device=dev)
    out = torch.zeros((b, n, h, dv), dtype=f32, device=dev)
    for j in sorted(runs):
        ii = runs[j]
        if ii != list(range(ii[0], ii[-1] + 1)):
            raise ValueError(f"kv chunk {j} pairs with q chunks {ii}, not a run")
        r0, r1 = ii[0] * chunk_q, (ii[-1] + 1) * chunk_q
        m2, l2, o2 = _block(q[:, r0:r1], kc[:, j], vc[:, j], block_mask(r0, r1, j))
        m, l, o = _merge(M[..., r0:r1], L[..., r0:r1], out[:, r0:r1], m2, l2, o2)
        M, L, out = _put(M, m, r0, r1, 2), _put(L, l, r0, r1, 2), _put(out, o, r0, r1, 1)
    out = (out / torch.clamp_min(L.movedim(1, -1)[..., None], 1e-30)).to(q.dtype)
    return out[:, :sq]


def _put(t: torch.Tensor, new: torch.Tensor, r0: int, r1: int, dim: int) -> torch.Tensor:
    """``t`` with rows [r0, r1) of ``dim`` replaced by ``new``, out of place."""
    if r0 == 0 and r1 == t.shape[dim]:
        return new
    return torch.cat([t.narrow(dim, 0, r0), new, t.narrow(dim, r1, t.shape[dim] - r1)], dim)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------
class GQAAttention(CastOnce):
    """Grouped-query self-attention with QKV bias, RoPE and a KV cache.
    Parameters are laid out as the JAX leaves are (tp = 1): wq (d, H·hd),
    wk/wv (d, KV, hd), wo (H·hd, d), bq (H·hd,), bk/bv (KV, hd). ``group``:
    "attn", or "cross" for cross-attention (the leaves' keys)."""

    def __init__(self, cfg: ModelConfig, generator, device, group: str = "attn"):
        super().__init__()
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.cfg = cfg
        self.group = group
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

    def forward(self, x, *, rope=None, cache=None, cache_len=None, prefill_cache=None,
                causal=True, window=None, impl="masked", cross_kv=None, cross_cache=None,
                env: ShardEnv | None = None):
        """x (b, s, d) → (y (b, s, d), new_cache).

        ``cache``: {"k", "v"} (b, S, KV, hd), written in place at
        ``cache_len`` (decode); attention then runs over the cache up to
        ``cache_len + s``. With a ``window``, a cache of at most ``window``
        slots is a rolling one: slot ``cache_len % S`` takes the new k/v and
        attention runs over every filled slot without a mask, as the JAX
        model's rolling write does. ``prefill_cache``: a cache of the same
        form whose first slots take this prompt's k/v in place (with a
        ``window``, its last ``window`` positions), while attention runs
        over the fresh k/v (what the JAX model's ``want_cache`` prefill
        computes, without a second copy of the cache). With neither, no
        cache is kept (``new_cache`` is None). ``rope``: (cos, sin) for the
        q positions. Cross-attention: ``cross_kv`` (b, s_enc, d), the memory
        that k/v are projected from (into ``prefill_cache`` when given), or
        ``cross_cache``, k/v built at prefill. ``env``: the tp ranks, whose
        output projection partials are summed; folded, the cache is held
        once with the logical kv heads, on a process mesh it holds the
        rank's kv slots."""
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.hd
        cross = cross_kv is not None or cross_cache is not None
        q = torch.matmul(x, self.fetch("wq", env).to(x.dtype))
        if cfg.qkv_bias:
            q = q + self.fetch("bq", env).to(x.dtype)
        hq = q.shape[-1] // hd  # the heads held: all of them folded, the rank's on processes
        q = q.view(b, s, hq, hd)

        new_cache = None
        kv_valid = None
        q_offset = 0
        if cross_cache is not None:
            k_all, v_all = cross_cache["k"], cross_cache["v"]
            new_cache = cross_cache
        else:
            src = cross_kv if cross else x
            sk = src.shape[1]
            wk = self.fetch("wk", env).to(src.dtype).flatten(1)
            wv = self.fetch("wv", env).to(src.dtype).flatten(1)
            k = torch.matmul(src, wk).view(b, sk, -1, hd)  # the kv slots held
            v = torch.matmul(src, wv).view(b, sk, -1, hd)
            if cfg.qkv_bias:
                k = k + self.fetch("bk", env).to(x.dtype)
                v = v + self.fetch("bv", env).to(x.dtype)
            if not cross:
                cos, sin = rope
                q = apply_rope(q, cos, sin)
                k = apply_rope(k, cos, sin)
            if cache is not None:
                ck, cv = cache["k"], cache["v"]
                n_slots = ck.shape[1]
                if window is not None and n_slots <= window:
                    # rolling window: slots are not in position order, so the
                    # rolling write itself keeps causality and the window
                    at = cache_len % n_slots
                    kv_valid = min(cache_len + s, n_slots)
                    window, causal = None, False
                else:
                    at = cache_len
                    kv_valid = cache_len + s
                ck[:, at:at + s] = k.to(ck.dtype)
                cv[:, at:at + s] = v.to(cv.dtype)
                new_cache = cache
                k_all, v_all = ck, cv
                q_offset = cache_len
            else:
                if prefill_cache is not None:
                    keep = sk if window is None else min(sk, window)
                    prefill_cache["k"][:, :keep] = k[:, sk - keep:].to(prefill_cache["k"].dtype)
                    prefill_cache["v"][:, :keep] = v[:, sk - keep:].to(prefill_cache["v"].dtype)
                    new_cache = prefill_cache
                k_all, v_all = k, v
        if cross:
            window, causal = None, False

        rep_q = hq // k_all.shape[2]  # q heads per kv slot
        cd = COMPUTE_DTYPE
        if impl == "flash":
            if cache is not None or cross or window is not None:
                raise ValueError("impl='flash' runs self-attention prefill only (causal, or the "
                                 "encoder's non-causal; no window, cache or cross-attention)")
            # the kernel reads the (b, s, h, d) tensors through strides, and kv
            # head i // rep_q directly: no transposed or repeated copy
            y = ops.flash_attention(q.to(cd).transpose(1, 2), k_all.to(cd).transpose(1, 2),
                                    v_all.to(cd).transpose(1, 2), causal=causal).transpose(1, 2)
        else:
            if rep_q > 1:  # expand kv slots to per-q-head (a copy: skipped when 1:1)
                k_all = torch.repeat_interleave(k_all, rep_q, dim=2)
                v_all = torch.repeat_interleave(v_all, rep_q, dim=2)
            y = chunked_attention(q.to(cd), k_all.to(cd), v_all.to(cd),
                                  scale=1.0 / math.sqrt(hd), causal=causal, q_offset=q_offset,
                                  window=window, impl=impl, kv_len=kv_valid)
        y = y.reshape(b, s, hq * hd)
        return row_parallel(y, self.fetch("wo", env), env), new_cache


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-style multi-head latent attention)
# ---------------------------------------------------------------------------
class MLAAttention(CastOnce):
    """Multi-head latent attention with a latent cache {"c_kv" (b, S,
    kv_lora_rank), "k_rope" (b, S, qk_rope_head_dim)}. Parameters as the
    JAX leaves: wq_a (d, q_lora), q_norm (q_lora,), wq_b (q_lora, H·(dn +
    dr)), wkv_a (d, dc + dr), kv_norm (dc,), wkv_b (dc, H·(dn + dv)), wo
    (H·dv, d). Prefill expands the latent into per-head k/v and runs the
    chunked attention in bf16; decode absorbs W_UK into q and attends in the
    latent space, in fp32 from the fp32 ``wkv_b``, as ``mla_apply`` does."""

    compute = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")
    group = "attn"

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        m = cfg.mla
        d, H = cfg.d_model, cfg.n_heads
        whole = LeafPlace(None, None, 0)  # the latent norms: neither FSDP nor TP sharded
        self.cfg = cfg
        self.wq_a = self.param((d, m.q_lora_rank), "normal", generator, device)
        self.q_norm = RMSNorm(m.q_lora_rank, cfg.norm_eps, generator, device, whole)
        self.wq_b = self.param((m.q_lora_rank, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                               "normal", generator, device)
        self.wkv_a = self.param((d, m.kv_lora_rank + m.qk_rope_head_dim), "normal", generator,
                                device)
        self.kv_norm = RMSNorm(m.kv_lora_rank, cfg.norm_eps, generator, device, whole)
        self.wkv_b = self.param((m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)),
                                "normal", generator, device)
        self.wo = self.param((H * m.v_head_dim, d), "normal", generator, device)

    def forward(self, x, *, rope, cache=None, cache_len=None, prefill_cache=None,
                impl="masked", env: ShardEnv | None = None):
        """x (b, s, d) → (y (b, s, d), new_cache). ``cache``, ``cache_len``
        and ``prefill_cache`` as for ``GQAAttention``, over the latent cache;
        ``impl`` is the prefill's chunked attention (the kernel takes no
        96/64 head dims). ``env``: the tp ranks, each with H/tp heads. Their
        q and kv up-projections (``wq_b``, ``wkv_b``) are column-parallel
        and their attention is per head, so folded these are the tp = 1
        computation; the output projection is row-parallel, its partials
        summed. Every weight comes through ``fetch`` (on a process mesh the
        rank's heads' slices, the decode's ``wkv_b`` gathered in fp32) and
        the heads are read off the fetched ``wq_b``. The latent cache, which
        every rank holds alike, is held once folded and by every process for
        its rows."""
        m = self.cfg.mla
        b, s, _ = x.shape
        dn, dr, dv, dc = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
        cos, sin = rope
        q = self.q_norm(x @ self.fetch("wq_a", env), env) @ self.fetch("wq_b", env)
        H = q.shape[-1] // (dn + dr)  # the heads held: all of them folded, the rank's on processes
        q = q.view(b, s, H, dn + dr)
        q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
        kv_a = x @ self.fetch("wkv_a", env)
        c_kv = self.kv_norm(kv_a[..., :dc], env)
        k_rope = apply_rope(kv_a[..., dc:][:, :, None, :], cos, sin)[:, :, 0]  # one shared head

        new_cache = None
        if cache is not None:  # decode: absorbed attention in the latent space, fp32
            cc, cr = cache["c_kv"], cache["k_rope"]
            cc[:, cache_len:cache_len + s] = c_kv.to(cc.dtype)
            cr[:, cache_len:cache_len + s] = k_rope.to(cr.dtype)
            new_cache = cache
            f32 = torch.float32
            w_kb = self.fetch("wkv_b", env, stored=True).to(f32).view(dc, H, dn + dv)
            q_abs = torch.einsum("bshn,chn->bshc", q_nope.to(f32), w_kb[..., :dn])
            sc = torch.einsum("bshc,bSc->bhsS", q_abs, cc.to(f32))
            sc = sc + torch.einsum("bshr,bSr->bhsS", q_rope.to(f32), cr.to(f32))
            sc = sc / math.sqrt(dn + dr)
            valid = torch.arange(cc.shape[1], device=x.device) < cache_len + s
            w = torch.softmax(torch.where(valid, sc, NEG_INF), dim=-1)
            ctx = torch.einsum("bhsS,bSc->bshc", w, cc.to(f32))
            y = torch.einsum("bshc,chv->bshv", ctx, w_kb[..., dn:])
        else:  # prefill: expand the latent and run the chunked attention
            w_kb = self.fetch("wkv_b", env).view(dc, H, dn + dv)
            k_nope = torch.einsum("bsc,chn->bshn", c_kv, w_kb[..., :dn])
            v = torch.einsum("bsc,chv->bshv", c_kv, w_kb[..., dn:])
            k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, H, dr)], dim=-1)
            cd = COMPUTE_DTYPE
            y = chunked_attention(torch.cat([q_nope, q_rope], dim=-1).to(cd), k.to(cd),
                                  v.to(cd), scale=1.0 / math.sqrt(dn + dr), causal=True,
                                  impl=impl)
            if prefill_cache is not None:
                prefill_cache["c_kv"][:, :s] = c_kv.to(prefill_cache["c_kv"].dtype)
                prefill_cache["k_rope"][:, :s] = k_rope.to(prefill_cache["k_rope"].dtype)
                new_cache = prefill_cache
        y = y.reshape(b, s, H * dv).to(x.dtype)
        return row_parallel(y, self.fetch("wo", env), env), new_cache
