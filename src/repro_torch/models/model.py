"""Model assembly: every block kind of the LM, and its prefill and decode steps.

The counterpart of ``repro/models/model.py`` on one card. ``Model`` owns the
parameters, stored in the config's ``param_dtype`` (fp32; bf16 for
grok-1-314b), with bf16 copies of the fp32 matmul weights (``layers.
CastOnce``; a bf16 weight is its own copy). The JAX model scans a
superblock of layers (RecurrentGemma's
(rec, rec, attn_local); one layer elsewhere) over stacked parameters and
unrolls a tail; here ``Model.blocks`` is the flat list of layers in the
order they run, and ``Model.layout`` names each layer's place in the JAX
tree: ("blocks", "<pos>_<kind>", superblock) or ("tail", "<i>_<kind>",
None). Enc-dec models add ``enc_blocks`` and ``enc_norm``.

Training (``Model.train_loss``) runs the layers with autograd recording,
each layer under ``torch.utils.checkpoint`` when the config asks for remat
(the JAX model's ``jax.checkpoint``), and adds the MoE layers' load-balance
loss. A cache mirrors the JAX cache tree without its mesh dims: ``{"blocks":
{"<pos>_<kind>": {...}}, "tail": {"<i>_<kind>": {...}}}``, each block with
``attn`` ({"k", "v"}, or MLA's {"c_kv", "k_rope"}), ``cross`` ({"k", "v"}
over the encoder's memory), ``ssm`` ({"conv_x", "conv_bc", "ssm"}) or
``rec`` ({"conv", "h"}); a superblock's leaves are stacked over the
superblocks. ``init_cache`` allocates every leaf once, at its full size,
and prefill and decode write it in place.

Serving across a ``("data", "model")`` mesh takes a ``parallel.ShardEnv``
(``Model(cfg, env=...)``; the vocab is padded to a multiple of the model
axis). The rows of a batch are held once (the device-major batch's
distinct rows, ``ShardEnv.row_groups``), and so are the parameters and
caches; the tp ranks fold into the products (``parallel``), and the MoE
prefill runs the all-to-all dispatch over the tp groups. Every block kind
serves under tp > 1, the encoder of an enc-dec model included, and trains:
``train_loss`` runs one data-parallel rank's rows under its tp group
(``ShardEnv.tp_group``), folded as serving is, with autograd recording.

On a process mesh (an env whose ``mesh`` is a ``ProcessMesh``) the model is
one device's: it holds that device's shard of every parameter (the same
seeded weights as the world-dim model's, each cut to its shard as it is
drawn), its rows and a cache of its kv slots, SSM heads and RG-LRU channels,
and serves and trains every block kind through the same code at one tp rank
(``launch.steps.ProcessTrainStep``): ``train_loss`` under the process's env
reads the step's working slices (``Model.working``: the decoder's vocab
shard, the encoder's layers and ``enc_norm``, MLA's latent norms and the
RG-LRU's vectors alike), and its loss is the device's own, as the
reference's (the collectives' backward sums the devices' losses).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.mesh import resolve_device
from repro_torch.models.attention import TRAIN_IMPLS, GQAAttention, MLAAttention, kv_held
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import MLP, CastOnce, RMSNorm, cutting, mrope_angles, rope_angles
from repro_torch.models.moe import MoE
from repro_torch.models.parallel import (ONE, ShardEnv, argmax_logits, embed_lookup, logits,
                                         pad_vocab, sharded_xent)
from repro_torch.models.rglru import CONV_WIDTH, RGLRU
from repro_torch.models.ssm import SSM, ssm_dims

ATTN_KINDS = ("attn_mlp", "attn_local", "enc", "dec", "attn_moe")
KINDS = ATTN_KINDS + ("ssm", "rec")


def block_pattern(cfg: ModelConfig) -> tuple[tuple[str, ...], tuple[str, ...], int]:
    """(superblock pattern, tail pattern, n_superblocks)."""
    if cfg.pattern:
        unit = cfg.pattern
        n_sb = cfg.n_layers // len(unit)
        tail = cfg.pattern_tail
        if n_sb * len(unit) + len(tail) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: pattern does not tile {cfg.n_layers} layers")
        return unit, tail, n_sb
    if cfg.family == "ssm":
        return ("ssm",), (), cfg.n_layers
    if cfg.family == "moe":
        return ("attn_moe",), (), cfg.n_layers
    if cfg.family == "encdec":
        return ("dec",), (), cfg.n_layers
    return ("attn_mlp",), (), cfg.n_layers


def attention_impl(cfg: ModelConfig, kind: str, impl: str) -> str:
    """The prefill self-attention of a ``kind`` layer under ``impl``:
    ``flash`` only where the kernel computes the layer's function — GQA,
    causal or the encoder's non-causal, no window, a head dim in
    ``HEAD_DIMS`` — and ``masked`` elsewhere (MLA's 96/64 heads, local
    windows). Cross-attention is always chunked."""
    if impl != "flash":
        return impl
    ok = cfg.mla is None and kind != "attn_local" and cfg.hd in HEAD_DIMS
    return "flash" if ok else "masked"


class Block(nn.Module):
    """One layer of kind ``kind``; its submodules are named as the JAX
    block's subtrees (``ln1``, ``attn``, ``lnx``, ``cross``, ``ln2``,
    ``mlp``, ``moe``, ``ssm``, ``rec``)."""

    def __init__(self, kind: str, cfg: ModelConfig, generator, device):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}; the model has {KINDS}")
        need = {"attn_moe": ("moe", cfg.moe), "ssm": ("ssm", cfg.ssm)}.get(kind)
        if need is not None and need[1] is None:
            raise ValueError(f"{cfg.name}: a {kind!r} block needs cfg.{need[0]}")
        self.kind = kind
        d, eps = cfg.d_model, cfg.norm_eps
        self.ln1 = RMSNorm(d, eps, generator, device)
        if kind in ATTN_KINDS:
            self.attn = (MLAAttention if cfg.mla is not None else GQAAttention)(
                cfg, generator, device)
            if kind == "dec":
                self.lnx = RMSNorm(d, eps, generator, device)
                self.cross = GQAAttention(cfg, generator, device, group="cross")
        elif kind == "ssm":
            self.ssm = SSM(cfg, generator, device)
        else:
            self.rec = RGLRU(cfg, generator, device)
        if kind != "ssm":
            self.ln2 = RMSNorm(d, eps, generator, device)
            if kind == "attn_moe":
                self.moe = MoE(cfg, generator, device)
            else:
                self.mlp = MLP(cfg, generator, device)


def block_apply(block: Block, x: torch.Tensor, ctx: dict, cache: dict | None = None,
                prefill_cache: dict | None = None) -> torch.Tensor:
    """Apply one layer. ctx: rope, impl, cache_len (decode), enc_out (the
    encoder's memory at an enc-dec prefill), aux (training: a list that an
    MoE layer appends its load-balance loss to), env (a ``ShardEnv``).
    ``cache``: the layer's cache (decode, written in place at
    ``cache_len``); ``prefill_cache``: the layer's cache that a prefill
    fills in place."""
    kind = block.kind
    cfg = block.attn.cfg if kind in ATTN_KINDS else None
    env = ctx.get("env")

    def sub(c, name):
        return None if c is None else c[name]

    if kind in ATTN_KINDS:
        impl = attention_impl(cfg, kind, ctx["impl"])
        h = block.ln1(x, env)
        if cfg.mla is not None:
            y, _ = block.attn(h, rope=ctx["rope"], cache=sub(cache, "attn"),
                              cache_len=ctx.get("cache_len"),
                              prefill_cache=sub(prefill_cache, "attn"), impl=impl, env=env)
        else:
            y, _ = block.attn(h, rope=ctx["rope"], cache=sub(cache, "attn"),
                              cache_len=ctx.get("cache_len"),
                              prefill_cache=sub(prefill_cache, "attn"), causal=kind != "enc",
                              window=cfg.window if kind == "attn_local" else None, impl=impl,
                              env=env)
        x = x + y
        if kind == "dec":
            y, _ = block.cross(block.lnx(x, env), cross_kv=ctx.get("enc_out"),
                               cross_cache=sub(cache, "cross"),
                               prefill_cache=sub(prefill_cache, "cross"),
                               impl="masked" if impl == "flash" else impl, env=env)
            x = x + y
        h = block.ln2(x, env)
        if kind != "attn_moe":
            return x + block.mlp(h, env)
        if "aux" in ctx:
            ctx["aux"].append(block.moe.rank_aux_loss(h, env))
        return x + block.moe(h, decode=cache is not None, env=env)
    if kind == "ssm":
        return x + block.ssm(block.ln1(x, env), state=sub(cache, "ssm"),
                             prefill_state=sub(prefill_cache, "ssm"), env=env)
    x = x + block.rec(block.ln1(x, env), state=sub(cache, "rec"),
                      prefill_state=sub(prefill_cache, "rec"), env=env)
    return x + block.mlp(block.ln2(x, env), env)


def check_train_impl(impl: str) -> None:
    """Raise unless training can run sequence mixing ``impl``: ``flash`` has
    no backward (neither the kernel nor the reference's Pallas kernel)."""
    if impl not in TRAIN_IMPLS:
        raise ValueError(f"training takes impl in {TRAIN_IMPLS}, got {impl!r}"
                         + (": the flash_attention kernel has no backward"
                            if impl == "flash" else ""))


def rope_dim(cfg: ModelConfig) -> int:
    return cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.hd


def rope_for(cfg: ModelConfig, positions: torch.Tensor, dim: int):
    """positions (..., b, s), or an M-RoPE grid (..., b, s, 3) → (cos, sin)
    (..., b, s, dim/2): the tables broadcast over any leading dims (a
    device-major batch's world dims). A config without M-RoPE reads a grid's
    first (temporal) position, as the reference does."""
    if positions.dim() >= 3 and positions.shape[-1] == 3:
        if cfg.mrope_sections is not None:
            return mrope_angles(positions, dim, cfg.rope_theta, cfg.mrope_sections)
        if positions.dim() == 3:
            positions = positions[..., 0]
    return rope_angles(positions, dim, cfg.rope_theta)


def _train_block(block: Block, x: torch.Tensor, ctx: dict):
    """One layer of a training forward: (x, its load-balance loss, 0.0 for
    a layer without experts)."""
    c = dict(ctx, aux=[])
    x = block_apply(block, x, c)
    return x, sum(c["aux"], 0.0)


def _layer_view(tree: dict, i: int | None) -> dict:
    """A superblock's cache leaves at superblock ``i`` (views), or a tail
    block's as they are (``i`` None)."""
    if i is None:
        return tree
    return {k: _layer_view(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class Model(CastOnce):
    """The LM: embedding (or embeddings given as input), the layers of
    ``block_pattern``, an encoder for enc-dec configs, the final norm and a
    head tied to the embedding (or its own). Parameters are made on
    ``device`` (``None``: the card) by the init law of the JAX model
    (``common.init_tensor``: fp32) from a ``torch.Generator`` seeded with
    ``seed`` (``device="meta"``: the layout alone), then stored in the
    config's ``param_dtype``, as ``init_params`` rounds them;
    ``convert.params_from_jax`` loads the JAX model's instead. ``env``: the
    ``ShardEnv`` it serves under (a (1, 1) mesh by default); the vocab is
    padded to a multiple of its model axis. Under a process mesh's env the
    model keeps only its device's shard of each parameter, cut as the
    parameter is drawn (``layers.cutting``: ``parallel.shard_leaf``), so the
    numbers are those of the world-dim model's shards and a process holds one
    whole leaf at a time while it builds."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 env: ShardEnv | None = None):
        super().__init__()
        self.env = env = ONE if env is None else env
        device = resolve_device(device, "Model()")
        # on the meta device (shapes only, no memory) there are no numbers to draw
        gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
        self.cfg = cfg
        self.vocab_padded = pad_vocab(cfg.vocab, env.model_size)
        self.compute = ("embed",) if cfg.tie_embeddings else ("embed", "head")
        unit, tail, n_sb = block_pattern(cfg)
        self.layout = [("blocks", f"{pos}_{kind}", i) for i in range(n_sb)
                       for pos, kind in enumerate(unit)]
        self.layout += [("tail", f"{i}_{kind}", None) for i, kind in enumerate(tail)]
        with cutting(env if env.mesh is not None else None):
            self.embed = self.param((self.vocab_padded, cfg.d_model), "normal", gen, device)
            self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, gen, device)
            if not cfg.tie_embeddings:
                self.head = self.param((self.vocab_padded, cfg.d_model), "normal", gen, device)
            self.blocks = nn.ModuleList(Block(key.split("_", 1)[1], cfg, gen, device)
                                        for _, key, _ in self.layout)
            self.enc_blocks = nn.ModuleList(Block("enc", cfg, gen, device)
                                            for _ in range(cfg.enc_layers))
            if cfg.enc_layers:
                self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, gen, device)
        dtype = getattr(torch, cfg.param_dtype)
        if dtype != torch.float32:
            for p in self.parameters():
                p.data = p.data.to(dtype)
        self.cast_weights()

    @contextlib.contextmanager
    def working(self, tensors: dict):
        """Run with ``tensors`` ({parameter name: its working slice}) read
        in place of each parameter's fetch (``CastOnce.work``): a process
        train step's fp32 slices, gathered once a step, so that the
        gradients of every use add up on them."""
        mods: dict[str, dict] = {}
        for name, t in tensors.items():
            mod, _, leaf = name.rpartition(".")
            mods.setdefault(mod, {})[leaf] = t
        try:
            for mod, work in mods.items():
                self.get_submodule(mod).work = work
            yield
        finally:
            for mod in mods:
                self.get_submodule(mod).work = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def cast_weights(self) -> None:
        """Remake every bf16 weight copy from the fp32 parameters."""
        for m in self.modules():
            if isinstance(m, CastOnce):
                CastOnce.cast_weights(m)

    def head_table(self, env: ShardEnv | None = None) -> torch.Tensor:
        """The output head's bf16 table under ``env``: the held vocab rows."""
        return self.fetch("embed" if self.cfg.tie_embeddings else "head", env)

    def embed_rows(self, ids: torch.Tensor, env: ShardEnv | None = None) -> torch.Tensor:
        """bf16 embedding rows of ``ids``: gathered from the fp32 table and
        then cast while training (the JAX lookup's order, so the gradients
        of a repeated id add in fp32), from the bf16 copy otherwise, under
        ``env`` (the sharded lookup)."""
        if self.embed.requires_grad and torch.is_grad_enabled():
            return embed_lookup(ids, self.embed)
        return embed_lookup(ids, self.fetch("embed", env), env)

    def init_cache(self, batch: int, seq_max: int, enc_len: int | None = None) -> dict:
        """An empty cache for ``batch`` sequences of up to ``seq_max``
        positions (``enc_len``: the encoder's input length, enc-dec only):
        every kv head, SSM head and RG-LRU channel folded; on a process mesh
        the device's kv slots (self- and cross-attention's), SSM heads and
        RG-LRU channels (its tp rank's), and MLA's latent cache of its rows."""
        cfg = self.cfg
        kv = kv_held(cfg, self.env)
        lru = cfg.d_model // (self.env.tp // self.env.held_tp)  # the RG-LRU channels held
        if cfg.enc_layers and enc_len is None:
            raise ValueError(f"{cfg.name} is enc-dec: init_cache needs enc_len")
        dt = getattr(torch, cfg.compute_dtype)
        unit, tail, n_sb = block_pattern(cfg)

        def zeros(lead, *shape, dtype=dt):
            return torch.zeros(lead + (batch,) + shape, dtype=dtype, device=self.device)

        def block_cache(kind: str, lead: tuple) -> dict:
            if kind == "ssm":
                s = cfg.ssm
                d_in, heads = ssm_dims(cfg, self.env)
                return {"ssm": {"conv_x": zeros(lead, s.conv_width - 1, d_in),
                                "conv_bc": zeros(lead, s.conv_width - 1,
                                                 2 * s.n_groups * s.d_state),
                                "ssm": zeros(lead, heads, s.d_state, s.head_dim,
                                             dtype=torch.float32)}}
            if kind == "rec":
                return {"rec": {"conv": zeros(lead, CONV_WIDTH - 1, lru),
                                "h": zeros(lead, lru, dtype=torch.float32)}}
            if cfg.mla is not None:
                m = cfg.mla
                out = {"attn": {"c_kv": zeros(lead, seq_max, m.kv_lora_rank),
                                "k_rope": zeros(lead, seq_max, m.qk_rope_head_dim)}}
            else:
                slots = min(seq_max, cfg.window) if kind == "attn_local" else seq_max
                out = {"attn": {"k": zeros(lead, slots, kv, cfg.hd),
                                "v": zeros(lead, slots, kv, cfg.hd)}}
            if kind == "dec":
                out["cross"] = {"k": zeros(lead, enc_len, kv, cfg.hd),
                                "v": zeros(lead, enc_len, kv, cfg.hd)}
            return out

        cache = {"blocks": {f"{pos}_{kind}": block_cache(kind, (n_sb,))
                            for pos, kind in enumerate(unit)}}
        if tail:
            cache["tail"] = {f"{i}_{kind}": block_cache(kind, ()) for i, kind in enumerate(tail)}
        return cache

    def backbone(self, x: torch.Tensor, ctx: dict, caches: dict | None = None,
                 prefill_cache: dict | None = None) -> torch.Tensor:
        """Run every layer over x (b, s, d). ``caches`` (decode) is read and
        written at ``ctx["cache_len"]``; ``prefill_cache`` is filled with
        the prompt's k/v and states."""
        for block, (group, key, i) in zip(self.blocks, self.layout):
            c = None if caches is None else _layer_view(caches[group][key], i)
            pc = None if prefill_cache is None else _layer_view(prefill_cache[group][key], i)
            x = block_apply(block, x, ctx, cache=c, prefill_cache=pc)
        return x

    def stack(self, blocks, x: torch.Tensor, ctx: dict):
        """Run ``blocks`` over x without caches: (x, the sum of their
        load-balance losses). While autograd records, each layer runs under
        ``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat``: its
        activations are recomputed in the backward, with the same numbers."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = 0.0
        for block in blocks:
            if remat:
                x, a = checkpoint(_train_block, block, x, ctx, use_reentrant=False)
            else:
                x, a = _train_block(block, x, ctx)
            aux = aux + a
        return x, aux

    def encode(self, embeds: torch.Tensor, positions: torch.Tensor, impl: str,
               env: ShardEnv | None = None) -> torch.Tensor:
        """The encoder stack (enc-dec): embeds (b, s_enc, d) → memory, under
        ``env`` (tp = 1 by default)."""
        ctx = {"rope": rope_for(self.cfg, positions, rope_dim(self.cfg)), "impl": impl,
               "env": env}
        x, _ = self.stack(self.enc_blocks, embeds.to(getattr(torch, self.cfg.compute_dtype)), ctx)
        return self.enc_norm(x, env)

    def train_loss(self, batch: dict, *, impl: str = "masked", env: ShardEnv | None = None):
        """The JAX model's ``train_loss`` on one rank's batch: ``tokens`` (or
        ``embeds`` (b, s, d) for an embedding-input model) and ``labels`` (b,
        s) int (< 0: padding), optional ``positions`` ((b, s), or (b, s, 3)
        for M-RoPE), and for enc-dec ``enc_embeds``/``enc_positions``.
        ``env``: the rank's tp group (``ShardEnv.tp_group``; tp = 1 by
        default). Returns (Σ nll + the MoE layers' load-balance loss,
        {"nll_sum", "ntok"}): the mean over the tp ranks of each rank's own
        loss, which differ only where the MoE's all-to-all route has each
        rank route (and balance) its slice of the sequence. Under a process
        mesh's env (inside ``Model.working``), this device's own loss on its
        rows, at its tp rank. Autograd records
        it once the parameters require grad. ``impl`` is the sequence mixing;
        ``flash`` raises: neither the ``flash_attention`` kernel nor the
        reference's Pallas kernel has a backward."""
        check_train_impl(impl)
        cfg = self.cfg
        env = ONE if env is None else env
        procs = env.mesh is not None
        if not procs and (env.fsdp_size != 1 or env.rep != 1):
            raise ValueError(f"train_loss runs one rank's rows under its tp group, got {env}: "
                             "pass env.tp_group()")
        if procs and self.work is None:
            raise ValueError("train_loss on a process mesh reads the step's working slices: "
                             "run it inside Model.working (launch.steps.ProcessTrainStep)")
        if self.vocab_padded % env.tp:
            raise ValueError(f"the model's vocab of {self.vocab_padded} rows does not split over "
                             f"tp {env.tp}: make it with Model(cfg, env=...) on the mesh")
        if cfg.embed_input and not cfg.enc_layers:
            x = batch["embeds"].to(getattr(torch, cfg.compute_dtype))
        elif procs:  # the fp32 working vocab shard, then the psum over the tp group
            x = embed_lookup(batch["tokens"], self.work["embed"], env)
        else:  # enc-dec: the decoder reads tokens
            x = self.embed_rows(batch["tokens"])
        b, s = x.shape[:2]
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(s, device=x.device)[None].expand(b, s)
        ctx = {"rope": rope_for(cfg, pos, rope_dim(cfg)), "impl": impl, "env": env}
        if cfg.enc_layers:
            ctx["enc_out"] = self.encode(batch["enc_embeds"], batch["enc_positions"], impl, env)
        x, aux = self.stack(self.blocks, x, ctx)
        head = "embed" if cfg.tie_embeddings else "head"
        head = self.work[head] if procs else getattr(self, head)
        labels = batch["labels"]
        nll = sharded_xent(self.final_norm(x), head, labels, cfg.vocab, env)
        nll_sum = nll.sum()
        return nll_sum + aux, {"nll_sum": nll_sum.detach(), "ntok": (labels >= 0).sum()}

    def prefill_hidden(self, batch, *, impl: str = "masked", cache: dict | None = None,
                       env: ShardEnv | None = None) -> tuple[dict, torch.Tensor]:
        """Fill a cache from a prompt batch. ``batch``: prompt tokens (b, s),
        or a dict as the JAX model's prefill takes it: ``tokens``, or
        ``embeds`` (b, s, d) for an embedding-input model, with optional
        ``positions`` ((b, s), or (b, s, 3) for M-RoPE), and for enc-dec
        ``enc_embeds`` (b, s_enc, d) and ``enc_positions`` (b, s_enc).
        Returns (cache, final-normed hidden state at the last prompt
        position (b, d)). ``cache`` may be longer than s (room for
        decoding); it is filled in place, and one of length s is made when
        none is given. ``env``: the ``ShardEnv`` to run under (the model's by
        default); the rows are those it holds once."""
        cfg = self.cfg
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        env = env or self.env
        if cfg.embed_input and not cfg.enc_layers:
            x = batch["embeds"].to(getattr(torch, cfg.compute_dtype))
        else:  # enc-dec: the decoder reads tokens
            x = self.embed_rows(batch["tokens"], env)
        b, s = x.shape[:2]
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(s, device=x.device)[None].expand(b, s)
        ctx = {"rope": rope_for(cfg, pos, rope_dim(cfg)), "impl": impl, "env": env}
        enc_len = None
        if cfg.enc_layers:
            ctx["enc_out"] = self.encode(batch["enc_embeds"], batch["enc_positions"], impl,
                                         ctx["env"])
            enc_len = ctx["enc_out"].shape[1]
        if cache is None:
            cache = self.init_cache(b, s, enc_len=enc_len)
        x = self.backbone(x, ctx, prefill_cache=cache)
        return cache, self.final_norm(x[:, -1], env)

    def decode_hidden(self, cache: dict, tokens: torch.Tensor, cache_len: int,
                      env: ShardEnv | None = None) -> torch.Tensor:
        """One-token decode: tokens (b,) at position ``cache_len``, written
        into the cache in place, under ``env`` (the model's by default).
        Returns the final-normed hidden state (b, d)."""
        cfg = self.cfg
        env = env or self.env
        x = self.embed_rows(tokens[:, None], env)  # (b, 1, d)
        shape = (x.shape[0], 1, 3) if cfg.mrope_sections is not None else (x.shape[0], 1)
        pos = torch.full(shape, cache_len, device=x.device)
        ctx = {"rope": rope_for(cfg, pos, rope_dim(cfg)), "impl": "masked",
               "cache_len": cache_len, "env": env}
        return self.final_norm(self.backbone(x, ctx, caches=cache)[:, 0], env)

    def logits(self, h: torch.Tensor, env: ShardEnv | None = None) -> torch.Tensor:
        """fp32 logits over the padded vocab, padding at -inf (on a process
        mesh, over the rank's vocab shard; ``env``: the model's by default)."""
        env = env or self.env
        return logits(h, self.head_table(env), self.cfg.vocab, env)

    def greedy(self, h: torch.Tensor, env: ShardEnv | None = None) -> torch.Tensor:
        """The greedy next token (b,) int32 under ``env`` (the model's by default)."""
        env = env or self.env
        return argmax_logits(h, self.head_table(env), self.cfg.vocab, env)


def prefill(model: Model, batch, *, impl: str = "masked", cache: dict | None = None,
            env: ShardEnv | None = None) -> tuple[dict, torch.Tensor]:
    """Fill caches from a prompt batch (see ``Model.prefill_hidden``).
    Returns (cache, next tokens (b,) int32)."""
    cache, h = model.prefill_hidden(batch, impl=impl, cache=cache, env=env)
    return cache, model.greedy(h, env)


def decode_step(model: Model, cache: dict, tokens: torch.Tensor, cache_len: int,
                env: ShardEnv | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode: tokens (b,) at position ``cache_len``, written into
    the cache in place. Returns (next tokens (b,) int32, cache)."""
    return model.greedy(model.decode_hidden(cache, tokens, int(cache_len), env), env), cache
