"""Mixture-of-Experts: token → expert dispatch as the word count's map →
shuffle → reduce.

The counterpart of ``repro/models/moe.py``. The router is the mapper's
hash, the shuffle brings each expert's tokens together, and the
gate-weighted combine is the reducer: ``kernels.ops.segment_reduce`` sums the
weighted expert rows into their tokens (the CUDA reducer on the card, its
plain version on the CPU).

Three routes compute it:
  * ``replicated`` (decode): ``moe_apply_replicated``, every expert on every
    token, weighted by its gate where chosen. Over tp ranks each rank
    applies its own expert slots (when n_experts < tp, the replicas of an
    expert split the tokens by index parity) and ``psum_tp`` adds the
    ranks' outputs, so every (token, expert) product enters the sum once:
    folded, the port holds every expert and sums over them at once.
  * ``dispatched`` (prefill at tp = 1, or when the sequence does not split
    over tp): the same function dropless, each expert on its own tokens.
  * ``a2a`` (prefill over tp ranks): ``moe_apply_a2a``, the paper's shuffle
    inside the model. Each rank routes its slice of the sequence, places
    each assignment in its destination rank's buffer of ``cap`` rows by a
    stable sort (assignments over capacity are dropped, as in the
    reference, bitwise), and three ``all_to_all``s over the tp groups of
    a world-dim ``Mesh`` send the rows, their expert slots, and the results
    back; the combine at the source runs every rank's assignments through
    one ``segment_reduce`` (segment ids offset by rank × tokens), and the
    tp group's all-gather of the sequence is a relabelling of the result,
    held once.
On a process mesh a process holds its device's expert slots and its rows:
the a2a routes its rank's slice of the sequence, the ``all_to_all``s are
calls into the tp group's process group, and the tp group's all-gather of
the sequence is one (differentiable: the inverse all-to-all and a
reduce-scatter in the backward); the replicated route runs the rank's
slots.
The routes sum the experts' outputs in fp32 where the JAX model adds each
expert's bf16 contribution to a bf16 total, so they agree with it to bf16
rounding, and the kernel's fp32 atomics make the last bits depend on their
order.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import CastOnce, act_fn
from repro_torch.models.parallel import (ShardEnv, all_gather, all_to_all, serve_col_matmul,
                                         serve_row_matmul, tp_groups)


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
    group = "moe"

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        self.cfg = cfg
        self.router = self.param((d, m.n_experts), "normal", generator, device)
        self.wi_gate = self.param((m.n_experts, d, m.d_expert), "normal", generator, device)
        self.wi_up = self.param((m.n_experts, d, m.d_expert), "normal", generator, device)
        self.wo = self.param((m.n_experts, m.d_expert, d), "normal", generator, device)

    def probs(self, x: torch.Tensor, router: torch.Tensor | None = None) -> torch.Tensor:
        """x (n, d) → the router's fp32 softmax (n, E); ``router``: the
        fetched (d, E) (the parameter by default)."""
        router = self.router if router is None else router
        return torch.softmax(x.to(torch.float32) @ router.to(torch.float32), dim=-1)

    def route(self, x: torch.Tensor, *, router: torch.Tensor | None = None):
        """x (n, d) → (gates (n, k) in x's dtype, experts (n, k) int64):
        ``_router``'s fp32 softmax, top-k and renormalisation. ``router``:
        the fetched router (a process mesh holds its FSDP shard)."""
        gates, experts = torch.topk(self.probs(x, router), self.cfg.moe.top_k, dim=-1)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return gates.to(x.dtype), experts

    def aux_loss(self, x: torch.Tensor, router: torch.Tensor | None = None) -> torch.Tensor:
        """``_router``'s third output, the switch-style load-balance loss of
        tokens x (n, d): E · Σ_e mean(probs)_e · count_e / (n·k) ·
        ``router_aux_weight``, fp32. The counts of top-k choices carry no
        gradient; the mean probabilities do. Training adds it to the loss;
        serving does not compute it. ``router``: as ``probs`` takes it."""
        m = self.cfg.moe
        probs = self.probs(x, router)
        experts = torch.topk(probs, m.top_k, dim=-1).indices.reshape(-1)
        ce = expert_counts(experts, m.n_experts).to(torch.float32) / max(1, experts.numel())
        return m.n_experts * torch.sum(probs.mean(0) * ce) * m.router_aux_weight

    def a2a_route(self, s: int, env: ShardEnv | None, decode: bool = False) -> bool:
        """Does a forward of sequence length ``s`` under ``env`` take the
        all-to-all dispatch (prefill and training over tp ranks, the
        sequence split over them)?"""
        tp = 1 if env is None else env.tp
        return not decode and tp > 1 and s % tp == 0 and self.cfg.moe.dispatch == "a2a"

    def rank_aux_loss(self, h: torch.Tensor, env: ShardEnv | None = None) -> torch.Tensor:
        """The load-balance loss of a training forward on h (b, s, d), as the
        mean over the tp ranks of each rank's own: on the all-to-all route
        rank t routes its slice t of the sequence (every row's) and balances
        it alone, elsewhere every rank routes every token. On a process mesh,
        this rank's own (the objective sums the devices' losses)."""
        b, s, d = h.shape
        procs = env is not None and env.mesh is not None
        router = self.fetch("router", env) if procs else None
        if not self.a2a_route(s, env):
            return self.aux_loss(h.reshape(-1, d), router)
        tp = env.tp
        parts = h.unflatten(1, (tp, s // tp)).movedim(1, 0)
        if procs:
            return self.aux_loss(parts[env.tp_index].reshape(-1, d), router)
        return sum(self.aux_loss(p, router) for p in parts.reshape(tp, -1, d)) / tp

    def expert(self, x: torch.Tensor, w: tuple[torch.Tensor, ...], e: int,
               env: ShardEnv | None = None) -> torch.Tensor:
        """Expert slot ``e``'s gated MLP on rows x (m, d), bf16; ``w``: the bf16
        (wi_gate, wi_up, wo) of the slots held (``weights``).
        ``env.compute_at_data`` over an fsdp world: the products at the
        weights' d-slices (on a process mesh ``w`` holds this rank's)."""
        wg, wu, wo = w
        if env is not None and env.compute_at_data and env.fsdp_size > 1:
            g, u = serve_col_matmul(x, wg[e], env), serve_col_matmul(x, wu[e], env)
            if env.mesh is not None:
                return serve_row_matmul(act_fn(self.cfg.act)(g) * u, wo[e], env, at_data=True)[0]
        else:
            g, u = x @ wg[e], x @ wu[e]
        return (act_fn(self.cfg.act)(g) * u) @ wo[e]

    def weights(self, env: ShardEnv | None = None, *, fsdp: bool = True
                ) -> tuple[torch.Tensor, ...]:
        """The bf16 (wi_gate, wi_up, wo) of the expert slots held: every
        expert folded, the rank's slots on a process mesh (``fsdp=False``:
        their d-slices, to compute at data)."""
        return (self.fetch("wi_gate", env, fsdp=fsdp), self.fetch("wi_up", env, fsdp=fsdp),
                self.fetch("wo", env, fsdp=fsdp))

    def forward(self, x: torch.Tensor, *, decode: bool = False,
                env: ShardEnv | None = None) -> torch.Tensor:
        """x (b, s, d) bf16 → (b, s, d): replicated (``decode``), over the
        tp groups' all-to-all (prefill over tp ranks when the sequence
        splits over them), or dispatched dropless. On a process mesh every
        route but the all-to-all is the replicated one, as the reference's."""
        b, s, d = x.shape
        if self.a2a_route(s, env, decode):
            return self.a2a(x, env)[0]
        flat = x.reshape(-1, d)
        gates, experts = self.route(flat, router=self.fetch("router", env))
        if decode or (env is not None and env.mesh is not None):
            out = self.replicated(flat, gates, experts, env)
        else:
            out = self.dispatched(flat, gates, experts, env)
        return out.reshape(b, s, d)

    def held_experts(self, env: ShardEnv | None, device) -> torch.Tensor:
        """The expert ids of the slots held, int64: every expert folded; on a
        process mesh the rank's slots (one replica's expert where
        n_experts < tp)."""
        m = self.cfg.moe
        if env is None or env.mesh is None:
            return torch.arange(m.n_experts, device=device)
        e_loc, span = max(1, m.n_experts // env.tp), max(1, env.tp // m.n_experts)
        if m.n_experts % env.tp:
            return torch.full((1,), env.tp_index // span, device=device)
        return env.tp_index * e_loc + torch.arange(e_loc, device=device)

    def replicated(self, flat, gates, experts, env: ShardEnv | None = None) -> torch.Tensor:
        """``moe_apply_replicated``: every expert slot held on every token,
        weighted by its gate where chosen (0 elsewhere), the slots' outputs
        summed in fp32 and the tp ranks' sums added by ``psum_tp``, rounded
        to bf16 once (where the JAX model adds in bf16). Folded, every
        expert is held and its replicas' halves of the tokens are one
        product; on a process mesh the rank's slots, and where n_experts <
        tp its replica t % span takes the tokens of index t % span. The
        slots run as one batched product per weight (a few tokens at decode:
        a loop's launches would set the step's time), or with
        ``env.compute_at_data`` over an fsdp world at the weights' d-slices
        (``expert``)."""
        ids = self.held_experts(env, flat.device)
        gw = torch.where(experts[None] == ids[:, None, None], gates.to(torch.float32)[None],
                         0.0).sum(-1)  # (slots, n)
        procs = env is not None and env.mesh is not None
        span = 1 if env is None else max(1, env.tp // self.cfg.moe.n_experts)
        if procs and span > 1:
            t = env.tp_index
            gw = gw * ((torch.arange(flat.shape[0], device=flat.device) % span) == t % span)
        cad = env is not None and env.compute_at_data and env.fsdp_size > 1
        w = self.weights(env, fsdp=not cad)
        if cad and procs:
            y = torch.stack([self.expert(flat, w, i, env) for i in range(ids.numel())])
        elif cad:
            y = self.folded_at_data(flat, w, env)
        else:
            g, u = torch.einsum("nd,edf->enf", flat, w[0]), torch.einsum("nd,edf->enf", flat, w[1])
            y = torch.bmm(act_fn(self.cfg.act)(g) * u, w[2])  # (slots, n, d)
        out = torch.sum(y * gw[..., None].to(y.dtype), 0, dtype=torch.float32)
        if env is None or env.tp == 1:
            return out.to(flat.dtype)
        return env.psum_tp(out[None]).to(flat.dtype)

    def folded_at_data(self, flat, w, env: ShardEnv) -> torch.Tensor:
        """Every expert's gated MLP on every token at the weights' d-slices,
        folded: each fsdp d-slice's bf16 partials of the column products,
        summed, then the row product. Noted as what the devices' slots move
        at data (``expert`` on a process mesh): every device's tokens × its
        slots, each through an all-to-all of the rows, the two column
        products' reduce-scatters and the row product's gather and
        all-to-all."""
        n = env.fsdp_size
        wg, wu, wo = w
        xs, cols = flat.unflatten(-1, (n, -1)), "njd,ejdf->jenf"
        g = torch.einsum(cols, xs, wg.unflatten(1, (n, -1))).sum(0)
        u = torch.einsum(cols, xs, wu.unflatten(1, (n, -1))).sum(0)
        m, d = self.cfg.moe, flat.shape[-1]
        rows = flat.shape[0] * env.tp * max(1, m.n_experts // env.tp)
        env._note("all-to-all", rows * d * 2 * 3)
        env._note("reduce-scatter", rows * m.d_expert * 2 * 2)
        env._note("all-gather", rows * n * m.d_expert * 2)
        return torch.bmm(act_fn(self.cfg.act)(g) * u, wo)

    def grouped(self, rows: torch.Tensor, sizes: list[int], w: tuple[torch.Tensor, ...],
                env: ShardEnv | None = None) -> torch.Tensor:
        """Rows (m, d) sorted by expert slot, ``sizes[e]`` of them for slot
        e of ``w`` (``weights``; past its slots, rows for none, which give
        zeros) → each row through its expert, in the same order."""
        parts, start = [], 0
        for e, size in enumerate(sizes):
            if size:
                sl = rows[start:start + size]
                parts.append(self.expert(sl, w, e, env) if e < w[0].shape[0]
                             else torch.zeros_like(sl))
                start += size
        return torch.cat(parts) if parts else rows[:0]

    def dispatched(self, flat, gates, experts, env: ShardEnv | None = None) -> torch.Tensor:
        """Map: the router's (token, expert) pairs. Shuffle: a stable sort by
        expert puts each expert's rows together. Reduce: each row's expert
        output times its gate, summed into its token by ``segment_reduce``
        (differentiable: its gradient gathers each token's gradient back to
        its rows). The group sizes reach the host (one sync) to slice the
        sorted rows."""
        n, k = experts.shape
        order = torch.argsort(experts.reshape(-1), stable=True)
        tok = torch.div(order, k, rounding_mode="floor")
        y = self.grouped(flat[tok], group_sizes(experts, self.cfg.moe.n_experts),
                         self.weights(env), env)
        y = y * gates.reshape(-1)[order, None]
        return ops.segment_reduce(y, tok.to(torch.int32), n).to(flat.dtype)

    def a2a(self, x: torch.Tensor, env: ShardEnv, route=None):
        """``moe_apply_a2a`` over the tp groups. x (R, s, d) bf16: the rows
        held once (``ShardEnv.row_groups``), or on a process mesh the rank's
        rows; s divisible by tp. ``route``: (gates, experts) (R·s, k) in x's
        row order to replay (on a process mesh the rank's (b·s/tp, k), its
        slice of the sequence), else the router's. Returns (out (R, s, d),
        {"keep": whether each assignment fitted in its destination's
        capacity, (R, s, k) bool (a process mesh: the rank's slice,
        (b, s/tp, k)); "send_meta": (*ranks, tp, cap, 2) int32, the (expert
        slot + 1, token) of each row a rank sends, 0 where empty, with the
        ranks laid out as the world dims (data, model) of the rows' distinct
        groups (a process mesh: its block)})."""
        m = self.cfg.moe
        tp, n_exp, k = env.tp, m.n_experts, m.top_k
        R, s, d = x.shape
        s_loc, dev = s // tp, x.device
        e_loc, span = max(1, n_exp // tp), max(1, tp // n_exp)
        procs = env.mesh is not None
        if procs:  # this rank: its rows' slice t of the sequence
            mesh, groups, lead = env.mesh, env.tp_groups, env.mesh.block
            n, trank = R * s_loc, torch.full(lead + (1, 1), env.tp_index, device=dev)

            def per_rank(t):
                t = t.unflatten(1, (tp, s_loc)).select(1, env.tp_index)
                return t.reshape(lead + (n,) + t.shape[2:])
        else:  # every rank of the rows' distinct groups, as world dims
            rep, b_loc = env.row_groups(R)
            # the data ranks, the model-axis width, tokens a rank
            D, mw, n = R // (rep * b_loc), tp * rep, b_loc * s // tp
            lead, groups = (D, mw), tp_groups(tp, rep)
            mesh = Mesh((env.data_axis, env.model_axis), lead, device=dev)
            trank = (mesh.axis_index(env.model_axis) // rep)[..., None, None]

            def per_rank(t):  # rows (R, s, ...) → rank (d, t·rep + r) takes slice t of group (d, r)
                t = t.reshape((D, rep, b_loc, tp, s_loc) + t.shape[2:])
                t = t.permute(0, 3, 1, 2, 4, *range(5, t.dim()))
                return t.reshape(lead + (n,) + t.shape[5:])
        ranks = math.prod(lead)
        tok = per_rank(x)  # (*lead, n, d)
        if route is not None:
            gates, experts = (r.reshape(lead + (n * k,)) if procs else
                              per_rank(r.reshape(R, s, k)).reshape(lead + (n * k,)) for r in route)
        elif procs:
            gates, experts = self.route(tok.reshape(-1, d), router=self.fetch("router", env))
            gates, experts = gates.reshape(lead + (n * k,)), experts.reshape(lead + (n * k,))
        else:
            gates, experts = self.route(x.reshape(-1, d), router=self.fetch("router", env))
            gates = per_rank(gates.reshape(R, s, k)).reshape(lead + (n * k,))
            experts = per_rank(experts.reshape(R, s, k)).reshape(lead + (n * k,))
        cap = int(-(-n * k * m.capacity_factor // tp))  # per-destination-rank capacity
        tok_id = torch.arange(n, device=dev).repeat_interleave(k)  # (n·k,)
        if n_exp % tp == 0:
            dst, e_slot = experts // e_loc, experts % e_loc
        else:  # the replica by token parity
            dst, e_slot = experts * span + tok_id % span, torch.zeros_like(experts)
        # position within the destination: a stable sort by dst, rank within its run
        dst_sorted, order = torch.sort(dst, dim=-1, stable=True)
        pos_sorted = torch.arange(n * k, device=dev) - torch.searchsorted(
            dst_sorted, dst_sorted, side="left")
        pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
        keep = pos < cap
        rank = torch.arange(ranks, device=dev).view(lead + (1,))
        # the send buffers, a dump row past each rank's end for the dropped
        at = (rank * (tp * cap + 1) + torch.where(keep, dst * cap + pos, tp * cap)).reshape(-1)
        send_x = x.new_zeros((ranks * (tp * cap + 1), d))
        send_x[at] = tok[..., tok_id, :].reshape(-1, d)
        meta = torch.stack([e_slot + 1, tok_id.expand_as(e_slot)], -1).to(torch.int32)
        send_meta = torch.zeros((ranks * (tp * cap + 1), 2), dtype=torch.int32, device=dev)
        send_meta[at] = meta.reshape(-1, 2)

        def cut(t):  # (ranks · (tp·cap + 1), ...) → (*lead, tp, cap, ...), the dump rows cut
            t = t.view(lead + (tp * cap + 1,) + t.shape[1:])[..., :-1, :]
            return t.reshape(lead + (tp, cap) + t.shape[len(lead) + 1:])

        def exchange(t):  # chunk j of rank i's dim 2 → chunk i on rank j, in each tp group
            return all_to_all(t, mesh, env.model_axis, 0, 0, groups=groups)

        send_meta = cut(send_meta)
        recv_x, recv_meta = exchange(cut(send_x)), exchange(send_meta)
        # the reducers: each rank's expert slots on the rows it received, grouped
        # by slot on a process mesh (it holds its slots), by expert folded
        slot_id = recv_meta[..., 0].long() - 1  # (*lead, tp, cap); -1: empty
        w = self.weights(env)
        if procs:
            key, n_keys = slot_id, e_loc
        else:
            key = trank * e_loc + slot_id if n_exp % tp == 0 else (trank // span).expand_as(slot_id)
            n_keys = n_exp
        key = torch.where(slot_id >= 0, key, n_keys).reshape(-1)
        order = torch.argsort(key, stable=True)
        y = torch.empty_like(recv_x.reshape(-1, d))
        y[order] = self.grouped(recv_x.reshape(-1, d)[order], group_sizes(key, n_keys + 1), w, env)
        back = exchange(y.view(lead + (tp, cap, d))).reshape(ranks * tp * cap, d)
        # the combine at the source: kept rows × their gates, summed into their tokens
        src = (rank * (tp * cap) + torch.where(keep, dst * cap + pos, 0)).reshape(-1)
        contrib = back[src] * (keep * gates).reshape(-1, 1).to(back.dtype)
        seg = torch.where(keep, rank * n + tok_id, -1).reshape(-1).to(torch.int32)
        out = ops.segment_reduce(contrib, seg, ranks * n).to(x.dtype)
        if procs:  # the tp group's all-gather of the sequence
            full = all_gather(out.view(lead + (R, s_loc, d)), mesh, env.model_axis,
                              groups=groups)
            full = full.reshape(full.shape[len(lead):]).permute(1, 0, 2, 3).reshape(R, s, d)
            return full, {"keep": keep.view(R, s_loc, k), "send_meta": send_meta}

        def per_row(t):  # per_rank's inverse: the tp group's all-gather of the sequence, held once
            t = t.reshape((D, tp, rep, b_loc, s_loc) + t.shape[3:])
            return t.permute(0, 2, 3, 1, 4, *range(5, t.dim())).reshape((R, s) + t.shape[5:])

        env._note("all-gather", x.numel() * x.element_size() * tp)
        return per_row(out.view(D, mw, n, d)), {"keep": per_row(keep.view(D, mw, n, k)),
                                                "send_meta": send_meta}
