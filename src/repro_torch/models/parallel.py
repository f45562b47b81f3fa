"""The single-device part of ``repro/models/parallel.py``, and its data world.

On one card tp = 1: a column- or row-parallel product is one bf16 matmul,
the vocab is padded to a multiple of 1, and the sharded embedding, logits,
cross-entropy and argmax see the whole vocab. Training runs a data world of
W ranks as the world dims of a ``Mesh`` on the card (``("data",)``, or
``("pod", "data")``): ``local_batch``/``loss_normalizer`` are ``ShardEnv``'s,
and ``fsdp_aggregate`` is the backward of ``scenario_all_gather``
(``_sag_bwd``), the paper's S1/S2/S3 gradient aggregation. The TP and rep
groups and the compute-at-data variants wait until the port runs across
cards.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.scenarios import Scenario
from repro_torch.mesh import Mesh, note_collective

COMPUTE_DTYPE = torch.bfloat16


def col_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) in bf16, bf16 out."""
    return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))


# x (..., f) @ w (f, d) in bf16: the psum over a tp group of one is the identity
row_parallel = col_parallel


def pad_vocab(vocab: int, model_size: int = 1) -> int:
    return ((vocab + model_size - 1) // model_size) * model_size


def embed_lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ids (...) int → (..., d) bf16 rows of ``table`` (V_pad, d); ids
    outside ``[0, V_pad)`` give zero rows, as the sharded lookup does."""
    per = table.shape[0]
    ok = (ids >= 0) & (ids < per)
    emb = table[ids.clamp(0, per - 1).long()]
    return torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                       device=emb.device)).to(COMPUTE_DTYPE)


def logits(x: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """x (..., d) → fp32 logits (..., V_pad) from a bf16 product with the
    tied table, vocab padding columns set to -inf."""
    out = torch.matmul(x.to(COMPUTE_DTYPE), table.to(COMPUTE_DTYPE).t()).to(torch.float32)
    if out.shape[-1] > vocab:
        out[..., vocab:] = float("-inf")
    return out


def argmax_logits(x: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy next token (..., ) int32 over the vocab; ties go to the
    smallest index (``torch.argmax`` returns the first maximum)."""
    return torch.argmax(logits(x, table, vocab), dim=-1).to(torch.int32)


def sharded_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``sharded_xent`` at tp = 1: per-position nll (...) in fp32 of labels
    under the logits of x (..., d) against ``table`` (V_pad, d), from a bf16
    product: vocab-padding columns at -inf, a max stabiliser that carries no
    gradient, and labels < 0 (padding) at 0 loss."""
    lg = torch.matmul(x.to(COMPUTE_DTYPE), table.to(COMPUTE_DTYPE).t()).to(torch.float32)
    per = lg.shape[-1]
    col = torch.arange(per, device=lg.device)
    lg = torch.where(col < vocab, lg, float("-inf"))
    mx = torch.amax(lg, dim=-1).detach()
    lse = torch.log(torch.sum(torch.exp(lg - mx[..., None]), dim=-1)) + mx
    ok = (labels >= 0) & (labels < per)
    tl = torch.gather(lg, -1, labels.clamp(0, per - 1).long()[..., None])[..., 0]
    nll = lse - torch.where(ok, tl, 0.0)
    return torch.where(labels >= 0, nll, 0.0)


# ---------------------------------------------------------------------------
# the data world (tp = 1): batch split and the scenario-selected aggregation
# ---------------------------------------------------------------------------
def local_batch(global_batch: int, world: int) -> int:
    """``ShardEnv.local_batch`` with rep = 1: each of ``world`` ranks' rows."""
    if global_batch % world:
        if global_batch >= world:
            raise ValueError(f"batch {global_batch} not divisible by dp {world}")
        return 1  # tiny batches replicate
    return max(1, global_batch // world)


def loss_normalizer(global_batch: int, seq: int, world: int) -> float:
    """``ShardEnv.loss_normalizer``: 1 / (the tokens counted on all ranks)."""
    return 1.0 / (local_batch(global_batch, world) * seq * world)


def fsdp_aggregate(g: torch.Tensor, mesh: Mesh, dim: int | None,
                   scenario: Scenario | str) -> torch.Tensor:
    """One leaf's gradient aggregation: ``g`` holds every rank's gradient
    (the mesh dims, then the leaf). With an FSDP ``dim`` it is what
    ``_sag_bwd`` runs under ``scenario``, axis by axis, the major axis
    first: each rank keeps its chunk of ``dim`` summed over the world —
    NATIVE: the sum (``psum_scatter``); S1_HOST: the endpoint sum (gather,
    sum, slice), which is the same on every rank and so computed once;
    S2_IN_NET and HIERARCHICAL: ``ring_reduce_scatter`` over chunks of
    ``dim``; S3_IN_NET_MAP: the same ring with bf16 on the wire, each hop
    one ``ring_fused_step``. With ``dim`` None (a leaf that is not FSDP
    sharded) it is ``sync_gradients``' sum over the world. Returns the whole
    aggregated leaf: the ranks' chunks concatenated along ``dim``, which is
    what the next step's all-gather of the updated weights amounts to.
    ``mesh.count_collectives`` sees the collectives that the reference runs
    here (the psum, the psum_scatter, S1's all-gathers, the rings'
    ppermutes), with every rank's output bytes."""
    nm, world = mesh.ndim, mesh.size
    sc = Scenario(scenario)
    if dim is not None and g.shape[nm + dim] % world:
        raise ValueError(f"FSDP dim {dim} of a {tuple(g.shape[nm:])} gradient does not split "
                         f"over {world} ranks")
    leaf_bytes = g.numel() // world * g.element_size()
    if dim is None or sc is Scenario.NATIVE:
        note_collective("all-reduce" if dim is None else "reduce-scatter",
                        leaf_bytes * (world if dim is None else 1))
        return g.reshape((world,) + g.shape[nm:]).sum(0)
    if sc is Scenario.S1_HOST:
        per = leaf_bytes  # each rank gathers its axis' gradients, then keeps its chunk
        for ax in mesh.axis_names:
            note_collective("all-gather", world * mesh.axis_size(ax) * per)
            per //= mesh.axis_size(ax)
            g = g.sum(0)
        return g
    wire = sc is Scenario.S3_IN_NET_MAP
    for ax in mesh.axis_names:
        p = mesh.axis_size(ax)
        gm = g.movedim(nm + dim, nm)
        chunks = gm.reshape(gm.shape[:nm] + (p, gm.shape[nm] // p) + gm.shape[nm + 1:])
        red = coll.ring_reduce_scatter(chunks, mesh, ax,
                                       wire_map=coll.bf16_wire if wire else None,
                                       unmap=coll.fp32_unwire if wire else None)
        g = red.movedim(nm, nm + dim)
    flat = g.reshape((world,) + g.shape[nm:])
    return flat.movedim(0, dim).flatten(dim, dim + 1)
