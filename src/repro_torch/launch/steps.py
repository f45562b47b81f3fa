"""Step builders on one card: the train step over a data world, prefill and
one-token decode.

The port of ``repro/launch/steps.py``. There the steps are
``jax.jit``-compiled ``shard_map``s over a mesh with fixed shapes; here they
are plain callables over a ``Model`` that check the shapes they were built
for. The serving steps run under ``torch.inference_mode``. The train step
runs a data world of W ranks, the world dims of a ``Mesh`` on the card, as
the reference's ``make_train_step`` runs it on W devices with a model axis
of 1: each rank's forward and backward on its own rows (a loop over the
ranks), the scenario-selected aggregation of every leaf along its FSDP dim
(S1/S2/S3/NATIVE/HIERARCHICAL: ``models.parallel.fsdp_aggregate``), the
clip and the AdamW update.
"""
from __future__ import annotations

import torch

from repro_torch.core.scenarios import Scenario
from repro_torch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models.parallel import local_batch, loss_normalizer
from repro_torch.models.specs import fsdp_dims
from repro_torch.optim import AdamW, OptState, clip_by_global_norm, sync_gradients


def batch_shape(batch) -> tuple[int, int]:
    """(b, s) of a prompt batch: tokens (b, s), or a dict of ``tokens`` or
    ``embeds`` (b, s, d) and the other inputs of ``Model.prefill_hidden``."""
    if isinstance(batch, torch.Tensor):
        return tuple(batch.shape)
    return tuple((batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[:2])


def make_prefill_step(model: M.Model, *, global_batch: int, seq: int, impl: str = "masked"):
    """``step(batch, cache=None) → (cache, next tokens (global_batch,)
    int32)``; ``batch`` is prompt tokens (global_batch, seq) or a dict of
    the model's inputs (``Model.prefill_hidden``). A ``cache`` longer than
    ``seq`` (from ``model.init_cache``) is filled in place."""

    @torch.inference_mode()
    def step(batch, cache: dict | None = None):
        if batch_shape(batch) != (global_batch, seq):
            raise ValueError(f"prefill step built for {(global_batch, seq)}, got "
                             f"{batch_shape(batch)}")
        return M.prefill(model, batch, impl=impl, cache=cache)

    return step


def make_serve_step(model: M.Model, *, global_batch: int, seq_max: int):
    """``step(cache, tokens (global_batch,), cache_len) → (next tokens,
    cache)``: one greedy decode step at position ``cache_len`` of a cache
    allocated for ``seq_max`` positions, written in place."""

    @torch.inference_mode()
    def step(cache: dict, tokens: torch.Tensor, cache_len: int):
        if tuple(tokens.shape) != (global_batch,):
            raise ValueError(f"serve step built for batch {global_batch}, got "
                             f"{tuple(tokens.shape)}")
        if not 0 <= int(cache_len) < seq_max:
            raise ValueError(f"cache_len {cache_len} outside the cache of {seq_max}")
        return M.decode_step(model, cache, tokens, cache_len)

    return step


class TrainStep:
    """``make_train_step``'s step: ``step(state, batch) → (state, metrics)``
    updates the model's parameters in place (and its bf16 copies, so that
    serving reads the new weights) and returns the new optimizer state and
    the reference's metrics: ``loss`` (Σ nll · norm over the world, the
    load-balance loss left out), ``ntok``, ``grad_norm`` (before the clip)
    and ``lr``. ``batch``: world-major arrays or tensors
    (``launch.shapes.train_input_specs``). Its phases are methods of their
    own, so that a caller can time or check each: ``rank_gradients``,
    ``aggregate``, ``apply``."""

    def __init__(self, model: M.Model, mesh: Mesh, *, scenario, optimizer: AdamW,
                 microbatches: int, global_batch: int, seq: int, impl: str, clip_norm: float):
        cfg = model.cfg
        M.check_train_impl(impl)
        if mesh.device.type != model.device.type:
            raise ValueError(f"mesh on {mesh.device}, model on {model.device}")
        self.model, self.mesh = model, mesh
        self.scenario = Scenario(scenario)
        self.optimizer, self.impl, self.clip_norm = optimizer, impl, clip_norm
        self.world = mesh.size
        self.b_loc = local_batch(global_batch, self.world)
        # microbatches must divide the local batch
        while self.b_loc % microbatches:
            microbatches -= 1
        self.microbatches = microbatches
        # enc-dec shapes split seq between encoder frames and decoder labels
        self.norm = loss_normalizer(global_batch, seq // 2 if cfg.enc_layers else seq, self.world)
        self.dims = fsdp_dims(model)
        self.layout = {k: (d, self.world) for k, d in self.dims.items() if d is not None}
        model.requires_grad_(True)
        self.params = dict(model.named_parameters())

    def init_state(self) -> OptState:
        return self.optimizer.init(self.params, self.layout)

    def rank_gradients(self, batch: dict, ranks=None):
        """Each rank's forward and backward on its own ``b_loc`` rows, its
        microbatches' fp32 gradients accumulated as the reference's
        ``micro`` does. Returns ({name: (mesh dims, *leaf) fp32}, Σ nll, Σ
        ntok). ``ranks``: the (flat) ranks to run, all by default; the
        others' gradients stay zero (the dry run counts one rank: they are
        alike)."""
        mesh, dev, mb = self.mesh, self.model.device, self.microbatches
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for k, v in batch.items():
            if v.shape[:mesh.ndim + 1] != mesh.shape + (self.b_loc,):
                raise ValueError(f"batch {k!r} {tuple(v.shape)} does not lead with the world "
                                 f"{mesh.shape} and {self.b_loc} rows a rank")
        names = list(self.params)
        grads = {k: torch.zeros(mesh.shape + tuple(p.shape), dtype=torch.float32, device=dev)
                 for k, p in self.params.items()}
        nll = torch.zeros((), dtype=torch.float32, device=dev)
        ntok = torch.zeros((), dtype=torch.int64, device=dev)
        rows = self.b_loc // mb
        for r in range(self.world) if ranks is None else ranks:
            for i in range(mb):
                part = {k: v.reshape((self.world, mb, rows) + v.shape[mesh.ndim + 1:])[r, i]
                        for k, v in batch.items()}
                loss, aux = self.model.train_loss(part, impl=self.impl)
                gs = torch.autograd.grad(loss * self.norm * mb, [self.params[k] for k in names],
                                         allow_unused=True)
                for k, g in zip(names, gs):
                    if g is not None:
                        grads[k].view((self.world,) + g.shape)[r].add_(g.to(torch.float32) / mb)
                nll += aux["nll_sum"]
                ntok += aux["ntok"]
        return grads, nll, ntok

    def aggregate(self, rank_grads: dict) -> dict:
        """The scenario's aggregation of every leaf over the world
        (``optim.sync_gradients``): {name: the whole aggregated gradient}."""
        return sync_gradients(rank_grads, self.dims, self.mesh, self.scenario)

    @torch.no_grad()
    def apply(self, state: OptState, grads: dict) -> tuple[OptState, torch.Tensor]:
        """The clip and the AdamW update, written into the model's
        parameters, then its bf16 copies remade. Returns (new state, the
        gradient's norm before the clip)."""
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        new, state = self.optimizer.update(grads, state, self.params, self.layout)
        for k, p in self.params.items():
            p.copy_(new[k])
        self.model.cast_weights()
        return state, gnorm

    def __call__(self, state: OptState, batch: dict) -> tuple[OptState, dict]:
        rank_grads, nll, ntok = self.rank_gradients(batch)
        grads = self.aggregate(rank_grads)
        del rank_grads
        state, gnorm = self.apply(state, grads)
        return state, {"loss": nll * self.norm, "ntok": ntok, "grad_norm": gnorm,
                       "lr": self.optimizer.schedule(state.count)}


def make_train_step(model: M.Model, mesh: Mesh, *, scenario: Scenario | str = Scenario.NATIVE,
                    optimizer: AdamW | None = None, microbatches: int = 1, global_batch: int = 8,
                    seq: int = 128, impl: str = "masked", clip_norm: float = 1.0) -> TrainStep:
    """The train step of ``model`` on the data world ``mesh`` (``("data",)``
    or ``("pod", "data")``, on the model's device), aggregating gradients
    under ``scenario``; ``optimizer`` defaults to ``AdamW`` with the
    config's 8-bit moments setting. Turns the model's parameters'
    gradients on."""
    return TrainStep(model, mesh, scenario=scenario,
                     optimizer=optimizer or AdamW(eightbit=model.cfg.opt_state_8bit),
                     microbatches=microbatches, global_batch=global_batch, seq=seq, impl=impl,
                     clip_norm=clip_norm)
