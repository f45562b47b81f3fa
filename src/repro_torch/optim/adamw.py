"""AdamW with warmup-cosine, fp32 or 8-bit block moments.

The port of ``repro/optim/adamw.py``. Parameters, gradients and moments are
dicts keyed by parameter name. The reference's moments are shaped like each
device's storage shard; the port holds each leaf whole, and the update is
elementwise, so only the 8-bit moments notice the shards: their blocks
(the trailing 256 elements, padded with zeros) are cut from each device's
shard, as the reference's device-major moments are, when ``init`` and
``update`` get a ``layout``: {name: the cuts of its device shard}, each cut
a (dim, count) pair: the FSDP dim over the data world and, over a model
axis, the TP dim over its distinct shards (a leaf's copies on the model
axis hold equal moments and are quantized once); absent or None for a leaf
every device holds whole. A shard's rows are in device order, the FSDP
cut's index major. Scalars (the schedule, the bias corrections) are
computed in fp32, as the reference's are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

BLOCK = 256

Cut = tuple[int, int]  # (dim, count): the leaf's dim split into count device shards
Layout = dict[str, "tuple[Cut, ...] | None"]


def quantize_block8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 rows (..., n) → (int8 codes (..., nb, 256), fp32 per-block scales
    (..., nb)): absmax / 127 per block, codes rounded half to even."""
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(x.shape[:-1] + (-1, BLOCK))
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    codes = torch.round(blocks / torch.clamp_min(scale, 1e-20)).to(torch.int8)
    return codes, scale[..., 0]


def dequantize_block8(codes: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """``quantize_block8``'s inverse (to the codes' precision): rows (..., n)."""
    out = (codes.to(torch.float32) * scale[..., None]).reshape(codes.shape[:-2] + (-1,))
    return out[..., :n]


def shard_rows(x: torch.Tensor, place) -> torch.Tensor:
    """A leaf → (shards, n) rows, row i the flat i-th device shard of the
    layout entry ``place`` (its cuts, the first one's index major); one row,
    the whole leaf, without cuts."""
    cuts = place or ()
    for k, (dim, count) in enumerate(cuts):
        x = x.unflatten(dim + k, (count, -1)).movedim(dim + k, k)
    return x.reshape(math.prod(c for _, c in cuts), -1)


def unshard_rows(rows: torch.Tensor, shape, place) -> torch.Tensor:
    """``shard_rows``' inverse: (shards, n) rows → the leaf of ``shape``."""
    cuts = place or ()
    local = list(shape)
    for dim, count in cuts:
        local[dim] //= count
    x = rows.reshape(tuple(c for _, c in cuts) + tuple(local))
    for k in reversed(range(len(cuts))):
        dim = cuts[k][0]
        x = x.movedim(k, dim + k).flatten(dim + k, dim + k + 1)
    return x


class OptState(NamedTuple):
    count: int
    m: dict  # name → fp32 tensor, or (codes, scales) rows of its shards
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    eightbit: bool = False

    def schedule(self, step: int) -> float:
        """Linear warmup to ``lr``, then cosine to ``lr · min_lr_ratio``, in
        fp32 (the returned float is that fp32 value)."""
        step = torch.tensor(float(step), dtype=torch.float32)
        warm = torch.clamp(step / max(1, self.warmup_steps), max=1.0)
        t = torch.clamp((step - self.warmup_steps)
                        / max(1, self.decay_steps - self.warmup_steps), 0, 1)
        cos = self.min_lr_ratio + (1 - self.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return float(self.lr * warm * cos)

    def _zeros(self, p: torch.Tensor, place) -> Any:
        if self.eightbit:
            return quantize_block8(torch.zeros_like(shard_rows(p, place), dtype=torch.float32))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(self, params: dict[str, torch.Tensor], layout: Layout | None = None) -> OptState:
        layout = layout or {}
        return OptState(count=0,
                        m={k: self._zeros(p, layout.get(k)) for k, p in params.items()},
                        v={k: self._zeros(p, layout.get(k)) for k, p in params.items()})

    def update(self, grads: dict[str, torch.Tensor], state: OptState,
               params: dict[str, torch.Tensor], layout: Layout | None = None
               ) -> tuple[dict[str, torch.Tensor], OptState]:
        """Returns (new params, new state); grads fp32, shaped like the
        parameters."""
        layout = layout or {}
        count = state.count + 1
        lr = self.schedule(count)
        c = torch.tensor(float(count), dtype=torch.float32)
        b1c = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** c)
        b2c = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** c)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            place = layout.get(k)
            m, v = state.m[k], state.v[k]
            if self.eightbit:
                n = shard_rows(p, place).shape[-1]
                m = unshard_rows(dequantize_block8(*m, n), p.shape, place)
                v = unshard_rows(dequantize_block8(*v, n), p.shape, place)
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            step = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            pf = p.to(torch.float32)
            new_p[k] = (pf - lr * (step + self.weight_decay * pf)).to(p.dtype)
            if self.eightbit:
                m = quantize_block8(shard_rows(m, place))
                v = quantize_block8(shard_rows(v, place))
            new_m[k], new_v[k] = m, v
        return new_p, OptState(count=count, m=new_m, v=new_v)
