"""The dry run: every (arch × shape) cell's step at full size on the
``meta`` device, its memory and its roofline terms, on one H100.

    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out dryrun.json

The port of ``repro/launch/dryrun.py``. The reference lowers and compiles
each cell for a 16 × 16 (or 2 × 16 × 16) TPU mesh; the port has no
compiler, and its analogue of "lower + compile" is the meta device, where a
step runs at full width and depth on shapes alone, with no memory and no
numbers. Per cell:

1. The full-depth proof: the cell's step at full width and depth (train:
   one rank's ``train_loss`` and backward on one microbatch, then the
   aggregation and the AdamW update, the whole batch held; prefill; decode
   of one token against a ``seq_len`` cache),
   with its peak live bytes counted (``LiveBytes``) over the state it holds:
   parameters in ``param_dtype``, bf16 copies, moments, the (W, *leaf)
   gradient buffers, caches and the batch. ``fits_80g`` holds the peak to
   the H100's memory (the card's own where one is present).
2. Cost probes: the same step at (L=1, mb=1), (L=2, mb=1), (L=1, mb=2),
   (L=2, mb=2) [+ (Le=2) enc-dec] with ``impl="direct"`` for train and
   prefill, counted by ``roofline.cost_vector``; the reference's linear
   solve gives the full-depth totals and ``attn_flops_adjustment`` puts the
   block schedule back. A tail of layers after the superblocks
   (recurrentgemma) is probed too (one more probe at each mb), where the
   reference scales the superblock's cost by |tail| / |unit|: so the FLOPs
   are exact, and the card's count of the real step checks them.

What a record is: one H100 holding the reference's production mesh as the
world dims of one tensor, and every count a per-card total. Every cell runs
on the whole (data 16, model 16) mesh (pod 2 × data 16 × model 16 with
``--multi-pod``): tp is ``cfg.resolve_tp(16)`` with its rep groups, as the
reference's cells run, the tp ranks folded into the ops; the count includes
what folding costs, the (tp, rows, d) bf16 partials of every row-parallel
product. Serving serves the batch's distinct rows (``steps.held_rows``) at
once. Training runs the data-parallel ranks, (pod ×) data × rep, one after
another; they are alike, so one rank is counted and its costs are scaled by
the ``dp_world``. train_4k's batch splits over the rep groups wherever rep
> 1, where the reference's tp ranks would mix rows (ROADMAP.md §3): the
meta device has no rows, and the count is the step's as the reference runs
it. ``--impl serve_opt`` takes the compute-at-data decode (its prefill and
training attention run ``masked``, as the reference's do). MoE dispatch
reads its group sizes on the host, which the meta
device does not have: the count takes balanced routing (``moe.BALANCED``),
named in the record. The numbers are not comparable with the reference's
256-chip TPU records.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.scenarios import Scenario
from repro_torch.launch import shapes as shp
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.mesh import Mesh
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import Model, block_pattern
from repro_torch.models.parallel import ShardEnv

META = torch.device("meta")
NOTE = ("one H100: the reference's production mesh held as world dims on the card, per-card "
        "totals counted on the meta device; not comparable with the reference's 256-chip TPU "
        "records")
IMPLS = ("masked", "triangle", "serve_opt")


def attention_impl(impl: str) -> str:
    """The sequence mixing a cell's step runs: ``serve_opt`` is the
    reference's compute-at-data decode, whose prefill and training attention
    run the whole block schedule (``masked``)."""
    return "masked" if impl == "serve_opt" else impl



class LiveBytes(TorchDispatchMode):
    """The peak of the bytes held by storages that ops make while the mode
    is open (each storage once; freed when its last tensor goes). A storage
    that an op reads or writes before any op of the mode made it (the
    parameters, a cache: held state) is not counted, nor are views of it.
    Works on the meta device, whose storages have sizes and no memory."""

    def __init__(self):
        super().__init__()
        self.seen = torch.utils.weak.WeakIdKeyDictionary()
        self.live = self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor):
                self.seen.setdefault(t.untyped_storage(), False)  # made before: held
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self.seen:
                    self.seen[st] = True
                    self.live += st.nbytes()
                    weakref.finalize(st, self._free, st.nbytes())
        self.peak = max(self.peak, self.live)
        return out


def held_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (tensors, dicts,
    lists, tuples, modules): a bf16 parameter and its compute copy are one
    storage."""
    seen = {}
    for tree in trees:
        if isinstance(tree, torch.nn.Module):
            tree = list(tree.parameters()) + list(tree.buffers())
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


def _meta_batch(specs: dict, lead: int = 0) -> dict:
    """Meta tensors of {name: (shape, dtype)} specs; ``lead`` leading dims
    of 1 dropped (a serving batch of a world of one)."""
    return {k: torch.empty(shape[lead:], dtype=dt, device=META) for k, (shape, dt) in specs.items()}


def _reduce_depth(cfg, n_units: int, enc_layers: int | None = None, tail: bool = False):
    unit, t, _ = block_pattern(cfg)
    kw = dict(n_layers=len(unit) * n_units + (len(t) if tail else 0),
              pattern=cfg.pattern and tuple(cfg.pattern),
              pattern_tail=tuple(t) if tail else ())
    if cfg.enc_layers:
        kw["enc_layers"] = 1 if enc_layers is None else enc_layers
    return dataclasses.replace(cfg, **kw)


class Cell:
    """A cell's step on the meta device: ``memory()`` runs it at full depth
    with its live bytes counted over ``held`` (what the step holds before it
    runs); ``cost()`` counts its FLOPs, bytes and collectives (the whole
    card: train's one rank scaled by the data-parallel world). ``mesh``: a
    launcher's mesh (``launch.mesh.make_mesh``; the production mesh for a
    cell's record), whose ``ShardEnv`` the step runs under."""

    def __init__(self, cfg, shape: shp.ShapeSpec, mesh: Mesh, *, scenario: str, impl: str,
                 microbatches: int, one_micro: bool = False):
        self.kind = shape.kind
        seq, gb = shape.seq_len, shape.global_batch
        serve_opt, impl = impl == "serve_opt", attention_impl(impl)
        if self.kind == "train":
            self.env = env = steps.make_env(cfg, mesh, scenario)
            self.model = Model(cfg, device=META, env=env)
            self.batch = _meta_batch(shp.train_input_specs(cfg, env, seq, gb))
            self.microbatches = micro_count(gb, env, microbatches)
            held_batch = self.batch
            if one_micro:  # the step on one microbatch's rows, the whole batch held
                gb //= self.microbatches
                self.batch = _meta_batch(shp.train_input_specs(cfg, env, seq, gb))
            self.step = steps.make_train_step(self.model, mesh, scenario=scenario,
                                              microbatches=1 if one_micro else microbatches,
                                              global_batch=gb, seq=seq, impl=impl)
            self.state = self.step.init_state()
            self.world = self.step.world
            self.held = (self.model, held_batch, self.state)
            return
        # serving: the mesh's tp ranks folded, the batch's distinct rows at once
        self.env = steps.make_env(cfg, mesh, scenario)
        self.model = Model(cfg, device=META, env=self.env)
        self.rows = rows = steps.held_rows(self.env, gb)
        one = Mesh(("data",), (1,), device=META)
        self.world, self.microbatches = 1, 1
        dec = seq // 2 if cfg.enc_layers else seq  # enc-dec splits seq in halves
        if self.kind == "prefill":
            self.step = steps.make_prefill_step(self.model, global_batch=rows, seq=dec, impl=impl)
            self.batch = _meta_batch(shp.prefill_input_specs(cfg, one, seq, rows), lead=1)
            self.held = (self.model, self.batch)
            return
        self.step = steps.make_serve_step(self.model, global_batch=rows, seq_max=dec,
                                          compute_at_data=serve_opt)
        self.cache = self.model.init_cache(rows, dec, enc_len=dec if cfg.enc_layers else None)
        self.tokens = _meta_batch(shp.decode_input_specs(cfg, one, rows), lead=1)["tokens"]
        self.cache_len = dec - 1
        self.held = (self.model, self.cache, self.tokens)

    def run(self, ranks=None):
        """One step (train: the ranks ``ranks``, all by default)."""
        if self.kind == "train":
            grads, _, _ = self.step.rank_gradients(self.batch, ranks=ranks)
            return self.step.apply(self.state, self.step.aggregate(grads))
        if self.kind == "prefill":
            return self.step(self.batch)
        return self.step(self.cache, self.tokens, self.cache_len)

    def memory(self) -> dict:
        """{held, transient, peak} bytes of one step at this depth (train:
        a cell made with ``one_micro``, whose peak is the real step's, every
        microbatch reaching the same one)."""
        held = held_bytes(*self.held)
        live = LiveBytes()
        with live:
            out = self.run(ranks=(0,) if self.kind == "train" else None)
        del out
        return {"held_bytes": held, "transient_bytes": live.peak, "peak_bytes": held + live.peak}

    def cost(self) -> np.ndarray:
        if self.kind != "train":
            return rl.cost_vector(self.run)
        step, keep = self.step, {}
        fixed = rl.cost_vector(lambda: step.rank_gradients(self.batch, ranks=()))
        one = rl.cost_vector(lambda: keep.update(g=step.rank_gradients(self.batch, ranks=(0,))))
        rest = rl.cost_vector(lambda: step.apply(self.state, step.aggregate(keep["g"][0])))
        return fixed + self.world * (one - fixed) + rest


def micro_count(global_batch: int, env: ShardEnv, microbatches: int) -> int:
    """The microbatches a train step takes: the largest count up to
    ``microbatches`` that divides a rank's rows (``TrainStep``'s rule)."""
    b_loc = env.local_batch(global_batch)
    while b_loc % microbatches:
        microbatches -= 1
    return microbatches


def card_memory() -> float:
    """The card's memory where one is present, else the data sheet's 80 GB."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return rl.HBM_BYTES


def probe_costs(cfg, shape, mesh, *, scenario: str, impl: str, mb: int) -> tuple[np.ndarray, dict]:
    """The reference's probes and solve: (full-depth cost vector, record
    entries)."""
    unit, tail, n_units = block_pattern(cfg)
    probe_impl = impl if shape.kind == "decode" else "direct"

    def probe(n_u, mb_p, enc_l=None, with_tail=False):
        c = _reduce_depth(cfg, n_u, enc_l, tail=with_tail)
        return Cell(c, shape, mesh, scenario=scenario, impl=probe_impl, microbatches=mb_p).cost()

    c11, c21 = probe(1, 1), probe(2, 1)
    c_enc2 = probe(1, 1, enc_l=2) if cfg.enc_layers else None
    c1m2 = c22 = None
    if shape.kind == "train":
        if mb > 1:
            c1m2, c22 = probe(1, 2), probe(2, 2)
        total = rl.solve_train(c11, c21, c1m2, n_units, mb, c_enc2=c_enc2,
                               enc_units=cfg.enc_layers, c22=c22)
    else:
        total = rl.solve_inference(c11, c21, n_units, c_enc2=c_enc2, enc_units=cfg.enc_layers)
    rec = {}
    if tail:
        # the tail's own cost, at one microbatch and (train) at two: it is
        # linear in mb as every other term is
        t1 = probe(1, 1, with_tail=True) - c11
        if shape.kind == "train" and mb > 1:
            t2 = probe(1, 2, with_tail=True) - c1m2
            t1 = t1 + (mb - 1) * (t2 - t1)
        total = total + t1
        rec["tail_probed"] = True
    return total, rec


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               scenario: str = "native", impl: str = "masked",
               microbatches: int | None = None, probes: bool = True,
               cfg_overrides: dict | None = None) -> dict:
    """One cell's record (or the reference's skip)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shp.SHAPES[shape_name]
    ok, reason = shp.shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": cfg.name, "shape": shape_name, "skipped": reason}
    mesh = make_production_mesh(multi_pod=multi_pod, device=META)
    train = shape.kind == "train"
    mb = (microbatches or shp.TRAIN_MICROBATCHES.get(cfg.name, 4)) if train else 1

    # 1) the full-depth proof and its memory
    t0 = time.time()
    cell = Cell(cfg, shape, mesh, scenario=scenario, impl=impl, microbatches=mb, one_micro=True)
    mem = cell.memory()
    env = cell.env
    rec = {
        "arch": cfg.name, "shape": shape_name, "mesh": "x".join(map(str, mesh.shape)),
        "scenario": scenario, "impl": impl, "tp": env.tp, "rep": env.rep,
        "microbatches": cell.microbatches,
        "world": cell.world,
        "ranks": ("one (pod, data, rep) rank counted, costs x the data-parallel world (the "
                  "ranks run one after another and are alike), the tp ranks folded" if train
                  else f"the batch's {cell.rows} distinct rows served at once, the tp "
                       f"ranks folded"),
        "param_dtype": cfg.param_dtype, "meta_s": 0.0, **mem,
        "fits_80g": mem["peak_bytes"] < card_memory(),
        "device": "H100 (meta-device count)", "note": NOTE,
    }
    if train:
        rec["rep_split"] = env.batch_split_rep(shape.global_batch)
    else:
        rec["rows"] = cell.rows
    if cfg.moe is not None:
        rec["moe_routing"] = moe_lib.BALANCED
    del cell
    rec["meta_s"] = round(time.time() - t0, 1)
    if not probes:
        return rec

    # 2) the cost probes and the solve
    t0 = time.time()
    total, extra = probe_costs(cfg, shape, mesh, scenario=scenario, impl=impl, mb=mb)
    rec.update(extra)
    rec["probe_s"] = round(time.time() - t0, 1)
    costs = rl.ExactCosts.from_vector(np.maximum(total, 0.0))
    # the block schedule back in (probes ran dense), the whole world's
    world = rec["world"]
    rows = env.local_batch(shape.global_batch) if train else rec["rows"]
    adj = rl.attn_flops_adjustment(cfg, shape, world, attention_impl(impl), train=train,
                                   rows=rows) * world
    costs.flops = max(0.0, costs.flops + adj)
    rec["attn_flops_adjustment"] = adj
    # the ring factor of the collectives' domain: the data-parallel world's
    # for training, the tp groups' (row-parallel all-reduces, the MoE
    # all-to-all) for serving
    terms = rl.wire_and_terms(costs, world_hint=world if train else rec["tp"], pod_fraction=0.0)
    mf = rl.model_flops(cfg, shape, 1)
    rec.update({
        "devices": 1,
        "flops_per_dev": costs.flops,
        "hbm_bytes_per_dev": costs.hbm_bytes,
        "collectives": costs.coll,
        **terms,
        "model_flops_per_dev": mf,
        "useful_flops_ratio": mf / costs.flops if costs.flops else 0.0,
    })
    tmax = max(terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"])
    rec["roofline_fraction"] = ((costs.flops / rl.PEAK_FLOPS) / tmax * rec["useful_flops_ratio"]
                                if tmax else 0.0)
    return rec


def _cell_record(cell, kw) -> dict:
    arch, shape = cell
    try:
        return lower_cell(arch, shape, **kw)
    except Exception as e:  # a failure here is a fault of the port: surface it
        return {"arch": arch, "shape": shape, "error": repr(e),
                "trace": traceback.format_exc()[-3000:]}


def submit_cells(cells, jobs: int, **kw):
    """Start every (arch, shape) cell on ``jobs`` worker processes (spawned:
    a worker never shares a CUDA context), or with ``jobs`` ≤ 1 on one
    thread of this process. Returns the executor, which the caller shuts
    down, and each cell's future of its record, in order."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    if jobs <= 1:
        ex = ThreadPoolExecutor(1)
    else:
        ex = ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn"))
    return ex, [ex.submit(_cell_record, cell, kw) for cell in cells]


def run_cells(cells, jobs: int = 1, **kw):
    """Yield (cell, record) for every (arch, shape) cell, ``jobs`` worker
    processes at a time (``submit_cells``)."""
    if jobs <= 1:
        for cell in cells:
            yield cell, _cell_record(cell, kw)
        return
    ex, futs = submit_cells(cells, jobs, **kw)
    with ex:
        try:
            for cell, fut in zip(cells, futs):
                yield cell, fut.result()
        finally:  # a caller that stops early waits for no more cells
            for fut in futs:
                fut.cancel()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--scenario", default="native", choices=[s.value for s in Scenario])
    ap.add_argument("--impl", default="masked", choices=list(IMPLS),
                    help="serve_opt: the compute-at-data decode")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--jobs", type=int, default=min(8, os.cpu_count() or 1),
                    help="worker processes (cells are independent)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in shp.SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    records = []
    for _, rec in run_cells(cells, args.jobs, multi_pod=args.multi_pod, scenario=args.scenario,
                            impl=args.impl, microbatches=args.microbatches,
                            probes=not args.no_probes):
        records.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "trace"}), flush=True)
        if "error" in rec:
            print(rec["trace"])
        if args.out:  # written as it goes: a long run leaves its evidence
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
    n_err = sum("error" in r for r in records)
    print(f"\n{len(records)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
