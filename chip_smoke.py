#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    PYTHONPATH=src python3 chip_smoke.py
    python3 chip_smoke.py --ring-hops [TREE]   # ring_fused_step's hops alone
    python3 chip_smoke.py --nccl-phase         # phase 14 alone, on four cards

1. Builds the Hopper kernels (``src/repro_torch/csrc``) into ``build/``.
2. Holds every kernel against its plain PyTorch version on the card, at edge
   shapes (bitwise where the function is exact, 2e-2 for float sums;
   ``segment_reduce`` in both of its branches, the shared-memory histogram
   up to the largest segment count that fits and the global atomics one
   past it; for ``flash_attention`` causal and not, d 64 and 128, fp32 at
   3e-4 and bf16 at 3e-2 elementwise and ``ROW_TOL`` per output row, ragged
   lengths up to 4096, grouped kv heads, strided layouts;
   ``ring_fused_step`` bitwise on every layout of ``ring_layouts``, each
   without a copy but ``RING_COPIED``).
3. Runs the paper's word count at full width — 8 mappers x 2**24 Zipf words,
   vocab 50,000 — in three forms (token shuffle + reducer count, histogram
   shuffle, S1 host baseline), each bitwise against ``wordcount_reference``,
   and the §4 aggregation of 8 x 25,557,032 fp32 gradients (ResNet-50's
   parameter count) in all five scenarios against a float64 host mean.
   Then the same jobs as p4mr programs compiled by the port's compiler onto
   an 8-ring (``TorusTopology((8,))``) and run by
   ``plan.run(backend="torch")``: the word count as the rebalanced
   in-network tree (``PLAN_PASSES``) and as the unlowered KEYBY fan-in over
   ``kernel_histogram``'s per-shard histograms, bitwise against
   ``wordcount_reference``; S1 (unoptimized, reducer pinned at d0's
   switch), S2 and S3 (``PLAN_PASSES``) against a float64 host sum within
   ``AGG_TOL`` and bitwise against the same plan run on the CPU over the
   first ``PREFIX`` elements. Then the default pipeline's plans, lowered
   shuffles: ``wordcount_via_plan``'s compile (a ``p4mr.Session``
   arbitrating 1, 4 or 8 buckets through ``lower-shuffle`` and
   ``reroute-feedback``) over the same histograms, bitwise, with
   ``wordcount_via_plan`` itself run beside it, on the card (its default)
   and on the host (``backend="simulate"``); and
   ``compile_scenario``'s S1/S2/S3 plans over the gradient rows, within
   ``AGG_TOL`` of the float64 sum and bitwise against the same plan run on
   the CPU at full width. Then the vectorized simulator's step on the card
   (the plan's own ``VoqParams`` with ``use_torch=True``) over the
   ``BENCH_simulator.json`` fat_tree_k8 cell, which must take steps on the
   card and give the numpy path's makespan and busy ticks, and S3's ring in the order ``plan_ring_order`` derives on a
   (2, 4) torus. Then the autotuned pipeline: the Session word count's
   compile with the ``autotune`` pass appended and telemetry on
   (``plan_wordcount_autotuned``), run over the same histograms, bitwise;
   ``BENCH_scheduler.json``'s two-tenant cell at vocab 50,000 scheduled by
   ``p4mr.Scheduler`` on a k=4 fat-tree, each tenant's plan run on the
   card over its own 4 shards' histograms, bitwise
   (``scheduler_two_tenants``). Then, in a phase of its own with its own
   peak device memory, ``sequence_parallel_linear_scan`` of an
   RG-LRU recurrence at recurrentgemma-2b's width (8 ranks × 2,048
   positions × batch 8 × 2,560, fp32) within 2e-5 of a float64 sequential
   recurrence on the card; and ``pipeline_apply`` of 8 stages of
   tanh(h @ W_s) at d 1024 over 32 microbatches of (8, 512, 1024) fp32
   within 2e-5 of the stages applied in sequence in float64. Plans compile
   (and the tenants are scheduled) once, outside the timed call; the host
   compile time, each plan's simulated makespan, each path's wall and peak
   device memory are logged. Kernel launch counts are zeroed before each
   path and read after it.
4. Times each kernel at its main-path shapes with CUDA events, beside its
   plain version, a one-call PyTorch yardstick where one exists (for
   ``segment_reduce`` the faster of ``index_add_`` and ``bincount``), and
   its bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32, 989 TFLOP/s bf16
   on the tensor cores); ``ring_fused_step`` on its hop's ``acc`` as the
   ring hands it (``ring_row``), back to back and on the device alone (a
   CUDA graph of the same launches, ``graph_ms``), each launch on inputs
   that are not in L2 (``cold_pairs``).
5. Serves Qwen1.5-0.5B at full width (24 layers, d 1024, 16 heads of 64,
   vocab 151,936; random weights from ``SEED``): prefills 8 prompts of 4096
   tokens through the ``flash_attention`` kernel (exactly 24 launches) and
   decodes 32 greedy tokens, then runs the same prefill with
   ``impl="masked"`` (the JAX model's chunked attention) and holds every
   layer's K/V cache, the last position's final hidden state and layer 0's
   attention output to it: on the served weights, then on the model
   sharpened (``sharpen``: attention far from uniform), and, as a control
   the limits must reject, with the kernel run without its causal mask.
   The repo's serving shapes (``launch/shapes.py``: prefill_32k, decode_32k)
   are sized for a 256-chip pod; one card takes batch 8 at train_4k's
   4096-token sequence. Then holds ``flash_attention`` to its plain version
   at that prefill's shape (b 8, h 16, s 4096, d 64, bf16, causal), per
   output row, and times it as in step 4, with
   ``scaled_dot_product_attention`` as the yardstick.

6. Serves one model of each other block family at full width and depth,
   one after another, each freed before the next: granite-moe-1b-a400m
   (MoE: the combine on ``segment_reduce``), minicpm3-4b (MLA), mamba2-1.3b
   (SSD), recurrentgemma-2b (RG-LRU with local attention), qwen2-vl-7b
   (M-RoPE over patch embeddings and a (t, h, w) grid) and
   seamless-m4t-large-v2 (enc-dec: 2,048 frame embeddings into the encoder,
   a 128-token prompt into the decoder); random weights from ``SEED``,
   batch 4 × 2,048-token prompts, 16 greedy tokens. Each path's launches are
   held to ``FAMILY_LAUNCHES``; where it launches a kernel its prefill is
   held to the plain route (``impl="masked"``, ``ref.segment_reduce``,
   replaying the kernel route's expert choices) on the served weights,
   within ``SERVE_TOL`` scaled to its depth and ``ATTN_TOL``, and every
   kernel layer to its plain route on the layer's own input, on the served
   and the sharpened weights, within ``ATTN_TOL``; every path's cache is
   held consistent (prefill of
   s then one decode step against the prefill of s + 1, within
   ``CONSIST_TOL``, with an empty-cache control the limit must reject).
   Then ``segment_reduce`` at the MoE combine's shape, against its plain
   version, timed beside ``index_add_``.

7. Trains at full width and depth through ``launch/train.py``'s ``build``
   and ``run``: Qwen1.5-0.5B on a data world of 8 ranks (``("data",)=8``,
   ``("pod","data")=(2,4)`` for HIERARCHICAL), global batch 8 × 2,048
   ``TrainPipeline`` tokens, random weights from ``SEED``. One step under
   each of NATIVE, S1, S2, S3 and HIERARCHICAL from the same parameters and
   state, phase by phase (``timed_step``): each scenario's aggregated
   gradient against the float64 sum of the ranks' within ``AGG_TOL``, S3's
   bitwise against the same ring run with ``ref.ring_fused_step``, and S3's
   ``ring_fused_step`` launches 7 per FSDP leaf. Then ``TRAIN_STEPS`` S3
   steps through ``run`` with ``TRAIN_OPT``'s AdamW: every loss finite, the
   last five's mean below the first. Then granite-moe-1b-a400m at W = 1 for
   ``MOE_TRAIN_STEPS`` steps of 4 × 2,048 tokens, the load-balance loss in
   the loss: ``segment_reduce`` launched once per layer per forward (twice
   under remat), and the kernel route held to its plain route
   (``MOE_TRAIN_TOL``): the loss of one batch, and layer 0's output and
   gradients on its own input.

8. Restarts and dry-runs. Through ``launch/train.py``'s ``run``: Qwen1.5-0.5B
   as in 7 under S3 on 8 ranks for ``RESTART_STEPS`` steps with a
   checkpoint every ``RESTART_EVERY`` (in a temporary directory, deleted
   after), a simulated failure at step ``RESTART_FAIL`` and the elastic
   restart on ``RESTART_SHRINK`` ranks from the step-``RESTART_AT``
   checkpoint: the restored parameters and moments bitwise equal to a
   device copy taken at the save, the first loss after the restart within
   ``RESTART_LOSS_TOL`` of world 8's loss at that step, ``ring_fused_step``
   launched (W - 1) per FSDP leaf a step at each world; save (asynchronous
   and blocking), restore and restart times are logged. Then granite-moe at
   W = 1, cut to ``MOE_CKPT_LAYERS`` layers: a step, a save, a step; the
   checkpoint restored into a model of another seed gives that second
   step's loss bitwise, ``segment_reduce`` on its kernel route. Then
   ``launch/dryrun.py``'s 40 cells on the meta device (``DRYRUN_JOBS``
   worker processes, started beside phase 7's training; each a record or
   the reference's skip; every cell on the reference's (16, 16) production
   mesh at ``resolve_tp(16)`` and its rep groups, a train cell's one
   data-parallel rank scaled by the data-parallel world), and every cell
   the dry run says fits one H100 run for real on the card at that mesh: its
   peak memory within ``DRYRUN_PEAK_TOL`` of the dry run's and its FLOPs
   within ``DRYRUN_FLOP_TOL``.

9. Serves across a ("data", "model") mesh of world dims (``MESH_SERVE``),
   at full width and depth (granite-moe, mamba2 and minicpm3 cut,
   ``MESH_LAYERS``),
   random weights from ``SEED``, through
   ``launch.serve.generate`` over the mesh (the batch device-major, its rows
   held once): Qwen1.5-0.5B at (2, 4) (tp 4; 8 × 4,096 tokens, 16 greedy
   tokens), granite-moe-1b-a400m at (1, 16) (tp 16, kv 8 over 16 ranks:
   dup span 2; 32 experts, 2 slots a rank; the prefill's MoE on the
   all-to-all dispatch at capacity 1.25; 4 × 2,048, 8 tokens) and
   mamba2-1.3b at (2, 2) (4 × 2,048, 8 tokens), and the other block kinds
   at the reference's tp: minicpm3-4b (MLA) at (1, 8), recurrentgemma-2b
   (RG-LRU and local attention) at (2, 2), qwen2-vl-7b (M-RoPE over patch
   embeddings) at (1, 8) (tp 4, rep 2) and seamless-m4t-large-v2 (enc-dec,
   ``ENC_FRAMES`` frames and a ``DEC_PROMPT``-token prompt) at (1, 16), 4
   prompts and 8 tokens each (the greedy tokens halved from 32 and 16 to
   keep the script inside its time limit). Launches are held to
   ``MESH_LAUNCHES``; each warm prefill's window, device busy time and idle
   share are printed (``device_busy``). The archs of ``TP_CHECK_ARCHS``, sharpened as in 5:
   the TP prefill's last-position logits against the tp = 1 route of the
   same model within ``TP_TOL``, its first token equal wherever the tp = 1
   route's top-two margin exceeds twice their largest logit difference (on
   at least ``DECISIVE_SHARE`` of the rows, and every row's token among
   that route's top two), the greedy tokens' agreement printed; on a mesh
   with an fsdp world (qwen1.5, recurrentgemma) the compute-at-data decode
   against the gather decode on one cache within ``CAD_TOL``, tokens
   likewise.
   granite-moe: every layer's a2a route against the replicated route on the
   layer's own input, on every token none of whose assignments dropped,
   within ``A2A_TOL`` (the dropped share printed); the a2a combine on
   ``segment_reduce`` against its plain version within ``COMBINE_TOL``.
   Every model's cache held consistent (``cache_consistency``;
   granite-moe's a2a prefill at ``no_drop_capacity``, so that it computes
   the dropless function of the longer prefill's route). Then
   ``flash_attention`` (at the TP prefill's shape and at seamless's encoder
   and decoder launch shapes) and ``segment_reduce`` at the TP paths'
   shapes against their plain versions, timed.

10. Trains under tensor parallelism at full width through
   ``launch/train.py``'s ``build`` and ``run``, random weights from
   ``SEED``: (a) Qwen1.5-0.5B on the reference's e2e mesh (4, 2) (tp 2;
   global batch 8 × 2,048), one step under each of NATIVE, S1, S2 and S3,
   and HIERARCHICAL on (2, 2, 2), from the same parameters, phase by phase:
   each aggregated gradient against NATIVE's fp32 sum of the same ranks'
   gradients within ``AGG_TOL``, S3's launches the step's ring hops and its
   result bitwise the ring run with ``ref.ring_fused_step``; the TP loss
   against the tp = 1 step on the same parameters and rows within
   ``TP_LOSS_TOL``; then ``TP_RESTART`` through ``run``: S3 on (4, 2), a
   checkpoint, a failure and the restart on 4 devices, (2, 2), the
   restored state bitwise and the first loss after it held as in 8.
   (b) recurrentgemma-2b on (1, 4) (tp 2, rep 2: the rep groups' S3 rings),
   cut to the deepest depth the card holds (``rec_tp_depth``), 3 × 2,048
   rows, two S3 steps held to NATIVE and bitwise to the plain ring.
   (c) granite-moe-1b-a400m on (1, 16) (tp 16, the a2a dispatch at capacity
   1.25), 4 layers, two steps: ``segment_reduce`` once a layer a forward
   (twice under remat), and the loss on the kernel route against the plain
   route. Each step's phases, tokens/s, peak and launches are printed, and
   for (a)'s S3 step, (b) and (c) the device's busy time and idle share.

11. Runs the paper's data plane on a process mesh: ``PROCS_WORLD`` = 8 gloo
   ranks spawned on the one card (``launch.procs.spawn``; the kernels were
   built in 1, so the ranks only load them), each holding only its own
   shard of 3's inputs (2**24 words, 25,557,032 / 8 gradients), its
   collectives staged through pinned host memory. 3's word count
   (histogram, token shuffle, S1 host), aggregation (S1, S2, S3, NATIVE on
   8; HIERARCHICAL on (2, 4)) and the rebalanced word-count plan on the
   8-ring, each once to warm up and once timed: every rank's outputs held to
   its row of 3's world-dim run (bitwise; NATIVE and HIERARCHICAL within
   ``PROCS_TOL``), S3 also bitwise to the plain ring, each rank's launches
   to ``PROCS_LAUNCHES``, no hop's input copied before ``ring_fused_step``'s
   kernel (``ops.COPIES``). Prints each path's wall, its host copies and
   their share of the wall, and a rank's peak memory; the kernels line gets
   the three data-plane kernels at a rank's shapes (timed in 4, alone on
   the card), with phase 11's launches summed over the ranks.
12. Serves the LM on a process mesh: one gloo rank per device of a
   (data, model) mesh on the one card, each holding only its device's shard
   of the parameters (each leaf cut as it is drawn from ``SEED``), its rows
   and its cache (``PROCS_SERVE``): qwen1.5 at (2, 4) (the flash prefill,
   both decode routes), granite-moe at (1, 8) (the a2a prefill at the
   config's capacity, the replicated decode), mamba2 at (2, 2), minicpm3
   (MLA) at (1, 4), recurrentgemma at (2, 2) (both decode routes), qwen2-vl
   at (1, 8) (patch embeddings on their grid, split over rep) and seamless
   at (1, 4) (``ENC_FRAMES`` frames), at full width and cut in depth to
   ``PROCS_SERVE_LAYERS``; the archs of one world size
   share a spawn (``PROCS_SERVE_SPAWNS``). Each arch is first served on the
   world-dim mesh of the same mesh shape, weights and rows. On each route every rank's greedy tokens equal
   its rows' there wherever the world-dim logits' top-two margin exceeds
   twice the row's measured logit difference at that step (for qwen1.5 on
   at least ``DECISIVE_SHARE`` of the positions), every step's logits (the
   prefill's, then each decode step's on the rows whose tokens so far
   agree) within ``TP_TOL`` normwise over every rank's vocab shard, each
   rank's final cache block within ``TP_TOL`` of the world-dim block on the
   rows whose tokens all agree (some rows must), and each rank's kernel
   launches to ``PROCS_SERVE_LAUNCHES``; at tp 2 the prefill's logits
   bitwise. The logits are recorded as the greedy token reads them and the
   kernels' inputs kept as device copies, so that the timed calls do no
   work of the check's. Prints
   per arch the prefill wall (the slowest rank; the first call, which makes
   the groups and pinned buffers) and decode ms a step on each route, the
   bytes staged through host memory and their share of the wall, the
   collectives of a rank and of all, and a rank's peak memory at setup and
   serving beside the world-dim run's; the kernels line gets
   ``flash_attention`` (qwen1.5's, qwen2-vl's GQA prefill and seamless's
   non-causal encoder, ``PROCS_SERVE_FLASH``) and the a2a combine's
   ``segment_reduce`` at a rank's shapes (rank 0's first layer), timed
   alone on the card.
13. Trains the LM on a process mesh: one gloo rank per device on the one
   card, each holding only its device's shard of the parameters and of the
   moments (``launch.steps.ProcessTrainStep``; ``PROCS_TRAIN``, at full
   width and ``PROCS_TRAIN_LAYERS``'s depth): qwen1.5 at (4, 2) under
   S3 for its steps, a checkpoint gathered and written by rank 0,
   granite-moe at (1, 8) on the a2a dispatch and qwen2-vl at (1, 8)
   (M-RoPE over embeddings, the rep groups' rings), in one world; then a
   new world of 4 ranks that restores qwen1.5's checkpoint on (2, 2) and
   takes a step, and trains mamba2 at (2, 2), recurrentgemma at (1, 4)
   (the RG-LRU and local attention, rep 2), minicpm3 at (1, 4) (MLA),
   seamless at (2, 2) (enc-dec) and qwen1.5 at (2, 2) with 8-bit moments
   (``PROCS_TRAIN_8BIT``). Each is first trained on the world-dim mesh of
   the same shape, weights (``SEED``) and batches (``procs_train_world``),
   qwen1.5's restart as the world-dim run carries on on (2, 2).
   Every step's loss and gradient norm within ``PROCS_TRAIN_TOL`` of the
   world-dim step's, each rank's parameter shards after the steps within
   two steps of lr of the world-dim ones and the whole update within
   ``PROCS_UPDATE_TOL`` normwise; a rank's ``ring_fused_step`` launches
   equal to its ring hops (``ring_hops()``), each hop's output bitwise its
   plain version's and no hop's input copied (``ops.COPIES``), and
   granite-moe's combines on ``segment_reduce``; the
   8-bit rows, dequantized, within ``PROCS_EIGHTBIT_TOL`` a leaf and
   ``PROCS_MOMENT_TOL`` over the tree of the world-dim step's, and their
   checkpoint (rank 0's) restored in every rank bitwise.
   Prints each step's wall on the slowest rank and its phases
   (``rank_gradients``, ``aggregate``, ``apply``), the bytes staged and
   their share, the collectives of a rank, the checkpoint's gather and
   write, and a rank's peak; the kernels line gets ``ring_fused_step`` at
   a rank's first hop and at the phase's largest (on seeded inputs laid
   out as the ring handed each) and ``segment_reduce`` at a rank's training
   combine.
14. The process mesh under nccl, one card per rank, on a host with four
   cards or more (``NCCL_WORLD``; on fewer it prints that it did not run):
   the kernels on cuda:3 while the current card is cuda:0, then the
   references on world dims on cuda:0, then three spawns. Four nccl ranks
   on cards 0-3: a partial permutation as the world's first collective
   against the world-dim mesh; phase 11's data plane at W = 4 (4 x 2^24
   tokens, 4 x GRAD_SIZE fp32, HIERARCHICAL on (2, 2), the plan on a
   4-ring) held to its world-dim run as phase 11 holds it; the five
   collectives alone at ``NCCL_COLL_BYTES`` a rank; each rank's three
   data-plane kernels against their plain versions on its own card; then
   every block kind served as phase 12 serves it (``NCCL_SERVE``: qwen1.5
   at (2, 2) at full depth, 8 x 4,096 prompts, 8 tokens; granite-moe at
   (1, 4) on its a2a route at full depth, mamba2 (2, 2), minicpm3 (1, 4),
   recurrentgemma (2, 2), qwen2-vl (1, 4), seamless (1, 4), 4 rows and 3
   tokens; both decode routes where the mesh has a data world, flash
   prefill) and trained as phase 13 trains it (``NCCL_TRAIN_WORLDS``: S3,
   1,024-token rows, qwen1.5 (2, 2) 2 steps with the checkpoint gathered
   to rank 0 and written, then a step each of granite-moe (1, 4),
   mamba2 (2, 2), minicpm3 (1, 4), recurrentgemma (1, 4) on its rep ring,
   qwen2-vl (1, 4), seamless (2, 2) and qwen1.5 (2, 2) with 8-bit moments,
   their checkpoint restored bitwise), each held to its world-dim
   reference (phases 12 and 13's four-rank ones reused), then
   phi3-medium-14b at (2, 2) at full depth, which does not fit one card,
   held by its own routes (``nccl_phi3_rank``); every rank's transport
   "nccl" and nothing staged; last the elastic restart inside that world,
   through ``launch/train.py``'s own (``train.restart``): ranks 2 and 3
   leave, ranks 0 and 1 form (1, 2) over a group of their own
   (``launch.procs.shrink_process_mesh``), draw qwen1.5, restore its
   checkpoint (bitwise, gathered back) and take a step, held as the
   training is, the wall time from the failure to the end of that step on
   the slower survivor printed with its parts. The same four ranks under gloo, staged through host
   memory (the data plane and the collectives). Prints each path's
   slowest-rank wall beside the world-dim one under both backends, the
   collectives' ms and algorithm and bus GB/s, the
   cards and their topology, phi3's peak a rank beside the whole model's
   bytes; the kernels line gets rank 3's data-plane kernels (timed on
   cuda:3) and, on cuda:0, rank 0's flash prefill of qwen1.5, qwen2-vl,
   phi3 and seamless's encoder, its a2a combine and recurrentgemma's first
   rep-ring hop, with phase 14's launches.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that last line. Needs one CUDA device.

``inputs`` and ``main_paths`` are the one definition of the word-count,
aggregation, compiled-plan and scheduler paths, ``recurrence_inputs`` and
``recurrence_paths`` of the scan and pipeline ones, ``serve_inputs``,
``serve_paths`` and ``prefill_paths`` of the serving ones, ``family_inputs``,
``family_paths`` and ``family_prefill_paths`` of the other block kinds',
``train_inputs`` and ``train_paths`` of training's (and, with
``tp_model``, of training under tensor parallelism), ``mesh_inputs``,
``mesh_paths`` and ``mesh_prefill_paths`` of serving across a mesh;
``benchmarks/torch_path_profile.py`` profiles the same tables.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM data sheet, bf16 tensor cores, dense

N_MAPPERS = 8
TOKENS_PER_MAPPER = 2**24
VOCAB = 50_000
GRAD_SIZE = 25_557_032  # ResNet-50 parameters
SEED = 1
SERVE_ARCH = "qwen1.5-0.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 4096, 32
# flash vs masked prefill, normwise relative (||a - b|| / ||b||) per layer's
# K/V cache and for the final hidden state. Both run in bf16 (2**-8 relative
# a rounding), but round in different places: the masked path rounds the
# scores and p to bf16 before P·V, the kernel keeps both in fp32 until its own
# bf16 P·V. Each layer adds a few such roundings to the residual stream; over
# 24 layers, as a random walk, that is a few 1e-2.
SERVE_TOL = 5e-2
# flash vs masked, layer 0's attention output (after wo), normwise relative:
# both paths see the same input there, so only the attention core's own
# roundings (scores and p in bf16 on the masked path, bf16 P in the kernel)
# and the bf16 outputs separate them, a few 2**-9 each.
ATTN_TOL = 2e-2
# wq and wk × QK_GAIN (with random biases and norm scales) in the sharpened
# comparison: score std about 2 at this width, as the parity tests' ×10 gives
# about 1.5 at the smoke config's width 32. Init weights give about 0.6.
QK_GAIN = 2.0
# kernel against plain version, the normwise relative difference of each
# output row (one query of one head), by dtype: for bf16 the output's own
# rounding is up to 2**-9 of each value and the kernel's bf16 P adds as much;
# for fp32 the reference's elementwise 3e-4, held per row.
ROW_TOL = {"torch.float32": 3e-4, "torch.bfloat16": 1e-2}
SCENARIOS = {"s1": "s1_host", "s2": "s2_in_net", "s3": "s3_in_net_map"}
AGG_TOL = {"s1_host": 1e-5, "s2_in_net": 1e-5, "s3_in_net_map": 3e-2,
           "native": 1e-5, "hierarchical": 1e-5}
# the first compiled-plan paths keep their pipeline, the default one minus
# lower-shuffle and reroute-feedback, so that their plans stay binary trees
# and their numbers comparable; the fabric; and the prefix of their output
# held bitwise to a CPU run
PLAN_PASSES = ("parse", "validate", "dead-node-elim", "rebalance-reduce-tree",
               "insert-combiners", "place", "route", "emit", "verify")
PLAN_RING = 8
PREFIX = 2**20
# switch memory for the aggregation plans: the default 1 MiB cannot hold one
# 25,557,032-wide state table (204 MB at 8 bytes an item); 512 MiB holds two,
# as 1 MiB holds two of the word count's 50,000-word tables, so both trees
# get fan-in 2
PLAN_SWITCH_MEMORY = 1 << 29
# the simulator path: ``benchmarks/bench_simulator.py``'s fat_tree_k8 cell
# (16 mappers, vocab 8192, 16 buckets, no skew, trains capped as by default)
SIM_K, SIM_MAPPERS, SIM_VOCAB, SIM_BUCKETS = 8, 16, 8192, 16
# the scheduler path: ``benchmarks/bench_scheduler.py``'s two_wordcounts
# cell at VOCAB words; tenant → (the corpus shards it counts, on hosts h<i>,
# and its sink host)
TENANTS = {"tenant_a": (range(0, 4), "h15"), "tenant_b": (range(4, 8), "h12")}
# the recurrence paths: an RG-LRU recurrence at recurrentgemma-2b's width
# (src/repro/configs/recurrentgemma_2b.py, d 2560) sharded over 8 ranks, and
# 8 pipeline stages of tanh(h @ W_s) at qwen1.5-0.5b's d_model 1024; both
# held to the reference tests' 2e-5 (rtol = atol) against float64
SCAN_RANKS, SCAN_LEN, SCAN_BATCH, SCAN_WIDTH = 8, 2048, 8, 2560
PIPE_STAGES, PIPE_MICRO, PIPE_SHAPE = 8, 32, (8, 512, 1024)
RECURRENCE_TOL = 2e-5
# the other block kinds: one model per family (src/repro/configs), full width
# and depth; 4 prompts of 2,048 tokens (a multiple of recurrentgemma's
# 2,048 window and of mamba2's 256 chunk), 8 greedy tokens (16 until the
# script had to be cut to its time limit); seamless's
# encoder takes 2,048 frames and its decoder a 128-token prompt
FAMILY_ARCHS = ("granite-moe-1b-a400m", "minicpm3-4b", "mamba2-1.3b", "recurrentgemma-2b",
                "qwen2-vl-7b", "seamless-m4t-large-v2")
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 4, 2048, 8
ENC_FRAMES, DEC_PROMPT = 2048, 128
# kernel launches of one served prefill: (flash_attention, segment_reduce).
# flash takes GQA self-attention with head dim 64 or 128 and no window (the
# encoder's non-causal included); MLA's 96/64 heads and recurrentgemma's
# windowed 256 stay on the chunked path; each MoE layer makes one combine
FAMILY_LAUNCHES = {"granite-moe-1b-a400m": (24, 24), "minicpm3-4b": (0, 0),
                   "mamba2-1.3b": (0, 0), "recurrentgemma-2b": (0, 0),
                   "qwen2-vl-7b": (28, 0), "seamless-m4t-large-v2": (48, 0)}
# prefill of s then one decode step against the prefill of s + 1, normwise
# relative over the last position's final hidden state (b, d). The two
# round in different places at every layer: decode attends over the cache
# with the chunked path where the prefill runs the kernel, MLA's decode
# attends in fp32 over the latent cache where its prefill expands it in
# bf16, the MoE decode sums experts in bf16 where the prefill's combine sums
# in fp32, and SSD's chunked scan meets a one-step recurrence. Rehearsed on
# the CPU at reduced depth these drift by about 1e-2 per √(layers / 8)
# (MLA 0.054 at 31 layers), so up to about 0.08 at minicpm3's 62; a decode
# from an empty cache (the control) is off by order 1.
CONSIST_TOL = 0.15
# training (phase 7): qwen1.5-0.5b at full width and depth on a data world
# of 8 ranks (``launch/train.py``'s --mesh: ("data",)=8, or ("pod","data") =
# (2, 4) for HIERARCHICAL), global batch 8 × 2,048 (one sequence a rank),
# one step per scenario from the same parameters, then the first TRAIN_STEPS
# steps under S3 of an AdamW warmed up in 5 steps and decayed over 20 (the
# reference's default warmup is 100 steps; the run was 20 steps long until
# the script had to be cut to its time limit, and its first 10 losses are
# the same either way); granite-moe-1b-a400m at W = 1, 4 × 2,048 tokens,
# MOE_TRAIN_STEPS steps
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_MESHES = {"native": "8,1", "s1_host": "8,1", "s2_in_net": "8,1", "s3_in_net_map": "8,1",
                "hierarchical": "2,4,1"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 10
TRAIN_OPT = {"warmup_steps": 5, "decay_steps": 20}
MOE_TRAIN_ARCH, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = "granite-moe-1b-a400m", 4, 3
# the MoE training route (the combine on segment_reduce) against its plain
# route (ref.segment_reduce through autograd, the kernel route's expert
# choices replayed), normwise relative: the whole model's loss on one batch,
# and layer 0's output and its router and expert gradients on the layer's
# own input. The two differ only in the order of the combine's fp32 sums
# (8 rows a token), which moves a bf16 output by one ulp now and then.
# Rehearsed on the CPU with the combine summed in reverse row order
# (granite-moe's width, 2 layers, 512 tokens): 0 for the loss and for layer
# 0; on the card a served MoE layer was 4.3e-6 from its plain route (PERF.md).
# The limits leave two orders of magnitude over that for the backward
MOE_TRAIN_TOL = {"loss": 1e-4, "layer0": 1e-3}
TRAIN_PHASES = ("rank_gradients", "aggregate", "apply")
# restart and dry run (phase 8): qwen1.5 as in phase 7 through train.run with
# a checkpoint every RESTART_EVERY steps, the failure at step RESTART_FAIL and
# the restart on RESTART_SHRINK ranks from the step-RESTART_AT checkpoint. The
# first loss after it is the same step on the same parameters and global
# batch, only the ranks' sum in another order: RESTART_LOSS_TOL relative
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL, RESTART_SHRINK, RESTART_AT = 4, 2, 3, 4, 2
# the restarts' rows (phase 8's and phase 10's), half phase 7's: the
# checkpoint is the same 5.57 GB, and the steps around the failure cost half
RESTART_SEQ = 1024
RESTART_FLAGS = ("--ckpt-every", str(RESTART_EVERY), "--fail-step", str(RESTART_FAIL),
                 "--shrink-to", str(RESTART_SHRINK))
RESTART_LOSS_TOL = 1e-5
# granite-moe's save/restore on the kernel route at 4 of its 24 layers: a
# checkpoint of all 24 (fp32 parameters and moments) is 16 GB
MOE_CKPT_LAYERS = 4
# the dry run against the card, on the cells it says fit: the peak within
# 25% of the card's (the allocator rounds and caches), the FLOPs within 1e-6.
# Its cells run on the meta device in DRYRUN_JOBS worker processes started
# beside phase 7 (``dryrun_start``), whose training keeps the card busy and
# leaves the host's other cores idle; 6 of the 8 leave one to phase 7's
# own process
DRYRUN_PEAK_TOL, DRYRUN_FLOP_TOL, DRYRUN_JOBS = 0.25, 1e-6, 6
# serving across a (data, model) mesh (phase 9): arch → (mesh, global batch,
# prompt, greedy tokens). qwen1.5 at (2, 4): tp 4, 2 data ranks × 4 rows;
# granite-moe at (1, 16), the reference's production model axis: tp 16, kv 8
# (dup span 2), 32 experts (2 slots a rank), the MoE prefill on the a2a
# dispatch at the config's capacity 1.25; mamba2 at (2, 2), the mesh the
# reference's own tests serve it on (tests/test_train_e2e.py:70-80). The
# other kinds at the reference's tp on a model axis one card holds:
# minicpm3 at (1, 8) (its config's tp 8: MLA, 5 heads a rank, the latent
# cache held once); recurrentgemma at (2, 2) (its config's tp 2: the RG-LRU
# and local attention, kv 1 over 2 ranks, a data world of 2; 2,048 is a
# multiple of its window); qwen2-vl at (1, 8) (resolve_tp(8) = 4, rep 2:
# M-RoPE over patch embeddings, the batch split over the rep groups);
# seamless at (1, 16) (tp 16: the non-causal encoder over ENC_FRAMES frames,
# cross-attention, a DEC_PROMPT-token decoder prompt)
# (all at full depth until the script had to be cut to its time limit: now
# granite-moe at 12 of 24 layers, mamba2 at 24 of 48 and minicpm3 at 16 of
# 62, MESH_LAYERS)
MESH_SERVE = {"qwen1.5-0.5b": ((2, 4), 8, 4096, 16),
              "granite-moe-1b-a400m": ((1, 16), 4, 2048, 8),
              "mamba2-1.3b": ((2, 2), 4, 2048, 8),
              "minicpm3-4b": ((1, 8), 4, 2048, 8),
              "recurrentgemma-2b": ((2, 2), 4, 2048, 8),
              "qwen2-vl-7b": ((1, 8), 4, 2048, 8),
              "seamless-m4t-large-v2": ((1, 16), 4, DEC_PROMPT, 8)}
MESH_LAYERS = {"granite-moe-1b-a400m": 12, "mamba2-1.3b": 24, "minicpm3-4b": 16}
# launches of one served path over the mesh: (flash_attention, segment_reduce);
# seamless: 24 encoder layers (non-causal) and 24 decoder self-attentions
MESH_LAUNCHES = {"qwen1.5-0.5b": (24, 0), "granite-moe-1b-a400m": (12, 12),
                 "mamba2-1.3b": (0, 0), "minicpm3-4b": (0, 0), "recurrentgemma-2b": (0, 0),
                 "qwen2-vl-7b": (28, 0), "seamless-m4t-large-v2": (48, 0)}
# the warm TP prefills that benchmarks/torch_path_profile.py traces
MESH_PREFILL_NAMES = {"qwen1.5-0.5b": "serve_prefill_tp_qwen1.5",
                      "granite-moe-1b-a400m": "prefill_tp_granite_moe",
                      "mamba2-1.3b": "prefill_tp_mamba2",
                      "minicpm3-4b": "prefill_tp_minicpm3",
                      "recurrentgemma-2b": "prefill_tp_recurrentgemma",
                      "qwen2-vl-7b": "prefill_tp_qwen2_vl",
                      "seamless-m4t-large-v2": "prefill_tp_seamless"}
# the archs whose TP serving phase 9 holds to the tp = 1 route of the same
# model. The two routes differ only in the row-parallel products (every
# other op is the same code on the same input), so each such sublayer is
# held on its own input (SUBLAYER_TOL), and the last position's logits
# (normwise relative) within TP_TOL and the compute-at-data decode within
# CAD_TOL for qwen1.5. Sharpened random weights make the other kinds
# amplify rounding-level differences far more over their depth (on an
# NVIDIA H100 80GB HBM3 at 700 W: every sublayer within 3e-3, the logits
# 0.063 apart for minicpm3, 0.088 recurrentgemma, 0.30 qwen2-vl, whose
# sharpened attention scores are ~4x qwen1.5's), so their logits are
# held to the larger of TP_TOL and SENSITIVITY_FACTOR × the model's own
# response to rounding-level noise on those products (``rounding_noise``),
# and their compute-at-data decode step to CONSIST_TOL, this script's limit
# for one decode step by two routes at full depth. A control must exceed the
# logits' limit: the TP prefill with each row-parallel sum replaced by one
# rank's partial × tp. granite-moe is held by its a2a check (router
# near-ties), mamba2 by its cache.
TP_CHECK_ARCHS = ("qwen1.5-0.5b", "minicpm3-4b", "recurrentgemma-2b", "qwen2-vl-7b",
                  "seamless-m4t-large-v2")
# TP prefill vs the tp = 1 route of the same weights, normwise relative over
# the last position's logits: the TP route rounds each of the 48 row-parallel
# products (attention's and the MLP's output projections) as 4 bf16 partials
# before their sum, where tp = 1 rounds one product: a few 2**-9 a layer, a
# random walk over 24 layers, as SERVE_TOL's flash-vs-masked roundings are
TP_TOL = SERVE_TOL
# compute-at-data vs gather decode, one step on one cache, normwise relative
# logits: the MLP's column products sum two bf16 d-slice partials where the
# gather route rounds one product, 2**-9 a product over 24 layers
CAD_TOL = 2e-2
# the least share of rows on which a token check compares (its top-two margin
# clear of the routes' logit difference); every other row's token must be
# among the reference route's top two. Required for qwen1.5. Equality where
# decisive follows from the logits' bound; under the other kinds' wider
# differences few of 4 rows are decisive and a third choice can win, so for
# them the count and the top-two membership are printed, not required
DECISIVE_SHARE = 0.5
# each row-parallel sublayer of a TP prefill against the tp = 1 route on its
# own input (tp_layer_readings), normwise relative: only that sublayer's bf16
# partials separate them, a few 2**-9
SUBLAYER_TOL = 2e-2
# how far above the model's response to one-ulp noise on every row-parallel
# product (about 1.5x the TP route's own per-product difference) the TP
# route's logits may lie: room for the spread of one chaotic draw
SENSITIVITY_FACTOR = 3.0
# a2a vs replicated MoE on the same input, on tokens none of whose
# assignments dropped (rtol = atol): the reference's own, tests/test_train_e2e.py:63
A2A_TOL = 2e-2
# the a2a combine on the kernel vs its plain version, relative to the largest
# sum: fp32 sums of 8 bf16 rows a token in another order (atomics)
COMBINE_TOL = 1e-4


# training under tensor parallelism (phase 10). (a) qwen1.5 at full width
# and depth on the reference's e2e mesh (tests/test_train_e2e.py:5-22):
# (4, 2) is tp 2, 4 data ranks × 2 of the 8 × 2,048 rows; one step a
# scenario (HIERARCHICAL on (2, 2, 2)) from the same parameters, each
# aggregated gradient against NATIVE's fp32 sum of the same ranks'
# gradients within AGG_TOL, and the TP step's loss against the tp = 1 step on
# the same parameters and rows within TP_LOSS_TOL: the two differ in the
# row-parallel products' bf16 partials (two a product, summed in fp32, where
# tp = 1 rounds one product) and in the cross-entropy's sum of the two vocab
# shards' exponentials; at the smoke width on the CPU they agree within
# test_torch_train's LOSS_TOL (tests/test_torch_tp_train.py), and a mean over
# 16,384 tokens averages a random walk of such roundings, so the limit
# leaves room for 24 layers. Then TP_RESTART through train.run: a
# checkpoint, the failure, the restart on 4 devices, which keep the model
# axis: (2, 2)
TP_TRAIN_MESHES = {"native": "4,2", "s1_host": "4,2", "s2_in_net": "4,2",
                   "s3_in_net_map": "4,2", "hierarchical": "2,2,2"}
TP_LOSS_TOL = 1e-3
TP_RESTART = {"mesh": "4,2", "steps": 4, "every": 2, "fail": 3, "shrink": 4, "at": 2}
# (b) recurrentgemma-2b on (1, 4): its config's tp 2, so rep 2 (its one kv
# head over span 2 × rep 2), and the rep groups' S3 rings; 3 × 2,048 rows,
# which do not split over the rep groups. Its depth is cut only as far as
# the card's memory forces (rec_tp_depth): the deepest cut of whole
# superblocks and the 2-layer tail whose train step the dry run's
# meta-device count (dryrun.Cell.memory: fp32 parameters, bf16 copies,
# moments and the batch held; the ranks' gradients, the aggregated ones,
# activations and the update's temporaries) puts within REC_TP_MARGIN of
# the card's memory, searched from the last element's layers. The margin
# is for what the count does not see: the CUDA context, the caching
# allocator's rounding and the checks' per-leaf copies. Two S3 steps, each
# aggregated gradient held against NATIVE and bitwise against the ring run
# with ref.ring_fused_step
REC_TP = ("recurrentgemma-2b", "1,4", 3, 17)
REC_TP_MARGIN = 0.04
# (c) granite-moe-1b-a400m on (1, 16): tp 16, its 8 kv heads over span 2, 32
# experts 2 slots a rank, the a2a dispatch at the config's capacity 1.25;
# phase 8's cut of 4 layers, MOE_TRAIN_BATCH × 2,048 rows, two S3 steps (a
# data world of 1 and rep 1: no ring hops). The loss of one batch on the
# kernel route against the plain route (ref.segment_reduce, the expert
# choices replayed) within MOE_TRAIN_TOL["loss"]
MOE_TP = ("granite-moe-1b-a400m", "1,16", MOE_TRAIN_BATCH, MOE_CKPT_LAYERS)
# the data plane on a process mesh (phase 11): PROCS_WORLD gloo ranks
# spawned on the one card, each holding only its own shard of phase 3's
# inputs, run phase 3's paths of PROCS_PATHS (a warm-up call, then one timed
# between barriers). Each rank's outputs are held to phase 3's world-dim run
# on the same card: bitwise, or for PROCS_CLOSE within PROCS_TOL (gloo's
# all-reduce adds in its own order); each path's kernel launches in every
# rank to PROCS_LAUNCHES (none where it names none).
PROCS_WORLD = N_MAPPERS
PROCS_TIMEOUT_S = 300
PROCS_PATHS = ("wordcount_histogram", "wordcount_token", "wordcount_s1_host",
               "aggregate_s1_host", "aggregate_s2_in_net", "aggregate_s3_in_net_map",
               "aggregate_native", "aggregate_hierarchical", "plan_wordcount_tree")
PROCS_CLOSE = ("aggregate_native", "aggregate_hierarchical")
PROCS_TOL = 1e-5
PROCS_LAUNCHES = {"wordcount_histogram": {"segment_reduce": 1},
                  "wordcount_token": {"hash_partition": 2, "segment_reduce": 1},
                  "aggregate_s3_in_net_map": {"ring_fused_step": N_MAPPERS - 1},
                  "plan_wordcount_tree": {"segment_reduce": 1}}
# serving on a process mesh (phase 12): arch → (mesh, global batch, prompt,
# greedy tokens), one gloo rank per device on the one card. qwen1.5 as
# phase 9 serves it (tp 4: a rank's 4 heads and kv slots, 2 data ranks x 4
# rows); granite-moe at (1, 8), not phase 9's (1, 16), to keep the phase at 8
# processes (tp 8: one kv head and 4 experts a rank, the a2a at the config's
# capacity 1.25); mamba2 at (2, 2) as phase 9 (tp 2). Full width; the
# greedy tokens cut from phase 9's 16 and 8 to 3, and the depth of qwen1.5
# and of the two archs beside it halved (PROCS_SERVE_LAYERS; qwen1.5 served
# all 24 layers until the script had to be cut to its time limit, and is
# served at full depth under nccl in phase 14), so that the whole
# script stays well inside its time limit: a decode step takes 1.3-2.9 s on
# gloo ranks that share the card, a prefill 7-15 s (measured on an NVIDIA
# H100 80GB HBM3 at 700.00 W; PERF.md §5). The other block kinds at full
# width, 4 rows and 3 tokens: minicpm3 at (1, 4) (tp 4: MLA, 10 heads a
# rank, the latent cache of its rows) at 8 of 62 layers; recurrentgemma at
# (2, 2) as phase 9 (tp 2: the RG-LRU by tp rank, the rolling window over
# its one kv head's copies) at 8 of 26 (2 superblocks and the tail), 2,048
# a multiple of its window; qwen2-vl at (1, 8) as phase 9 (tp 4, rep 2: a
# rank's 7 q heads and one kv slot, patch embeddings on their (t, h, w)
# grid, the batch split over the rep groups) at 4 of 28; seamless at (1, 4)
# (tp 4: the non-causal encoder over ENC_FRAMES frames, cross-attention
# over a rank's kv slots, a DEC_PROMPT-token prompt) at 6 + 6 of 24 + 24
PROCS_SERVE = {"qwen1.5-0.5b": ((2, 4), 8, 4096, 3),
               "granite-moe-1b-a400m": ((1, 8), 4, 2048, 3),
               "mamba2-1.3b": ((2, 2), 4, 2048, 3),
               "minicpm3-4b": ((1, 4), 4, 2048, 3),
               "recurrentgemma-2b": ((2, 2), 4, 2048, 3),
               "qwen2-vl-7b": ((1, 8), 4, 2048, 3),
               "seamless-m4t-large-v2": ((1, 4), 4, DEC_PROMPT, 3)}
PROCS_SERVE_LAYERS = {"qwen1.5-0.5b": 12,  # of 24
                      "granite-moe-1b-a400m": 12, "mamba2-1.3b": 24,  # of 24 and 48
                      "minicpm3-4b": 8, "recurrentgemma-2b": 8, "qwen2-vl-7b": 4,
                      "seamless-m4t-large-v2": 6}  # of 62, 26, 28 and 24
PROCS_SERVE_ENC_LAYERS = {"seamless-m4t-large-v2": 6}  # of 24
# each rank's launches of one served path: (flash_attention, segment_reduce),
# one prefill flash per layer on the rank's heads (seamless: its encoder's
# non-causal ones and its decoder's), one a2a combine per MoE layer
PROCS_SERVE_LAUNCHES = {"qwen1.5-0.5b": (12, 0), "granite-moe-1b-a400m": (12, 12),
                        "mamba2-1.3b": (0, 0), "minicpm3-4b": (0, 0),
                        "recurrentgemma-2b": (0, 0), "qwen2-vl-7b": (4, 0),
                        "seamless-m4t-large-v2": (12, 0)}
# with an fsdp world and an MLP: both decode routes
PROCS_SERVE_CAD = ("qwen1.5-0.5b", "recurrentgemma-2b")
# the archs of one world size share one spawn: each rank serves them in turn
PROCS_SERVE_SPAWNS = (("qwen1.5-0.5b", "granite-moe-1b-a400m", "qwen2-vl-7b"),
                      ("mamba2-1.3b", "minicpm3-4b", "recurrentgemma-2b",
                       "seamless-m4t-large-v2"))
# the flash_attention rows at a rank's shapes: rank 0's first launch of each
# of these archs, and what it is
PROCS_SERVE_FLASH = {"qwen1.5-0.5b": "one rank's heads and rows of the prefill",
                     "qwen2-vl-7b": "one rank's prefill, GQA (its q heads over one kv slot)",
                     "seamless-m4t-large-v2": "one rank's encoder layer"}
# held to the world-dim run of the same mesh, weights and rows on each route:
# every step's logits normwise (the prefill's, then each decode step's, on
# the rows whose tokens so far agree) within TP_TOL, and the final cache
# blocks on the rows whose tokens all agree within TP_TOL: the two compute
# the same products, but a process's have its rows where the world-dim ones
# have every row (another cuBLAS kernel, another rounding), and gloo adds a
# group's fp32 partials in its own order; over 24 layers that is a random
# walk of bf16 roundings, as TP_TOL's. The tokens equal wherever the
# world-dim top-two margin exceeds twice the row's logit difference, and for
# the archs of PROCS_SERVE_SHARE on at least DECISIVE_SHARE of the positions
PROCS_SERVE_SHARE = ("qwen1.5-0.5b",)
# training on a process mesh (phase 13): arch → (mesh, global batch, steps),
# PROCS_TRAIN_SEQ tokens a row, S3, full width. qwen1.5 at (4, 2), the
# reference's e2e mesh (tp 2, 4 data ranks: 3 ring hops a FSDP leaf), two
# steps, then the restart world PROCS_TRAIN_RESTART from the checkpoint for
# one; granite-moe at (1, 8) (tp 8, the a2a dispatch, no rings: data 1, rep
# 1) and mamba2 at (2, 2) (tp 2), a step each. The depth cut to
# PROCS_TRAIN_LAYERS and the rows to 1,024 tokens so that the phase stays
# near 90 s: a rank's step makes ~47 staged collectives a layer under S3
# at (4, 2), 7-28 ms each on gloo ranks that share the card (phase 12).
# The other block kinds, a step each: qwen2-vl at (1, 8) as phase 12 (tp 4,
# rep 2: the rep groups' rings, M-RoPE over patch embeddings; 3 rows, which
# do not split over the rep groups: training refuses a split, REP_SPLIT) at
# 2 of 28 layers, since 8 ranks share the card and each holds its working
# slices and their gradients of the two 152k-row tables (0.55 GB each in
# fp32 at tp 4); recurrentgemma at (1, 4), phase 10's mesh (tp 2, rep 2:
# the RG-LRU vectors' and every TP leaf's rep ring; 3 rows, which do not
# split over the rep groups), at 5 of 26 layers, one superblock (rec, rec,
# attn_local) and the 2-layer tail: an 8-device mesh with rep 2, (2, 4),
# would put ~9 GB on each of 8 ranks by the count of its leaves (the
# 256,000-row table's working slice and gradient, 1.3 GB each); minicpm3
# at (1, 4) (tp 4: MLA, the latent norms and projections held whole) and
# seamless at (2, 2) (tp 2: the encoder's and decoder's FSDP rings) at 4
# layers, seamless's encoder at PROCS_TRAIN_ENC_LAYERS
PROCS_TRAIN = {"qwen1.5-0.5b": ((4, 2), 8, 2),
               "granite-moe-1b-a400m": ((1, 8), 4, 1),
               "mamba2-1.3b": ((2, 2), 4, 1),
               "qwen2-vl-7b": ((1, 8), 3, 1),
               "recurrentgemma-2b": ((1, 4), 3, 1),
               "minicpm3-4b": ((1, 4), 4, 1),
               "seamless-m4t-large-v2": ((2, 2), 4, 1)}
PROCS_TRAIN_SEQ = 1024
PROCS_TRAIN_LAYERS = {"qwen1.5-0.5b": 4, "granite-moe-1b-a400m": 4,
                      "mamba2-1.3b": 4, "qwen2-vl-7b": 2,  # of 24, 24, 48 and 28
                      "recurrentgemma-2b": 5, "minicpm3-4b": 4,  # of 26 and 62
                      "seamless-m4t-large-v2": 4}  # of 24
PROCS_TRAIN_ENC_LAYERS = {"seamless-m4t-large-v2": 4}  # of 24
PROCS_TRAIN_RESTART = (2, 2)
# qwen1.5 with 8-bit moments (AdamW(eightbit=True)) on (2, 2) from SEED, a
# step: each rank's (codes, scales) row against the world-dim step's row of
# its device, dequantized, per leaf within PROCS_EIGHTBIT_TOL
# (tests/test_torch_tp_train_kinds.py's EIGHTBIT_TOL: a gradient's bf16
# rounding turns a code by a step of its block's absmax / 127) but for the
# key bias, whose gradient is rounding noise (it cancels in the softmax),
# and over the tree within PROCS_MOMENT_TOL (tests/test_torch_train.py's
# MOMENT_TOL); its checkpoint written by rank 0 and restored in every rank
# into zeroed parameters and fresh moments, bitwise
PROCS_TRAIN_8BIT = (2, 2)
PROCS_EIGHTBIT_TOL, PROCS_MOMENT_TOL = 0.1, 5e-2
PROCS_NOISE_LEAVES = ("attn/bk",)
# the two worlds: (arch, what it does) in order; "restart" restores qwen1.5's
# checkpoint on PROCS_TRAIN_RESTART and takes one step, "8bit" trains it on
# PROCS_TRAIN_8BIT with 8-bit moments
PROCS_TRAIN_WORLDS = {"first": (("qwen1.5-0.5b", "train"), ("granite-moe-1b-a400m", "train"),
                                ("qwen2-vl-7b", "train")),
                      "second": (("qwen1.5-0.5b", "restart"), ("mamba2-1.3b", "train"),
                                 ("recurrentgemma-2b", "train"), ("minicpm3-4b", "train"),
                                 ("seamless-m4t-large-v2", "train"), ("qwen1.5-0.5b", "8bit"))}
# held to the world-dim step of the same weights and batch, relative: the
# loss and the gradient's norm at tests/test_torch_procs_train.py's
# WORLD_LOSS_TOL and WORLD_NORM_TOL (the same products on other shapes,
# gloo's order of fp32 sums), and the whole update at test_torch_train's
# UPDATE_TOL (an element whose gradient is rounding noise takes an lr step
# of either sign), each element within two steps of lr
PROCS_TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-3}
PROCS_UPDATE_TOL = 0.15
# the process mesh under nccl, one card per rank (phase 14), on a host with
# NCCL_WORLD cards or more (else it does not run): NCCL_WORLD ranks on cards
# 0-3. In one nccl world: a partial permutation as the world's first
# collective (NCCL_FIRST, ranks left out), phase 11's data plane at
# W = NCCL_WORLD (NCCL_WORLD x 2^24 tokens, NCCL_WORLD x GRAD_SIZE fp32,
# HIERARCHICAL on (2, 2), the word-count plan on a 4-ring) held to its
# world-dim run on cuda:0 as phase 11 holds it, the collectives alone at
# NCCL_COLL_BYTES a rank, then qwen1.5 served and trained at (2, 2) at full
# depth as phases 12 and 13 serve and train (NCCL_CASE's entries of their
# tables: 8 x 4,096 prompts, 8 tokens, both routes, flash prefill; S3, 8 x
# PROCS_TRAIN_SEQ rows, 2 steps, the checkpoint gathered to rank 0 and
# written); the same 4 processes on a gloo group of their own, staged
# through pinned host memory (the data plane and the collectives), in the
# same world (``nccl_gloo_group``). The nccl world ends in the
# elastic restart inside it: ranks 0-1 go on on NCCL_RESTART over a group of
# their own, restore the checkpoint and take a step; ranks 2-3 leave
NCCL_WORLD = 4
NCCL_TIMEOUT_S = 300
NCCL_FIRST = ((0, 1),)  # rank 1 receives rank 0's block; ranks 2, 3 take no part
NCCL_COLL_BYTES = 256 << 20
NCCL_COLL_ITERS = {"nccl": 5, "gloo": 1}  # timed calls after a warm-up
# algorithm GB/s = NCCL_COLL_BYTES / time (the larger of a rank's send and
# receive buffers, as nccl-tests count them); bus GB/s = that x the factor
# (what each rank's link carries at n ranks: nccl-tests' convention)
NCCL_BUS = {"all_reduce": lambda n: 2 * (n - 1) / n, "all_gather": lambda n: (n - 1) / n,
            "reduce_scatter": lambda n: (n - 1) / n, "all_to_all": lambda n: (n - 1) / n,
            "ppermute": lambda n: 1.0}
NCCL_CASE = "qwen1.5-0.5b@nccl"
NCCL_RESTART = (1, 2)
PROCS_SERVE[NCCL_CASE] = ((2, 2), 8, 4096, 8)
PROCS_SERVE_LAUNCHES[NCCL_CASE] = (24, 0)  # full depth
PROCS_SERVE_CAD += (NCCL_CASE,)
PROCS_SERVE_SHARE += (NCCL_CASE,)
PROCS_TRAIN[NCCL_CASE] = ((2, 2), 8, 2)
PROCS_TRAIN_LAYERS[NCCL_CASE] = 24  # of 24
# every other block kind in the same nccl world after qwen1.5, served and
# trained at full width as phases 12 and 13 serve and train them and held the
# same way: granite-moe at (1, 4) on its a2a route (tp 4: 8 experts and 2 kv
# heads a rank, the config's capacity 1.25), all 24 layers served, 4
# trained; qwen2-vl at (1, 4) (tp 4, rep 1: 7 q heads over one kv head a
# rank), 4 of 28 layers served, 2 trained; these two with references of
# their own. mamba2, minicpm3, recurrentgemma and seamless on their phase 12
# and 13 meshes, and qwen1.5's 8-bit job on PROCS_TRAIN_8BIT, reuse those
# phases' four-rank references (``procs_serve_phase``/``procs_train_phase``
# keep them for phase 14): the ranks draw the same weights from SEED
NCCL_MOE, NCCL_VL = "granite-moe-1b-a400m@nccl", "qwen2-vl-7b@nccl"
PROCS_SERVE[NCCL_MOE] = ((1, 4), 4, 2048, 3)
PROCS_SERVE_LAUNCHES[NCCL_MOE] = (24, 24)  # all 24 layers
PROCS_SERVE[NCCL_VL] = ((1, 4), 4, 2048, 3)
PROCS_SERVE_LAYERS[NCCL_VL] = 4  # of 28
PROCS_SERVE_LAUNCHES[NCCL_VL] = (4, 0)
PROCS_TRAIN[NCCL_MOE] = ((1, 4), 4, 1)
PROCS_TRAIN_LAYERS[NCCL_MOE] = 4  # of 24
PROCS_TRAIN[NCCL_VL] = ((1, 4), 4, 1)
PROCS_TRAIN_LAYERS[NCCL_VL] = 2  # of 28
NCCL_SERVE = (NCCL_CASE, NCCL_MOE, "mamba2-1.3b", "minicpm3-4b", "recurrentgemma-2b", NCCL_VL,
              "seamless-m4t-large-v2")
NCCL_TRAIN_WORLDS = {"first": ((NCCL_CASE, "train"), (NCCL_MOE, "train"), ("mamba2-1.3b", "train"),
                               ("minicpm3-4b", "train"), ("recurrentgemma-2b", "train"),
                               (NCCL_VL, "train"), ("seamless-m4t-large-v2", "train"),
                               ("qwen1.5-0.5b", "8bit")),
                     "restart": ((NCCL_CASE, "restart"),)}
# phi3-medium-14b at (2, 2) (tp 2, data 2: 20 q heads over 5 kv heads and a
# quarter of its ~14.7 B parameters a rank), all 40 layers: 4 x 2,048
# prompts, 3 tokens, both decode routes. It does not fit one card, so it has
# no world-dim reference: its routes are held against each other on the
# ranks (``nccl_phi3_rank``): the flash prefill against the masked one
# within SERVE_TOL scaled to its 40 layers (``within``'s random walk), the
# compute-at-data decode step against the gather one from one cache within
# CAD_TOL scaled the same way (the column products' two bf16 partials a
# product, now over 40 layers), and ``cache_consistency`` within
# CONSIST_TOL. On random weights 40 layers deep (d 5,120) the two prefills
# and the two decode steps part further than those random walks (measured
# 0.112 and 0.0586 on four H100s): the roundings compound, as phase 9 found
# for the TP routes (qwen2-vl 0.30). So, as phase 9 holds them, each limit
# is the larger of that scaled one and SENSITIVITY_FACTOR x the model's own
# response to one-ulp noise on every row-parallel product
# (``rounding_noise``, the same route with and without it), each flash
# layer is held against the masked attention on its own input within
# ATTN_TOL (``layer_readings``: nothing compounds there), and the prefill's
# limit must reject a kernel without its causal mask
NCCL_PHI3 = "phi3-medium-14b"
PROCS_SERVE[NCCL_PHI3] = ((2, 2), 4, 2048, 3)
PROCS_SERVE_LAUNCHES[NCCL_PHI3] = (40, 0)
PHI3_DEPTH = (40 / 24) ** 0.5
# the kernel rows at a rank's shapes in phase 14: flash_attention at rank 0's
# first launch of each of these cases, and what it is
NCCL_FLASH = {NCCL_CASE: "rank 0's heads and rows of the prefill at (2, 2)",
              NCCL_VL: "rank 0's prefill at (1, 4), GQA (7 q heads over one kv head)",
              NCCL_PHI3: "rank 0's prefill at (2, 2), GQA (20 q heads over 5 kv heads)",
              "seamless-m4t-large-v2": "rank 0's encoder layer at (1, 4)"}


def case_arch(case: str) -> str:
    """The arch of a process-mesh case: its name before any ``@``."""
    return case.split("@")[0]


def log(msg: str) -> None:
    print(msg, flush=True)


START = time.perf_counter()
STAGES: dict[str, tuple[float, str]] = {}  # each phase's first stage: (its time, its line)


def stage(what: str) -> None:
    """A line on standard error as each phase starts, with the seconds since
    the script began: where a run that was cut stood. The first stage of
    each phase ("phase N ...") and "done" are kept for ``phase_walls``."""
    now = time.perf_counter()
    key = what.split()[1] if what.startswith("phase ") else what
    STAGES.setdefault(key, (now, what.removeprefix("phase ")))
    print(f"chip_smoke: {now - START:.1f} s: {what}", file=sys.stderr, flush=True)


def phase_walls() -> dict:
    """Each phase's wall in seconds, from its first stage to the next
    phase's (the last one's to "done"), by its first stage's words in phase
    order, and the script's so far under "script_s"."""
    marks = sorted(STAGES.values())
    walls = {label: b[0] - a for (a, label), b in zip(marks, marks[1:])}
    order = sorted(walls, key=lambda label: (int(label.split()[0].rstrip("b")), label))
    return {**{label: walls[label] for label in order}, "script_s": time.perf_counter() - START}


def _gated_call(fn, gate: str, device) -> dict:
    """A rank's call of ``fn`` once the file ``gate`` exists (``spawning``),
    with the wall-clock times it stood ready, began and ended; raises where
    ``gate`` + ".failed" appears instead."""
    ready = time.time()
    while not Path(gate).exists():
        if Path(gate + ".failed").exists():
            raise RuntimeError("the parent failed before the ranks' call")
        time.sleep(0.02)
    begin = time.time()
    out = fn(device)
    return {"out": out, "ready": ready, "begin": begin, "end": time.time()}


@contextlib.contextmanager
def spawning(fn, world: int, **kw):
    """``launch.procs.spawn(fn, world, **kw)`` begun before what ``fn``
    reads exists: the ranks start (the processes, torch's import, a CUDA
    context each, the group) while the ``with`` block makes it, and call
    ``fn`` once the block has ended; where the block fails they stop. Yields
    a dict that after the block holds "ranks", every rank's result, and
    "times", where the wall went: "start_s" from the spawn to the last rank
    standing ready, "idle_s" how long the ranks then stood ready for the
    block (0 where they were still starting when it ended), "call_s" the
    slowest rank's call, "teardown_s" from the last call's end to the
    spawn's return (the group's end, the processes' exit)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import procs

    gate = f"{kw['store_path']}.go"
    for p in (gate, gate + ".failed"):
        Path(p).unlink(missing_ok=True)
    got = {}
    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(procs.spawn, functools.partial(_gated_call, fn, gate), world, **kw)
        try:
            yield got
        except BaseException:
            Path(gate + ".failed").touch()
            raise
        go = time.time()
        Path(gate).touch()
        ranks = ranks.result()
    t1 = time.time()
    ready, end = max(r["ready"] for r in ranks), max(r["end"] for r in ranks)
    got["ranks"] = [r["out"] for r in ranks]
    got["times"] = {"spawn_s": t1 - t0, "start_s": ready - t0, "idle_s": max(0.0, go - ready),
                    "call_s": max(r["end"] - r["begin"] for r in ranks),
                    "teardown_s": t1 - end}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, its replay timed by CUDA events, over ``iters``. No host
    issue lies between the launches, so at small sizes this is the kernel's
    own time where ``cuda_ms`` (the same calls issued back to back) may be
    the host's. ``fn`` reads inputs that the call before it left in L2
    unless it takes them in turn (``in_turn``)."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def hop_layout(t) -> tuple:
    """How an S3 hop's ``acc`` lies: (shape, element strides, its offset's
    phase in 16 B in elements, elements spanned from its first to its last)."""
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return (tuple(t.shape), tuple(t.stride()), t.data_ptr() % 16 // t.element_size(), span)


def process_hop_layout(n: int, world: int, rank: int = 0) -> tuple:
    """``hop_layout`` of ``rank``'s first S3 hop on a process mesh of
    ``world`` over a flat gradient of ``n``: chunk (rank − 2) mod world of
    its (1, world, n / world) chunks, a view at that chunk's offset
    (``ring_reduce_scatter``; the buffer itself 16-B aligned)."""
    m = n // world
    return ((1, m), (m, 1), (rank - 2) % world * m % 4, m)


def seeded_hop(layout: tuple, gen, device="cuda"):
    """An S3 hop's inputs of seeded values: ``acc`` laid out as ``layout``
    (``hop_layout``) in a new buffer, ``wire`` contiguous, as it lands."""
    import torch

    shape, stride, phase, span = layout
    buf = torch.randn((phase + span,), generator=gen, device=device)
    acc = torch.as_strided(buf, shape, stride, phase)
    wire = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    return acc, wire


# a timed hop's inputs are read again only after this many L2s of other inputs
COLD_L2S = 4


def cold_pairs(acc, wire, iters: int = 20) -> list:
    """(acc, wire) and copies of them, each acc laid out as ``acc`` is
    (``hop_layout``): enough pairs that the inputs of the others outweigh the
    card's L2 ``COLD_L2S`` times, at most ``iters``."""
    import torch

    l2 = torch.cuda.get_device_properties(acc.device).L2_cache_size
    n = max(1, min(iters, math.ceil(COLD_L2S * l2 / (acc.numel() * 6))))
    shape, stride, phase, span = hop_layout(acc)
    pairs = [(acc, wire)]
    for _ in range(n - 1):
        a = torch.as_strided(torch.empty((phase + span,), device=acc.device), shape, stride, phase)
        pairs.append((a.copy_(acc), wire.clone()))
    return pairs


def in_turn(fn, pairs):
    """A call of ``fn`` on the next of ``pairs`` each time, the last
    ``len(pairs)`` calls' outputs kept: timed so, each call reads its inputs
    from device memory and writes where no call before it wrote, as an S3
    hop reads a chunk of a gradient that was just computed, not from an L2
    that the call before warmed. Warm it up with two rounds of ``pairs``
    before timing it back to back: the allocator then holds every output
    block, and no timed call waits on ``cudaMalloc``."""
    turn, kept = itertools.cycle(pairs), collections.deque(maxlen=len(pairs))
    return lambda: kept.append(fn(*next(turn)))


def ring_row(acc, wire, path: str, shape: str, launches: int = 0) -> dict:
    """The kernels line's row of ``ring_fused_step`` at one hop, ``acc`` as
    the path hands it: held bitwise against the plain version, timed back to
    back (``ms``) and on the device alone (``device_ms``, ``graph_ms``), each
    call on inputs that are not in L2 (``cold_pairs``, ``in_turn``), with the
    route the wrapper planned and the copies it made (0 unless the layout is
    one no route reads)."""
    from repro_torch.kernels import ops, ref

    rf, rfs = bare_launchers()[2], importlib.import_module("repro_torch.kernels.ring_fused_step")
    before = ops.COPIES["ring_fused_step"]
    kout, pout = rf(acc, wire), ref.ring_fused_step(acc, wire)
    if not all(equal(k, p) for k, p in zip(kout, pout)):
        raise AssertionError(f"ring_fused_step differs at {path}'s hop {tuple(acc.shape)} "
                             f"strides {acc.stride()}")
    plan = rfs.plan(acc.shape, acc.stride(), wire.stride())
    pairs = cold_pairs(acc, wire)
    n = acc.numel()
    b, b_by = bound_ms(n * 12, n)
    row = {
        "name": "ring_fused_step", "route": "cuda",
        "source": "src/repro_torch/csrc/ring_fused_step.cu",
        "replaces": "src/repro/kernels/ring_fused_step.py:41",
        "launches": launches, "max_abs_err": max_abs_err(zip(kout, pout)),
        "ms": cuda_ms(in_turn(rf, pairs), warmup=2 * len(pairs)),
        "device_ms": graph_ms(in_turn(rf, pairs)),
        "plain_ms": cuda_ms(in_turn(ref.ring_fused_step, pairs), warmup=2 * len(pairs)),
        "bound_ms": b, "bound_by": b_by, "library_ms": None, "path": path,
        "shape": shape, "layout": {"strides": list(acc.stride()), "phase_16B": hop_layout(acc)[2],
                                   "kernel_route": plan.route, "dims": list(plan.dims)},
    }
    row["copies"] = ops.COPIES["ring_fused_step"] - before
    row["cold_pairs"] = len(pairs)
    return row


def ring_hop_layouts() -> dict:
    """``hop_layout`` of each kernels-line row's S3 hop, ``acc`` as its path
    hands it: the world-dim ring's gather over 8 devices (phases 3-4), a
    rank's first hop over the flat gradient (phase 11: rank 0 of 8; phase
    14: rank 3 of 4), and the two that phase 13 captures in its ranks:
    rank 0's first hop of qwen1.5's embedding gradient (75,968, 1,024) cut
    along its dim 1 over a data ring of 4 (chunk 2 of (4, 256, 75,968),
    strides (1, 1,024)), and recurrentgemma's (64,000, 2,560) table chunk."""
    m = GRAD_SIZE // 8
    return {
        "world_s3_hop": ((8, m), (m, 1), 0, 8 * m),
        "procs_s3_hop": process_hop_layout(GRAD_SIZE, 8, 0),
        "nccl_s3_hop": process_hop_layout(GRAD_SIZE, 4, 3),
        "procs_train_embedding_hop": ((1, 1, 256, 75_968), (1_024, 1_024, 1, 1_024), 0,
                                      1 + 255 + 75_967 * 1_024),
        "procs_train_largest_hop": ((1, 1, 64_000, 2_560), (64_000 * 2_560, 64_000 * 2_560,
                                                           2_560, 1), 0, 64_000 * 2_560),
    }


def ring_hops(tree: Path) -> int:
    """``chip_smoke.py --ring-hops [TREE]``: ``ring_fused_step`` of the port
    in the checkout at TREE (this one by default; a parent commit unpacked
    by ``git archive`` into a git-ignored directory, say, so that two
    versions are timed in one call on one card: parent, change, change,
    parent) at each hop of ``ring_hop_layouts`` on seeded values: held
    bitwise against that tree's plain version, timed back to back
    (``ms``) and on the device alone (``device_ms``), each call on inputs
    not in L2 (``cold_pairs``), with ``acc`` as its path hands it and as a
    contiguous copy (``contiguous_*``: what a gather before the kernel
    hands it). Builds that tree's kernels into its ``build/``; prints one
    JSON line with the card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build, ref

    _build.build_all()
    rf = importlib.import_module("repro_torch.kernels.ring_fused_step").ring_fused_step
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hops = {}
    for name, layout in ring_hop_layouts().items():
        acc, wire = seeded_hop(layout, gen)
        n = acc.numel()
        row = {"shape": list(acc.shape), "strides": list(acc.stride()), "phase_16B": layout[2],
               "bound_ms": bound_ms(n * 12, n)[0]}
        for key, a in (("", acc), ("contiguous_", acc.contiguous())):
            if not all(equal(k, p) for k, p in zip(rf(a, wire), ref.ring_fused_step(a, wire))):
                raise AssertionError(f"ring_fused_step of {tree} differs at {name} "
                                     f"({key or 'as handed'})")
            pairs = cold_pairs(a, wire)
            row[key + "ms"] = cuda_ms(in_turn(rf, pairs), warmup=2 * len(pairs))
            row[key + "device_ms"] = graph_ms(in_turn(rf, pairs))
            del pairs
        hops[name] = row
        del acc, wire
        torch.cuda.empty_cache()
    log(json.dumps({"tree": str(tree), "card": smi, "torch": torch.__version__, "hops": hops}))
    return 0


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time for moving ``nbytes`` and doing ``ops`` at the card's
    peaks (``ops_per_s``: the rate of the operations' type), and which bounds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def max_abs_err(pairs) -> float:
    """Largest absolute difference over (kernel, plain) output pairs."""
    return max(float((k.double() - p.double()).abs().max()) for k, p in pairs)


def bare_launchers():
    """The kernels' own launchers (CUDA only, not counted in ``ops.LAUNCHES``).
    The package exports the dispatching wrappers under the same names, so the
    modules are looked up directly."""
    mods = [importlib.import_module(f"repro_torch.kernels.{n}")
            for n in ("hash_partition", "segment_reduce", "ring_fused_step")]
    return mods[0].hash_partition, mods[1].segment_reduce, mods[2].ring_fused_step


def data_plane_rows(words, recv, hop: tuple, prefix: str = "", buckets: int = N_MAPPERS
                    ) -> list:
    """The kernels line's rows of the three data-plane kernels: each held
    against its plain version and timed on the card at the shapes given,
    ``words`` (mappers, n) int32 for ``hash_partition`` and the histogram
    path's ``segment_reduce``, ``recv`` (reducers, m) the token path's
    received words, and one S3 hop's (acc, wire) for ``ring_fused_step``
    (``ring_row``), acc laid out as the path hands it, on the current card.
    ``prefix`` goes before each row's path; ``buckets``: the token path's
    reducers; the launch counts are the caller's to fill."""
    import torch

    from repro_torch.kernels import ref

    hp, sr, _ = bare_launchers()
    seg_mod = importlib.import_module("repro_torch.kernels.segment_reduce")
    rows = []
    n_tok, mappers = words.numel(), words.shape[0]
    kout, pout = hp(words, buckets), ref.hash_partition(words, buckets)
    if not all(equal(k, p) for k, p in zip(kout, pout)):
        raise AssertionError(f"hash_partition differs at {tuple(words.shape)}")
    b, b_by = bound_ms(n_tok * 8 + mappers * buckets * 4, 3 * n_tok)
    rows.append({
        "name": "hash_partition", "route": "cuda",
        "source": "src/repro_torch/csrc/hash_partition.cu",
        "replaces": "src/repro/kernels/hash_partition.py:47",
        "launches": 0, "max_abs_err": max_abs_err(zip(kout, pout)),
        "ms": cuda_ms(lambda: hp(words, buckets)),
        "plain_ms": cuda_ms(lambda: ref.hash_partition(words, buckets)),
        "bound_ms": b, "bound_by": b_by, "library_ms": None,
        "path": prefix + "wordcount_token",
        "shape": f"tokens {tuple(words.shape)} int32, B={buckets}",
    })
    del kout, pout

    # segment_reduce at both of its shapes: the histogram path's mapper
    # counts and the token path's reducer counts of received words
    for path, ids in (("wordcount_histogram", words), ("wordcount_token", recv)):
        ones = torch.ones((1, 1, 1), device="cuda").expand(ids.shape + (1,))
        ks, ps = sr(ones, ids, VOCAB), ref.segment_reduce(ones, ids, VOCAB)
        if not equal(ks, ps):
            raise AssertionError(f"segment_reduce counts differ at the {prefix}{path} shape")
        w = ids.shape[0]
        dump = w * VOCAB
        offs = torch.arange(w, device="cuda")[:, None] * VOCAB
        flat_idx = torch.where(ids >= 0, ids.long() + offs, dump).reshape(-1)
        src = torch.ones((1,), device="cuda").expand(flat_idx.shape)
        lib_out = torch.zeros((dump + 1,), device="cuda")
        n_ids = int((ids >= 0).sum())
        # two one-call yardsticks for the same counts; the row keeps the faster
        index_add_ms = cuda_ms(lambda: lib_out.index_add_(0, flat_idx, src))
        bincount_ms = cuda_ms(lambda: torch.bincount(flat_idx, minlength=dump + 1))
        b, b_by = bound_ms(ids.numel() * 4 + 4 + w * VOCAB * 4, n_ids)
        rows.append({
            "name": "segment_reduce", "route": "cuda",
            "source": "src/repro_torch/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:55",
            "launches": 0, "max_abs_err": max_abs_err([(ks, ps)]),
            "ms": cuda_ms(lambda: sr(ones, ids, VOCAB)),
            "plain_ms": cuda_ms(lambda: ref.segment_reduce(ones, ids, VOCAB)),
            "bound_ms": b, "bound_by": b_by,
            "library_ms": min(index_add_ms, bincount_ms),
            "index_add_ms": index_add_ms, "bincount_ms": bincount_ms,
            "branch": ("shared-memory histogram" if VOCAB * 4 <= seg_mod.max_bin_bytes()
                       else "global atomics"),
            "path": prefix + path,
            "shape": f"ids {tuple(ids.shape)} int32 ({n_ids} valid), broadcast ones, "
                     f"nseg={VOCAB} per row",
        })
        del ks, ps, flat_idx, src, lib_out

    acc, wire = hop
    what = "over 8 ranks" if acc.numel() == GRAD_SIZE else f"of one rank of {buckets}"
    rows.append(ring_row(acc, wire, prefix + "aggregate_s3_in_net_map",
                         f"acc {tuple(acc.shape)} fp32 + wire bf16: one S3 hop {what}, acc as "
                         "the ring hands it"))
    return rows


def draw_inputs(world: int = N_MAPPERS, tokens: int = TOKENS_PER_MAPPER,
                grad_size: int = GRAD_SIZE) -> tuple:
    """The data of the main paths for ``world`` mappers and devices, made
    from ``SEED`` on the host: (word shards, a list of ``tokens`` int32
    arrays; gradients (world, grad_size) fp32). A world's rows are the first
    rows of any larger world's."""
    import numpy as np

    from repro_torch.data.pipeline import wordcount_shards

    shards = wordcount_shards(world * tokens, world, VOCAB, seed=SEED)
    shards[3][-5:] = -1  # padding, as the tests do
    grads_np = np.random.default_rng(SEED).standard_normal((world, grad_size), dtype=np.float32)
    return shards, grads_np


def inputs():
    """The full-size data of the main paths (``draw_inputs``), laid on the
    card: (word shards as numpy, words (8, 2**24) int32, gradients as numpy,
    gradients (8, 25,557,032) fp32)."""
    from repro_torch.mesh import Mesh

    shards, grads_np = draw_inputs()
    return (shards, Mesh(("all",), (N_MAPPERS,)).shard(shards),
            grads_np, Mesh(("data",), (8,)).shard(grads_np))


def autotuned_wordcount():
    """``plan_wordcount_session``'s compile with the ``autotune`` pass
    appended: a ``Session`` on the 8-ring with ``max_fanin=4``, the
    ``autotuned`` preset and telemetry on, arbitrating 1 / 4 / 8 buckets.
    Returns (plan, the session's ``Telemetry``)."""
    from repro_torch import compiler, p4mr
    from repro_torch.core import wordcount as wc
    from repro_torch.core.topology import TorusTopology

    sess = p4mr.Session(TorusTopology(dims=(PLAN_RING,)), cost_model=compiler.CostModel(max_fanin=4),
                        options="autotuned", telemetry=True)
    plan = sess.arbitrate_buckets(
        lambda b: wc.wordcount_shuffle_program(N_MAPPERS, VOCAB, num_buckets=b),
        [1, N_MAPPERS // 2, N_MAPPERS], name="wordcount")
    return plan, sess.telemetry


def compile_plans(compile_ms: dict | None = None) -> dict:
    """The compiled-plan paths' plans, name → ``CompiledPlan``, each
    compiled on the host by the port's compiler: onto ``PLAN_RING``
    switches, and for ``simulator_device_step`` onto a k=8 fat-tree; each
    compile's wall (ms) goes into ``compile_ms`` when given. The autotuned
    plan is ``autotuned_wordcount``'s."""
    from repro_torch import compiler
    from repro_torch.core import scenarios, topology
    from repro_torch.core import wordcount as wc
    from repro_torch.core.topology import TorusTopology

    topo = TorusTopology(dims=(PLAN_RING,))
    agg_cost = compiler.CostModel(switch_memory_bytes=PLAN_SWITCH_MEMORY)
    jobs = {
        "plan_wordcount_tree": (wc.wordcount_program(N_MAPPERS, VOCAB), PLAN_PASSES, {}),
        "plan_wordcount_keyby": (
            wc.wordcount_shuffle_program(N_MAPPERS, VOCAB, num_buckets=N_MAPPERS),
            compiler.UNOPTIMIZED_PASSES, {}),
        "plan_aggregate_s1": (
            scenarios.scenario_program(8, "s1_host", state_width=GRAD_SIZE),
            compiler.UNOPTIMIZED_PASSES,
            {"pins": {"R": topo.attach_switch("d0")}, "cost_model": agg_cost}),
        "plan_aggregate_s2": (scenarios.scenario_program(8, "s2_in_net", state_width=GRAD_SIZE),
                              PLAN_PASSES, {"cost_model": agg_cost}),
        "plan_aggregate_s3": (
            scenarios.scenario_program(8, "s3_in_net_map", state_width=GRAD_SIZE),
            PLAN_PASSES, {"cost_model": agg_cost}),
    }
    ft = topology.fat_tree_topology(SIM_K)
    sim_prog = wc.wordcount_shuffle_program(
        SIM_MAPPERS, SIM_VOCAB, num_buckets=SIM_BUCKETS,
        hosts=[f"h{i}" for i in range(SIM_MAPPERS)], sink_host=f"h{len(ft.hosts) - 1}")
    builds = {name: (lambda prog=prog, passes=passes, kw=kw: compiler.compile(
        prog, topo, passes=passes, **kw)) for name, (prog, passes, kw) in jobs.items()}
    # the default pipeline: wordcount_via_plan's compile, and compile_scenario
    builds["plan_wordcount_session"] = lambda: wc._compile_wordcount_plan(N_MAPPERS, VOCAB)
    for sc in ("s1", "s2", "s3"):
        builds[f"plan_scenario_{sc}"] = lambda sc=sc: scenarios.compile_scenario(
            8, SCENARIOS[sc], state_width=GRAD_SIZE, cost_model=agg_cost)
    builds["simulator_device_step"] = lambda: compiler.compile(
        sim_prog, ft, passes=compiler.STATIC_ECMP_PASSES)
    plans = {}
    for name, build in builds.items():
        t = time.perf_counter()
        plans[name] = build()
        if compile_ms is not None:
            compile_ms[name] = (time.perf_counter() - t) * 1e3
    return plans


def timed(fn, *args):
    """(``fn(*args)``, its seconds): a host process's job, timed where it runs."""
    t = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t


def plan_on_cpu(plan, saved: str) -> tuple[str, float]:
    """A compiled plan's run on the CPU over phase 3's gradient rows
    (``save_inputs``' files under ``saved``), in the host process beside the
    card's phases: (the ``digest`` of its output's bits, its seconds)."""
    import numpy as np
    import torch

    torch.set_num_threads(4)  # the card's phases keep the other cores
    grads = np.load(Path(saved) / "grads.npy", mmap_mode="c")
    t = time.perf_counter()
    out = plan.run({f"g{i}": torch.from_numpy(np.array(grads[i])) for i in range(N_MAPPERS)},
                   backend="torch", device="cpu")["OUT"]
    return digest(out), time.perf_counter() - t


def schedule_tenants():
    """``BENCH_scheduler.json``'s two_wordcounts cell at ``VOCAB`` words:
    ``Scheduler(reroute_rounds=3)`` on a k=4 fat-tree admits ``TENANTS``.
    Returns (``ScheduleReport``, tenant → its plan on the fat-tree's integer
    view, which the torch backend addresses)."""
    from repro_torch import p4mr
    from repro_torch.core.topology import fat_tree_topology

    sess = p4mr.Session(fat_tree_topology(4))
    sched = p4mr.Scheduler(sess, reroute_rounds=3)
    for name, (hosts, sink) in TENANTS.items():
        job = p4mr.job(name)
        keyed = [job.store(f"s{i}", host=f"h{h}", items=VOCAB).key_by(4)
                 for i, h in enumerate(hosts)]
        keyed[0].reduce("SUM", *keyed[1:], label="R").collect(sink, label="OUT")
        sched.submit(job, name=name)
    rep = sched.run()
    return rep, {name: sess.plans[name].indexed() for name in rep.admitted}


def main_paths(words, grads, plans: dict | None = None, schedule=None) -> dict:
    """The port's main paths, name → call, through the entry points a user
    calls: word count by token shuffle, by histogram shuffle and by the S1
    host baseline on ``("all",)=8``; aggregation in S1, S2, S3 and NATIVE on
    ``("data",)=8`` and HIERARCHICAL on ``("pod","data")=(2,4)``; then the
    compiled plans of ``compile_plans`` and ``autotuned_wordcount``
    (``plans``, or compiled here, outside the calls), run by
    ``plan.run(backend="torch")``: the word counts over ``kernel_histogram``'s
    per-shard histograms, the aggregations over the gradient rows. Each plan
    call returns {sink: float64 numpy}. Then ``simulator_device_step``, the
    vectorized simulator over that plan with its step on the card (returns a
    ``SimReport``), and
    ``aggregate_s3_plan_order``, S3 on ``("data",)=8`` in the ring order
    ``plan_ring_order`` derives on a (2, 4) torus. Last
    ``scheduler_two_tenants``: the tenants of ``schedule_tenants`` (``schedule``,
    or scheduled here, outside the call), each plan run on the card over its
    own mappers' ``kernel_histogram`` rows (one launch for all 8)."""
    import dataclasses

    from repro_torch.compiler.vectorized import VoqParams, simulate_vectorized
    from repro_torch.core import scenarios
    from repro_torch.core import wordcount as wc
    from repro_torch.core.topology import TorusTopology
    from repro_torch.mesh import Mesh

    mesh = Mesh(("all",), (N_MAPPERS,))
    mesh8, mesh24 = Mesh(("data",), (8,)), Mesh(("pod", "data"), (2, 4))

    def hist_path():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return wc.wordcount_step(words, VOCAB, mesh, "all", histogram_fn=wc.kernel_histogram)

    paths = {
        "wordcount_token": lambda: wc.wordcount_token_shuffle(words, VOCAB, mesh, "all"),
        "wordcount_histogram": hist_path,
        "wordcount_s1_host": lambda: wc.wordcount_host_baseline(words, VOCAB, mesh, "all"),
    }
    for sc in ("s1_host", "s2_in_net", "s3_in_net_map", "native"):
        paths[f"aggregate_{sc}"] = lambda sc=sc: scenarios.aggregate(
            grads, mesh8, sc, data_axis="data")
    paths["aggregate_hierarchical"] = lambda: scenarios.aggregate(
        grads.view(2, 4, -1), mesh24, "hierarchical", data_axis="data", pod_axis="pod")

    def plan_wordcount(plan):
        hist = wc.kernel_histogram(words, VOCAB)  # one segment_reduce launch, every mapper
        return plan.run({f"s{i}": hist[i] for i in range(N_MAPPERS)}, backend="torch")

    plans = plans or {**compile_plans(), "plan_wordcount_autotuned": autotuned_wordcount()[0]}
    for name, plan in plans.items():
        if name.startswith("plan_wordcount"):
            paths[name] = lambda plan=plan: plan_wordcount(plan)
        elif name == "simulator_device_step":
            spec = plan.flow_spec()  # built once, outside the call
            params = dataclasses.replace(VoqParams.from_cost_model(plan.cost_model),
                                         use_torch=True)
            paths[name] = lambda plan=plan, spec=spec, params=params: simulate_vectorized(
                plan.program, spec, plan.cost_model, params=params)
        else:
            paths[name] = lambda plan=plan: plan.run(
                {f"g{i}": grads[i] for i in range(8)}, backend="torch")
    order = scenarios.plan_ring_order(8, topo=TorusTopology(dims=(2, 4)))
    paths["aggregate_s3_plan_order"] = lambda: scenarios.aggregate(
        grads, mesh8, "s3_in_net_map", data_axis="data", ring_order=order)
    _, tenant_plans = schedule or schedule_tenants()

    def scheduled():
        hist = wc.kernel_histogram(words, VOCAB)  # one segment_reduce launch, every mapper
        return {name: plan.run({f"s{i}": hist[m] for i, m in enumerate(TENANTS[name][0])})
                for name, plan in tenant_plans.items()}

    paths["scheduler_two_tenants"] = scheduled
    return paths


def recurrence_inputs():
    """The recurrence paths' data on the card, from ``SEED``: the decay
    ``a`` in [0.5, 1) and input ``b`` of (``SCAN_RANKS``, ``SCAN_LEN``,
    ``SCAN_BATCH``, ``SCAN_WIDTH``) fp32 (rank r holds positions
    [r·SCAN_LEN, (r+1)·SCAN_LEN)), the stages' (d, d) weights scaled by
    1/√d, and ``PIPE_MICRO`` microbatches of ``PIPE_SHAPE`` fp32."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (SCAN_RANKS, SCAN_LEN, SCAN_BATCH, SCAN_WIDTH)
    a = 0.5 + 0.5 * torch.rand(shape, generator=g, device="cuda")
    b = torch.randn(shape, generator=g, device="cuda")
    d = PIPE_SHAPE[-1]
    ws = torch.randn((PIPE_STAGES, d, d), generator=g, device="cuda") / d**0.5
    micro = torch.randn((PIPE_MICRO,) + PIPE_SHAPE, generator=g, device="cuda")
    return a, b, ws, micro


def pipeline_stage(w, h):
    """tanh(h @ W_s) on every stage at once: each stage's microbatch rows
    times its (d, d) weights, one batched product."""
    import torch

    p, d = w.shape[0], w.shape[-1]
    return torch.tanh(torch.bmm(h.reshape(p, -1, d), w)).view(h.shape)


def recurrence_paths(a, b, ws, micro) -> dict:
    """``sequence_parallel_linear_scan`` of ``h_t = a_t·h_{t−1} + b_t`` over
    ``("seq",)=SCAN_RANKS`` and ``pipeline_apply`` of ``PIPE_STAGES`` stages
    over ``("pipe",)=PIPE_STAGES``, name → call."""
    from repro_torch.core.pipeline import pipeline_apply
    from repro_torch.core.ring_scan import sequence_parallel_linear_scan
    from repro_torch.mesh import Mesh

    seq, pipe = Mesh(("seq",), (SCAN_RANKS,)), Mesh(("pipe",), (PIPE_STAGES,))
    return {
        "ring_scan_linear_recurrence": lambda: sequence_parallel_linear_scan(a, b, seq, "seq"),
        "pipeline_apply": lambda: pipeline_apply(pipeline_stage, ws, micro, pipe, "pipe"),
    }


def sequential_recurrence(a, b):
    """The scan's check: ``h_t = a_t·h_{t−1} + b_t`` in float64, one position
    at a time along the whole (rank-major) sequence, on the card."""
    import torch

    out = torch.empty(a.shape, dtype=torch.float64, device=a.device)
    h = torch.zeros(a.shape[2:], dtype=torch.float64, device=a.device)
    for r in range(a.shape[0]):
        for t in range(a.shape[1]):
            h = torch.addcmul(b[r, t].double(), a[r, t].double(), h)
            out[r, t] = h
    return out


def beyond_tol(got, want) -> tuple[float, float]:
    """(largest |got − want|, largest |got − want| / (tol + tol·|want|)) in
    float64, ``RECURRENCE_TOL`` as rtol and atol: the second is at most 1
    where ``numpy.testing.assert_allclose`` would pass."""
    d = (got.double() - want).abs()
    return float(d.max()), float((d / (RECURRENCE_TOL + RECURRENCE_TOL * want.abs())).max())


def check_kernels_at_edges(torch) -> dict:
    """Each kernel against its plain version on the card, at edge shapes,
    ``ring_fused_step`` also on every layout of ``ring_layouts``. Returns
    the copies its wrapper made on each of those layouts."""
    from repro_torch.kernels import ref

    hp, sr, rf = bare_launchers()
    dev = "cuda"
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def tokens(shape, lo=-1, hi=100_000):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32).to(dev)

    cases = [(tokens((n,)), b) for n in (1, 1023, 1024, 1025, 3000) for b in (2, 8, 16)]
    cases += [
        (torch.full((256,), -1, dtype=torch.int32, device=dev), 4),  # all padding
        (tokens((8, 1025)), 8),  # batched mappers
        (tokens((4096,), -2**31, 2**31 - 1), 61),  # full int32 range
        (tokens((2, 5000)), 20_000),  # histogram above 48 KB of shared memory
    ]
    for t, b in cases:
        (ki, kh), (pi, ph) = hp(t, b), ref.hash_partition(t, b)
        if not (equal(ki, pi) and equal(kh, ph)):
            raise AssertionError(f"hash_partition differs at {tuple(t.shape)}, B={b}")

    def vals(shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)

    for n, d, nseg, dtype in [(64, 8, 4, torch.float32), (1000, 32, 16, torch.float32),
                              (513, 128, 7, torch.bfloat16), (2048, 16, 64, torch.float32),
                              (1, 3, 2, torch.float16), (1025, 4, 9, torch.float16)]:
        v, ids = vals((n, d), dtype), tokens((n,), -1, nseg)
        torch.testing.assert_close(sr(v, ids, nseg), ref.segment_reduce(v, ids, nseg),
                                   rtol=2e-2, atol=2e-2)
    v, ids = vals((8, 1025, 3), torch.float32), tokens((8, 1025), -1, 5)  # batched reducers
    torch.testing.assert_close(sr(v, ids, 5), ref.segment_reduce(v, ids, 5), rtol=2e-2, atol=2e-2)
    ids = tokens((8, 4097), -1, 300)
    ones = torch.ones((1, 1, 1), device=dev).expand(8, 4097, 1)  # broadcast count: exact
    if not equal(sr(ones, ids, 300), ref.segment_reduce(ones, ids, 300)):
        raise AssertionError("segment_reduce integer counts differ")
    pad = torch.full((300,), -1, dtype=torch.int32, device=dev)
    if sr(vals((300, 2), torch.float32), pad, 4).abs().sum() != 0:
        raise AssertionError("segment_reduce counted padding rows")
    check_segment_reduce_branches(torch, sr, tokens, vals)

    for n in (1, 100, 1023, 1024, 1025, 16384, 40000):
        acc = vals((n + 1,), torch.float32)
        wire = vals((n + 1,), torch.bfloat16)
        for a, w in ((acc[:n], wire[:n]), (acc[1:], wire[1:])):  # aligned and not
            (ka, kw), (pa, pw) = rf(a, w), ref.ring_fused_step(a, w)
            if not (equal(ka, pa) and equal(kw, pw)):
                raise AssertionError(f"ring_fused_step differs at n={n}")
    copies = check_ring_layouts(torch, rf, vals)
    torch.cuda.synchronize()
    return copies


RING_COPIED = ("strided_slice", "transposed_wire")  # the layouts no kernel route reads


def ring_layouts(torch, vals) -> dict:
    """name → (acc, wire): the layouts of an S3 hop's inputs that the edge
    sweep holds ``ring_fused_step`` to. The rows route's: flat at each
    16-B phase, row-major, row-strided batches (aligned, off by one, an odd
    pitch), ``rep_aggregate``'s (tp, chunk, rest) chunks, 1 × n and n × 1;
    the tiles route's: a dense transposed acc, a transposed chunk of a wider
    gradient (strides (1, d)) at an aligned and an unaligned start, batched,
    ragged tiles; a wire off alignment; a 0-d and an empty hop; and
    ``RING_COPIED``, which the wrapper copies first."""
    def f32(*shape):
        return vals(shape, torch.float32)

    def bf16(*shape):
        return vals(shape, torch.bfloat16)

    grad = f32(1000, 1024)  # a (x, d) gradient: its chunks along d, (d/4, x) of strides (1, d)
    odd = f32(1 + 1000 * 1024)[1:].view(1000, 1024)
    rep = f32(2, 2 * 128, 1024).reshape(2, 2, 128, 1024)  # (tp, rep, chunk, rest)
    out = {f"flat_phase{k}": (f32(40_003)[k:k + 40_000], bf16(40_000)) for k in range(4)}
    out.update({
        "row_major": (f32(333, 700), bf16(333, 700)),
        "row_strided_batches": (f32(3, 50, 1040)[:, :, 16:1040], bf16(3, 50, 1024)),
        "row_strided_off_by_one": (f32(3, 50, 1040)[:, :, 1:1025], bf16(3, 50, 1024)),
        "row_pitch_odd": (f32(50, 1031)[:, :1030], bf16(50, 1030)),
        "rep_chunks": (rep.select(1, 1), bf16(2, 128, 1024)),
        "one_by_n": (f32(1, 7777), bf16(1, 7777)),
        "n_by_one": (f32(7777, 1), bf16(7777, 1)),
        "one_by_n_transposed": (f32(7777, 1).t(), bf16(1, 7777)),
        "n_by_one_transposed": (f32(1, 7777).t(), bf16(7777, 1)),
        "dense_transposed": (f32(1000, 257).t(), bf16(257, 1000)),
        "transposed_chunk_of_wider": (grad.t().reshape(4, 256, 1000)[1], bf16(256, 1000)),
        "transposed_chunk_unaligned": (odd.t().reshape(4, 256, 1000)[3], bf16(256, 1000)),
        "batched_transposed": (f32(3, 1000, 45).transpose(1, 2), bf16(3, 45, 1000)),
        "ragged_tiles": (f32(65, 31).t(), bf16(31, 65)),
        "wire_unaligned": (f32(4096), bf16(4097)[1:]),
        "scalar": (f32(1).reshape(()), bf16(1).reshape(())),
        "empty": (f32(0, 7), bf16(0, 7)),
        "strided_slice": (f32(300, 200)[:, ::2], bf16(300, 100)),
        "transposed_wire": (f32(90, 110), bf16(110, 90).t()),
    })
    return out


def check_ring_layouts(torch, rf, vals) -> dict:
    """``ring_fused_step`` (the bare launcher ``rf``) bitwise against its
    plain version on each of ``ring_layouts``; the layouts the wrapper
    plans on a kernel route copy nothing, ``RING_COPIED`` one tensor each.
    Returns {layout: copies}."""
    from repro_torch.kernels import ops, ref

    rfs = importlib.import_module("repro_torch.kernels.ring_fused_step")
    copies = {}
    for name, (a, w) in ring_layouts(torch, vals).items():
        before = ops.COPIES["ring_fused_step"]
        (ka, kw), (pa, pw) = rf(a, w), ref.ring_fused_step(a, w)
        copies[name] = ops.COPIES["ring_fused_step"] - before
        route = rfs.plan(a.shape, a.stride(), w.stride()).route
        if not (equal(ka, pa) and equal(kw, pw)):
            raise AssertionError(f"ring_fused_step differs on layout {name}: acc "
                                 f"{tuple(a.shape)} strides {a.stride()}, route {route}")
        if copies[name] != (name in RING_COPIED) or (route == "copy") != (name in RING_COPIED):
            raise AssertionError(f"ring_fused_step on layout {name}: route {route}, "
                                 f"{copies[name]} copies")
    return copies


def check_segment_reduce_branches(torch, sr, tokens, vals) -> int:
    """``segment_reduce``'s two branches against the plain version: the
    shared-memory histogram (uint32 counts for a broadcast value row, fp32
    sums otherwise) wherever the bins fit in ``max_bin_bytes``, and the
    global-atomic scatter one segment past that. Counts bitwise, float sums
    at 2e-2. Returns the number of cases."""
    from repro_torch.kernels import ref

    seg_mod = importlib.import_module("repro_torch.kernels.segment_reduce")
    limit = seg_mod.max_bin_bytes()
    most = limit // 4  # count bins (or d-1 fp32 bins) that fit
    dev = "cuda"

    def ones(shape):
        return torch.ones((1,) * (len(shape) + 1), device=dev).expand(tuple(shape) + (1,))

    def zipf(shape, nseg, hot):
        """Ids whose one id ``hot`` is more than half of each row, the rest
        uniform, a few -1 (padding) and a few past ``nseg`` (dropped)."""
        ids = tokens(shape, -1, nseg + 3)
        ids[tokens(shape, 0, 10) < 6] = hot
        return ids

    counts = [  # (ids, num_segments): bitwise
        (zipf((20_001,), most, 7), most),  # largest count histogram that fits
        (zipf((20_001,), most + 1, most), most + 1),  # one past: global branch
        (zipf((8, 40_003), 50_000, 3), 50_000),  # batched reducers, rows start mid-vector
        (zipf((3, 1_000_003), 1000, 999), 1000),  # many chunks a reducer, ragged tails
        (torch.full((4, 5000), -1, dtype=torch.int32, device=dev), 50_000),  # all padding
    ]
    big = zipf((100_005,), 50_000, 1)
    counts.append((big[1:], 50_000))  # starts 4 bytes past a 16-byte boundary
    n = 0
    for ids, nseg in counts:
        if not equal(sr(ones(ids.shape), ids, nseg), ref.segment_reduce(ones(ids.shape), ids, nseg)):
            raise AssertionError(f"segment_reduce counts differ at ids {tuple(ids.shape)}, "
                                 f"num_segments={nseg}")
        n += 1
    bcast = torch.randn((1, 3), device=dev).expand(20_001, 3)  # a broadcast row, d 3: counted
    ids = zipf((20_001,), 500, 2)
    torch.testing.assert_close(sr(bcast, ids, 500), ref.segment_reduce(bcast, ids, 500),
                               rtol=2e-2, atol=2e-2)
    sums = [  # (rows, d, num_segments, dtype): fp32 sums in shared memory, then past it
        ((20_001,), 1, most, torch.float32),
        ((20_001,), 1, most + 1, torch.float32),
        ((4, 9_999), 8, most // 8, torch.bfloat16),
        ((4, 9_999), 8, most // 8 + 1, torch.bfloat16),
        ((2, 3_001), 64, 900, torch.float16),
    ]
    for shape, d, nseg, dtype in sums:
        v, ids = vals(tuple(shape) + (d,), dtype), zipf(shape, nseg, 0)
        torch.testing.assert_close(sr(v, ids, nseg), ref.segment_reduce(v, ids, nseg),
                                   rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()
    return n + 1 + len(sums)


def row_rel_err(got, want) -> float:
    """Largest normwise relative difference over the rows (last dim) of two
    (..., d) tensors, in float64."""
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def check_flash_at_edges(torch, dtypes=None) -> int:
    """``flash_attention`` against its plain version on the card: causal and
    not, d 64 and 128, fp32 and bf16 (or ``dtypes``), lengths on both sides
    of the bf16 kernel's 128-row query tile and 128- or 64-key K/V tile up
    to the prefill's 4096, b·h 1 and 6; then grouped kv heads (rep 2, 4 and
    16), the model's strided (b, s, h, d) layout and sq != sk. Tolerance 3e-4 fp32,
    3e-2 bf16 elementwise (``tests/test_kernels.py:101``) and ``ROW_TOL`` per
    output row. Returns the number of cases."""
    from repro_torch.kernels import ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention").flash_attention
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen).to("cuda", dtype)

    def check(q, k, v, causal, what):
        got = fa(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        tol = 3e-2 if q.dtype == torch.bfloat16 else 3e-4
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"flash_attention {what}: {got.shape} {got.dtype} "
                                 f"!= {want.shape} {want.dtype}")
        try:
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        except AssertionError as e:
            raise AssertionError(f"flash_attention differs at {what}: {e}") from None
        row_err = row_rel_err(got, want)
        if row_err > ROW_TOL[str(q.dtype)]:
            raise AssertionError(f"flash_attention differs at {what}: a row is {row_err:.3e} "
                                 f"off normwise, limit {ROW_TOL[str(q.dtype)]}")

    n = 0
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for s in (1, 100, 127, 128, 129, 1000, 4095, 4096):
                for b, h in ((1, 1), (2, 3)):
                    for causal in (True, False):
                        q, k, v = (rnd(b, h, s, d, dtype=dtype) for _ in range(3))
                        check(q, k, v, causal, f"b={b} h={h} s={s} d={d} {dtype} causal={causal}")
                        n += 1
            # grouped kv heads, read through the (b, s, h, d) layout the model uses
            q = rnd(2, 257, 8, d, dtype=dtype).transpose(1, 2)
            k, v = (rnd(2, 257, 2, d, dtype=dtype).transpose(1, 2) for _ in range(2))
            check(q, k, v, True, f"GQA 8/2 strided s=257 d={d} {dtype}")
            check(q, k, v, False, f"GQA 8/2 strided s=257 d={d} {dtype} non-causal")
            k, v = (rnd(2, 2, 70, d, dtype=dtype) for _ in range(2))
            check(q, k, v, False, f"sq=257 sk=70 d={d} {dtype}")
            # 16 query heads over 8 kv heads (rep 2) and over 1 (rep 16), strided
            q = rnd(1, 129, 16, d, dtype=dtype).transpose(1, 2)
            for kvh in (8, 1):
                k, v = (rnd(1, 129, kvh, d, dtype=dtype).transpose(1, 2) for _ in range(2))
                check(q, k, v, True, f"GQA 16/{kvh} strided s=129 d={d} {dtype}")
            n += 5
    torch.cuda.synchronize()
    return n


def rel_err(a, b) -> float:
    """Normwise relative difference ||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def sharpen(model) -> None:
    """Set what init leaves flat, as ``tests/test_torch_serve.py``'s
    ``perturb`` does, from ``SEED``: random QKV biases (N × 0.5) and norm
    scales (1 + 0.2 N), and wq, wk × ``QK_GAIN``, so that attention is far
    from uniform and carries weight in the residual stream."""
    import torch

    g = torch.Generator(device=model.device).manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bq", "bk", "bv"):
                p.copy_(torch.randn(p.shape, generator=g, device=p.device) * 0.5)
            elif leaf == "scale":
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=g, device=p.device))
            elif leaf in ("wq", "wk"):
                p.mul_(QK_GAIN)
    model.cast_weights()


def layer_caches(model, cache) -> list[dict]:
    """Each layer's cache leaves ({name: tensor}), in the order the layers
    run (``Model.layout``)."""
    from repro_torch.models.convert import flatten

    return [{k: v if i is None else v[i] for k, v in flatten(cache[group][key]).items()}
            for group, key, i in model.layout]


def prefill_run(model, prompts, impl: str):
    """One prefill: (each layer's cache leaves, final hidden at the last
    position, layer 0's attention output (b, s, d))."""
    import torch

    seen = {}
    hook = model.blocks[0].attn.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("attn0", out[0]))
    try:
        with torch.inference_mode():
            cache, h = model.prefill_hidden(prompts, impl=impl)
    finally:
        hook.remove()
    return layer_caches(model, cache), h, seen["attn0"]


def prefill_readings(got, want) -> dict:
    """Normwise relative differences of two ``prefill_run`` results: each
    layer's cache (the worst of its leaves: K/V, latent, states; worst
    layer, layer 0, last layer), final hidden, layer 0's attention output;
    and whether the hidden state is finite."""
    import torch

    (cg, hg, ag), (cw, hw, aw) = got, want
    kv = [max(rel_err(g[x], w[x]) for x in w) for g, w in zip(cg, cw)]
    return {"kv_worst": max(kv), "kv_worst_layer": kv.index(max(kv)), "kv_layer0": kv[0],
            "kv_last_layer": kv[-1], "hidden": rel_err(hg, hw), "attn0": rel_err(ag, aw),
            "finite": bool(torch.isfinite(hg).all())}


def within(r: dict, layers: int = 24) -> bool:
    """Whether ``prefill_readings`` are inside ``SERVE_TOL`` (set for 24
    layers, a random walk of per-layer roundings: scaled by √(layers / 24)
    for a path of ``layers`` kernel layers in series) and ``ATTN_TOL``."""
    tol = SERVE_TOL * max(1.0, layers / 24) ** 0.5
    return r["kv_worst"] <= tol and r["hidden"] <= tol and r["attn0"] <= ATTN_TOL and r["finite"]


def serve_walls(res: dict, batch: int = SERVE_BATCH, gen: int = SERVE_GEN) -> dict:
    """Prefill and decode walls of one ``serve.generate`` result, as rates."""
    return {
        "prefill_ms": res["prefill_s"] * 1e3,
        "decode_ms_per_step": res["decode_s"] * 1e3 / (gen - 1),
        "decode_tokens_per_s": batch * (gen - 1) / res["decode_s"],
        "generated_tokens_per_s": batch * gen / (res["prefill_s"] + res["decode_s"]),
    }


def serve_inputs():
    """Qwen1.5-0.5B at full width on the card, weights from a ``torch.Generator``
    seeded with ``SEED``, and ``SERVE_BATCH`` prompts of ``SERVE_PROMPT``
    random ids from ``SEED``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(SERVE_ARCH)
    model = Model(cfg, device="cuda", seed=SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                            device="cuda", dtype=torch.int32)
    return model, prompts


def serve_paths(model, prompts) -> dict:
    """The serving path, name → call: what ``python -m repro_torch.launch.serve``
    runs — prefill with its attention through the ``flash_attention`` kernel,
    then ``SERVE_GEN`` greedy tokens in all."""
    from repro_torch.launch import serve

    return {"serve_flash": lambda: serve.generate(model, prompts, SERVE_GEN, impl="flash")}


def prefill_paths(model, prompts) -> dict:
    """The serving path's prefill alone, name → call: ``launch.steps``'
    prefill step with its attention through the ``flash_attention`` kernel,
    writing the first ``SERVE_PROMPT`` slots of a cache allocated once (as
    ``serve.generate`` does), so a repeated call is the warm prefill."""
    from repro_torch.launch import steps

    b, s = prompts.shape
    step = steps.make_prefill_step(model, global_batch=b, seq=s, impl="flash")
    cache = model.init_cache(b, s + SERVE_GEN)
    return {"serve_prefill_flash": lambda: step(prompts, cache)}


def recorded_routes(log: list):
    """A patch of ``MoE.route`` that appends each call's expert choices to
    ``log``, in call order."""
    from repro_torch.models.moe import MoE

    real = MoE.route

    def route(self, x, router=None):
        out = real(self, x, router=router)
        log.append(out[1])
        return out

    return mock.patch.object(MoE, "route", route)


def replayed_routes(log: list, flips: list):
    """A patch of ``MoE.route`` that takes ``log``'s expert choices in call
    order, with this route's own gates for them (the router's fp32
    probabilities, renormalised as it does), and appends to ``flips`` the
    number of tokens whose own top-k differs: near-ties between the k-th and
    (k+1)-th probability that the two routes' roundings order otherwise."""
    import torch

    from repro_torch.models.moe import MoE

    real = MoE.route
    chosen = iter(log)

    def route(self, x, router=None):
        _, own = real(self, x, router=router)
        experts = next(chosen)
        p = self.probs(x, router).gather(-1, experts)
        gates = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-9)
        flips.append(int((own.sort(-1).values != experts.sort(-1).values).any(-1).sum()))
        return gates.to(x.dtype), experts

    return mock.patch.object(MoE, "route", route)


def layer_readings(model, batch) -> dict:
    """The served prefill through the kernels, and at every layer that runs
    one (self-attention through ``flash_attention``, the MoE combine through
    ``segment_reduce``) that layer's plain route on the layer's own input:
    the masked chunked attention, ``ref.segment_reduce``. The worst
    normwise relative difference of a layer's output, per kind, and how many
    layers were compared: differences do not compound over depth here."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import ATTN_KINDS, attention_impl

    errs = {"attention": [], "moe": []}

    def attention(mod, args, kwargs, out):
        want, _ = mod.forward(*args, **{**kwargs, "prefill_cache": None, "impl": "masked"})
        errs["attention"].append(rel_err(out[0], want))

    def moe(mod, args, kwargs, out):
        with mock.patch.object(ops, "segment_reduce", ref.segment_reduce):
            errs["moe"].append(rel_err(out, mod.forward(*args, **kwargs)))

    handles = []
    for block in list(model.blocks) + list(model.enc_blocks):
        if (block.kind in ATTN_KINDS
                and attention_impl(model.cfg, block.kind, "flash") == "flash"):
            handles.append(block.attn.register_forward_hook(attention, with_kwargs=True))
        if block.kind == "attn_moe":
            handles.append(block.moe.register_forward_hook(moe, with_kwargs=True))
    try:
        with torch.inference_mode():
            model.prefill_hidden(batch, impl="flash")
    finally:
        for h in handles:
            h.remove()
    return {f"{k}_{stat}": v for k, e in errs.items()
            for stat, v in (("worst", max(e, default=0.0)), ("layers", len(e)))}


def enc_frames(batch) -> int | None:
    """The encoder's input length of an enc-dec prompt batch, else None."""
    return batch["enc_embeds"].shape[1] if isinstance(batch, dict) and "enc_embeds" in batch \
        else None


def family_inputs(arch: str):
    """``arch`` at full width and depth on the card, weights from a
    ``torch.Generator`` seeded with ``SEED``, and its prompt batch from
    ``SEED`` (``launch.serve.prompt_batch``): ``FAMILY_BATCH`` ×
    ``FAMILY_PROMPT`` tokens, patch embeddings with a (t, h, w) grid for
    qwen2-vl, ``ENC_FRAMES`` frame embeddings and ``DEC_PROMPT`` tokens for
    seamless."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    model = Model(get_config(arch), device="cuda", seed=SEED)
    prompt = DEC_PROMPT if model.cfg.enc_layers else FAMILY_PROMPT
    return model, serve.prompt_batch(model, FAMILY_BATCH, prompt, seed=SEED, enc_len=ENC_FRAMES)


def family_paths(model, batch) -> dict:
    """The serving path of one block family, name → call: prefill through
    the kernels where they apply, then ``FAMILY_GEN`` greedy tokens."""
    from repro_torch.launch import serve

    return {f"serve_{model.cfg.name}": lambda: serve.generate(model, batch, FAMILY_GEN,
                                                              impl="flash")}


def family_prefill_paths(model, batch) -> dict:
    """That path's prefill alone, writing a cache allocated once (the warm
    prefill)."""
    from repro_torch.launch import steps

    b, s = steps.batch_shape(batch)
    step = steps.make_prefill_step(model, global_batch=b, seq=s, impl="flash")
    cache = model.init_cache(b, s + FAMILY_GEN, enc_len=enc_frames(batch))
    return {f"prefill_{model.cfg.name}": lambda: step(batch, cache)}


def extend_batch(model, batch, tok):
    """``batch`` with the token ``tok`` (b,) appended as decode would read
    it: its embedding row for an embedding-input model, at M-RoPE position
    (s, s, s)."""
    import torch

    from repro_torch.models.parallel import embed_lookup

    if isinstance(batch, torch.Tensor):
        return torch.cat([batch, tok[:, None]], 1)
    out = dict(batch)
    if "embeds" in out:
        s = out["embeds"].shape[1]
        out["embeds"] = torch.cat([out["embeds"], embed_lookup(tok[:, None], model.embed_c)], 1)
        if "positions" in out:
            at = torch.full_like(out["positions"][:, :1], s)
            out["positions"] = torch.cat([out["positions"], at], 1)
    else:
        out["tokens"] = torch.cat([out["tokens"], tok[:, None]], 1)
    return out


def cache_consistency(model, batch, impl: str) -> dict:
    """Prefill of s (``impl``) into a cache of s + 1, then one decode step
    at position s with the prefill's greedy token, against the prefill of
    s + 1 with that token appended: normwise relative difference of the
    last position's final hidden state. Control: the same step from an
    empty cache."""
    import torch

    from repro_torch.launch import steps

    b, s = steps.batch_shape(batch)
    enc_len = enc_frames(batch)
    with torch.inference_mode():
        cache, h = model.prefill_hidden(batch, impl=impl,
                                        cache=model.init_cache(b, s + 1, enc_len=enc_len))
        tok = model.greedy(h)
        h_dec = model.decode_hidden(cache, tok, s)
        _, h_full = model.prefill_hidden(extend_batch(model, batch, tok), impl=impl)
        del cache
        h_ctl = model.decode_hidden(model.init_cache(b, s + 1, enc_len=enc_len), tok, s)
    return {"decode_vs_prefill": rel_err(h_dec, h_full), "control": rel_err(h_ctl, h_full),
            "finite": bool(torch.isfinite(h_dec).all())}


def mesh_inputs(arch: str, layers: int | None = None):
    """``arch`` at full width (``layers`` deep, by default its full depth)
    served over its ``MESH_SERVE`` mesh (``launch.mesh.make_mesh``) on the
    card: (the model under the mesh's
    ``ShardEnv``, weights from a ``torch.Generator`` seeded with ``SEED``;
    the mesh; the prompt rows held once, ``launch.serve.prompt_batch`` from
    ``SEED``: tokens, patch embeddings with their grid for qwen2-vl,
    ``ENC_FRAMES`` frames and a token prompt for seamless)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    dims, gb, prompt, _ = MESH_SERVE[arch]
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mesh = make_mesh(dims, device="cuda")
    model = Model(cfg, device="cuda", seed=SEED, env=steps.make_env(cfg, mesh))
    return model, mesh, serve.prompt_batch(model, steps.held_rows(model.env, gb), prompt,
                                           seed=SEED, enc_len=ENC_FRAMES)


def mesh_paths(arch: str, model, mesh, batch, compute_at_data: bool = False) -> dict:
    """The serving path over the mesh, name → call: what ``python -m
    repro_torch.launch.serve --mesh d,m`` runs, the prefill's attention
    through ``flash_attention``."""
    from repro_torch.launch import serve

    _, gb, _, gen = MESH_SERVE[arch]
    name = f"serve_tp_{'cad_' if compute_at_data else ''}{arch}"
    return {name: lambda: serve.generate(model, batch, gen, impl="flash", mesh=mesh,
                                         global_batch=gb, compute_at_data=compute_at_data)}


def mesh_prefill_paths(arch: str, model, mesh, batch) -> dict:
    """That path's prefill alone, over the device-major batch, writing a
    cache allocated once (the warm prefill)."""
    from repro_torch.launch import steps

    _, gb, prompt, gen = MESH_SERVE[arch]
    step = steps.make_prefill_step(model, global_batch=gb, seq=prompt, impl="flash", mesh=mesh)
    cache = model.init_cache(steps.batch_shape(batch)[0], prompt + gen, enc_len=enc_frames(batch))
    dm = steps.map_batch(batch, lambda v: steps.device_major(model.env, v, gb))
    return {MESH_PREFILL_NAMES[arch]: lambda: step(dm, cache)}


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total, end = total + b - max(a, end), b
    return total


def device_busy(fn) -> dict:
    """``fn`` called twice under ``torch.profiler`` (CPU and CUDA activity),
    each call in a window that ends after ``torch.cuda.synchronize()``; of
    the second: the window's ms (host clock), the device's busy ms (the
    union of its kernel, copy and set intervals) and the idle share 1 -
    busy / window. None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            with record_function("busy_window"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    wins = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == "busy_window" and e.device_type != cuda)
    w0, w1 = wins[-1]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == cuda and e.name != "busy_window"
             and not getattr(e, "is_user_annotation", False) and e.time_range.start >= w0]
    if not spans:
        return None
    busy = busy_us(spans)
    return {"window_ms": (w1 - w0) / 1e3, "busy_ms": busy / 1e3, "idle": 1 - busy / (w1 - w0)}


def decisive_equal(got, want_logits, diff: float) -> tuple[bool, int, bool]:
    """Greedy tokens ``got`` (b,) against the argmax of ``want_logits`` (b,
    V) wherever its top-two margin exceeds twice ``diff``, the largest
    logit difference between the two routes: (equal there, how many rows,
    whether every row's token is among ``want_logits``' top two)."""
    import torch

    top2, top2_ids = torch.topk(want_logits, 2, dim=-1)
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * diff
    want = torch.argmax(want_logits, dim=-1).to(got.dtype)
    in_top2 = bool((got[:, None] == top2_ids.to(got.dtype)).any(-1).all())
    return bool((got == want)[decisive].all()), int(decisive.sum()), in_top2


def tp_layer_readings(model, batch) -> dict:
    """Every sublayer whose output projection is row-parallel (attention,
    cross-attention, MLA, the MLP, the RG-LRU; the encoder's included) in
    a TP prefill, run again on its own input through the tp = 1 route: the
    worst normwise relative difference of their outputs. Only that
    sublayer's own roundings (the tp ranks' bf16 partials) separate them."""
    import torch

    from repro_torch.models.attention import GQAAttention, MLAAttention
    from repro_torch.models.layers import MLP
    from repro_torch.models.parallel import ONE
    from repro_torch.models.rglru import RGLRU

    errs, inner = [], []

    def hook(mod, args, kwargs, out):
        if inner:  # the tp = 1 call below
            return
        inner.append(1)
        try:
            one = mod(args[0], ONE) if isinstance(mod, MLP) else mod(*args, **dict(kwargs, env=ONE))
        finally:
            inner.pop()
        pick = (lambda o: o[0] if isinstance(o, tuple) else o)
        errs.append(rel_err(pick(out), pick(one)))

    kinds = (GQAAttention, MLAAttention, MLP, RGLRU)
    handles = [m.register_forward_hook(hook, with_kwargs=True) for m in model.modules()
               if isinstance(m, kinds)]
    try:
        with torch.inference_mode():
            model.prefill_hidden(batch, impl="flash")
    finally:
        for h in handles:
            h.remove()
    return {"sublayers_worst": max(errs), "sublayers": len(errs)}


def rounding_noise():
    """A context in which every row-parallel product (attention's, MLA's,
    the RG-LRU's and the MLP's output projections) returns its bf16 output
    times 1 + N(0, 2**-8), noise from ``SEED``: one bf16 ulp, about what the
    tp ranks' rounded partials change (``SUBLAYER_TOL``'s readings)."""
    import torch

    from repro_torch.models import attention, layers, rglru

    real = layers.row_parallel
    gen = {}

    def noisy(x, w, env=None):
        y = real(x, w, env)
        g = gen.setdefault("g", torch.Generator(device=y.device).manual_seed(SEED))
        eps = torch.randn(y.shape, generator=g, device=y.device) * 2.0 ** -8
        return (y.float() * (1 + eps)).to(y.dtype)

    stack = contextlib.ExitStack()
    for mod in (attention, layers, rglru):
        stack.enter_context(mock.patch.object(mod, "row_parallel", noisy))
    return stack


def tree_clone(tree):
    """A copy of a nested dict of tensors (a cache)."""
    return {k: tree_clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def sublayers(cfg) -> int:
    """How many sublayers ``tp_layer_readings`` reads in a prefill of
    ``cfg``: two a layer (attention or the RG-LRU, then the MLP), three in
    an enc-dec decoder layer (self-attention, cross-attention, the MLP)."""
    return 2 * (cfg.n_layers + cfg.enc_layers) + (cfg.n_layers if cfg.enc_layers else 0)


def tp_checks(arch: str, model, mesh, batch) -> dict:
    """``arch`` over its mesh, sharpened: the TP prefill against the tp = 1
    route of the same model (logits, first token, the greedy tokens'
    agreement), and where the mesh has an fsdp world and the model an MLP,
    the compute-at-data decode step against the gather one on the same
    cache."""
    import dataclasses

    import torch

    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.parallel import ONE

    from repro_torch.models.parallel import ShardEnv

    _, gb, prompt, gen = MESH_SERVE[arch]
    vocab = model.cfg.vocab
    rows, enc = steps.batch_shape(batch)[0], enc_frames(batch)
    sharpen(model)
    (name, fn), = mesh_paths(arch, model, mesh, batch).items()
    toks_tp = fn()["tokens"]
    with torch.inference_mode():
        cache = model.init_cache(rows, prompt + gen, enc_len=enc)
        cache, h1 = model.prefill_hidden(batch, impl="flash", cache=cache, env=ONE)
        tok = model.greedy(h1)
        toks_1 = [tok]
        for i in range(gen - 1):
            tok, cache = M.decode_step(model, cache, tok, prompt + i, ONE)
            toks_1.append(tok)
        del cache
        toks_1 = torch.stack(toks_1, 1)
        lg1 = model.logits(h1)[:, :vocab]
        cache, htp = model.prefill_hidden(batch, impl="flash",
                                          cache=model.init_cache(rows, prompt + 1, enc_len=enc))
        lgtp = model.logits(htp)[:, :vocab]
        # the control: one rank's partial × tp in place of each row-parallel sum
        with mock.patch.object(ShardEnv, "psum_tp", lambda self, parts: parts[0] * parts.shape[0]):
            _, hw = model.prefill_hidden(batch, impl="flash")
        control = rel_err(model.logits(hw)[:, :vocab], lg1)
        # the model's own response to rounding-level differences of those products
        with rounding_noise():
            _, hn = model.prefill_hidden(batch, impl="flash", env=ONE)
        sensitivity = rel_err(model.logits(hn)[:, :vocab], lg1)
        diff = float((lgtp - lg1).abs().max())
        first_ok, first_rows, first_top2 = decisive_equal(model.greedy(htp), lg1, diff)
        out = {"tp_vs_tp1_logits": rel_err(lgtp, lg1), "tp_vs_tp1_max_abs": diff,
               "control": control, "sensitivity": sensitivity,
               "first_token_equal": first_ok, "first_token_rows_compared": first_rows,
               "first_token_in_top_two": first_top2, "rows": rows,
               "greedy_agreement": float((toks_tp == toks_1).float().mean()),
               "finite": bool(torch.isfinite(lgtp).all())}
        if model.env.fsdp_size > 1 and model.cfg.d_ff:
            # the same step from the same cache (decode writes recurrent states in place)
            tok, copy = model.greedy(htp), tree_clone(cache)
            hg = model.decode_hidden(cache, tok, prompt)
            hc = model.decode_hidden(copy, tok, prompt,
                                     dataclasses.replace(model.env, compute_at_data=True))
            del copy
            lgg, lgc = model.logits(hg)[:, :vocab], model.logits(hc)[:, :vocab]
            cdiff = float((lgc - lgg).abs().max())
            cad_ok, cad_rows, cad_top2 = decisive_equal(model.greedy(hc), lgg, cdiff)
            out.update({"cad_vs_gather_logits": rel_err(lgc, lgg), "cad_vs_gather_max_abs": cdiff,
                        "cad_token_equal": cad_ok, "cad_rows_compared": cad_rows,
                        "cad_in_top_two": cad_top2,
                        "finite": out["finite"] and bool(torch.isfinite(lgc).all())})
        del cache
    out.update(tp_layer_readings(model, batch))
    return out


def a2a_checks(model, batch) -> dict:
    """granite-moe over its mesh: every MoE layer of a served prefill, on
    the layer's own input, through the a2a route and the replicated route
    with the same route: the worst difference over the tokens none of whose
    assignments dropped (as ``np.allclose``'s rtol = atol: max |a - r| /
    (1 + |r|)), and the dropped share."""
    import torch

    env = model.env
    worst, dropped, layers = 0.0, [], 0

    def hook(mod, args, kwargs, out):
        nonlocal worst, layers
        h = args[0]
        flat = h.reshape(-1, h.shape[-1])
        route = mod.route(flat)
        y, info = mod.a2a(h, env, route=route)
        rep = mod.replicated(flat, *route, env).reshape(h.shape)
        kept = info["keep"].all(-1)
        err = ((y.float() - rep.float()).abs() / (1 + rep.float().abs()))[kept]
        worst = max(worst, float(err.max()))
        dropped.append(float(1 - info["keep"].float().mean()))
        layers += 1

    handles = [b.moe.register_forward_hook(hook, with_kwargs=True) for b in model.blocks]
    try:
        with torch.inference_mode():
            model.prefill_hidden(batch, impl="flash")
    finally:
        for h in handles:
            h.remove()
    return {"a2a_vs_replicated_worst": worst, "layers": layers,
            "dropped_share_mean": sum(dropped) / len(dropped), "dropped_share_max": max(dropped)}


def no_drop_capacity(model) -> float:
    """The capacity factor at which no assignment of ``model``'s a2a MoE can
    drop. A destination rank holds e_loc experts (or one replica of one),
    and each token picks k distinct experts, so at most n · min(k, e_loc) of
    a source rank's n·k assignments meet there; cap = n · k · factor / tp."""
    m, tp = model.cfg.moe, model.env.tp
    return tp * min(m.top_k, max(1, m.n_experts // tp)) / m.top_k


def at_capacity(model, factor: float | None):
    """A context in which every MoE layer of ``model`` runs at capacity
    ``factor`` (None: as configured)."""
    import dataclasses

    stack = contextlib.ExitStack()
    if factor is not None:
        cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(model.cfg.moe,
                                                                     capacity_factor=factor))
        for b in model.blocks:
            if getattr(b, "moe", None) is not None:
                stack.enter_context(mock.patch.object(b.moe, "cfg", cfg))
    return stack


def mesh_phase(drive, launches: dict, rows: list) -> dict:
    """Phase 9: serving across a mesh (see the module doc). Adds its
    launches to ``launches`` and its two kernel rows to ``rows``; returns
    the phase's readings and checks."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve

    fa = importlib.import_module("repro_torch.kernels.flash_attention").flash_attention
    sr = importlib.import_module("repro_torch.kernels.segment_reduce").segment_reduce
    stats, checks, captured = {}, {}, {}
    for arch, (dims, gb, prompt, gen) in MESH_SERVE.items():
        stage(f"phase 9 {arch}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model, mesh, batch = mesh_inputs(arch, MESH_LAYERS.get(arch))
        torch.cuda.synchronize()
        cfg, env = model.cfg, model.env
        held_gb = torch.cuda.memory_allocated() / 1e9
        log(f"serve {arch} over a (data, model) = {dims} mesh: tp {env.tp}, rep {env.rep}, "
            f"{cfg.n_layers} layers, d {cfg.d_model}, kv {cfg.n_kv_heads}, vocab {cfg.vocab} "
            f"padded to {model.vocab_padded}, {held_gb:.3f} GB on the card, built in "
            f"{time.perf_counter() - t:.2f} s; {gb} prompts x {prompt}, {gen} greedy tokens")
        (name, fn), = mesh_paths(arch, model, mesh, batch).items()
        res, got, _ = drive(name, fn)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = MESH_LAUNCHES[arch]
        if (got["flash_attention"], got["segment_reduce"]) != want:
            raise AssertionError(f"{name} made {got} launches, not {want[0]} flash_attention "
                                 f"and {want[1]} segment_reduce")
        toks = res["tokens"]
        if toks.shape != (gb, gen) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{name}: tokens {tuple(toks.shape)} out of shape or vocab")
        cold = serve_walls(res, gb, gen)
        cache_gb = sum(v.numel() * v.element_size() for v in
                       importlib.import_module("repro_torch.models.convert").flatten(
                           res["cache"]).values()) / 1e9
        del res, toks
        warm = serve_walls(serve.generate(model, batch, gen, impl="flash", mesh=mesh,
                                          global_batch=gb), gb, gen)
        st = {"cold": cold, "warm": warm, "held_gb": held_gb, "peak_gb": peak_gb,
              "cache_gb": cache_gb}
        if env.fsdp_size > 1 and cfg.d_ff:
            (cname, cfn), = mesh_paths(arch, model, mesh, batch, compute_at_data=True).items()
            cres, _, _ = drive(cname, cfn)
            st["compute_at_data"] = serve_walls(cres, gb, gen)
            del cres, cfn  # cfn's closure holds the model
        (pname, pfn), = mesh_prefill_paths(arch, model, mesh, batch).items()
        st["prefill_profile"] = device_busy(pfn)  # the warm prefill's window, busy, idle
        del pfn  # its closure holds a cache
        stats[name] = st
        log(f"  {json.dumps(st)}")
        # the MoE's a2a prefill (s) at a capacity where nothing drops, so that
        # it computes what the longer prefill's dropless route (s + 1) does
        factor = no_drop_capacity(model) if want[1] else None
        with at_capacity(model, factor):
            c = {"consistency": cache_consistency(model, batch, "flash")}
        cc = c["consistency"]
        log(f"  cache consistency (limit {CONSIST_TOL}"
            f"{'' if factor is None else f'; the MoE at capacity {factor}, no drops'}): "
            f"{json.dumps(cc)}")
        if (not cc["finite"] or cc["decode_vs_prefill"] > CONSIST_TOL
                or cc["control"] <= CONSIST_TOL):
            raise AssertionError(f"{name}: decode over the prefill's cache differs from the longer "
                                 f"prefill, or the limit passes an empty cache: {cc}")
        if want[0] and ("flash" not in captured or cfg.enc_layers):
            # the TP prefill's first flash inputs; seamless's encoder (non-causal)
            # and decoder (causal) launch shapes too
            real_fa = ops.flash_attention

            def cap_fa(q, k, v, causal=True):
                key = ("flash_dec" if causal else "flash_enc") if cfg.enc_layers else "flash"
                captured.setdefault(key, (q.clone(), k.clone(), v.clone(), causal, name))
                return real_fa(q, k, v, causal=causal)

            with mock.patch.object(ops, "flash_attention", cap_fa), torch.inference_mode():
                model.prefill_hidden(batch, impl="flash")
        if want[1]:
            real_sr = ops.segment_reduce

            def cap_sr(values, ids, n):
                captured.setdefault("combine", (values.clone(), ids.clone(), n, name))
                return real_sr(values, ids, n)

            with mock.patch.object(ops, "segment_reduce", cap_sr), torch.inference_mode():
                model.prefill_hidden(batch, impl="flash")
            c["a2a"] = a2a_checks(model, batch)
            log(f"  a2a vs replicated MoE, each layer on its own input (limit {A2A_TOL} on "
                f"tokens with no dropped assignment): {json.dumps(c['a2a'])}")
            if c["a2a"]["a2a_vs_replicated_worst"] > A2A_TOL or c["a2a"]["layers"] != cfg.n_layers:
                raise AssertionError(f"{name}: the a2a MoE differs from the replicated: {c['a2a']}")
        if arch in TP_CHECK_ARCHS:
            c["tp"] = r = tp_checks(arch, model, mesh, batch)
            qwen = arch == "qwen1.5-0.5b"
            log(f"  TP vs tp = 1 (limit {TP_TOL if qwen else 'the larger of TP_TOL and '}"
                f"{'' if qwen else f'{SENSITIVITY_FACTOR} x the sensitivity'}, below the control; "
                f"each row-parallel sublayer on its own input {SUBLAYER_TOL})"
                + (f" and compute-at-data vs gather decode (limit "
                   f"{CAD_TOL if qwen else CONSIST_TOL})" if "cad_vs_gather_logits" in r else "")
                + ", sharpened weights, tokens equal where decisive"
                + (f", compared on at least {DECISIVE_SHARE} of the rows and all in the top two"
                   if qwen else "") + f": {json.dumps(r)}")
            tp_tol, cad_tol = (TP_TOL, CAD_TOL) if qwen else (
                max(TP_TOL, SENSITIVITY_FACTOR * r["sensitivity"]), CONSIST_TOL)
            floor = r["rows"] * DECISIVE_SHARE
            ok = (r["finite"] and r["tp_vs_tp1_logits"] <= tp_tol < r["control"]
                  and r["sublayers_worst"] <= SUBLAYER_TOL and r["sublayers"] == sublayers(cfg)
                  and r["first_token_equal"])
            if qwen:
                ok = ok and r["first_token_rows_compared"] >= floor and r["first_token_in_top_two"]
            if "cad_vs_gather_logits" in r:
                ok = ok and r["cad_vs_gather_logits"] <= cad_tol and r["cad_token_equal"]
                if qwen:
                    ok = ok and r["cad_rows_compared"] >= floor and r["cad_in_top_two"]
            if not ok:
                raise AssertionError(f"{name}: TP or compute-at-data serving differs: {r}")
        checks[name] = c
        del model, batch, fn
    # the kernels at the TP paths' shapes: agreement and time
    for key, what in (("flash", "the TP prefill's self-attention"),
                      ("flash_enc", "seamless's encoder"),
                      ("flash_dec", "seamless's decoder self-attention")):
        q, k, v, causal, fpath = captured.pop(key)
        kout, pout = fa(q, k, v, causal=causal), ref.flash_attention(q, k, v, causal=causal)
        row_err = row_rel_err(kout, pout)
        if row_err > ROW_TOL[str(kout.dtype)]:
            raise AssertionError(f"flash_attention at {what}'s shape: a row is {row_err} off")
        fb, fh, fs, fd = q.shape
        pairs = fs * (fs + 1) / 2 if causal else fs * fs
        b_ms, b_by = bound_ms(4 * q.numel() * 2, 4 * fd * fb * fh * pairs, BF16_TC_OPS_PER_S)
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:79",
            "launches": 0, "max_abs_err": max_abs_err([(kout, pout)]),
            "ms": cuda_ms(lambda: fa(q, k, v, causal=causal)),
            "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v, causal=causal), iters=3,
                                warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])),
            "norm_rel_err": rel_err(kout, pout), "max_row_rel_err": row_err, "path": fpath,
            "shape": f"q, k, v {tuple(q.shape)} bf16, {'causal' if causal else 'non-causal'}: "
                     f"{what}, every tp rank's heads in one launch",
        })
        del q, k, v, kout, pout
    values, ids, nseg, spath = captured.pop("combine")
    ks, ps = sr(values, ids, nseg), ref.segment_reduce(values, ids, nseg)
    comb_err = float((ks - ps).abs().max() / ps.abs().max())
    if comb_err > COMBINE_TOL:
        raise AssertionError(f"segment_reduce at the a2a combine: {comb_err} off (relative)")
    ok = ids >= 0
    vals32, ids64 = values[ok].float(), ids[ok].long()
    lib_out = torch.zeros_like(ps)
    kept = int(ok.sum())
    b_ms, b_by = bound_ms(kept * values.shape[1] * values.element_size() + ids.numel() * 4
                          + ps.numel() * 4, kept * values.shape[1])
    rows.append({
        "name": "segment_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:55",
        "launches": 0, "max_abs_err": max_abs_err([(ks, ps)]), "rel_err": comb_err,
        "ms": cuda_ms(lambda: sr(values, ids, nseg)),
        "plain_ms": cuda_ms(lambda: ref.segment_reduce(values, ids, nseg)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, ids64, vals32)),
        "path": spath,
        "shape": f"values {tuple(values.shape)} bf16, ids ({ids.numel()},) int32 by rank and "
                 f"token ({kept} kept), nseg={nseg}: the a2a combine of every rank at once",
    })
    return {"stats": stats, "checks": checks}


def train_args(arch: str, scenario: str, mesh: str, global_batch: int, steps: int = 1,
               *extra: str, seq: int = TRAIN_SEQ):
    """``python -m repro_torch.launch.train``'s arguments for ``arch`` at full
    width on the card: random weights from ``SEED``, ``seq`` tokens a
    sequence, a step's loss logged each step; ``extra``: more flags."""
    from repro_torch.launch import train

    return train.parser().parse_args([
        "--arch", arch, "--scenario", scenario, "--mesh", mesh, "--global-batch",
        str(global_batch), "--seq", str(seq), "--seed", str(SEED), "--steps", str(steps),
        "--device", "cuda", "--log-every", "1", *extra])


def train_inputs(arch: str, scenario: str, mesh: str, global_batch: int, model=None):
    """``launch/train.py``'s ``build`` for ``train_args``: (train step,
    optimizer state, ``TrainPipeline``). ``model``: one to train (its
    parameters are not reset); else ``arch`` from ``SEED`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    args = train_args(arch, scenario, mesh, global_batch)
    model = model or Model(get_config(arch), device="cuda", seed=SEED)
    step, pipe = train.build(model, make_mesh(
        tuple(int(x) for x in mesh.split(",")), device="cuda"), args)
    return step, step.init_state(), pipe


def timed_step(step, state, batch) -> dict:
    """One train step, phase by phase (``TrainStep.rank_gradients``,
    ``aggregate``, ``apply``), each in a ``record_function`` window of its
    name that ends in ``torch.cuda.synchronize()``. Returns every rank's
    gradients, the aggregated ones, the new state, Σ nll, Σ ntok, the
    gradient's norm and each phase's wall in ms."""
    import torch
    from torch.profiler import record_function

    out, ms = {}, {}
    for phase in TRAIN_PHASES:
        t = time.perf_counter()
        with record_function(phase):
            if phase == "rank_gradients":
                out["rank"], out["nll"], out["ntok"] = step.rank_gradients(batch)
            elif phase == "aggregate":
                out["grads"] = step.aggregate(out["rank"])
            else:
                out["state"], out["grad_norm"] = step.apply(state, out["grads"])
            torch.cuda.synchronize()
        ms[phase] = (time.perf_counter() - t) * 1e3
    out["ms"] = ms
    return out


def train_paths(step, state, pipe) -> dict:
    """A train step on batch 0 as a path, name → call (the profile's: its
    parameters move at every call, its optimizer state does not)."""
    name = f"train_step_{step.model.cfg.name}_{step.scenario.value}"
    batch = pipe.batch_at(0)
    return {name: lambda: timed_step(step, state, batch)["ms"]}


def aggregation_error(rank: dict, grads: dict) -> tuple[float, str, float]:
    """The aggregated gradient against the float64 sum of the ranks'
    (accumulated one rank at a time), Frobenius over all leaves:
    (normwise relative difference, the worst leaf, its own)."""
    num = den = 0.0
    worst = ("", -1.0)
    for k, g in rank.items():
        flat = g.reshape((-1,) + g.shape[g.dim() - grads[k].dim():])
        want = flat[0].double()
        for r in range(1, flat.shape[0]):
            want += flat[r].double()
        d = float((grads[k].double() - want).norm()) ** 2
        w = float(want.norm()) ** 2
        num, den = num + d, den + w
        if w and (d / w) ** 0.5 > worst[1]:
            worst = (k, (d / w) ** 0.5)
    return (num / den) ** 0.5, worst[0], worst[1]


def moe_layer_grads(moe, h, cot):
    """Layer ``moe``'s output on its input h (b, s, d) and the gradients of
    ⟨output, cot⟩ + its load-balance loss by its four weights."""
    import torch

    y = moe(h)
    loss = (y.float() * cot).sum() + moe.aux_loss(h.reshape(-1, h.shape[-1]))
    return [y.detach()] + list(torch.autograd.grad(
        loss, [moe.router, moe.wi_gate, moe.wi_up, moe.wo]))


def train_phase(launches: dict) -> dict:
    """Phase 7: training at full width. Returns its numbers for the JSON
    line; adds its main paths' kernel launches to ``launches``."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    from repro_torch.optim import AdamW

    res: dict = {"scenarios": {}}

    def count():
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        return dict(ops.LAUNCHES)

    # (a) one step a scenario, from the same parameters and state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    step, _, pipe = train_inputs(TRAIN_ARCH, "native", TRAIN_MESHES["native"], TRAIN_BATCH)
    model = step.model
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    n_fsdp = sum(d is not None for d in step.dims.values())
    cfg = model.cfg
    log(f"train {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
        f"{sum(p.numel() for p in init.values()) / 1e9:.3f} B fp32 parameters ({len(init)} "
        f"leaves, {n_fsdp} with an FSDP dim), random from seed {SEED}; global batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, Markov tokens from TrainPipeline(seed={SEED}); "
        f"built in {time.perf_counter() - t:.2f} s")
    timed_step(step, step.init_state(), pipe.batch_at(0))  # warm-up: cuBLAS, the allocator
    del step
    for sc, mesh in TRAIN_MESHES.items():
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(init[k])
        model.cast_weights()
        step, state, pipe = train_inputs(TRAIN_ARCH, sc, mesh, TRAIN_BATCH, model=model)
        batch = pipe.batch_at(0)
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        out = timed_step(step, state, batch)
        got = count()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
        step_ms = sum(out["ms"].values())
        loss = float(out["nll"]) * step.norm
        err, leaf, leaf_err = aggregation_error(out["rank"], out["grads"])
        hops = (step.world - 1) * n_fsdp if sc == "s3_in_net_map" else 0
        r = {**{f"{p}_ms": v for p, v in out["ms"].items()}, "step_ms": step_ms,
             "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
             "peak_gb_over_held": peak_gb, "held_gb": base_gb, "loss": loss,
             "grad_norm": float(out["grad_norm"]), "agg_err_vs_float64": err,
             "worst_leaf": leaf, "worst_leaf_err": leaf_err, "launches": got,
             "ring_copies": ops.COPIES["ring_fused_step"]}
        if sc == "s3_in_net_map":
            # the same ring hop by hop with the kernel's plain version
            with mock.patch.object(ops, "ring_fused_step", ref.ring_fused_step):
                plain = step.aggregate(out["rank"])
            r["bitwise_vs_plain_ring"] = all(torch.equal(out["grads"][k], plain[k]) for k in plain)
            del plain
        res["scenarios"][sc] = r
        log(f"train step {cfg.name} {sc} on {mesh}: {json.dumps(r)}")
        if not (np.isfinite(loss) and np.isfinite(r["grad_norm"])):
            raise AssertionError(f"train step under {sc}: loss {loss}, grad norm {r['grad_norm']}")
        if err > AGG_TOL[sc]:
            raise AssertionError(f"train step under {sc}: aggregated gradient {err} from the "
                                 f"float64 sum (limit {AGG_TOL[sc]})")
        if got["ring_fused_step"] != hops:
            raise AssertionError(f"train step under {sc}: {got['ring_fused_step']} ring_fused_step "
                                 f"launches, not {hops} (7 hops x {n_fsdp} FSDP leaves)")
        if sc == "s3_in_net_map" and not r["bitwise_vs_plain_ring"]:
            raise AssertionError("S3's aggregated gradient differs from the ring run with "
                                 "ref.ring_fused_step")
        del out, step, state
    del model, init

    # (b) TRAIN_STEPS steps under S3, through launch/train.py's run
    stage("phase 7 the S3 run")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    args = train_args(TRAIN_ARCH, "s3_in_net_map", TRAIN_MESHES["s3_in_net_map"], TRAIN_BATCH,
                      steps=TRAIN_STEPS)
    t = time.perf_counter()
    losses = train.run(args, optimizer=AdamW(**TRAIN_OPT))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = count()
    res["s3_run"] = {"steps": TRAIN_STEPS, "optimizer": TRAIN_OPT, "wall_s": wall,
                     "first_loss": losses[0], "last5_mean": float(np.mean(losses[-5:])),
                     "losses": losses, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": got, "ring_copies": ops.COPIES["ring_fused_step"]}
    log(f"train run {TRAIN_ARCH} s3_in_net_map, {TRAIN_STEPS} steps (AdamW {TRAIN_OPT}, lr "
        f"3e-4): {json.dumps(res['s3_run'])}")
    if not np.isfinite(losses).all() or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"the S3 run's losses: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"the S3 run did not learn: first {losses[0]}, last five "
                             f"{np.mean(losses[-5:])}")
    if got["ring_fused_step"] != TRAIN_STEPS * 7 * n_fsdp:
        raise AssertionError(f"the S3 run made {got['ring_fused_step']} ring_fused_step launches")

    # (c) granite-moe: the combine on segment_reduce in the training forward
    stage(f"phase 7 {MOE_TRAIN_ARCH}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, state, pipe = train_inputs(MOE_TRAIN_ARCH, "native", "1,1", MOE_TRAIN_BATCH)
    model, cfg = step.model, step.model.cfg
    batches = [pipe.batch_at(k) for k in range(MOE_TRAIN_STEPS)]
    ops.reset_launches()
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    step_ms, moe_losses = [], []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, b)
        moe_losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    got = count()
    fwd = cfg.n_layers * (2 if cfg.remat else 1)  # remat runs each layer's forward twice
    r = {"step_ms": step_ms, "tokens_per_s": MOE_TRAIN_BATCH * TRAIN_SEQ / np.median(step_ms) * 1e3,
         "held_gb": base_gb, "peak_gb_over_held": torch.cuda.max_memory_allocated() / 1e9 - base_gb,
         "losses": moe_losses, "launches": got}
    log(f"train {cfg.name} native on 1,1, {MOE_TRAIN_STEPS} steps of {MOE_TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens: {json.dumps(r)}")
    if not np.isfinite(moe_losses).all():
        raise AssertionError(f"{cfg.name}: losses {moe_losses}")
    if got["segment_reduce"] != MOE_TRAIN_STEPS * fwd:
        raise AssertionError(f"{cfg.name}: {got['segment_reduce']} segment_reduce launches, not "
                             f"{MOE_TRAIN_STEPS} steps x {fwd} forward combines")
    # the kernel route against the plain route, uncounted: the loss of one
    # batch, then layer 0 on its own input
    part = {k: v[0, 0] for k, v in step.rank_rows(batches[0]).items()}  # rank 0's rows
    seen = {}

    def keep_input(mod, args, out):  # returns None: the layer's output stands
        seen.setdefault("h", args[0].detach())

    hook = model.blocks[0].moe.register_forward_hook(keep_input)
    routes, flips = [], []
    with torch.no_grad():
        with recorded_routes(routes):
            got_loss = float(model.train_loss(part)[0])
        hook.remove()
        with mock.patch.object(ops, "segment_reduce", ref.segment_reduce), \
                replayed_routes(routes, flips):
            want_loss = float(model.train_loss(part)[0])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cot = torch.randn(seen["h"].shape, generator=g, device="cuda")
    routes0, flips0 = [], []
    with recorded_routes(routes0):
        kern = moe_layer_grads(model.blocks[0].moe, seen["h"], cot)
    with mock.patch.object(ops, "segment_reduce", ref.segment_reduce), \
            replayed_routes(routes0, flips0):
        plain = moe_layer_grads(model.blocks[0].moe, seen["h"], cot)
    names = ("output", "router", "wi_gate", "wi_up", "wo")
    checks = {"loss": abs(got_loss - want_loss) / abs(want_loss), "router_flips": sum(flips),
              **{f"layer0_{n}": rel_err(k, p) for n, k, p in zip(names, kern, plain)}}
    res["moe"] = {**r, "kernel_vs_plain": checks}
    log(f"  kernel route vs plain route (ref.segment_reduce through autograd, choices "
        f"replayed): {json.dumps(checks)} (limits {json.dumps(MOE_TRAIN_TOL)})")
    if checks["loss"] > MOE_TRAIN_TOL["loss"] or any(
            v > MOE_TRAIN_TOL["layer0"] for k, v in checks.items() if k.startswith("layer0")):
        raise AssertionError(f"{cfg.name}: the training route differs from its plain route: "
                             f"{checks}")
    return res


def flat_tensors(tree) -> dict:
    """A checkpoint tree → {path: leaf}, as the store flattens it."""
    from repro_torch.checkpoint import store

    return store._flatten(tree)


def restart_run(count, mesh: str = "8,1", steps: int = RESTART_STEPS,
                every: int = RESTART_EVERY, fail: int = RESTART_FAIL, shrink: int = RESTART_SHRINK,
                at: int = RESTART_AT) -> dict:
    """Phase 8 (a), and phase 10's TP restart: the elastic restart at full
    width through ``train.run``: qwen1.5 on ``mesh`` under S3 for ``steps``
    steps, a checkpoint every ``every`` steps, the failure at step ``fail``,
    the restart on ``shrink`` devices (``elastic_mesh_plan``, the model axis
    kept) from the latest checkpoint, the step-``at`` one. Observed through
    wrappers of ``CheckpointStore.save`` (a device copy of the step-``at``
    tree), ``train.restore`` (the restored tree against that copy, bitwise)
    and ``TrainStep.__call__`` (each step's ms, mesh, world, expected ring
    hops and ``ring_fused_step`` launches)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    from repro_torch.runtime.fault_tolerance import elastic_mesh_plan

    shape = tuple(int(x) for x in mesh.split(","))
    flags = ("--ckpt-every", str(every), "--fail-step", str(fail), "--shrink-to", str(shrink))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    seen, saved, log_steps = {}, {}, []
    real_save, real_restore = CheckpointStore.save, train.restore
    real_call = steps_lib.TrainStep.__call__

    def save(store, k, tree, **kw):
        seen["store"] = store
        if k == at:
            saved.update({n: v.clone() if isinstance(v, torch.Tensor) else int(v)
                          for n, v in flat_tensors(tree).items()})
        return real_save(store, k, tree, **kw)

    def restore(step, store, at=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, k = real_restore(step, store, at)
        torch.cuda.synchronize()
        seen["restore_ms"] = (time.perf_counter() - t) * 1e3
        got = flat_tensors(train.checkpoint_tree(step, state))
        seen["restored_step"] = k
        seen["restored_bitwise"] = got.keys() == saved.keys() and all(
            torch.equal(v, saved[n]) if isinstance(v, torch.Tensor) else int(v) == saved[n]
            for n, v in got.items())
        del got
        return state, k

    def call(step, state, batch):
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_call(step, state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        log_steps.append({"mesh": list(step.mesh_shape), "world": step.world,
                          "ms": (t1 - t0) * 1e3, "t0": t0, "t1": t1, "hops": step.ring_hops(),
                          "ring_fused_step": ops.LAUNCHES["ring_fused_step"]
                          - before["ring_fused_step"]})
        seen["last"] = (step, out[0])
        return out

    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        args = train_args(TRAIN_ARCH, "s3_in_net_map", mesh, TRAIN_BATCH, steps,
                          "--ckpt", tmp, *flags, seq=RESTART_SEQ)
        t = time.perf_counter()
        with mock.patch.object(CheckpointStore, "save", save), \
                mock.patch.object(train, "restore", restore), \
                mock.patch.object(steps_lib.TrainStep, "__call__", call):
            losses = train.run(args, optimizer=AdamW(**TRAIN_OPT))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = count()
        step, state = seen.pop("last")
        stats = list(seen["store"].stats)
        # a blocking save of the last state, timed on its own
        blocking = CheckpointStore(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"), keep=1)
        t = time.perf_counter()
        blocking.save(steps, train.checkpoint_tree(step, state), blocking=True)
        blocking_ms = (time.perf_counter() - t) * 1e3
        shutil.rmtree(blocking.directory)
        del step, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    meshes = [s["mesh"] for s in log_steps]
    cut = fail
    gb = stats[0]["bytes"] / 1e9
    res = {"mesh": mesh, "losses": losses, "meshes": meshes,
           "worlds": [s["world"] for s in log_steps], "step_ms": [s["ms"] for s in log_steps],
           "ring_fused_step_per_step": [s["ring_fused_step"] for s in log_steps],
           "ring_hops_per_step": [s["hops"] for s in log_steps],
           "launches": launched, "saves": stats,
           "gb_per_save": gb, "blocking_save_ms": blocking_ms,
           "blocking_snapshot_ms": blocking.stats[0]["snapshot_ms"],
           "blocking_gb_per_s": gb / blocking_ms * 1e3,
           "restore_ms": seen["restore_ms"], "restore_gb_per_s": gb / seen["restore_ms"] * 1e3,
           "restart_ms": (log_steps[cut]["t0"] - log_steps[cut - 1]["t1"]) * 1e3,
           "restored_step": seen["restored_step"], "restored_bitwise": seen["restored_bitwise"],
           "first_loss_after_restart": losses[cut],
           "same_step_before_restart": losses[at],
           "rel_diff": abs(losses[cut] - losses[at]) / abs(losses[at]),
           "wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    after = list(elastic_mesh_plan(shrink, model_size=shape[-1]).shape)
    log(f"restart {TRAIN_ARCH} s3_in_net_map {mesh} -> {after} ({' '.join(flags)}, "
        f"{TRAIN_BATCH} x {RESTART_SEQ} tokens): {json.dumps(res)}")
    log(f"  saves: {gb:.2f} GB each; async snapshot "
        f"{np.mean([s['snapshot_ms'] for s in stats]):.1f} ms, write "
        f"{np.mean([s['write_ms'] for s in stats]):.1f} ms; blocking {blocking_ms:.1f} ms "
        f"(snapshot {res['blocking_snapshot_ms']:.1f}); restore {seen['restore_ms']:.1f} ms; "
        f"restart {res['restart_ms']:.1f} ms; step ms on {mesh} "
        f"{np.median(res['step_ms'][:cut]):.1f}, on {after} "
        f"{np.median(res['step_ms'][cut:]):.1f}")
    want_meshes = [list(shape)] * fail + [after] * (steps - at)
    if meshes != want_meshes or not np.isfinite(losses).all():
        raise AssertionError(f"restart: steps on meshes {meshes} (want {want_meshes}), "
                             f"losses {losses}")
    if res["restored_step"] != at or not res["restored_bitwise"]:
        raise AssertionError(f"restart: restored step {res['restored_step']}, bitwise "
                             f"{res['restored_bitwise']} against the device copy at the save")
    if res["rel_diff"] > RESTART_LOSS_TOL:
        raise AssertionError(f"restart: the first loss after the restart {losses[cut]} is "
                             f"{res['rel_diff']:.3g} from the same step's {losses[at]} before it")
    if res["ring_fused_step_per_step"] != res["ring_hops_per_step"]:
        raise AssertionError(f"restart: ring_fused_step launches a step "
                             f"{res['ring_fused_step_per_step']}, not the steps' ring hops "
                             f"{res['ring_hops_per_step']}")
    return res


def moe_restore(count) -> dict:
    """Phase 8 (b): granite-moe at W = 1, cut to ``MOE_CKPT_LAYERS`` layers:
    a step, a blocking save, a second step; then the checkpoint restored
    into a model from another seed, and the second step again. Its loss must
    equal the uninterrupted one bitwise, with ``segment_reduce`` on its
    kernel route."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH), n_layers=MOE_CKPT_LAYERS)
    args = train_args(MOE_TRAIN_ARCH, "native", "1,1", MOE_TRAIN_BATCH)
    mesh = make_mesh((1, 1), device="cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ops.reset_launches()
        step, pipe = train.build(Model(cfg, device="cuda", seed=SEED), mesh, args)
        state, _ = step(step.init_state(), pipe.batch_at(0))
        store = CheckpointStore(tmp)
        store.save(1, train.checkpoint_tree(step, state), meta={"world": 1}, blocking=True)
        _, m1 = step(state, pipe.batch_at(1))
        del step, state
        step2, _ = train.build(Model(cfg, device="cuda", seed=SEED + 1), mesh, args)
        state2, at = train.restore(step2, store)
        _, r1 = step2(state2, pipe.batch_at(1))
        got = count()
        del step2, state2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"layers": MOE_CKPT_LAYERS, "restored_step": at, "loss": float(m1["loss"]),
           "loss_after_restore": float(r1["loss"]),
           "bitwise": bool(torch.equal(m1["loss"], r1["loss"])),
           "gb": store.stats[0]["bytes"] / 1e9,
           "segment_reduce": got["segment_reduce"]}
    log(f"restore {cfg.name} at W = 1, {MOE_CKPT_LAYERS} of 24 layers: {json.dumps(res)}")
    fwd = 3 * MOE_CKPT_LAYERS * (2 if cfg.remat else 1)  # three steps, forward twice under remat
    if at != 1 or not res["bitwise"] or got["segment_reduce"] != fwd:
        raise AssertionError(f"{cfg.name}: the step after the restore {res} (segment_reduce "
                             f"{got['segment_reduce']} launches, want {fwd})")
    return res


def dryrun_start() -> dict:
    """Phase 8 (c)'s cells, ``launch/dryrun.py --all`` on the meta device,
    started on ``DRYRUN_JOBS`` worker processes (``dryrun.submit_cells``)
    to run beside the phases before it. Returns what ``dryrun_phase``
    collects: the executor, the cells, their futures, the start time and
    each cell's time of completion."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as shp

    cells = [(a, s) for a in ARCHS for s in shp.SHAPES]
    t = time.perf_counter()
    ex, futs = dryrun.submit_cells(cells, DRYRUN_JOBS)
    done = []
    for fut in futs:
        fut.add_done_callback(lambda _: done.append(time.perf_counter()))
    return {"executor": ex, "cells": cells, "futures": futs, "t0": t, "done": done}


def dryrun_phase(pending: dict) -> dict:
    """Phase 8 (c): the dry run's records (``dryrun_start``), one line a
    cell, then every cell it says fits one H100 held to the card: the real
    step's peak memory (over what the process held before) within
    ``DRYRUN_PEAK_TOL`` of ``peak_bytes``, and ``FlopCounterMode``'s count of
    it equal to ``flops_per_dev`` within ``DRYRUN_FLOP_TOL``. Shuts the
    dry run's workers down."""
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import shapes as shp
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import Model

    records = {}
    with pending["executor"]:
        results = [fut.result() for fut in pending["futures"]]
    # from the start to the last cell's end: the workers' wall beside phase 7
    wall = max(pending["done"]) - pending["t0"]
    for (arch, shape), rec in zip(pending["cells"], results):
        records[(arch, shape)] = rec
        if "error" in rec:
            log(rec["trace"])
            raise AssertionError(f"dry run {arch} {shape}: {rec['error']}")
        if "skipped" in rec:
            want = shp.shape_applicable(get_config(arch), shape)
            if want != (False, rec["skipped"]):
                raise AssertionError(f"dry run {arch} {shape} skipped: {rec['skipped']}")
            log(f"dryrun {arch} {shape}: skipped ({rec['skipped']})")
            continue
        log(f"dryrun {arch} {shape}: {rec['mesh']}, tp {rec['tp']}, rep {rec['rep']}"
            f"{', ' + str(rec['rows']) + ' rows' if 'rows' in rec else ''}; peak "
            f"{rec['peak_bytes'] / 1e9:.2f} GB (held "
            f"{rec['held_bytes'] / 1e9:.2f}) fits_80g {rec['fits_80g']}; "
            f"{rec['flops_per_dev']:.4g} FLOP, {rec['hbm_bytes_per_dev']:.4g} B; "
            f"t compute/memory/collective "
            f"{rec['t_compute_s']:.4g}/{rec['t_memory_s']:.4g}/{rec['t_collective_s']:.4g} s "
            f"({rec['bottleneck']}); useful {rec['useful_flops_ratio']:.3f}; meta "
            f"{rec['meta_s']} s, probes {rec['probe_s']} s")
    fits = [c for c, r in records.items() if r.get("fits_80g")]
    log(f"dry run: {len(records)} cells in {wall:.1f} s ({DRYRUN_JOBS} workers, started "
        f"beside phase 7), "
        f"{sum('skipped' in r for r in records.values())} skipped, fit one H100: {fits}")
    if len(records) != 40 or not {("mamba2_1_3b", "long_500k"),
                                  ("recurrentgemma_2b", "long_500k")} <= set(fits):
        raise AssertionError(f"dry run: {len(records)} cells, fit {fits}")
    checks = {}
    for arch, shape_name in fits:
        rec, shape = records[(arch, shape_name)], shp.SHAPES[shape_name]
        if shape.kind != "decode":
            raise AssertionError(f"{arch} {shape_name} fits one card: no card check for "
                                 f"{shape.kind} cells")
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        dec = shape.seq_len // 2 if cfg.enc_layers else shape.seq_len
        # the cell's own mesh: the production mesh's env, the batch's distinct rows
        env = steps_lib.make_env(cfg, make_production_mesh(device="cuda"))
        if (env.tp, env.rep, steps_lib.held_rows(env, shape.global_batch)) != (
                rec["tp"], rec["rep"], rec["rows"]):
            raise AssertionError(f"dry run {arch} {shape_name}: the record's tp, rep and rows "
                                 f"are not the production mesh's {env}")
        rows = rec["rows"]
        model = Model(cfg, device="cuda", seed=SEED, env=env)
        serve = steps_lib.make_serve_step(model, global_batch=rows, seq_max=dec)
        cache = model.init_cache(rows, dec, enc_len=dec if cfg.enc_layers else None)
        tokens = torch.zeros((rows,), dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        serve(cache, tokens, dec - 1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        with FlopCounterMode(display=False) as fc:
            serve(cache, tokens, dec - 1)
        flops = fc.get_total_flops()
        c = {"card_peak_bytes": peak, "dryrun_peak_bytes": rec["peak_bytes"],
             "peak_rel": abs(rec["peak_bytes"] - peak) / peak, "card_flops": flops,
             "dryrun_flops": rec["flops_per_dev"],
             "flops_rel": abs(rec["flops_per_dev"] - flops) / flops}
        checks[f"{arch}/{shape_name}"] = c
        log(f"  card check {arch} {shape_name}: {json.dumps(c)}")
        del model, serve, cache, tokens
        if c["peak_rel"] > DRYRUN_PEAK_TOL or c["flops_rel"] > DRYRUN_FLOP_TOL:
            raise AssertionError(f"dry run {arch} {shape_name} against the card: {c}")
    return {"wall_s": wall, "jobs": DRYRUN_JOBS, "fit": [f"{a}/{s}" for a, s in fits],
            "card_checks": checks,
            "records": {f"{a}/{s}": {k: v for k, v in r.items() if k not in ("note", "trace")}
                        for (a, s), r in records.items()}}


def restart_phase(launches: dict, dryrun_pending: dict) -> dict:
    """Phase 8: the elastic restart, the MoE checkpoint on the kernel route
    and the dry run (started by ``dryrun_start``). Adds its kernel launches
    to ``launches``."""
    from repro_torch.kernels import ops

    def count():
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        got = dict(ops.LAUNCHES)
        ops.reset_launches()
        return got

    try:
        res = {"restart": restart_run(count)}
        stage("phase 8 the MoE restore")
        res["moe_restore"] = moe_restore(count)
    except BaseException:
        dryrun_pending["executor"].shutdown(wait=True, cancel_futures=True)
        raise
    stage("phase 8 the dry run's card checks")
    res["dryrun"] = dryrun_phase(dryrun_pending)
    return res


def tp_model(arch: str, mesh: str, layers: int | None = None):
    """``arch`` at full width (``layers`` of its depth, all by default) from
    ``SEED`` on the card, made for ``mesh``: its vocab padded to the model
    axis."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    env = steps_lib.make_env(cfg, make_mesh(tuple(int(x) for x in mesh.split(",")),
                                            device="cuda"))
    return Model(cfg, device="cuda", seed=SEED, env=env)


def rec_tp_depth(arch: str, mesh: str, rows: int, layers: int, card_bytes: float) -> dict:
    """``arch``'s deepest cut (whole superblocks and its tail, its full
    depth at most) whose S3 train step on ``mesh`` over ``rows`` ×
    ``TRAIN_SEQ`` tokens fits the card: the dry run's meta-device count of
    the step's peak (``dryrun.Cell.memory``) within ``1 - REC_TP_MARGIN``
    of the card's ``card_bytes`` (``dryrun.card_memory()``; the count runs
    in the host process, beside the card's phases). The search starts at ``layers`` and moves
    a superblock at a time. Returns {"layers", "limit_gb", "peak_gb":
    {layers counted: peak GB}}."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as shp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import block_pattern

    cfg = get_config(arch)
    unit = len(block_pattern(cfg)[0])
    world = make_mesh(tuple(int(x) for x in mesh.split(",")), device="meta")
    shape = shp.ShapeSpec("phase10", TRAIN_SEQ, rows, "train")
    limit = (1 - REC_TP_MARGIN) * card_bytes
    peak: dict[int, float] = {}

    def fits(n: int) -> bool:
        if n not in peak:
            cell = dryrun.Cell(dataclasses.replace(cfg, n_layers=n), shape, world,
                               scenario="s3_in_net_map", impl="masked", microbatches=1)
            peak[n] = cell.memory()["peak_bytes"]
            del cell
        return peak[n] <= limit

    n = layers
    while not fits(n):
        if n <= unit:
            raise AssertionError(f"{arch} on {mesh}: no cut fits the card: {peak}")
        n -= unit
    while n + unit <= cfg.n_layers and fits(n + unit):
        n += unit
    return {"layers": n, "limit_gb": limit / 1e9,
            "peak_gb": {k: v / 1e9 for k, v in sorted(peak.items())}}


def plain_ring_equal(step, rank: dict, grads: dict) -> bool:
    """Whether the aggregated gradient is bitwise the same aggregation with
    every S3 hop on ``ref.ring_fused_step`` (leaf by leaf, so that only one
    leaf's extra copy is held)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models.parallel import aggregate_leaf

    same = True
    with mock.patch.object(ops, "ring_fused_step", ref.ring_fused_step):
        for k, g in rank.items():
            pl = step.places[k]
            plain = aggregate_leaf(g, step.grad_mesh, step.scenario, fsdp_dim=pl.fsdp_dim,
                                   tp_dim=pl.tp_dim, dup_of=pl.dup_of, tp=step.env.tp)
            same = same and torch.equal(grads[k], plain)
            del plain
    return same


def native_error(step, rank: dict, grads: dict) -> tuple[float, str, float]:
    """The aggregated gradient against NATIVE's fp32 sum of the same ranks'
    gradients (``aggregate_leaf`` under ``native``, leaf by leaf, so that
    only one leaf's extra copy is held), Frobenius over all leaves:
    (normwise relative difference, the worst leaf, its own)."""
    from repro_torch.models.parallel import aggregate_leaf

    num = den = 0.0
    worst = ("", -1.0)
    for k, g in rank.items():
        pl = step.places[k]
        want = aggregate_leaf(g, step.grad_mesh, "native", fsdp_dim=pl.fsdp_dim,
                              tp_dim=pl.tp_dim, dup_of=pl.dup_of, tp=step.env.tp)
        d, w = float((grads[k] - want).norm()) ** 2, float(want.norm()) ** 2
        num, den = num + d, den + w
        if w and (d / w) ** 0.5 > worst[1]:
            worst = (k, (d / w) ** 0.5)
        del want
    return (num / den) ** 0.5, worst[0], worst[1]


def tp_step_record(step, out: dict, got: dict, base_gb: float, rows: int) -> dict:
    """A TP train step's numbers: each phase's ms, the step's, tokens/s, the
    peak over what was held, loss and gradient norm, launches and the ring
    hops that S3 launches ``ring_fused_step`` for."""
    import torch

    step_ms = sum(out["ms"].values())
    return {**{f"{p}_ms": v for p, v in out["ms"].items()}, "step_ms": step_ms,
            "tokens_per_s": rows * TRAIN_SEQ / step_ms * 1e3, "held_gb": base_gb,
            "peak_gb_over_held": torch.cuda.max_memory_allocated() / 1e9 - base_gb,
            "loss": float(out["nll"]) * step.norm, "grad_norm": float(out["grad_norm"]),
            "mesh": list(step.mesh_shape), "tp": step.env.tp, "rep": step.env.rep,
            "dp_world": step.world, "ring_hops": step.ring_hops(), "launches": got,
            "ring_copies": out.get("ring_copies")}


def tp_busy(step, batch) -> dict:
    """The window (host clock to the end of ``torch.cuda.synchronize()``),
    the device's busy time (the union of its intervals, from a
    ``torch.profiler`` trace of CUDA activity alone: a train step's ~10^5
    host-side ops would cost the trace more than the step) and the idle
    share of one call of a step's gradients and their aggregation, the
    parameters left as they are; its launches not counted. None where the
    profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step.aggregate(step.rank_gradients(batch)[0])
        torch.cuda.synchronize()
        window = (time.perf_counter() - t) * 1e3
    ops.reset_launches()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]
    if not spans:
        return None
    busy = busy_us(spans) / 1e3
    return {"window_ms": window, "busy_ms": busy, "idle": 1 - busy / window}


def tp_train_phase(launches: dict, depth: dict) -> dict:
    """Phase 10: training under tensor parallelism at full width, paths (a)
    to (c) (``TP_TRAIN_MESHES``, ``TP_RESTART``, ``REC_TP`` at ``depth``,
    ``rec_tp_depth``'s, ``MOE_TP``). Returns its numbers for the JSON line;
    adds its main paths' kernel launches to ``launches``."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_mesh

    res: dict = {"scenarios": {}, "section_s": {}}
    t_section = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        res["section_s"][name] = now - t_section[0]
        t_section[0] = now
        stage(f"phase 10 after {name}")

    def count():
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        got = dict(ops.LAUNCHES)
        ops.reset_launches()
        return got

    def measured(step, state, batch):
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        out = timed_step(step, state, batch)
        out["ring_copies"] = ops.COPIES["ring_fused_step"]  # count() zeroes it
        return out, count(), base_gb

    # (a) qwen1.5 on (4, 2): one step a scenario from the same parameters
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = tp_model(TRAIN_ARCH, TP_TRAIN_MESHES["native"])
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    cfg = model.cfg
    step, state, pipe = train_inputs(TRAIN_ARCH, "native", TP_TRAIN_MESHES["native"],
                                     TRAIN_BATCH, model=model)
    log(f"tp train {cfg.name}: {cfg.n_layers} layers, tp {step.env.tp} on "
        f"{TP_TRAIN_MESHES['native']}, global batch {TRAIN_BATCH} x {TRAIN_SEQ}; built in "
        f"{time.perf_counter() - t:.2f} s")
    step.rank_gradients(pipe.batch_at(0))  # warm-up: cuBLAS at the tp partials' shapes
    ops.reset_launches()
    del step, state
    native_loss = None
    for sc, mesh in TP_TRAIN_MESHES.items():
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(init[k])
        model.cast_weights()
        step, state, pipe = train_inputs(TRAIN_ARCH, sc, mesh, TRAIN_BATCH, model=model)
        batch = pipe.batch_at(0)
        out, got, base_gb = measured(step, state, batch)
        r = tp_step_record(step, out, got, base_gb, TRAIN_BATCH)
        err, leaf, leaf_err = native_error(step, out["rank"], out["grads"])
        r.update({"agg_err_vs_native": err, "worst_leaf": leaf, "worst_leaf_err": leaf_err})
        hops = step.ring_hops() if sc == "s3_in_net_map" else 0
        if sc == "s3_in_net_map":
            r["bitwise_vs_plain_ring"] = plain_ring_equal(step, out["rank"], out["grads"])
            r["busy"] = tp_busy(step, batch)
        if sc == "native":
            native_loss = r["loss"]
        res["scenarios"][sc] = r
        log(f"tp train step {cfg.name} {sc} on {mesh}: {json.dumps(r)}")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise AssertionError(f"tp train step under {sc}: loss {r['loss']}, grad norm "
                                 f"{r['grad_norm']}")
        if err > AGG_TOL[sc]:
            raise AssertionError(f"tp train step under {sc}: aggregated gradient {err} from "
                                 f"NATIVE's (limit {AGG_TOL[sc]})")
        if got["ring_fused_step"] != hops:
            raise AssertionError(f"tp train step under {sc}: {got['ring_fused_step']} "
                                 f"ring_fused_step launches, not the {hops} ring hops")
        if sc == "s3_in_net_map" and not r["bitwise_vs_plain_ring"]:
            raise AssertionError("TP S3's aggregated gradient differs from the ring run with "
                                 "ref.ring_fused_step")
        del out, step, state
    # the tp = 1 step on the same parameters and rows
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(init[k])
    model.cast_weights()
    step1, _, pipe1 = train_inputs(TRAIN_ARCH, "native", "4,1", TRAIN_BATCH, model=model)
    _, nll1, _ = step1.rank_gradients(pipe1.batch_at(0))
    loss1 = float(nll1) * step1.norm
    res["tp1"] = {"loss": loss1, "tp2_loss": native_loss,
                  "rel_diff": abs(native_loss - loss1) / abs(loss1)}
    log(f"  TP (4, 2) against tp = 1 (4, 1), same parameters and rows: "
        f"{json.dumps(res['tp1'])} (limit {TP_LOSS_TOL})")
    if res["tp1"]["rel_diff"] > TP_LOSS_TOL:
        raise AssertionError(f"the TP step's loss {native_loss} is {res['tp1']['rel_diff']:.3g} "
                             f"from the tp = 1 step's {loss1}")
    ops.reset_launches()
    del step1, pipe1, model, init
    section("a_scenarios_and_tp1")
    res["restart"] = restart_run(count, **TP_RESTART)
    section("a_restart")

    # (b) recurrentgemma on (1, 4): rep 2, the rep groups' rings
    arch, mesh, rows, _ = REC_TP
    torch.cuda.empty_cache()
    layers = depth["layers"]
    log(f"  {arch} on {mesh}: {layers} layers, the deepest whose step fits "
        f"{depth['limit_gb']:.2f} GB (meta-device peak GB by layers: "
        f"{json.dumps(depth['peak_gb'])})")
    section("b_depth")
    model = tp_model(arch, mesh, layers)
    step, state, pipe = train_inputs(arch, "s3_in_net_map", mesh, rows, model=model)
    cfg, recs = model.cfg, []
    for k in range(2):
        batch = pipe.batch_at(k)
        out, got, base_gb = measured(step, state, batch)
        r = tp_step_record(step, out, got, base_gb, rows)
        err, leaf, leaf_err = native_error(step, out["rank"], out["grads"])
        r.update({"agg_err_vs_native": err, "worst_leaf": leaf, "worst_leaf_err": leaf_err,
                  "rep_split": step.split_rep,
                  "bitwise_vs_plain_ring": plain_ring_equal(step, out["rank"], out["grads"])})
        state = out["state"]
        recs.append(r)
        log(f"tp train step {k} {cfg.name} ({layers} of 26 layers) s3_in_net_map on {mesh}: "
            f"{json.dumps(r)}")
        if not np.isfinite(r["loss"]) or err > AGG_TOL["s3_in_net_map"]:
            raise AssertionError(f"{cfg.name} on {mesh}: loss {r['loss']}, aggregated gradient "
                                 f"{err} from NATIVE's")
        if not r["bitwise_vs_plain_ring"]:
            raise AssertionError(f"{cfg.name} on {mesh}: the S3 aggregated gradient differs "
                                 "from the ring run with ref.ring_fused_step")
        if step.env.rep != 2 or got["ring_fused_step"] != r["ring_hops"] or not r["ring_hops"]:
            raise AssertionError(f"{cfg.name} on {mesh}: rep {step.env.rep}, "
                                 f"{got['ring_fused_step']} ring_fused_step launches for "
                                 f"{r['ring_hops']} rep-ring hops")
        del out
    res["recurrentgemma"] = {"steps": recs, "layers": layers, "depth": depth,
                             "busy": tp_busy(step, batch)}
    log(f"  {cfg.name} on {mesh}: window / busy / idle {json.dumps(res['recurrentgemma']['busy'])}")
    del model, step, state, pipe
    section("b_recurrentgemma")

    # (c) granite-moe on (1, 16): tp 16, the a2a dispatch
    arch, mesh, rows, layers = MOE_TP
    torch.cuda.empty_cache()
    model = tp_model(arch, mesh, layers)
    step, state, pipe = train_inputs(arch, "s3_in_net_map", mesh, rows, model=model)
    cfg, recs = model.cfg, []
    fwd = layers * (2 if cfg.remat else 1)  # remat runs each layer's forward twice
    for k in range(2):
        batch = pipe.batch_at(k)
        out, got, base_gb = measured(step, state, batch)
        r = tp_step_record(step, out, got, base_gb, rows)
        state = out["state"]
        recs.append(r)
        log(f"tp train step {k} {cfg.name} ({layers} of 24 layers) s3_in_net_map on {mesh}: "
            f"{json.dumps(r)}")
        if not np.isfinite(r["loss"]) or got["segment_reduce"] != fwd or got["ring_fused_step"]:
            raise AssertionError(f"{cfg.name} on {mesh}: loss {r['loss']}, launches {got} (want "
                                 f"{fwd} segment_reduce: {layers} layers' forward combines, no "
                                 "ring hops)")
        del out
    busy = tp_busy(step, batch)
    part = {k: v[0, 0] for k, v in step.rank_rows(batch).items()}  # the one rank's rows
    group = step.env.tp_group()
    routes, flips = [], []
    with torch.no_grad():
        with recorded_routes(routes):
            got_loss = float(model.train_loss(part, env=group)[0])
        with mock.patch.object(ops, "segment_reduce", ref.segment_reduce), \
                replayed_routes(routes, flips):
            want_loss = float(model.train_loss(part, env=group)[0])
    ops.reset_launches()
    checks = {"loss": abs(got_loss - want_loss) / abs(want_loss), "router_flips": sum(flips)}
    res["granite_moe"] = {"steps": recs, "layers": layers, "busy": busy,
                          "kernel_vs_plain": checks, "tp": step.env.tp,
                          "kv_span": step.env.tp // cfg.n_kv_heads}
    log(f"  {cfg.name} on {mesh}: window / busy / idle {json.dumps(busy)}; kernel route vs "
        f"plain route (ref.segment_reduce, choices replayed): {json.dumps(checks)} (limit "
        f"{MOE_TRAIN_TOL['loss']})")
    if checks["loss"] > MOE_TRAIN_TOL["loss"]:
        raise AssertionError(f"{cfg.name} on {mesh}: the TP training route differs from its "
                             f"plain route: {checks}")
    del model, step, state, pipe
    section("c_granite_moe")
    log(f"  phase 10 sections (s): {json.dumps(res['section_s'])}")
    return res


def digest(x) -> str:
    """The dtype and the sha256 of the bytes of a tensor or array: equal
    digests, equal bits."""
    import hashlib

    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous().cpu().numpy()
    a = np.ascontiguousarray(x)
    return f"{a.dtype}:{hashlib.sha256(a.reshape(-1).view(np.uint8)).hexdigest()}"


def procs_record(name: str, out, devices: int) -> list:
    """What phase 11 holds a path's outputs by, for each of ``devices``
    devices in rank order: the digests of its outputs, or for
    ``PROCS_CLOSE`` its values on the host; for a plan one digest of the
    collected counts, which every rank returns."""
    if name.startswith("plan_"):
        return [digest(out["OUT"])]
    parts = out if isinstance(out, tuple) else (out,)
    rows = [[p.reshape(devices, -1)[r] for p in parts] for r in range(devices)]
    if name in PROCS_CLOSE:
        return [r[0].cpu().numpy() for r in rows]
    return [[digest(x) for x in r] for r in rows]


def procs_launches(name: str, world: int) -> dict:
    """A data-plane path's kernel launches in each rank of a ``world``-rank
    process mesh (``PROCS_LAUNCHES``; S3 makes ``world - 1`` hops)."""
    want = dict(PROCS_LAUNCHES.get(name, {}))
    if "ring_fused_step" in want:
        want["ring_fused_step"] = world - 1
    return want


def procs_meshes(world: int, device, process: bool = True, group=None) -> dict:
    """The data plane's meshes over ``world`` devices: "all" and "data" of
    ``world``, "pod_data" (2, world / 2); this process's ``ProcessMesh``es
    over ``group`` (None: the default group), or (``process`` False) world
    dims on ``device``."""
    from repro_torch.mesh import Mesh, ProcessMesh

    if not process:
        return {"all": Mesh(("all",), (world,), device=device),
                "data": Mesh(("data",), (world,), device=device),
                "pod_data": Mesh(("pod", "data"), (2, world // 2), device=device)}
    return {"all": ProcessMesh(("all",), (world,), device=device, group=group),
            "data": ProcessMesh(("data",), (world,), device=device, group=group),
            "pod_data": ProcessMesh(("pod", "data"), (2, world // 2), device=device,
                                    group=group)}


def save_inputs(directory: Path, shards, grads_np) -> Path:
    """Phase 3's inputs written under ``directory`` for ``procs_inputs``:
    the word shards (one row a mapper) and the gradient rows, ``.npy``."""
    import numpy as np

    np.save(directory / "shards.npy", np.stack(shards))
    np.save(directory / "grads.npy", grads_np)
    return directory


def procs_inputs(meshes: dict, tokens: int = TOKENS_PER_MAPPER, grad_size: int = GRAD_SIZE,
                 saved: Path | None = None) -> tuple:
    """Phase 3's inputs at the meshes' world (``draw_inputs``: ``tokens`` a
    mapper, ``grad_size`` gradients a device), or their first rows read
    from ``save_inputs``' files under ``saved``, each mesh's share of them
    (a process's shard, or every row on world dims), and the word-count
    plan on a ring of that many switches: (words, grads, grads on
    "pod_data", plan)."""
    import numpy as np

    from repro_torch import compiler
    from repro_torch.core import wordcount as wc
    from repro_torch.core.topology import TorusTopology

    world = meshes["all"].axis_size("all")
    if saved is not None:
        shards = np.load(Path(saved) / "shards.npy", mmap_mode="c")[:world]
        grads_np = np.load(Path(saved) / "grads.npy", mmap_mode="c")[:world]
        if shards.shape != (world, tokens) or grads_np.shape != (world, grad_size):
            raise ValueError(f"saved inputs {shards.shape}, {grads_np.shape} are not a world "
                             f"of {world} at {tokens} tokens and {grad_size} gradients")
    else:
        shards, grads_np = draw_inputs(world, tokens, grad_size)
    words = meshes["all"].shard(shards)
    grads = meshes["data"].shard(grads_np)
    grads24 = meshes["pod_data"].shard(grads_np.reshape(2, world // 2, grad_size))
    plan = compiler.compile(wc.wordcount_program(world, VOCAB),
                            TorusTopology(dims=(world,)), passes=PLAN_PASSES)
    return words, grads, grads24, plan


def procs_paths(meshes: dict, words, grads, grads24, plan) -> dict:
    """Phase 3's paths of ``PROCS_PATHS`` on one rank's process meshes
    (``procs_meshes``) over its shards, or on world dims over every row,
    through the same entry points: name → call."""
    import torch

    from repro_torch.core import scenarios
    from repro_torch.core import wordcount as wc
    from repro_torch.mesh import ProcessMesh

    m, d8, d24 = meshes["all"], meshes["data"], meshes["pod_data"]
    n = m.axis_size("all")

    def hist_path():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return wc.wordcount_step(words, VOCAB, m, "all", histogram_fn=wc.kernel_histogram)

    def plan_path():
        hist = wc.kernel_histogram(words, VOCAB)
        if not isinstance(m, ProcessMesh):
            return plan.run({f"s{i}": hist[i] for i in range(n)}, mesh=m)
        # the plan reads a rank's inputs only for the Store on its own switch
        other = torch.zeros_like(hist[0])
        return plan.run({f"s{i}": hist[0] if int(plan.placement.switch_of(f"s{i}")) == m.rank
                         else other for i in range(n)}, mesh=m)

    paths = {
        "wordcount_histogram": hist_path,
        "wordcount_token": lambda: wc.wordcount_token_shuffle(words, VOCAB, m, "all"),
        "wordcount_s1_host": lambda: wc.wordcount_host_baseline(words, VOCAB, m, "all"),
    }
    for sc in ("s1_host", "s2_in_net", "s3_in_net_map", "native"):
        paths[f"aggregate_{sc}"] = lambda sc=sc: scenarios.aggregate(
            grads, d8, sc, data_axis="data")
    paths["aggregate_hierarchical"] = lambda: scenarios.aggregate(
        grads24, d24, "hierarchical", data_axis="data", pod_axis="pod")
    paths["plan_wordcount_tree"] = plan_path
    return paths


def procs_timed(meshes: dict, paths: dict, grads, capture: dict | None = None) -> dict:
    """Every path of ``paths`` once to warm up, then once timed (between
    barriers on a process mesh): its wall, kernel launches, staged host
    copies and collectives, with its outputs' ``procs_record``; S3 against
    the plain ring. With ``capture``, the inputs of each path's first launch
    of each kernel in the timed call, device copies under (path, kernel)
    (for ``ring_fused_step`` also its acc's ``hop_layout``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.mesh import ProcessMesh, count_collectives, count_staging

    process = isinstance(meshes["all"], ProcessMesh)
    n = meshes["all"].axis_size("all")
    out_recs = {}

    def capturing(name):
        stack = contextlib.ExitStack()
        if capture is None:
            return stack
        for k in ("hash_partition", "segment_reduce", "ring_fused_step"):
            real = getattr(ops, k)

            def kept(*args, real=real, key=(name, k), **kw):
                if key not in capture:
                    capture[key] = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
                    if k == "ring_fused_step":  # and how its acc lay
                        capture[key] += (hop_layout(args[0]),)
                return real(*args, **kw)

            stack.enter_context(mock.patch.object(ops, k, kept))
        return stack

    for name, fn in paths.items():
        fn()  # the warm-up: groups, pinned buffers, the allocator's blocks
        torch.cuda.synchronize()
        if process:
            dist.barrier(group=meshes["all"].group)
        ops.reset_launches()
        with count_staging() as staged, count_collectives() as colls, capturing(name):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        rec = {"wall_s": wall, "launches": dict(ops.LAUNCHES), "staged": dict(staged),
               "copies": ops.COPIES["ring_fused_step"], "collectives": dict(colls),
               "out": procs_record(name, out, 1 if process else n)}
        if name == "aggregate_s3_in_net_map":
            plain = coll.ring_all_reduce(grads, meshes["data"], "data",
                                         wire_map=lambda a: a.to(torch.bfloat16),
                                         unmap=lambda a: a.to(torch.float32)) * (1.0 / n)
            rec["plain_ring_equal"] = bool(torch.equal(out, plain))
            del plain
        out_recs[name] = rec
        del out
    return out_recs


def procs_rank(saved: str, device) -> dict:
    """Phase 11 in one rank (``launch.procs.spawn``): its shards of phase 3's
    inputs (``procs_inputs``, from the files under ``saved``), every path of
    ``procs_paths`` timed (``procs_timed``), and the rank's peak memory."""
    import torch

    t = time.perf_counter()
    meshes = procs_meshes(PROCS_WORLD, device)
    words, grads, grads24, plan = procs_inputs(meshes, saved=saved)
    res = {"transport": meshes["all"].transport, "setup_s": time.perf_counter() - t}
    torch.cuda.reset_peak_memory_stats()
    res["paths"] = procs_timed(meshes, procs_paths(meshes, words, grads, grads24, plan), grads)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def procs_hold(ranks: list, ref: dict, world: int, launches: dict, label: str) -> dict:
    """Each data-plane path's outputs in every rank held to the world-dim
    run (``ref``, from ``procs_record``: bitwise, ``PROCS_CLOSE`` within
    ``PROCS_TOL``, S3 also bitwise the plain ring) and its launches to
    ``procs_launches``, which are added to ``launches``; no rank's
    ``ring_fused_step`` copied a hop's input (``ops.COPIES``). Returns per path
    the wall (the slowest rank), the bytes staged through host memory (all
    ranks), the staging seconds and their share of the wall (the rank
    where it is largest), rank 0's collectives and the launches per rank."""
    import numpy as np

    from repro_torch.kernels import ops

    out = {}
    for name in PROCS_PATHS:
        recs = [r["paths"][name] for r in ranks]
        want = {k: procs_launches(name, world).get(k, 0) for k in ops.LAUNCHES}
        for r, rec in enumerate(recs):
            if rec["launches"] != want:
                raise AssertionError(f"{label}_{name}: rank {r} made launches {rec['launches']}, "
                                     f"not {want}")
            if rec["copies"]:
                raise AssertionError(f"{label}_{name}: rank {r}'s ring_fused_step copied "
                                     f"{rec['copies']} hop inputs before its kernel")
            for k, v in rec["launches"].items():
                launches[k] += v
        if name in PROCS_CLOSE:
            got = [(rec["out"][0], ref[name][r]) for r, rec in enumerate(recs)]
            err = max(float(np.abs(g.astype(np.float64) - w).max()) for g, w in got)
            same = all(np.allclose(g, w, rtol=PROCS_TOL, atol=PROCS_TOL) for g, w in got)
            held = f"within rtol=atol={PROCS_TOL} of the world-dim run (max abs diff {err!r})"
        elif name.startswith("plan_"):
            same = all(rec["out"] == ref[name] for rec in recs)
            held = "every rank's counts bitwise == the world-dim run's"
        else:
            same = all(rec["out"][0] == ref[name][r] for r, rec in enumerate(recs))
            held = "every rank's outputs bitwise == its row of the world-dim run"
        if name == "aggregate_s3_in_net_map":
            same = same and all(rec["plain_ring_equal"] for rec in recs)
            held += ", and == the plain ring (bf16 maps as separate steps)"
        if not same:
            raise AssertionError(f"{label}_{name}: a rank's outputs differ from the world-dim "
                                 f"run (or S3 from the plain ring)")
        wall = max(rec["wall_s"] for rec in recs)
        share = max(rec["staged"]["seconds"] / rec["wall_s"] for rec in recs)
        out[name] = {
            "wall_s": wall, "staged_bytes": sum(rec["staged"]["bytes"] for rec in recs),
            "staged_copies": sum(rec["staged"]["copies"] for rec in recs),
            "staging_s": max(rec["staged"]["seconds"] for rec in recs), "staging_share": share,
            "collectives_rank0": {k: v for k, v in recs[0]["collectives"].items() if v},
            "launches_per_rank": recs[0]["launches"], "held": held}
    return out


def procs_phase(ref: dict, saved: Path) -> dict:
    """Phase 11: ``PROCS_WORLD`` gloo ranks spawned on the one card
    (``procs_rank``); each path's outputs in every rank held to phase 3's
    world-dim run (``ref``, from ``procs_record``) and its launches to
    ``PROCS_LAUNCHES`` (``procs_hold``). Returns the readings: per path the
    wall (the slowest rank), the bytes staged through host memory (all
    ranks), the staging seconds and their share of the wall (the rank
    where it is largest), the launches per rank; the largest peak memory of
    a rank; the launches summed over ranks and paths."""
    import tempfile

    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        with spawning(functools.partial(procs_rank, str(saved)), PROCS_WORLD, backend="gloo",
                      store_path=Path(tmp) / "store", timeout_s=PROCS_TIMEOUT_S) as got:
            pass  # nothing to make meanwhile: phase 3 made the reference
        ranks, spawned = got["ranks"], got["times"]
    res = {"ranks": PROCS_WORLD, "transport": sorted({r["transport"] for r in ranks}),
           **spawned, "setup_s": max(r["setup_s"] for r in ranks),
           "peak_gb_per_rank": max(r["peak_gb"] for r in ranks),
           "launches": dict.fromkeys(ops.LAUNCHES, 0)}
    log(f"process mesh: {PROCS_WORLD} ranks on one card, {' / '.join(res['transport'])}; spawned, "
        f"run and joined in {res['spawn_s']:.2f} s (start {res['start_s']:.2f} s, the slowest "
        f"rank's call {res['call_s']:.2f} s, teardown {res['teardown_s']:.2f} s; a rank's setup, "
        f"its shards read and the plan compiled: {res['setup_s']:.2f} s at most)")
    res["paths"] = procs_hold(ranks, ref, PROCS_WORLD, res["launches"], "procs")
    for name, p in res["paths"].items():
        log(f"path procs_{name}: {p['wall_s'] * 1e3:.3f} ms wall (the slowest rank), "
            f"{p['staged_copies']} host copies of {p['staged_bytes'] / 1e9:.3f} GB, staging "
            f"{p['staging_s'] * 1e3:.3f} ms in a rank ({p['staging_share']:.1%} of its wall at "
            f"most), launches per rank "
            f"{ {k: v for k, v in p['launches_per_rank'].items() if v} }; {p.pop('held')}")
    log(f"  peak device memory of a rank {res['peak_gb_per_rank']:.3f} GB; launches summed over "
        f"the ranks {res['launches']}")
    return res


def procs_phases(procs_ref: dict, saved: Path, refs: Path) -> dict:
    """Phases 11-13, the process mesh on one card: the data plane held to
    phase 3's world-dim run (``procs_ref``, its inputs ``saved``), serving
    and training every block kind, with the four-rank references that phase
    14 reuses kept under ``refs`` (``keep_refs``). Returns each phase's
    readings (its ``wall_s`` among them), their kernel rows at a rank's
    shapes, the launches of their main paths and what phase 14 reuses
    ("kept")."""
    from repro_torch.kernels import ops

    launches = dict.fromkeys(ops.LAUNCHES, 0)
    stage("phase 11 data plane on a process mesh")
    t = time.perf_counter()
    procs = procs_phase(procs_ref, saved)
    procs["wall_s"] = time.perf_counter() - t
    for k in launches:
        launches[k] += procs["launches"][k]
    log(f"process mesh phase: {procs['wall_s']:.2f} s")

    stage("phase 12 serving on a process mesh")
    kept = {"dir": refs, "serve": {}, "train": {}}
    t = time.perf_counter()
    serve_rows = []  # the kernels at a rank's shapes, with phase 12's launches
    serving = procs_serve_phase(launches, serve_rows, kept)
    serving["wall_s"] = time.perf_counter() - t
    log(f"serving on a process mesh phase: {serving['wall_s']:.2f} s")

    stage("phase 13 training on a process mesh")
    t = time.perf_counter()
    train_rows = []  # the kernels at a rank's shapes, with phase 13's launches
    training = procs_train_phase(launches, train_rows, kept)
    training["wall_s"] = time.perf_counter() - t
    log(f"training on a process mesh phase: {training['wall_s']:.2f} s")
    return {"procs": procs, "procs_serving": serving, "procs_training": training,
            "rows": serve_rows + train_rows, "launches": launches, "kept": kept}


def recording_logits(log: list):
    """A patch of ``parallel._local_logits`` that appends to ``log`` the
    fp32 logits that each greedy token is taken from (the whole padded vocab
    on world dims, the rank's vocab shard on a process mesh): the served
    call's own, with no product or weight fetch of its own."""
    from repro_torch.models import parallel

    real = parallel._local_logits

    def local_logits(*args):
        out = real(*args)
        log.append(out[0])
        return out

    return mock.patch.object(parallel, "_local_logits", local_logits)


def procs_serve_routes(arch: str) -> tuple[str, ...]:
    return ("gather", "cad") if arch in PROCS_SERVE_CAD else ("gather",)


def procs_serve_config(arch: str):
    """``arch``'s config at full width, cut to ``PROCS_SERVE_LAYERS`` (and
    an enc-dec model's encoder to ``PROCS_SERVE_ENC_LAYERS``)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(case_arch(arch))
    cut = {"n_layers": PROCS_SERVE_LAYERS.get(arch), "enc_layers": PROCS_SERVE_ENC_LAYERS.get(arch)}
    return dataclasses.replace(cfg, **{k: v for k, v in cut.items() if v})


def procs_serve_batch(model, rows: int, arch: str):
    """``arch``'s seeded prompt rows (``launch.serve.prompt_batch`` from
    ``SEED``): tokens, patch embeddings with their grid, or ``ENC_FRAMES``
    frames and a token prompt."""
    from repro_torch.launch import serve

    _, _, prompt, _ = PROCS_SERVE[arch]
    return serve.prompt_batch(model, rows, prompt, seed=SEED, enc_len=ENC_FRAMES)


def procs_serve_world(arch: str, tmp: Path) -> dict:
    """Phase 12's reference for ``arch``: the world-dim serve on the card of
    the same mesh shape, weights (``SEED``) and rows, on each route, with
    every step's logits recorded. Writes each rank's part to
    ``tmp/ref.<arch>.<rank>.pt`` (the world tokens, that rank's rows and
    vocab shard of every step's logits, and its block of the final cache,
    ``convert.cache_block``) and returns the tokens, each step's top-two
    margins, the walls and the peak memory of each route."""
    import torch

    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import cache_block, flatten
    from repro_torch.models.model import Model

    dims, gb, _, gen = PROCS_SERVE[arch]
    cfg = procs_serve_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(dims, device="cuda")
    env = steps.make_env(cfg, mesh)
    model = Model(cfg, device="cuda", seed=SEED, env=env)
    batch = procs_serve_batch(model, steps.held_rows(env, gb), arch)
    setup_gb = torch.cuda.max_memory_allocated() / 1e9
    per = model.vocab_padded // env.tp
    rep, b_loc = env.row_groups(steps.batch_shape(batch)[0])
    parts = [{} for _ in range(mesh.size)]
    out = {}
    for route in procs_serve_routes(arch):
        logs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recording_logits(logs):
            res = serve.generate(model, batch, gen, impl="flash", mesh=mesh, global_batch=gb,
                                 compute_at_data=route == "cad")
        torch.cuda.synchronize()
        if len(logs) != gen:
            raise AssertionError(f"procs_serve_{arch} ({route}): {len(logs)} greedy calls, not {gen}")
        lg = torch.stack(logs)  # (gen, rows, V_pad)
        top2 = torch.topk(lg[..., :cfg.vocab], 2, dim=-1).values
        out[route] = {"tokens": res["tokens"].cpu(), "margins": (top2[..., 0] - top2[..., 1]).cpu(),
                      "walls": serve_walls(res, gb, gen), "setup_peak_gb": setup_gb,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        for r in range(mesh.size):
            f, m = divmod(r, env.model_size)
            start = (f * rep + (m % env.rep if rep > 1 else 0)) * b_loc
            t = m // env.rep
            parts[r][route] = {
                "tokens": out[route]["tokens"],
                "logits": lg[:, start:start + b_loc, t * per:(t + 1) * per].cpu(),
                "cache": {k: v.cpu() for k, v in flatten(
                    cache_block(res["cache"], env, f, m)).items()}}
        del res, logs, lg
    del model, batch
    torch.cuda.empty_cache()
    for r, part in enumerate(parts):
        torch.save(part, tmp / f"ref.{arch}.{r}.pt")
    return out


def process_mesh(dims: tuple, device, meshes: dict | None = None):
    """The ("data", "model") process mesh of ``dims`` on ``device``: the one
    in ``meshes`` of that shape (made there the first time), else a new one."""
    from repro_torch.mesh import ProcessMesh

    if meshes is None:
        return ProcessMesh(("data", "model"), dims, device=device)
    if dims not in meshes:
        meshes[dims] = ProcessMesh(("data", "model"), dims, device=device)
    return meshes[dims]


def procs_serve_rank(arch: str, tmp: str, device, meshes: dict | None = None) -> dict:
    """Phase 12 for ``arch`` in one rank (``launch.procs.spawn``): the model
    made from ``SEED`` under its process mesh's env (each leaf cut to its
    device's shard as it is drawn; the setup's peak memory read), the seeded
    prompts' rows of its block (every input of a dict batch), then per route
    one served call, its launches, staged copies and collectives counted
    and every step's logits recorded as the greedy token reads them (on the
    gather route, rank 0 keeps a device copy of its first
    ``flash_attention`` and ``segment_reduce`` inputs), held on its rows and
    vocab shard to the world-dim run (``procs_serve_world``'s part), at each
    step on the rows whose tokens so far agree: each row's largest logit
    difference, and the step's squared differences and squared reference
    logits; and the final cache block's worst normwise difference on the
    rows whose tokens all agree. ``meshes``: process meshes by shape that
    the rank's cases share (their groups made once), else one of its own."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps
    from repro_torch.mesh import count_collectives, count_staging
    from repro_torch.models.convert import flatten
    from repro_torch.models.model import Model

    dims, gb, _, gen = PROCS_SERVE[arch]
    cfg = procs_serve_config(arch)
    t0 = time.perf_counter()
    torch.set_num_threads(1)  # the ranks share the host's cores
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pm = process_mesh(dims, device, meshes)
    env = steps.make_env(cfg, pm)
    model = Model(cfg, device=device, seed=SEED, env=env)
    batch = procs_serve_batch(model, steps.held_rows(env.world(), gb), arch)
    rows = steps.map_batch(batch, lambda v: steps.rank_rows(env, v, gb))
    del batch
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref = torch.load(Path(tmp) / f"ref.{arch}.{pm.rank}.pt")
    res = {"setup_s": time.perf_counter() - t0, "held_gb": torch.cuda.memory_allocated() / 1e9,
           "setup_peak_gb": setup_peak,
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "transport": pm.transport, "routes": {}, "capture": {}}

    def capturing():
        stack = contextlib.ExitStack()
        if pm.rank != 0:
            return stack
        real_fa, real_sr = ops.flash_attention, ops.segment_reduce

        def fa(q, k, v, causal=True):
            if "flash" not in res["capture"]:
                res["capture"]["flash"] = tuple(t.clone() for t in (q, k, v)) + (causal,)
            return real_fa(q, k, v, causal=causal)

        def sr(values, ids, n):
            if "combine" not in res["capture"]:
                res["capture"]["combine"] = (values.clone(), ids.clone(), n)
            return real_sr(values, ids, n)

        stack.enter_context(mock.patch.object(ops, "flash_attention", fa))
        stack.enter_context(mock.patch.object(ops, "segment_reduce", sr))
        return stack

    for route in procs_serve_routes(arch):
        logs = []
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        with (recording_logits(logs), count_staging() as staged,
              count_collectives() as coll,
              capturing() if route == "gather" else contextlib.ExitStack()):
            out = serve.generate(model, rows, gen, impl="flash", mesh=pm, global_batch=gb,
                                 compute_at_data=route == "cad")
        torch.cuda.synchronize()
        rec = {"launches": dict(ops.LAUNCHES), "prefill_s": out["prefill_s"],
               "decode_s": out["decode_s"], "staged": dict(staged), "collectives": dict(coll)}
        toks, want = out["tokens"], ref[route]
        wt = steps.rank_rows(env, want["tokens"].to(device), gb)  # (b_loc, gen)
        if len(logs) != gen:
            raise AssertionError(f"procs_serve_{arch} ({route}): {len(logs)} greedy calls")
        lg, wl = torch.stack(logs), want["logits"].to(device)  # (gen, b_loc, V/tp)
        agree = torch.stack([(toks[:, :i] == wt[:, :i]).all(1) for i in range(gen)])
        mask = agree[..., None] & torch.isfinite(wl)  # (gen, b_loc, V/tp)
        d = torch.where(mask, lg - wl, 0.0)
        rec.update({"tokens": toks.cpu(), "row_diffs": d.abs().amax(-1).cpu(),  # (gen, b_loc)
                    "sq": (d * d).sum((1, 2)).tolist(),
                    "wsq": torch.where(mask, wl * wl, 0.0).sum((1, 2)).tolist(),
                    "logits_equal": bool(torch.equal(lg[0], wl[0])),
                    "coords": tuple(pm.coords)})
        same = (toks == wt).all(1).nonzero()[:, 0]
        worst = 0.0
        for k, v in flatten(out["cache"]).items():
            rd = int(k.split("/")[0] == "blocks")  # superblock leaves lead with the layers
            a, b = v.index_select(rd, same), want["cache"][k].to(device).index_select(rd, same)
            if b.numel() and float(b.float().norm()):
                worst = max(worst, rel_err(a, b))
        rec.update({"cache_worst": worst, "cache_rows": int(same.numel())})
        del out, logs, lg, wl, d, mask
        res["routes"][route] = rec
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["capture"] = {k: tuple(t.cpu() if hasattr(t, "cpu") else t for t in v)
                      for k, v in res["capture"].items()}
    res["arch_s"] = time.perf_counter() - t0
    del model, rows, ref
    torch.cuda.empty_cache()
    return res


def procs_serve_ranks(archs: tuple, tmp: str, device) -> dict:
    """One rank of a spawn shared by ``archs`` (one world size): each arch
    in turn (``procs_serve_rank``), its model freed before the next."""
    return {arch: procs_serve_rank(arch, tmp, device) for arch in archs}


def procs_serve_decisive(tokens, want, margins, diffs) -> tuple[bool, int, int]:
    """Every row's greedy tokens (rows, gen) against the world-dim run's
    ``want``, step by step while the row's tokens agree: at a step whose
    world-dim top-two margin exceeds twice ``diffs[step, row]`` (the row's
    largest logit difference of the two runs there, over the whole vocab)
    the tokens must be equal; at another, a difference ends that row's
    comparison. Returns (equal where decisive, decisive positions compared,
    positions compared)."""
    ok, decisive, compared = True, 0, 0
    for r in range(tokens.shape[0]):
        for i in range(tokens.shape[1]):
            compared += 1
            same = bool(tokens[r, i] == want[r, i])
            if float(margins[i, r]) > 2 * float(diffs[i, r]):
                decisive += 1
                ok = ok and same
            if not same:
                break
    return ok, decisive, compared


def procs_serve_check(arch: str, world: dict, ranks: list, res: dict) -> dict:
    """Phase 12's checks of ``arch``: every rank's launches, then on each
    route its tokens, logits and cache blocks held to the world-dim run
    (``world``); adds the ranks' launches to ``res``. Returns the readings."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    dims, gb, _, gen = PROCS_SERVE[arch]
    cfg = procs_serve_config(arch)
    env = steps.make_env(cfg, make_mesh(dims, device="meta"))
    want_fa, want_sr = PROCS_SERVE_LAUNCHES[arch]
    st = {"ranks": len(ranks), "layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
          "transport": sorted({r["transport"] for r in ranks}),
          "setup_s": max(r["setup_s"] for r in ranks),
          "rank_s": max(r["arch_s"] for r in ranks),
          "setup_peak_gb_per_rank": max(r["setup_peak_gb"] for r in ranks),
          "held_gb_per_rank": max(r["held_gb"] for r in ranks),
          "param_gb_per_rank": max(r["param_bytes"] for r in ranks) / 1e9,
          "peak_gb_per_rank": max(r["peak_gb"] for r in ranks),
          "world_setup_peak_gb": max(w["setup_peak_gb"] for w in world.values()),
          "world_peak_gb": max(w["peak_gb"] for w in world.values()), "routes": {},
          "flash_launches": 0}
    for route, w in world.items():
        recs = [r["routes"][route] for r in ranks]
        for i, rec in enumerate(recs):
            got = rec["launches"]
            if (got["flash_attention"], got["segment_reduce"]) != (want_fa, want_sr) or (
                    got["hash_partition"] or got["ring_fused_step"]):
                raise AssertionError(f"procs_serve_{arch} ({route}): rank {i} made {got} "
                                     f"launches, not {want_fa} flash_attention and {want_sr} "
                                     "segment_reduce")
            for k, v in got.items():
                res["launches"][k] += v
            st["flash_launches"] += got["flash_attention"]
        # the tokens device-major (rows_of refuses tp ranks of a group that differ)
        blocks = torch.stack([rec["tokens"] for rec in recs])
        blocks = blocks.reshape(dims + blocks.shape[1:])
        if not env.batch_split_rep(gb):  # every model index holds the data rank's rows
            if not bool((blocks == blocks[:, :1]).all()):
                raise AssertionError(f"procs_serve_{arch} ({route}): the tp ranks' tokens "
                                     "differ")
            blocks = blocks[:, :1]
        toks = steps.rows_of(env, blocks, gb)
        if toks.shape != (gb, gen) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"procs_serve_{arch}: tokens {tuple(toks.shape)} out of shape "
                                 "or vocab")
        # each row's largest difference over the vocab shards of the ranks that hold it
        rep, b_loc = env.row_groups(gb)
        diffs = torch.zeros(gen, w["tokens"].shape[0])
        for rec in recs:
            f, m = rec["coords"]
            start = (f * rep + (m % env.rep if rep > 1 else 0)) * b_loc
            sl = diffs[:, start:start + b_loc]
            torch.maximum(sl, rec["row_diffs"], out=sl)
        ok, decisive, compared = procs_serve_decisive(toks, w["tokens"], w["margins"], diffs)
        step_rel = [(sum(rec["sq"][i] for rec in recs)
                     / sum(rec["wsq"][i] for rec in recs)) ** 0.5 for i in range(gen)]
        logits = step_rel[0]
        r = {"tokens_equal_where_decisive": ok, "decisive": decisive, "compared": compared,
             "positions": gb * gen, "agreement": float((toks == w["tokens"]).float().mean()),
             "max_logit_diff": float(diffs.max()), "step_logits_rel": step_rel,
             "prefill_logits_rel": logits,
             "prefill_logits_bitwise": all(rec["logits_equal"] for rec in recs),
             "launches_per_rank": {k: v for k, v in recs[0]["launches"].items() if v},
             "world_walls": w["walls"]}
        wall = max(rec["prefill_s"] + rec["decode_s"] for rec in recs)
        r.update({"prefill_s": max(rec["prefill_s"] for rec in recs),
                  "decode_ms_per_step": (max(rec["decode_s"] for rec in recs)
                                         / max(1, gen - 1) * 1e3),
                  "staged_bytes": sum(rec["staged"]["bytes"] for rec in recs),
                  "staged_copies": sum(rec["staged"]["copies"] for rec in recs),
                  "staging_share": max(rec["staged"]["seconds"] for rec in recs) / wall,
                  "collectives_rank0": recs[0]["collectives"],
                  "collectives_summed": {k: sum(rec["collectives"][k] for rec in recs)
                                         for k in recs[0]["collectives"]}})
        r["cache_worst"] = max(rec["cache_worst"] for rec in recs)
        r["cache_rows"] = sum(rec["cache_rows"] for rec in recs)
        st["routes"][route] = r
        # tp 2 sums two partials, exactly in either order: the prefill bitwise
        bad = (not ok or max(step_rel) > TP_TOL
               or (env.tp == 2 and not r["prefill_logits_bitwise"])
               or r["cache_worst"] > TP_TOL or r["cache_rows"] == 0
               or (arch in PROCS_SERVE_SHARE and decisive < DECISIVE_SHARE * compared))
        if bad:
            raise AssertionError(f"procs_serve_{arch} ({route}) differs from the world-dim "
                                 f"run: {r}")
    return st


def procs_flash_row(capture: tuple, launches: int, what: str) -> dict:
    """The ``flash_attention`` row at a rank's shapes (``capture``: rank 0's
    first launch of a path, (q, k, v, causal, path)), timed alone against
    its plain version and SDPA; ``launches``: that path's over its ranks."""
    import torch

    from repro_torch.kernels import ref

    q, k, v, causal, fpath = capture
    q, k, v = (t.cuda() for t in (q, k, v))
    fa = importlib.import_module("repro_torch.kernels.flash_attention").flash_attention
    kout, pout = fa(q, k, v, causal=causal), ref.flash_attention(q, k, v, causal=causal)
    row_err = row_rel_err(kout, pout)
    if row_err > ROW_TOL[str(kout.dtype)]:
        raise AssertionError(f"flash_attention at a rank's shape ({fpath}): a row is {row_err} "
                             "off")
    fb, fh, fs, fd = q.shape
    pairs = fs * (fs + 1) / 2 if causal else fs * fs
    b_ms, b_by = bound_ms((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                          4 * fd * fb * fh * pairs, BF16_TC_OPS_PER_S)
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "launches": launches, "max_abs_err": max_abs_err([(kout, pout)]),
        "ms": cuda_ms(lambda: fa(q, k, v, causal=causal)),
        "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v, causal=causal), iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])),
        "norm_rel_err": rel_err(kout, pout), "max_row_rel_err": row_err, "path": "procs_" + fpath,
        "shape": f"q {tuple(q.shape)}, k, v {tuple(k.shape)} bf16, "
                 f"{'causal' if causal else 'non-causal'}: {what}",
    }
    del q, k, v, kout, pout
    return row


def keep_refs(kept: dict, tmp: Path, names: list, ranks: int) -> None:
    """Move each rank's reference file ``<name>.<rank>.pt`` of ``names`` from
    ``tmp`` into ``kept["dir"]``, where phase 14 reads them (``main`` holds
    the directory from phase 12 to phase 14)."""
    import shutil

    for name in names:
        for r in range(ranks):
            shutil.move(tmp / f"{name}.{r}.pt", kept["dir"] / f"{name}.{r}.pt")


def combine_row(capture: tuple, launches: int, path: str, what: str) -> dict:
    """The ``segment_reduce`` row at a rank's a2a combine (``capture``: its
    (values, ids, nseg), copied to the current card), held against the plain
    version within ``COMBINE_TOL`` of the largest sum and timed alone beside
    it and ``index_add_`` on the kept rows; ``launches``: its path's."""
    import torch

    from repro_torch.kernels import ref

    values, ids, nseg = capture[:3]
    values, ids = values.cuda(), ids.cuda()
    sr = bare_launchers()[1]
    ks, ps = sr(values, ids, nseg), ref.segment_reduce(values, ids, nseg)
    comb_err = float((ks - ps).abs().max() / ps.abs().max())
    if comb_err > COMBINE_TOL:
        raise AssertionError(f"segment_reduce at {what}: {comb_err} off (relative)")
    ok = ids >= 0
    vals32, ids64, kept = values[ok].float(), ids[ok].long(), int(ok.sum())
    lib_out = torch.zeros_like(ps)
    b_ms, b_by = bound_ms(kept * values.shape[1] * values.element_size() + ids.numel() * 4
                          + ps.numel() * 4, kept * values.shape[1])
    return {
        "name": "segment_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:55",
        "launches": launches, "max_abs_err": max_abs_err([(ks, ps)]),
        "rel_err": comb_err, "ms": cuda_ms(lambda: sr(values, ids, nseg)),
        "plain_ms": cuda_ms(lambda: ref.segment_reduce(values, ids, nseg)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, ids64, vals32)), "path": path,
        "shape": f"values {tuple(values.shape)} bf16, ids ({ids.numel()},) int32 ({kept} kept), "
                 f"nseg={nseg}: {what}",
    }


def procs_serve_phase(launches: dict, rows: list, kept: dict | None = None) -> dict:
    """Phase 12: for each group of ``PROCS_SERVE_SPAWNS`` one gloo rank per
    mesh device spawned on the card once for the group
    (``procs_serve_ranks``), which starts while the world-dim reference of
    each of its archs is made (``procs_serve_world``, ``spawning``) and
    then serves them, each arch held to its reference
    (``procs_serve_check``). Adds the ranks' launches to ``launches`` and
    the kernel rows at a rank's shapes to ``rows``: ``flash_attention`` at
    each of ``PROCS_SERVE_FLASH``'s archs, ``segment_reduce`` at the a2a
    combine; returns the readings. With ``kept`` (``keep_refs``) the
    references of the archs served on ``NCCL_WORLD`` ranks stay for phase 14."""
    import tempfile

    import torch

    from repro_torch.kernels import ops

    res = {"archs": {}, "launches": dict.fromkeys(ops.LAUNCHES, 0), "spawns": []}
    captured = {}
    for group in PROCS_SERVE_SPAWNS:
        sizes = {math.prod(PROCS_SERVE[a][0]) for a in group}
        if len(sizes) != 1:
            raise ValueError(f"phase 12 spawn {group}: world sizes {sizes} differ")
        n = sizes.pop()
        with tempfile.TemporaryDirectory() as tmp:
            world, world_s = {}, {}
            # the ranks start while their references are made
            with spawning(functools.partial(procs_serve_ranks, group, tmp), n, backend="gloo",
                          store_path=Path(tmp) / "store", timeout_s=PROCS_TIMEOUT_S) as got:
                for arch in group:
                    stage(f"phase 12 {arch} on world dims")
                    t = time.perf_counter()
                    world[arch] = procs_serve_world(arch, Path(tmp))
                    world_s[arch] = time.perf_counter() - t
                torch.cuda.synchronize()
                torch.cuda.empty_cache()  # the ranks share the card with this process
                stage(f"phase 12 {n} ranks: {', '.join(group)}")
            ranks, spawned = got["ranks"], got["times"]
            spawn_s = spawned["spawn_s"]
            if kept is not None and n == NCCL_WORLD:
                for arch in group:
                    keep_refs(kept, Path(tmp), [f"ref.{arch}"], n)
                    kept["serve"][arch] = world[arch]
        res["spawns"].append({"archs": list(group), "ranks": n, **spawned})
        log(f"phase 12 spawn of {n} ranks ({', '.join(group)}): {json.dumps(spawned)}")
        for arch in group:
            mine = [r[arch] for r in ranks]
            st = procs_serve_check(arch, world[arch], mine, res)
            st.update({"world_s": world_s[arch], "spawn_s": spawn_s,
                       "wall_s": world_s[arch] + st["rank_s"]})
            res["archs"][arch] = st
            cap = mine[0]["capture"]
            if arch in PROCS_SERVE_FLASH:
                captured[arch] = cap["flash"] + (f"serve_{arch}",)
            if "combine" in cap:
                captured.setdefault("combine", cap["combine"] + (f"serve_{arch}",))
            log(f"process mesh serve {arch} on {PROCS_SERVE[arch][0]} ({n} gloo ranks on one "
                f"card, {' / '.join(st['transport'])}): {json.dumps(st)}")
        del ranks, world
    # the kernels at a rank's shapes (rank 0's first launch), timed alone:
    # qwen1.5's with phase 12's launches, the others' with their arch's
    for arch, what in PROCS_SERVE_FLASH.items():
        n_fa = (res["launches"]["flash_attention"] if arch == "qwen1.5-0.5b"
                else res["archs"][arch]["flash_launches"])
        rows.append(procs_flash_row(captured.pop(arch), n_fa, what))
    values, ids, nseg, spath = captured.pop("combine")
    rows.append(combine_row((values, ids, nseg), res["launches"]["segment_reduce"],
                            "procs_" + spath, "one rank's a2a combine"))
    for k2, v2 in res["launches"].items():
        launches[k2] += v2
    return res


def procs_train_dims(arch: str, what: str) -> tuple:
    """The mesh of phase 13's ``arch`` doing ``what`` (``PROCS_TRAIN_WORLDS``)."""
    restart = NCCL_RESTART if arch == NCCL_CASE else PROCS_TRAIN_RESTART
    return {"restart": restart, "8bit": PROCS_TRAIN_8BIT}.get(what, PROCS_TRAIN[arch][0])


def procs_train_build(arch: str, mesh, what: str = "train"):
    """(model, train step, pipeline) of phase 13's ``arch`` doing ``what``
    on ``mesh`` (world dims on the card, or this process's ``ProcessMesh``):
    full width at ``PROCS_TRAIN_LAYERS`` (and ``PROCS_TRAIN_ENC_LAYERS``),
    weights from ``SEED`` (a process keeps its device's shard), S3,
    ``PROCS_TRAIN_SEQ`` tokens a row, 8-bit moments for ``8bit``, through
    ``launch/train.py``'s ``build``."""
    from repro_torch.launch import steps, train
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW

    cfg = procs_train_cfg(arch)
    model = Model(cfg, device=mesh.device, seed=SEED, env=steps.make_env(cfg, mesh))
    step, pipe = train.build(model, mesh, procs_train_args(arch, procs_train_dims(arch, what)),
                             optimizer=AdamW(eightbit=True) if what == "8bit" else None)
    return model, step, pipe


def procs_train_cfg(arch: str):
    """Phase 13's config of ``arch``: full width at ``PROCS_TRAIN_LAYERS``
    (and ``PROCS_TRAIN_ENC_LAYERS``)."""
    import dataclasses

    from repro_torch.configs import get_config

    cut = {"n_layers": PROCS_TRAIN_LAYERS[arch]}
    if arch in PROCS_TRAIN_ENC_LAYERS:
        cut["enc_layers"] = PROCS_TRAIN_ENC_LAYERS[arch]
    return dataclasses.replace(get_config(case_arch(arch)), **cut)


def procs_train_args(arch: str, dims, *extra: str):
    """``launch/train.py``'s arguments of phase 13's ``arch`` on ``dims``,
    and ``extra``."""
    from repro_torch.launch import train

    return train.parser().parse_args([
        "--arch", case_arch(arch), "--scenario", "s3_in_net_map", "--mesh",
        ",".join(map(str, dims)),
        "--global-batch", str(PROCS_TRAIN[arch][1]), "--seq", str(PROCS_TRAIN_SEQ),
        "--seed", str(SEED), *extra])


def procs_train_steps(step, state, pipe, k0: int, n: int) -> tuple:
    """``n`` steps from step ``k0`` on world dims: (state, [{loss,
    grad_norm, lr, s}])."""
    import torch

    out = []
    for k in range(k0, k0 + n):
        t = time.perf_counter()
        state, m = step(state, pipe.batch_at(k))
        torch.cuda.synchronize()
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "lr": float(m["lr"]), "s": time.perf_counter() - t})
    return state, out


def procs_train_shards(step, tmp: Path, name: str, metrics: list, lrs: list,
                       state=None) -> None:
    """Each device's shard of the world-dim step's parameters, with the
    steps' metrics and the lr of every step since the seeded weights, to
    ``tmp/name.<rank>.pt`` for the rank that holds it; with 8-bit moments
    (``state``) also the device's row of each leaf's (codes, scales)
    (``TrainStep.shard_row``)."""
    import torch

    from repro_torch.models.parallel import shard_leaf

    env = step.env
    for r in range(env.fsdp_size * env.model_size):
        f, m = divmod(r, env.model_size)
        out = {"metrics": metrics, "lrs": lrs,
               "params": {k: shard_leaf(p.detach(), step.places[k], env, f, m).cpu()
                          for k, p in step.params.items()}}
        if state is not None:
            out["rows"] = {what: {path: tuple(t[step.shard_row(path, f, m)][None].cpu()
                                              for t in pair)
                                  for path, pair in getattr(state, what).items()}
                           for what in ("m", "v")}
        torch.save(out, tmp / f"{name}.{r}.pt")


def procs_train_world(tmp: Path, worlds: dict = PROCS_TRAIN_WORLDS) -> dict:
    """The references of the process worlds ``worlds`` (phase 13's, or
    phase 14's) on world dims on the card: every arch of theirs trained from
    the same weights on the same batches as the ranks
    (``procs_train_build``, ``PROCS_TRAIN``), each rank's expected shards
    written (``procs_train_shards``); one that a world restores carries on
    on its restart mesh (``procs_train_dims``) for one step, as the
    world-dim restart does (``launch/train.py``: the same model and
    optimizer state under the new mesh's step), and one that a world
    trains with 8-bit moments takes a step with them on
    ``PROCS_TRAIN_8BIT`` from the seeded weights. Returns each one's
    metrics and its peak GB."""
    import torch

    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh

    jobs = {job for js in worlds.values() for job in js}
    out = {}
    for arch, (dims, gb, n) in PROCS_TRAIN.items():
        whats = {what for a, what in jobs if a == arch}
        if not whats:
            continue
        out[arch] = {}
        if whats & {"train", "restart"}:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model, step, pipe = procs_train_build(arch, make_mesh(dims, device="cuda"))
            state, metrics = procs_train_steps(step, step.init_state(), pipe, 0, n)
            lrs = [m["lr"] for m in metrics]
            procs_train_shards(step, tmp, arch, metrics, lrs)
            out[arch].update(steps=metrics, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            if "restart" in whats:
                dims = procs_train_dims(arch, "restart")
                step, pipe = train.build(model, make_mesh(dims, device="cuda"),
                                         procs_train_args(arch, dims))
                state, metrics = procs_train_steps(step, state, pipe, n, 1)
                procs_train_shards(step, tmp, f"{arch}.restart", metrics,
                                   lrs + [m["lr"] for m in metrics])
                out[arch]["restart"] = metrics
            del model, step, state, pipe
        if "8bit" in whats:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model, step, pipe = procs_train_build(arch, make_mesh(PROCS_TRAIN_8BIT,
                                                                  device="cuda"), "8bit")
            state, metrics = procs_train_steps(step, step.init_state(), pipe, 0, 1)
            procs_train_shards(step, tmp, f"{arch}.8bit", metrics, [m["lr"] for m in metrics],
                               state)
            out[arch]["8bit"] = metrics
            out[arch]["8bit_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del model, step, state, pipe
    torch.cuda.empty_cache()
    return out


def procs_train_arch(arch: str, what: str, pm, tmp: Path, capture: dict, writes: list,
                     restarted=None) -> dict:
    """One arch of phase 13 in this rank: built from ``SEED`` (its device's
    shards kept), or for ``restart`` restored from the processes'
    checkpoint (``tmp/procs``), or, given ``restarted``
    (``launch/train.py``'s ``restart`` on ``pm``), as that built and
    restored it; its steps phase by phase between barriers,
    each with its launches, staged copies and collectives counted, the
    first one's ``ring_fused_step`` hops each held bitwise against the plain
    version (rank 0 keeps the first hop's and the first combine's inputs in
    ``capture``, and the largest hop's shape); qwen1.5's checkpoint gathered
    after its steps, rank 0's store appended to ``writes`` while it writes in
    the background; each step's metrics and this rank's shards against the
    world-dim run's (``tmp/<arch>[.<what>].<rank>.pt``). For ``8bit`` also
    the rank's 8-bit rows against the world-dim run's
    (``procs_eightbit_readings``), and its checkpoint written by rank 0 and
    restored in every rank into zeroed parameters and fresh moments."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    from repro_torch.mesh import count_collectives, count_staging

    t0 = time.perf_counter()
    dims = procs_train_dims(arch, what)
    n = PROCS_TRAIN[arch][2] if what == "train" else 1
    if restarted is None:
        model, step, pipe = procs_train_build(arch, pm, what)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    else:
        model, step, pipe = restarted.model, restarted.step, restarted.pipe
        build_s = restarted.times["rebuild_s"]
    rec = {"mesh": list(dims), "tp": step.env.tp, "ring_hops": step.ring_hops(), "steps": [],
           "build_s": build_s}
    k0 = 0
    store = CheckpointStore(str(tmp / "procs"))
    # the seeded weights (a restarted run's, restored in place, are drawn again below)
    p0 = None if restarted else {k: p.detach().clone() for k, p in step.params.items()}
    if restarted is not None:
        state, k0 = restarted.state, restarted.k
        rec["restore_s"] = restarted.times["restore_s"]
    elif what == "restart":
        t = time.perf_counter()
        state, k0 = train.restore(step, store)
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t
    else:
        state = step.init_state()
    if what == "restart":
        t = time.perf_counter()
        rec["restore_bitwise"] = procs_restored_bitwise(step, state, store, k0)
        rec["restore_check_s"] = time.perf_counter() - t
    want = torch.load(tmp / f"{arch}{'' if what == 'train' else '.' + what}.{pm.rank}.pt")
    rec["setup_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    real_rf, real_sr = ops.ring_fused_step, ops.segment_reduce
    hops = {"n": 0, "equal": True}

    def checked(acc, wire):
        out = real_rf(acc, wire)
        plain = ref.ring_fused_step(acc, wire)
        hops["n"] += 1
        hops["equal"] = hops["equal"] and all(equal(a, b) for a, b in zip(out, plain))
        if pm.rank == 0 and f"hop {arch}" not in capture:  # how the ring hands it
            capture[f"hop {arch}"] = (hop_layout(acc), f"procs_train_{arch}")
        if pm.rank == 0 and acc.numel() > capture.get("largest", (0,))[0]:
            capture["largest"] = (acc.numel(), hop_layout(acc), f"procs_train_{arch}")
        return out

    def combine(values, ids, nseg):
        if pm.rank == 0 and "combine" not in capture:
            capture["combine"] = (values.detach().clone(), ids.clone(), nseg,
                                  f"procs_train_{arch}")
        return real_sr(values, ids, nseg)

    for i, k in enumerate(range(k0, k0 + n)):
        batch = pipe.batch_at(k)
        torch.cuda.synchronize()
        dist.barrier(group=pm.group)
        started = time.perf_counter()
        ops.reset_launches()
        phases = {}
        fetch, real_fetch = {}, step.fetch

        def timed_fetch():
            t = time.perf_counter()
            out = real_fetch()
            torch.cuda.synchronize()
            fetch["s"] = time.perf_counter() - t
            return out

        with (count_staging() as staged, count_collectives() as coll,
              mock.patch.object(step, "fetch", timed_fetch),
              mock.patch.object(ops, "ring_fused_step", checked) if i == 0
              else contextlib.nullcontext(),
              mock.patch.object(ops, "segment_reduce", combine)):
            t = time.perf_counter()
            grads, nll, ntok = step.rank_gradients(batch)
            torch.cuda.synchronize()
            phases["rank_gradients"] = time.perf_counter() - t
            t = time.perf_counter()
            grads = step.aggregate(grads)
            torch.cuda.synchronize()
            phases["aggregate"] = time.perf_counter() - t
            t = time.perf_counter()
            state, gnorm = step.apply(state, grads)
            torch.cuda.synchronize()
            phases["apply"] = time.perf_counter() - t
        if i == 0:  # on this process's clock, as ``restarted.failed_at``
            rec["first_step_at"] = (started, time.perf_counter())
        del grads
        rec["steps"].append({
            "loss": float(nll) * step.norm, "grad_norm": float(gnorm),
            "lr": step.optimizer.schedule(state.count), "phases_s": phases,
            "fetch_s": fetch["s"],
            "wall_s": sum(phases.values()), "launches": dict(ops.LAUNCHES),
            "copies": ops.COPIES["ring_fused_step"], "staged": dict(staged),
            "collectives": dict(coll)})
    rec["hops_checked"], rec["hops_bitwise"] = hops["n"], hops["equal"]
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if case_arch(arch) == TRAIN_ARCH and what == "train":  # rank 0 writes; the world goes on
        t = time.perf_counter()
        tree = train.checkpoint_tree(step, state)
        rec["ckpt_gather_s"] = time.perf_counter() - t
        if tree is not None:
            store.save(k0 + n, tree, meta=train.checkpoint_meta(step, arch=arch), blocking=False)
            writes.append(store)
        del tree
    if what == "8bit":
        rec["moments"] = procs_eightbit_readings(step, state, want["rows"], pm)
        store8 = CheckpointStore(str(tmp / "procs8"))
        t = time.perf_counter()
        train.save(store8, k0 + n, step, state, blocking=True)  # rank 0 writes
        dist.barrier(group=pm.group)
        rec["ckpt8_save_s"] = time.perf_counter() - t
        kept = {k: p.detach().clone() for k, p in step.params.items()}
        with torch.no_grad():
            for p in step.params.values():
                p.zero_()
        t = time.perf_counter()
        got, at = train.restore(step, store8)
        rec["restore_s"] = time.perf_counter() - t
        rec["restore_bitwise"] = (
            at == k0 + n and got.count == state.count
            and all(equal(p, kept[k]) for k, p in step.params.items())
            and all(equal(a, b) for what_ in ("m", "v")
                    for path, pair in getattr(state, what_).items()
                    for a, b in zip(pair, getattr(got, what_)[path])))
        del kept, got
    # this rank's shards against the world-dim run's, and the update since the seeded weights
    if p0 is None:
        p0 = {k: p.detach().clone()
              for k, p in procs_train_build(arch, pm, what)[1].params.items()}
    lrs = want["lrs"]
    worst, num, den = 0.0, 0.0, 0.0
    for key, p in step.params.items():
        p, w = p.detach(), want["params"][key].to(p.device)
        worst = max(worst, float((p - w).abs().max()))
        d_got, d_want = p - p0[key], w - p0[key]
        num += float(((d_got - d_want).double() ** 2).sum())
        den += float((d_want.double() ** 2).sum())
    rec.update({"param_max_abs": worst, "param_atol": 2 * sum(lrs) * 1.01, "update_sq": num,
                "update_want_sq": den, "want": want["metrics"]})
    del model, step, state, pipe, want, p0
    torch.cuda.empty_cache()
    return rec


def procs_restored_bitwise(step, state, store, k: int) -> bool | None:
    """A restored process step's parameters and moments gathered back into
    whole leaves on rank 0 (``train.checkpoint_tree``, every rank calls it)
    against checkpoint ``k``'s leaves as the store reads them: bitwise on
    rank 0, None on the others."""
    from repro_torch.launch import train

    tree = train.checkpoint_tree(step, state)
    if tree is None:
        return None
    flat, _ = store.restore(step=k, device="cpu")
    count, m, v = tree["opt"]
    got = {**{f"params/{p}": t for p, t in tree["params"].items()},
           **{f"opt/1/{p}": t for p, t in m.items()}, **{f"opt/2/{p}": t for p, t in v.items()}}
    return (int(flat["opt/0"]) == int(count) and set(got) == set(flat) - {"opt/0"}
            and all(equal(t.cpu(), flat[p]) for p, t in got.items()))


def procs_eightbit_readings(step, state, want: dict, pm) -> dict:
    """This rank's 8-bit moments against the world-dim step's row of its
    device (``want``: {"m" | "v": {path: (codes, scales)}}), dequantized:
    {path: {"m" | "v": (Σ (got − want)², Σ want²)}} over the leaves whose
    row this rank is the first device to hold, so that the ranks' sums
    count each row once; and whether every row's shape is the world-dim
    one."""
    from repro_torch.optim.adamw import dequantize_block8

    env = step.env
    numel = {path: t.numel() for path, t in step.opt_tree(step.params).items()}
    out = {"shapes_equal": True, "leaves": {}}
    for path, n in numel.items():
        row = step.shard_row(path, env.fsdp_index, env.model_index)
        first = next(r for r in range(pm.size)
                     if step.shard_row(path, *divmod(r, env.model_size)) == row)
        sums = {}
        for what in ("m", "v"):
            got = getattr(state, what)[path]
            ref = tuple(t.to(got[0].device) for t in want[what][path])
            out["shapes_equal"] &= all(a.shape == b.shape for a, b in zip(got, ref))
            a, b = dequantize_block8(*got, n), dequantize_block8(*ref, n)
            sums[what] = (float(((a - b).double() ** 2).sum()), float((b.double() ** 2).sum()))
        if first == pm.rank:
            out["leaves"][path] = sums
    return out


def procs_train_rank(tmp: str, jobs: tuple, device, meshes: dict | None = None) -> dict:
    """Phase 13 (or 14) in one rank of a world whose ``jobs`` are (arch,
    what) pairs (``PROCS_TRAIN_WORLDS``, ``launch.procs.spawn``): each of
    its archs (``procs_train_arch``) on its process mesh (``meshes``'s of
    its shape). Returns their records and rank 0's captured kernel inputs."""
    import torch

    torch.set_num_threads(1)  # the ranks share the host's cores
    res, capture, writes = {"archs": {}}, {}, []
    meshes = {} if meshes is None else meshes
    for arch, what in jobs:
        pm = process_mesh(procs_train_dims(arch, what), device, meshes)
        res["archs"][f"{arch}/{what}"] = procs_train_arch(arch, what, pm, Path(tmp), capture,
                                                          writes)
    t = time.perf_counter()
    for store in writes:  # the world ends once the checkpoint is on disk
        store.wait()
        res["ckpt"] = {**store.stats[-1], "wait_s": time.perf_counter() - t}
    torch.distributed.barrier()
    res["transport"] = pm.transport
    res["capture"] = {k: tuple(t.cpu() if hasattr(t, "cpu") else t for t in v)
                      for k, v in capture.items()}
    return res


def procs_train_phase(launches: dict, rows: list, kept: dict | None = None) -> dict:
    """Phase 13: the two worlds of gloo ranks spawned on the card
    (``procs_train_rank``), each starting while the world-dim references of
    its archs are made (``procs_train_world``, ``spawning``), held to them.
    Adds the ranks' launches to ``launches`` and the kernel rows at a rank's
    shapes to ``rows`` (the first S3 hop, the largest one, the first
    combine); returns the readings. With ``kept`` (``keep_refs``)
    the references of the jobs trained on ``NCCL_WORLD`` ranks (but a
    restart) stay for phase 14."""
    import tempfile

    import torch

    from repro_torch.kernels import ops

    res = {"worlds": {}, "launches": dict.fromkeys(ops.LAUNCHES, 0)}
    captured = {}
    with tempfile.TemporaryDirectory() as tmp:
        world, res["world_s"] = {}, 0.0
        for name, jobs in PROCS_TRAIN_WORLDS.items():
            dims = {procs_train_dims(arch, what) for arch, what in jobs}
            n = {d[0] * d[1] for d in dims}
            if len(n) != 1:
                raise AssertionError(f"phase 13's {name} world mixes mesh sizes {sorted(dims)}")
            # the ranks start while the references of this world's archs are made, each
            # arch's every job at once (a restart carries on from its training)
            new = {a for a, _ in jobs} - set(world)
            with spawning(functools.partial(procs_train_rank, tmp, jobs), n.pop(),
                          backend="gloo", store_path=Path(tmp) / f"store_{name}",
                          timeout_s=PROCS_TIMEOUT_S) as got:
                stage(f"phase 13 {name} world's references")
                t = time.perf_counter()
                world.update(procs_train_world(Path(tmp), {
                    w: tuple(j for j in js if j[0] in new)
                    for w, js in PROCS_TRAIN_WORLDS.items()}))
                res["world_s"] += time.perf_counter() - t
                torch.cuda.synchronize()
                torch.cuda.empty_cache()  # the ranks share the card with this process
                stage(f"phase 13 {name} world")
            ranks, spawned = got["ranks"], got["times"]
            st = {**spawned, "ranks": len(ranks),
                  "transport": ranks[0]["transport"], "archs": {}}
            if kept is not None and len(ranks) == NCCL_WORLD:
                for arch, what in jobs:
                    if what != "restart":
                        keep_refs(kept, Path(tmp), [arch if what == "train" else f"{arch}.{what}"],
                                  len(ranks))
                        kept["train"][arch] = world[arch]
            for key in ranks[0]["archs"]:
                arch, what = key.split("/")
                recs = [r["archs"][key] for r in ranks]
                want = world[arch]["steps" if what == "train" else what]
                st["archs"][key] = procs_train_check(arch, what, recs, want, res["launches"])
                st["archs"][key]["world_peak_gb"] = world[arch].get(f"{what}_peak_gb",
                                                                    world[arch]["peak_gb"])
            if "ckpt" in ranks[0]:
                st["ckpt_rank0"] = ranks[0]["ckpt"]
            for k, v in ranks[0]["capture"].items():
                captured[k] = max(captured.get(k, v), v) if k == "largest" else \
                    captured.get(k, v)
            res["worlds"][name] = st
            log(f"process mesh train, {name} world ({st['ranks']} gloo ranks on one card, "
                f"{st['transport']}): {json.dumps(st)}")
            del ranks
    res["world_refs"] = world
    # the kernels at a rank's shapes (rank 0's first S3 hop and first combine), timed alone;
    # each hop laid out as the ring handed it, on seeded values
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    layout, hpath = captured.pop(f"hop {PROCS_TRAIN_WORLDS['first'][0][0]}")
    acc, wire = seeded_hop(layout, gen)
    rows.append(ring_row(acc, wire, hpath,
                         f"acc {tuple(acc.shape)} fp32 + wire bf16: one rank's first S3 hop of "
                         "its fetch's backward, acc as the ring hands it",
                         res["launches"]["ring_fused_step"]))
    del acc, wire
    _, layout, lpath = captured.pop("largest")
    acc, wire = seeded_hop(layout, gen)
    rows.append(ring_row(acc, wire, lpath,
                         f"acc {tuple(acc.shape)} fp32 + wire bf16: the phase's largest rank "
                         "hop, acc as the ring hands it",
                         res["launches"]["ring_fused_step"]))
    del acc, wire
    values, ids, nseg, spath = captured.pop("combine")
    rows.append(combine_row((values, ids, nseg), res["launches"]["segment_reduce"], spath,
                            "one rank's a2a combine in training"))
    for k, v in res["launches"].items():
        launches[k] += v
    return res


def procs_train_check(arch: str, what: str, recs: list, want: list, launches: dict) -> dict:
    """One arch of a phase 13 world, its ranks' records (``procs_train_arch``)
    against the world-dim run's steps ``want`` (and no hop's input copied
    before ``ring_fused_step``'s kernel): raises where a check fails;
    returns the readings and adds the ranks' launches to ``launches``."""
    r0 = recs[0]
    out = {"mesh": r0["mesh"], "tp": r0["tp"], "ring_hops": r0["ring_hops"], "steps": []}
    for i, w in enumerate(want):
        got = [r["steps"][i] for r in recs]
        if any((g["loss"], g["grad_norm"]) != (got[0]["loss"], got[0]["grad_norm"])
               for g in got):
            raise AssertionError(f"procs_train {arch} ({what}): the ranks' metrics differ")
        diff = {n: abs(got[0][n] - w[n]) / abs(w[n]) for n in PROCS_TRAIN_TOL}
        wall = max(g["wall_s"] for g in got)
        step = {"loss": got[0]["loss"], "world_loss": w["loss"], "grad_norm": got[0]["grad_norm"],
                "world_grad_norm": w["grad_norm"], "rel_diff": diff, "wall_s": wall,
                "world_s": w["s"],
                "phases_s": {p: max(g["phases_s"][p] for g in got) for p in TRAIN_PHASES},
                "fetch_s": max(g["fetch_s"] for g in got),
                "staged_gb": sum(g["staged"]["bytes"] for g in got) / 1e9,
                "staged_copies_rank0": got[0]["staged"]["copies"],
                "staging_share": max(g["staged"]["seconds"] / g["wall_s"] for g in got),
                "collectives_rank0_gb": {k: v / 1e9 for k, v in got[0]["collectives"].items() if v},
                "launches_rank0": {k: v for k, v in got[0]["launches"].items() if v}}
        out["steps"].append(step)
        if any(diff[n] > PROCS_TRAIN_TOL[n] for n in PROCS_TRAIN_TOL):
            raise AssertionError(f"procs_train {arch} ({what}) step {i}: {step} (limits "
                                 f"{PROCS_TRAIN_TOL})")
        for r in recs:
            lr = r["steps"][i]["launches"]
            want_hops = r["ring_hops"]
            if lr["ring_fused_step"] != want_hops or lr["flash_attention"] or lr["hash_partition"]:
                raise AssertionError(f"procs_train {arch} ({what}): a rank made {lr} launches, "
                                     f"not its {want_hops} ring hops")
            if r["steps"][i]["copies"]:
                raise AssertionError(f"procs_train {arch} ({what}): a rank's ring_fused_step "
                                     f"copied {r['steps'][i]['copies']} hop inputs")
            if (lr["segment_reduce"] > 0) != (case_arch(arch) == "granite-moe-1b-a400m"):
                raise AssertionError(f"procs_train {arch} ({what}): {lr['segment_reduce']} "
                                     "segment_reduce launches")
            for k, v in lr.items():
                launches[k] += v
    if any(r["hops_checked"] != r["ring_hops"] or not r["hops_bitwise"] for r in recs):
        raise AssertionError(f"procs_train {arch} ({what}): ring hops checked "
                             f"{[r['hops_checked'] for r in recs]} of {r0['ring_hops']}, bitwise "
                             f"{[r['hops_bitwise'] for r in recs]}")
    update = (sum(r["update_sq"] for r in recs) / sum(r["update_want_sq"] for r in recs)) ** 0.5
    worst = max(r["param_max_abs"] for r in recs)
    out.update({"param_max_abs": worst, "param_atol": r0["param_atol"], "update_rel": update,
                "peak_gb_per_rank": max(r["peak_gb"] for r in recs),
                "setup_s": max(r["setup_s"] for r in recs)})
    for key in ("build_s", "restore_s", "restore_check_s", "ckpt_gather_s", "ckpt8_save_s"):
        if key in r0:
            out[key] = max(r[key] for r in recs)
    if "restore_bitwise" in r0:  # rank 0 gathered the restored shards back
        out["restore_bitwise"] = r0["restore_bitwise"]
        if r0["restore_bitwise"] is not True:
            raise AssertionError(f"procs_train {arch} ({what}): the restored parameters and "
                                 "moments, gathered back, are not the checkpoint's bitwise")
    if what == "8bit":
        out["moments"] = procs_eightbit_check(arch, recs)
    if worst > r0["param_atol"] or update > PROCS_UPDATE_TOL:
        raise AssertionError(f"procs_train {arch} ({what}): parameters {worst} from the "
                             f"world-dim run's (limit {r0['param_atol']}), update {update} "
                             f"(limit {PROCS_UPDATE_TOL})")
    return out


def procs_eightbit_check(arch: str, recs: list) -> dict:
    """The ranks' 8-bit rows against the world-dim run's
    (``procs_eightbit_readings``' sums, each row once): every leaf within
    ``PROCS_EIGHTBIT_TOL`` but ``PROCS_NOISE_LEAVES``, the tree within
    ``PROCS_MOMENT_TOL``, relative; the rows' shapes the world-dim ones and
    the checkpoint's restore bitwise in every rank. Raises where one fails;
    returns the readings."""
    sums = {}
    for r in recs:
        for path, by in r["moments"]["leaves"].items():
            for what, (num, den) in by.items():
                acc = sums.setdefault(what, {}).setdefault(path, [0.0, 0.0])
                acc[0] += num
                acc[1] += den
    out = {}
    for what, leaves in sums.items():
        rel = {p: (num / den) ** 0.5 if den else float(num > 0) for p, (num, den) in leaves.items()}
        checked = {p: v for p, v in rel.items()
                   if not any(p.endswith(n) for n in PROCS_NOISE_LEAVES)}
        worst = max(checked.items(), key=lambda kv: kv[1])
        tree = (sum(n for n, _ in leaves.values()) / sum(d for _, d in leaves.values())) ** 0.5
        out[what] = {"worst_leaf": worst, "tree": tree, "leaves": len(rel),
                     "noise_leaves": {p: v for p, v in rel.items() if p not in checked}}
        if worst[1] > PROCS_EIGHTBIT_TOL or tree > PROCS_MOMENT_TOL:
            raise AssertionError(f"procs_train {arch} (8bit): moments {what} {out[what]} (limits "
                                 f"{PROCS_EIGHTBIT_TOL} a leaf, {PROCS_MOMENT_TOL} the tree)")
    if not all(r["moments"]["shapes_equal"] and r["restore_bitwise"] for r in recs):
        raise AssertionError(f"procs_train {arch} (8bit): rows shaped as the world-dim ones "
                             f"{[r['moments']['shapes_equal'] for r in recs]}, the restore bitwise "
                             f"{[r['restore_bitwise'] for r in recs]}")
    out["restore_bitwise"] = True
    return out


def calls_counted(calls: dict):
    """A patch of ``mesh.note_collective`` that also counts the collectives
    by kind into ``calls`` (``count_collectives`` counts their bytes)."""
    from repro_torch import mesh

    real = mesh.note_collective

    def note(kind, nbytes):
        calls[kind] = calls.get(kind, 0) + 1
        real(kind, nbytes)

    return mock.patch.object(mesh, "note_collective", note)


def sq_sums(got, want) -> tuple[float, float]:
    """(Σ (got − want)², Σ want²) in float64 over the entries where ``want``
    is finite (a padded vocab's -inf left out): one rank's part of a
    normwise relative difference whose whole spans the ranks."""
    import torch

    ok = torch.isfinite(want)
    d = torch.where(ok, got.double() - want.double(), 0.0)
    return float((d * d).sum()), float(torch.where(ok, want.double() ** 2, 0.0).sum())


def nccl_phi3_rank(device, meshes: dict | None = None) -> dict:
    """phi3-medium-14b (``NCCL_PHI3``) in one rank of phase 14's nccl world:
    made from ``SEED`` under its process mesh's env (each leaf cut as it is
    drawn; the setup's peak read), the seeded prompts' rows of its block,
    then its routes on the ranks (it has no world-dim reference): the flash
    and the masked prefill into fresh caches, this rank's ``sq_sums`` of
    the prefill's logits (its rows, its vocab shard) and of each layer's
    cache leaves, and the same of the flash prefill under ``rounding_noise``
    against the plain flash prefill (the model's sensitivity) and of a
    flash prefill without its causal mask against the masked one (the
    control); each flash layer against the masked attention on its own
    input (``layer_readings``); one decode step from the flash prefill's
    cache on the gather and the compute-at-data route and the gather one
    under ``rounding_noise`` (each from a copy: decode writes in place),
    the ``sq_sums`` of their logits against the gather step's;
    ``cache_consistency``; then
    per route one served call (``serve.generate``: flash prefill, ``gen``
    tokens) with its launches, staged copies and collectives counted and
    its tokens (rank 0 keeps a copy of its first ``flash_attention``
    inputs)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps
    from repro_torch.mesh import count_collectives, count_staging
    from repro_torch.models.model import Model

    arch = NCCL_PHI3
    dims, gb, s, gen = PROCS_SERVE[arch]
    cfg = procs_serve_config(arch)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pm = process_mesh(dims, device, meshes)
    env = steps.make_env(cfg, pm)
    model = Model(cfg, device=device, seed=SEED, env=env)
    batch = procs_serve_batch(model, steps.held_rows(env.world(), gb), arch)
    rows = steps.map_batch(batch, lambda v: steps.rank_rows(env, v, gb))
    del batch
    torch.cuda.synchronize()
    res = {"setup_s": time.perf_counter() - t0,
           "setup_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "held_gb": torch.cuda.memory_allocated() / 1e9,
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "transport": pm.transport, "coords": tuple(pm.coords), "routes": {}, "capture": {}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = steps.batch_shape(rows)[0]
    dm = steps.map_batch(rows, lambda v: steps.device_major(env, v, gb))
    real_fa = ops.flash_attention

    def prefill(impl: str, ctx=contextlib.nullcontext):
        logs = []
        pstep = steps.make_prefill_step(model, global_batch=gb, seq=s, impl=impl, mesh=pm)
        with recording_logits(logs), ctx():
            cache, tok = pstep(dm, model.init_cache(b, s + 1))
        return cache, logs[0], tok

    def readings(got, want):
        (cg, lg, _), (cw, lw, _) = got, want
        return {"logits": sq_sums(lg, lw),
                "layers": [{k: sq_sums(g[k], w[k]) for k in w}
                           for g, w in zip(layer_caches(model, cg), layer_caches(model, cw))]}

    # the flash prefill against the masked one, the model's response to
    # one-ulp noise, and a kernel without its causal mask (the control)
    flash, masked = prefill("flash"), prefill("masked")
    res["prefill"] = readings(flash, masked)
    res["prefill_noise"] = readings(prefill("flash", rounding_noise), flash)
    res["prefill_control"] = readings(prefill("flash", lambda: mock.patch.object(
        ops, "flash_attention", lambda q, k, v, causal=True: real_fa(q, k, v, causal=False))),
        masked)
    del masked
    res["by_layer"] = layer_readings(model, rows)
    # one decode step from the flash prefill's cache on each route
    cf, _, tok = flash
    del flash
    dec = {}
    for route in ("gather", "noise", "cad"):
        logs = []
        sstep = steps.make_serve_step(model, global_batch=gb, seq_max=s + 1, mesh=pm,
                                      compute_at_data=route == "cad")
        c = cf if route == "cad" else tree_clone(cf)
        # rounding_noise patches as it is made: make it where it is entered
        with (recording_logits(logs),
              rounding_noise() if route == "noise" else contextlib.nullcontext()):
            sstep(c, tok, s)
        dec[route] = logs[0]
        del c
    res["decode"] = {"cad_vs_gather": sq_sums(dec["cad"], dec["gather"]),
                     "noise_vs_gather": sq_sums(dec["noise"], dec["gather"])}
    del cf, dec
    res["consistency"] = cache_consistency(model, rows, "flash")

    def fa(q, k, v, causal=True):
        if "flash" not in res["capture"]:
            res["capture"]["flash"] = tuple(t.clone() for t in (q, k, v)) + (causal,)
        return real_fa(q, k, v, causal=causal)

    for route in ("gather", "cad"):
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        with (count_staging() as staged, count_collectives() as coll,
              mock.patch.object(ops, "flash_attention", fa) if pm.rank == 0 and route == "gather"
              else contextlib.nullcontext()):
            out = serve.generate(model, rows, gen, impl="flash", mesh=pm, global_batch=gb,
                                 compute_at_data=route == "cad")
        torch.cuda.synchronize()
        toks = out["tokens"]
        res["routes"][route] = {
            "launches": dict(ops.LAUNCHES), "prefill_s": out["prefill_s"],
            "decode_s": out["decode_s"], "staged": dict(staged), "collectives": dict(coll),
            "tokens": toks.cpu(),
            "in_vocab": bool(((toks >= 0) & (toks < cfg.vocab)).all())}
        del out
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["capture"] = {k: tuple(t.cpu() if hasattr(t, "cpu") else t for t in v)
                      for k, v in res["capture"].items()}
    res["arch_s"] = time.perf_counter() - t0
    del model, rows, dm, tok
    torch.cuda.empty_cache()
    return res


def nccl_phi3_check(recs: list, res: dict) -> dict:
    """phi3's ranks (``nccl_phi3_rank``) held by its own routes (the
    constants' comment says why each limit): the flash prefill's logits and
    its worst layer's cache against the masked prefill's (normwise over the
    ranks) within the larger of ``SERVE_TOL`` scaled by ``PHI3_DEPTH`` and
    ``SENSITIVITY_FACTOR`` x the model's response to one-ulp noise, the
    caches' limit one that the non-causal control must exceed (as phase 5's
    control); every flash layer within
    ``ATTN_TOL`` of the masked attention on its own input; the
    compute-at-data decode step's logits against the gather step's within
    the larger of ``CAD_TOL`` scaled so and ``SENSITIVITY_FACTOR`` x the
    decode's response to that noise; ``cache_consistency`` within
    ``CONSIST_TOL`` on every rank (its empty-cache control beyond it); every
    rank's launches ``PROCS_SERVE_LAUNCHES``'s, tokens in the vocab.
    Adds the ranks' launches to ``res``; returns the readings, with a rank's
    peak beside the whole model's reckoned bytes."""
    import torch

    from repro_torch.models.model import Model

    def rel(parts):
        num, den = map(sum, zip(*parts))
        return (num / den) ** 0.5

    def layers(key):  # each layer's worst leaf, normwise over the ranks
        n = len(recs[0][key]["layers"])
        return [max(rel([r[key]["layers"][i][k] for r in recs]) for k in recs[0][key]["layers"][i])
                for i in range(n)]

    dims, gb, s, gen = PROCS_SERVE[NCCL_PHI3]
    cfg = procs_serve_config(NCCL_PHI3)
    kv = {key: layers(key) for key in ("prefill", "prefill_noise", "prefill_control")}
    lg = {key: rel([r[key]["logits"] for r in recs])
          for key in ("prefill", "prefill_noise", "prefill_control")}
    dec = {key: rel([r["decode"][key] for r in recs]) for key in ("cad_vs_gather", "noise_vs_gather")}
    whole = Model(cfg, device="meta", seed=SEED)
    whole_bytes = sum(p.numel() * p.element_size() for p in whole.parameters())
    st = {"ranks": len(recs), "layers": cfg.n_layers,
          "transport": sorted({r["transport"] for r in recs}),
          "prefill_logits_rel": lg["prefill"], "prefill_kv_worst": max(kv["prefill"]),
          "prefill_kv_worst_layer": kv["prefill"].index(max(kv["prefill"])),
          "prefill_kv_layer0": kv["prefill"][0],
          "sensitivity_logits": lg["prefill_noise"], "sensitivity_kv": max(kv["prefill_noise"]),
          "control_logits": lg["prefill_control"], "control_kv": max(kv["prefill_control"]),
          "prefill_logits_tol": max(SERVE_TOL * PHI3_DEPTH,
                                    SENSITIVITY_FACTOR * lg["prefill_noise"]),
          "prefill_kv_tol": max(SERVE_TOL * PHI3_DEPTH,
                                SENSITIVITY_FACTOR * max(kv["prefill_noise"])),
          "attention_by_layer_worst": max(r["by_layer"]["attention_worst"] for r in recs),
          "attention_layers": min(r["by_layer"]["attention_layers"] for r in recs),
          "cad_vs_gather_logits": dec["cad_vs_gather"],
          "decode_sensitivity": dec["noise_vs_gather"],
          "cad_tol": max(CAD_TOL * PHI3_DEPTH, SENSITIVITY_FACTOR * dec["noise_vs_gather"]),
          "consistency_worst": max(r["consistency"]["decode_vs_prefill"] for r in recs),
          "consistency_control_least": min(r["consistency"]["control"] for r in recs),
          "finite": all(r["consistency"]["finite"] for r in recs),
          "setup_s": max(r["setup_s"] for r in recs), "rank_s": max(r["arch_s"] for r in recs),
          "setup_peak_gb_per_rank": max(r["setup_peak_gb"] for r in recs),
          "held_gb_per_rank": max(r["held_gb"] for r in recs),
          "param_gb_per_rank": max(r["param_bytes"] for r in recs) / 1e9,
          "peak_gb_per_rank": max(r["peak_gb"] for r in recs),
          "whole_param_gb": whole_bytes / 1e9,
          "whole_with_bf16_gb": whole_bytes * 1.5 / 1e9, "routes": {}, "flash_launches": 0}
    del whole
    want_fa, want_sr = PROCS_SERVE_LAUNCHES[NCCL_PHI3]
    for route in ("gather", "cad"):
        rr = [r["routes"][route] for r in recs]
        for i, x in enumerate(rr):
            got = x["launches"]
            if (got["flash_attention"], got["segment_reduce"]) != (want_fa, want_sr) or (
                    got["hash_partition"] or got["ring_fused_step"]):
                raise AssertionError(f"nccl {NCCL_PHI3} ({route}): rank {i} made {got} launches")
            for k, v in got.items():
                res["launches"][k] += v
            st["flash_launches"] += got["flash_attention"]
        toks = torch.stack([x["tokens"] for x in rr])
        st["routes"][route] = {
            "prefill_s": max(x["prefill_s"] for x in rr),
            "decode_ms_per_step": max(x["decode_s"] for x in rr) / max(1, gen - 1) * 1e3,
            "tokens_shape": list(toks.shape), "in_vocab": all(x["in_vocab"] for x in rr),
            "staged_bytes": sum(x["staged"]["bytes"] for x in rr),
            "collectives_rank0": rr[0]["collectives"],
            "launches_per_rank": {k: v for k, v in rr[0]["launches"].items() if v}}
    st["staged_bytes"] = sum(r["staged_bytes"] for r in st["routes"].values())
    bad = (st["prefill_logits_rel"] > st["prefill_logits_tol"]
           or st["prefill_kv_worst"] > st["prefill_kv_tol"]
           or st["control_kv"] <= st["prefill_kv_tol"]
           or st["attention_by_layer_worst"] > ATTN_TOL or st["attention_layers"] != cfg.n_layers
           or st["cad_vs_gather_logits"] > st["cad_tol"]
           or st["consistency_worst"] > CONSIST_TOL
           or st["consistency_control_least"] <= CONSIST_TOL or not st["finite"]
           or not all(r["in_vocab"] for r in st["routes"].values()))
    if bad:
        raise AssertionError(f"nccl {NCCL_PHI3}: its routes disagree: {st}")
    return st


def nccl_first(device, group=None) -> dict:
    """The world's first collective, before any other (on ``group``, a
    gloo group of the world's ranks: its first after the one that formed
    it): ``NCCL_FIRST``'s partial permutation, which leaves some ranks out,
    against the world-dim ``Mesh`` on the CPU; then the reverse
    permutation."""
    import numpy as np

    from repro_torch.mesh import Mesh, ProcessMesh

    pm = ProcessMesh(("all",), (NCCL_WORLD,), device=device, group=group)
    w = Mesh(("all",), (NCCL_WORLD,), device="cpu")
    data = np.arange(NCCL_WORLD * 6, dtype=np.float32).reshape(NCCL_WORLD, 2, 3) + 1
    out = {}
    for name, perm in (("first", NCCL_FIRST), ("reverse", [(d, s) for s, d in NCCL_FIRST])):
        t = time.perf_counter()
        got = pm.ppermute(pm.shard(data), "all", perm).cpu().numpy()
        want = w.ppermute(w.shard(data), "all", perm).numpy()[pm.rank:pm.rank + 1]
        out[name] = {"equal": bool(np.array_equal(got, want)), "s": time.perf_counter() - t}
    return out


def nccl_collectives(m, iters: int) -> dict:
    """The collectives alone on process mesh ``m`` ("all"), each over
    ``NCCL_COLL_BYTES`` of fp32 a rank (``NCCL_BUS``'s buffers): once to
    warm up, then ``iters`` calls between barriers; this rank's ms a call,
    its staged bytes, and whether the values are right."""
    import torch
    import torch.distributed as dist

    from repro_torch.mesh import count_staging

    n = m.axis_size("all")
    e = NCCL_COLL_BYTES // 4
    x = torch.ones((1, e), device=m.device)
    part = torch.ones((1, e // n), device=m.device)
    calls = {
        "all_reduce": (lambda: m.psum(x, "all"), n),
        "all_gather": (lambda: m.all_gather(part, "all", tiled=True), 1),
        "reduce_scatter": (lambda: m.psum_scatter(x, "all", 0, tiled=True), n),
        "all_to_all": (lambda: m.all_to_all(x, "all", 0, 0, tiled=True), 1),
        "ppermute": (lambda: m.ppermute(x, "all", [(i, (i + 1) % n) for i in range(n)]), 1),
    }
    out = {}
    for name, (fn, value) in calls.items():
        y = fn()
        right = bool((y == value).all()) and y.numel() * 4 in (NCCL_COLL_BYTES, NCCL_COLL_BYTES // n)
        del y
        torch.cuda.synchronize()
        dist.barrier(group=m.group)
        with count_staging() as staged:
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / iters * 1e3
        dist.barrier(group=m.group)
        out[name] = {"ms": ms, "staged_bytes": staged["bytes"], "right": right}
    del x, part
    torch.cuda.empty_cache()
    return out


def nccl_kernel_checks(capture: dict, words, n: int) -> list:
    """This rank's kernels on its own card against their plain versions:
    its first S3 hop of the timed data plane (``procs_timed``'s capture)
    bitwise, then ``data_plane_rows`` at the rank's shapes (its words, the
    token path's received words, a hop laid out as that first hop), which
    checks and times each. Returns the rows."""
    from repro_torch.kernels import ref

    import torch

    acc, wire, layout = capture[("aggregate_s3_in_net_map", "ring_fused_step")]
    rf = bare_launchers()[2]
    if not all(equal(a, b) for a, b in zip(rf(acc, wire), ref.ring_fused_step(acc, wire))):
        raise AssertionError(f"ring_fused_step differs from its plain version at a rank's hop "
                             f"{tuple(acc.shape)} on {acc.device}")
    recv = capture[("wordcount_token", "segment_reduce")][1]
    gen = torch.Generator(device=acc.device).manual_seed(SEED)
    return data_plane_rows(words.reshape(1, -1), recv.reshape(1, -1),
                           seeded_hop(layout, gen, acc.device), "nccl_", buckets=n)


def nccl_gloo_group(device):
    """A gloo group over the nccl world's ``NCCL_WORLD`` ranks, made by them
    (``mesh.local_group``): 14a's comparison runs staged on process meshes
    over it, in the nccl world's own processes."""
    from repro_torch.mesh import local_group

    return local_group(range(NCCL_WORLD), device, backend="gloo")


def nccl_dataplane(device, saved: str, group=None) -> dict:
    """14a in one rank, on process meshes over ``group`` (None: the nccl
    world's own; else a gloo group of its ranks, ``nccl_gloo_group``,
    staged through pinned host memory): ``nccl_first``, phase 11's data
    plane at W = ``NCCL_WORLD`` (``procs_inputs`` from the files under
    ``saved``, ``procs_timed`` with each call's collectives counted), the
    collectives alone
    (``nccl_collectives``), the kernels on this rank's card
    (``nccl_kernel_checks``). Returns the readings, its seconds under
    ``s``."""
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    res = {"first": nccl_first(device, group), "device": str(device)}
    t = time.perf_counter()
    meshes = procs_meshes(NCCL_WORLD, device, group=group)
    words, grads, grads24, plan = procs_inputs(meshes, saved=saved)
    res.update(transport=meshes["all"].transport, setup_s=time.perf_counter() - t)
    torch.cuda.reset_peak_memory_stats()
    capture, calls = {}, {}
    with calls_counted(calls):
        res["paths"] = procs_timed(meshes, procs_paths(meshes, words, grads, grads24, plan),
                                   grads, capture)
    res["calls"] = calls  # the warm-up calls' and the timed calls' together
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["collectives"] = nccl_collectives(meshes["all"],
                                          NCCL_COLL_ITERS[dist.get_backend(group)])
    t = time.perf_counter()
    res["rows"] = nccl_kernel_checks(capture, words, NCCL_WORLD)
    res["kernel_check_s"] = time.perf_counter() - t
    for m in meshes.values():
        m.close()
    del words, grads, grads24, capture, meshes
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t0
    return res


def nccl_rank(tmp: str, saved: str, device) -> dict:
    """Phase 14 in one rank of the nccl world (``launch.procs.spawn``): 14a
    (``nccl_dataplane``) on the world's own group, ``nccl_first`` before any
    other collective, then the same staged on a gloo group of the same
    ranks (``nccl_gloo_group``, under ``gloo``); every case of
    ``NCCL_SERVE`` served (``procs_serve_rank``), phi3 served
    (``nccl_phi3_rank``) and the jobs of ``NCCL_TRAIN_WORLDS["first"]``
    trained (``procs_train_rank``), each on the process mesh of its shape
    (shared: its groups made once), each served case and the training with
    the collectives it called, held to their world-dim files under
    ``tmp``; and the restart inside the world (``nccl_restart_rank``)."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(4)  # the ranks share the host's cores
    t0 = time.perf_counter()
    res = nccl_dataplane(device, saved)
    pg = nccl_gloo_group(device)
    res["gloo"] = nccl_dataplane(device, saved, pg)
    dist.destroy_process_group(pg)
    meshes, res["serve"] = {}, {}
    for case in NCCL_SERVE:
        calls = {}
        with calls_counted(calls):
            res["serve"][case] = procs_serve_rank(case, tmp, device, meshes)
        res["serve"][case]["calls"] = calls
    calls = {}
    with calls_counted(calls):
        res["train"] = procs_train_rank(tmp, NCCL_TRAIN_WORLDS["first"], device, meshes)
    res["train"]["calls"] = calls
    calls = {}
    with calls_counted(calls):
        res["phi3"] = nccl_phi3_rank(device, meshes)
    res["phi3"]["calls"] = calls
    calls = {}
    with calls_counted(calls):
        res["restart"] = nccl_restart_rank(tmp, device, meshes)
    res["restart"]["calls"] = calls
    res["rank_s"] = time.perf_counter() - t0  # the spawn's wall less this: start and teardown
    return res


def nccl_restart_rank(tmp: str, device, meshes: dict) -> dict:
    """Phase 14's elastic restart inside the world, at its end, through
    ``launch/train.py``'s own (``train.restart``, the ``--fail-step`` branch
    of ``train.run``): on the (2, 2) world mesh, with qwen1.5's checkpoint
    on disk since its training, a barrier of the world (the failure), then
    ranks 0-1 go on on ``NCCL_RESTART`` over a group of their own, made by
    them alone, draw qwen1.5 on it, build the step and restore the
    checkpoint; ranks 2-3 leave. The survivors take a step
    (``procs_train_arch`` given the restarted run: the restore held
    bitwise, the step to the world-dim run's, each S3 hop to
    ``ring_fused_step``'s plain version), then release their groups; no
    call of theirs reaches the default group after the shrink. Returns on a
    survivor its record under ``archs`` as ``procs_train_rank`` returns it,
    the restart's parts and the failure's time on its clock."""
    import torch

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.launch import procs, train

    world = process_mesh(PROCS_TRAIN[NCCL_CASE][0], device, meshes)
    args = procs_train_args(NCCL_CASE, world.shape, "--fail-step",
                            str(PROCS_TRAIN[NCCL_CASE][2]), "--shrink-to",
                            str(math.prod(NCCL_RESTART)), "--ckpt", str(Path(tmp) / "procs"))
    torch.cuda.synchronize()
    restarted = train.restart(args, procs_train_cfg(NCCL_CASE), world,
                              CheckpointStore(args.ckpt))
    res = {"left": restarted is None}
    if restarted is None:
        return res
    pm = restarted.mesh
    if pm.shape != NCCL_RESTART:
        raise AssertionError(f"phase 14's restart: the survivors' mesh is {pm.shape}, "
                             f"not {NCCL_RESTART}")
    rec = procs_train_arch(NCCL_CASE, "restart", pm, Path(tmp), {}, [], restarted)
    res.update(archs={f"{NCCL_CASE}/restart": rec}, times=restarted.times,
               wall_s=rec["first_step_at"][1] - restarted.failed_at,
               step_s=rec["first_step_at"][1] - rec["first_step_at"][0],
               transport=pm.transport, ranks=pm.ranks)
    del restarted
    procs.release_process_mesh(pm)
    return res


def nccl_other_card(card: int) -> dict:
    """The four kernels on ``cuda:{card}`` while the current card is
    another: each wrapper launches on its tensors' card. Small seeded
    shapes, each against its plain version there (flash within
    ``ROW_TOL``, the others bitwise: ``segment_reduce`` sums small
    integers, exact in any order)."""
    import torch

    from repro_torch.kernels import ref

    dev = torch.device("cuda", card)
    hp, sr, rf = bare_launchers()
    fa = importlib.import_module("repro_torch.kernels.flash_attention").flash_attention
    g = torch.Generator(device=dev).manual_seed(SEED)
    tok = torch.randint(-1, VOCAB, (2, 1 << 16), generator=g, device=dev, dtype=torch.int32)
    vals = torch.randint(-8, 8, (4096, 64), generator=g, device=dev).float()  # exact sums
    ids = torch.randint(-1, 512, (4096,), generator=g, device=dev, dtype=torch.int32)
    acc = torch.randn((1 << 20,), generator=g, device=dev)
    wire = torch.randn((1 << 20,), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (torch.randn((2, 4, 256, 64), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out = {"current": torch.cuda.current_device(), "card": card}
    out["hash_partition"] = all(equal(a, b) for a, b in zip(hp(tok, 8), ref.hash_partition(tok, 8)))
    out["segment_reduce"] = equal(sr(vals[None], ids[None], 512).to("cpu"),
                                  ref.segment_reduce(vals[None], ids[None], 512).to("cpu"))
    out["ring_fused_step"] = all(equal(a, b) for a, b in zip(rf(acc, wire),
                                                            ref.ring_fused_step(acc, wire)))
    kout = fa(q, k, v, causal=True)
    out["flash_row_rel_err"] = row_rel_err(kout, ref.flash_attention(q, k, v, causal=True))
    out["flash_attention"] = out["flash_row_rel_err"] <= ROW_TOL["torch.bfloat16"]
    out["on_card"] = kout.device == dev
    if not all(out[k] for k in ("hash_partition", "segment_reduce", "ring_fused_step",
                                "flash_attention", "on_card")):
        raise AssertionError(f"a kernel on cuda:{card} differs from its plain version: {out}")
    return out


def nccl_smi() -> dict:
    """``nvidia-smi``'s cards (index, name, power limit) and ``topo -m``;
    where the matrix cannot be read, the cards' peer-to-peer NVLink
    matrix (``topo -p2p n``) instead."""
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    topo = []
    for args in (["topo", "-m"], ["topo", "-p2p", "n"]):
        r = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        topo += [f"nvidia-smi {' '.join(args)}:"] + (r.stdout + r.stderr).rstrip().splitlines()
        if r.returncode == 0:
            break
    return {"cards": cards, "topo": topo}


def nccl_world_dataplane(saved: Path) -> tuple[dict, dict]:
    """14a's reference: phase 11's paths at W = ``NCCL_WORLD`` on world dims
    on the current card (``procs_inputs`` from the files under ``saved``,
    ``procs_timed``). Returns (each path's ``procs_record`` per device, each
    path's readings)."""
    import torch

    meshes = procs_meshes(NCCL_WORLD, "cuda", process=False)
    words, grads, grads24, plan = procs_inputs(meshes, saved=saved)
    torch.cuda.reset_peak_memory_stats()
    recs = procs_timed(meshes, procs_paths(meshes, words, grads, grads24, plan), grads)
    if not recs["aggregate_s3_in_net_map"]["plain_ring_equal"]:
        raise AssertionError("14a on world dims: S3 differs from the plain ring")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del words, grads, grads24, meshes
    torch.cuda.empty_cache()
    return ({name: r.pop("out") for name, r in recs.items()},
            {"paths": recs, "peak_gb": peak})


def nccl_unstaged(label: str, transports: list, staged) -> None:
    """Under nccl every rank's transport is "nccl" and nothing is staged."""
    if transports != ["nccl"] or staged:
        raise AssertionError(f"{label}: transports {transports}, {staged} staged")


def nccl_hold_world(ranks: list, backend: str, ref: dict, world_dp: dict, launches: dict
                    ) -> dict:
    """One group of 14a, nccl or gloo (``nccl_dataplane``'s records): the
    first collective, the data plane held to the world-dim run
    (``procs_hold``; every rank's launches
    added to ``launches``), the collectives' values; under nccl every rank's
    transport "nccl" and nothing staged. Returns the readings."""
    label = f"nccl_{backend}"
    transports = sorted({r["transport"] for r in ranks})
    for r, rec in enumerate(ranks):
        if not all(v["equal"] for v in rec["first"].values()):
            raise AssertionError(f"{label}: rank {r}'s first collective {rec['first']} differs "
                                 "from the world-dim permutation")
        if not all(c["right"] for c in rec["collectives"].values()):
            raise AssertionError(f"{label}: rank {r}'s collectives {rec['collectives']} give "
                                 "wrong values")
    paths = procs_hold(ranks, ref, NCCL_WORLD, launches, label)
    for name, p in paths.items():
        p["world_wall_s"] = world_dp["paths"][name]["wall_s"]
        p["world_collectives"] = {k: v for k, v in world_dp["paths"][name]["collectives"].items()
                                  if v}
        p.pop("held")
    staged = sum(p["staged_bytes"] for p in paths.values()) + sum(
        c["staged_bytes"] for r in ranks for c in r["collectives"].values())
    if backend == "nccl":
        nccl_unstaged(label, transports, staged)
    n = NCCL_WORLD
    coll = {}
    for name in ranks[0]["collectives"]:
        ms = max(r["collectives"][name]["ms"] for r in ranks)
        alg = NCCL_COLL_BYTES / (ms * 1e-3) / 1e9
        coll[name] = {"ms": ms, "algbw_gb_s": alg, "busbw_gb_s": alg * NCCL_BUS[name](n),
                      "bus_factor": NCCL_BUS[name](n),
                      "staged_bytes": sum(r["collectives"][name]["staged_bytes"] for r in ranks)}
    return {"ranks": len(ranks), "transport": transports, "devices": [r["device"] for r in ranks],
            "first": ranks[0]["first"], "setup_s": max(r["setup_s"] for r in ranks),
            "peak_gb_per_rank": max(r["peak_gb"] for r in ranks), "paths": paths,
            "staged_bytes": staged, "collective_calls_rank0": ranks[0]["calls"],
            "collectives": coll, "kernel_check_s": max(r["kernel_check_s"] for r in ranks)}


def nccl_restart_check(recs: list) -> dict:
    """The restart inside the nccl world (``nccl_restart_rank``, the
    survivors' records): the wall time from the failure to the end of the
    first restarted step on the slowest survivor, with its parts there: the
    group's formation, the rebuild and the restore (``train.restart``), this
    script's checks before the step (the restore gathered back bitwise, the
    world-dim reference loaded) and the step. The survivors' groups are
    their own: their global ranks are the mesh's first positions."""
    if any(r["ranks"] != list(range(len(recs))) for r in recs):
        raise AssertionError(f"phase 14's restart: the survivors' groups span "
                             f"{[r['ranks'] for r in recs]}")
    slow = max(recs, key=lambda r: r["wall_s"])
    parts = {**slow["times"], "checks_s": slow["wall_s"] - sum(slow["times"].values())
             - slow["step_s"], "step_s": slow["step_s"]}
    st = {"mesh": list(NCCL_RESTART), "transport": sorted({r["transport"] for r in recs}),
          "failure_to_first_step_s": slow["wall_s"], "slowest_rank": recs.index(slow),
          "each_rank_s": [r["wall_s"] for r in recs], **parts,
          "collective_calls_rank0": recs[0]["calls"]}
    log(f"restart inside the nccl world, (2, 2) -> {NCCL_RESTART} on cards 0-1: "
        f"{slow['wall_s']:.3f} s from the failure to the end of the first restarted step on "
        f"rank {st['slowest_rank']}, the slower survivor (" +
        ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in parts.items()) + ")")
    return st


def nccl_phase(launches: dict, rows: list, kept: dict | None = None,
               saved: Path | None = None) -> dict:
    """Phase 14, the process mesh under nccl with one card per rank: on a
    host with fewer than ``NCCL_WORLD`` cards it says so and returns
    {"ran": False, "cards": N}. Else the kernels on the last card
    (``nccl_other_card``), the references on world dims on cuda:0
    (``nccl_world_dataplane``, ``procs_serve_world`` of each case of
    ``NCCL_SERVE`` and ``procs_train_world`` of each job of
    ``NCCL_TRAIN_WORLDS`` that ``kept`` does not hold: phases 12 and 13's
    four-rank references, ``keep_refs``; phase 14 alone computes them all),
    then one spawn of ``NCCL_WORLD`` nccl ranks (``nccl_rank``: the data
    plane and the collectives on the world's group and, staged, on a gloo
    group of the same ranks; the cases; ending in the elastic restart inside
    that world, ``nccl_restart_rank``: ranks 0-1 go on on ``NCCL_RESTART``
    over a group of their own); each case held to its reference as phases
    11-13 hold theirs, phi3 by
    its own routes (``nccl_phi3_check``), and under nccl every rank's
    transport "nccl" with nothing staged. Adds the ranks' launches to ``launches`` and the
    kernel rows at a rank's shapes to ``rows`` (rank 3's data-plane kernels
    on cuda:3; on cuda:0 rank 0's first flash prefill of each of
    ``NCCL_FLASH``'s cases, its first a2a combine and recurrentgemma's
    first rep-ring hop); returns the readings."""
    import torch

    from repro_torch.kernels import _build, ops

    cards = torch.cuda.device_count()
    if cards < NCCL_WORLD:
        log(f"phase 14 (the process mesh under nccl, one card per rank) needs {NCCL_WORLD} cards; "
            f"found {cards}: not run")
        return {"ran": False, "cards": cards}
    t0 = time.perf_counter()
    res = {"ran": True, "cards": cards, **nccl_smi(), "launches": dict.fromkeys(ops.LAUNCHES, 0)}
    for line in res["cards"] + res["topo"]:
        log(f"  {line}")
    _build.build_all()  # built already: the ranks only load
    res["other_card"] = nccl_other_card(NCCL_WORLD - 1)
    train_jobs = NCCL_TRAIN_WORLDS["first"] + NCCL_TRAIN_WORLDS["restart"]
    with contextlib.ExitStack() as stack:
        if kept is None:  # phase 14 alone: every reference of its own
            kept = {"dir": Path(stack.enter_context(tempfile.TemporaryDirectory())),
                    "serve": {}, "train": {}}
        tmp = kept["dir"]
        if saved is None:  # phase 14 alone: its inputs drawn here
            saved = Path(stack.enter_context(tempfile.TemporaryDirectory()))
            save_inputs(saved, *draw_inputs(NCCL_WORLD))
        # the nccl world starts while the references are made
        with spawning(functools.partial(nccl_rank, str(tmp), str(saved)), NCCL_WORLD,
                      backend="nccl", store_path=tmp / "store_nccl",
                      timeout_s=NCCL_TIMEOUT_S) as got:
            stage("phase 14 world dims")
            t = time.perf_counter()
            ref_s = {}
            ref, world_dp = nccl_world_dataplane(saved)
            ref_s["data_plane"] = time.perf_counter() - t
            world_serve = dict(kept["serve"])
            for case in NCCL_SERVE:
                if case not in world_serve:
                    t1 = time.perf_counter()
                    world_serve[case] = procs_serve_world(case, tmp)
                    ref_s[f"serve {case}"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            world_train = {**kept["train"], **procs_train_world(
                tmp, {"phase 14": tuple(j for j in train_jobs if j[0] not in kept["train"])})}
            ref_s["train"] = time.perf_counter() - t1
            res["world_s"], res["world_ref_s"] = time.perf_counter() - t, ref_s
            res["reused_refs"] = sorted(set(kept["serve"]) | set(kept["train"]))
            log(f"phase 14 references on world dims: {res['world_s']:.2f} s "
                f"({json.dumps(ref_s)}); reused from phases 12 and 13: {res['reused_refs']}")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # rank 0 shares cuda:0 with this process
            stage("phase 14 nccl world")
        ranks, spawned = got["ranks"], got["times"]
        res["nccl_spawn_s"], res["nccl_spawn"] = spawned["spawn_s"], spawned
        res["nccl_rank_s"] = [r["rank_s"] for r in ranks]
        res["gloo_s"] = [r["gloo"]["s"] for r in ranks]
        log(f"phase 14 nccl world: spawn {json.dumps(spawned)}, each rank's work "
            f"{[round(x, 2) for x in res['nccl_rank_s']]} s, of it the data plane staged "
            f"on the gloo group {[round(x, 2) for x in res['gloo_s']]} s")
    spawns = {"nccl": ranks, "gloo": [r["gloo"] for r in ranks]}
    if [r["device"] for r in ranks] != [f"cuda:{i}" for i in range(NCCL_WORLD)]:
        raise AssertionError(f"phase 14's ranks ran on {[r['device'] for r in ranks]}")
    res["data_plane"] = {b: nccl_hold_world(spawns[b], b, ref, world_dp, res["launches"])
                         for b in ("nccl", "gloo")}
    res["world_data_plane_peak_gb"] = world_dp["peak_gb"]
    for b, st in res["data_plane"].items():
        for name, p in st["paths"].items():
            log(f"path nccl_{name} ({b}, {' / '.join(st['transport'])}): {p['wall_s'] * 1e3:.3f} ms "
                f"(the slowest rank; world dims {p['world_wall_s'] * 1e3:.3f} ms), staged "
                f"{p['staged_bytes'] / 1e9:.3f} GB, rank 0's collectives {p['collectives_rank0']}")
        for name, c in st["collectives"].items():
            log(f"collective {name} ({b}), {NCCL_COLL_BYTES >> 20} MiB a rank: {c['ms']:.3f} ms, "
                f"{c['algbw_gb_s']:.2f} GB/s algorithm, {c['busbw_gb_s']:.2f} GB/s bus "
                f"(x {c['bus_factor']:.3f})")
    # 14c: serving every block kind, held as phase 12 holds it; phi3 by its routes
    res["serve"] = {}
    for case in NCCL_SERVE:
        serve = [r["serve"][case] for r in ranks]
        st = procs_serve_check(case, world_serve[case], serve, res)
        st["staged_bytes"] = sum(sum(x["staged"]["bytes"] for x in r["routes"].values())
                                 for r in serve)
        st["collective_calls_rank0"] = serve[0]["calls"]
        nccl_unstaged(f"nccl serve {case}", st["transport"], st["staged_bytes"])
        res["serve"][case] = st
        log(f"process mesh under nccl, serve {case_arch(case)} on {PROCS_SERVE[case][0]}: "
            f"{json.dumps(st)}")
    phi3 = [r["phi3"] for r in ranks]
    st = nccl_phi3_check(phi3, res)
    st["collective_calls_rank0"] = phi3[0]["calls"]
    nccl_unstaged(f"nccl serve {NCCL_PHI3}", st["transport"], st["staged_bytes"])
    res["phi3"] = st
    log(f"process mesh under nccl, serve {NCCL_PHI3} on {PROCS_SERVE[NCCL_PHI3][0]} (its own "
        f"routes; a rank's peak beside the whole model's reckoned bytes): {json.dumps(st)}")
    # 14d: training every block kind, 8-bit moments and the restart, held as phase 13 holds them
    survivors = math.prod(NCCL_RESTART)
    restarts = [r["restart"] for r in ranks]
    if [r["left"] for r in restarts] != [i >= survivors for i in range(NCCL_WORLD)]:
        raise AssertionError(f"phase 14's restart: ranks {[r['left'] for r in restarts]} left, "
                             f"not all but the first {survivors}")
    res["train"] = {}
    for arch, what in train_jobs:
        recs_of = restarts[:survivors] if what == "restart" else [r["train"] for r in ranks]
        recs = [r["archs"][f"{arch}/{what}"] for r in recs_of]
        tr = procs_train_check(arch, what, recs, world_train[arch]["steps" if what == "train"
                                                                   else what], res["launches"])
        tr["transport"] = sorted({r["transport"] for r in recs_of})
        tr["staged_gb"] = sum(s["staged_gb"] for s in tr["steps"])
        tr["world_peak_gb"] = world_train[arch].get(f"{what}_peak_gb",
                                                    world_train[arch].get("peak_gb"))
        nccl_unstaged(f"nccl {arch} ({what})", tr["transport"], tr["staged_gb"])
        if "ckpt" in recs_of[0] and case_arch(arch) == TRAIN_ARCH and what == "train":
            tr["ckpt_rank0"] = recs_of[0]["ckpt"]
        res["train"][f"{arch}/{what}"] = tr
        log(f"process mesh under nccl, {what} {case_arch(arch)} on {tr['mesh']}: {json.dumps(tr)}")
    res["train_collective_calls_rank0"] = ranks[0]["train"]["calls"]
    res["restart"] = nccl_restart_check(restarts[:survivors])
    # the kernel rows: rank 3's data-plane kernels on cuda:3; rank 0's on cuda:0
    for row in ranks[-1]["rows"]:
        row["launches"] = res["launches"][row["name"]]
        row["card"] = ranks[-1]["device"]
        rows.append(row)
    for case, what in NCCL_FLASH.items():
        rec = ranks[0]["phi3"] if case == NCCL_PHI3 else ranks[0]["serve"][case]
        if case == NCCL_CASE:
            n_fa = res["launches"]["flash_attention"]
        else:
            n_fa = (res["phi3"] if case == NCCL_PHI3 else res["serve"][case])["flash_launches"]
        rows.append(procs_flash_row(rec["capture"]["flash"] + (f"serve_{case}",), n_fa,
                                    what + ", on cuda:0"))
        rows[-1]["path"] = f"nccl_serve_{case_arch(case)}"
    rows.append(combine_row(ranks[0]["serve"][NCCL_MOE]["capture"]["combine"],
                            res["launches"]["segment_reduce"], f"nccl_serve_{case_arch(NCCL_MOE)}",
                            "rank 0's a2a combine at (1, 4), on cuda:0"))
    layout, _ = ranks[0]["train"]["capture"]["hop recurrentgemma-2b"]
    acc, wire = seeded_hop(layout, torch.Generator(device="cuda").manual_seed(SEED))
    rows.append(ring_row(acc, wire, "nccl_train_recurrentgemma-2b",
                         f"acc {tuple(acc.shape)} fp32 + wire bf16: rank 0's first rep-ring hop "
                         "of recurrentgemma at (1, 4), acc as the ring hands it, on cuda:0",
                         res["launches"]["ring_fused_step"]))
    del acc, wire
    for k, v in res["launches"].items():
        launches[k] += v
    res["wall_s"] = time.perf_counter() - t0
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from repro_torch.compiler import vectorized
    from repro_torch.compiler.simulator import simulate_timing
    from repro_torch.compiler.vectorized import simulate_vectorized
    from repro_torch.core import wordcount as wc
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # the host's own work, in a process of its own beside the card's phases: the
    # tenants' schedule from the start (phase 3 reads it), the scenario plans'
    # runs on the CPU once they are compiled (checked after phase 6), phase
    # 10's depth search
    host = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    scheduled = host.submit(timed, schedule_tenants)

    # 1. build ------------------------------------------------------------
    stage("phase 1 build")
    build_s = _build.build_all()
    log(f"build: {build_s:.2f} s for {len(_build.NAMES)} kernels")
    for name in _build.NAMES:
        logf = _build.BUILD / f"{name}.log"
        lines = logf.read_text().splitlines() if logf.exists() else []
        for line in lines:
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 2. kernels against their plain versions, edge shapes ----------------
    stage("phase 2 edge checks")
    t0 = time.perf_counter()
    ring_copies = check_kernels_at_edges(torch)
    n_flash = check_flash_at_edges(torch)
    log(f"edge checks: all four kernels match their plain versions ({n_flash} flash_attention "
        f"cases; ring_fused_step bitwise on {len(ring_copies)} layouts, copies "
        f"{ {k: v for k, v in ring_copies.items() if v} } (only {RING_COPIED}); "
        f"{time.perf_counter() - t0:.2f} s)")

    # 3. main paths -----------------------------------------------------------
    stage("phase 3 main paths")
    t = time.perf_counter()
    shards, words, grads_np, grads = inputs()
    # the same inputs, for the process meshes of phases 11 and 14 to read
    saved_inputs = tempfile.TemporaryDirectory()
    saved = save_inputs(Path(saved_inputs.name), shards, grads_np)
    want_counts = wc.wordcount_reference(shards, VOCAB)
    if want_counts.max() >= wc.MAX_EXACT_COUNT:
        raise AssertionError("a word count reaches 2**24: fp32 atomics would not be exact")
    want_mean = torch.from_numpy(grads_np.mean(0, dtype=np.float64)).cuda()
    want_sum = grads_np.sum(0, dtype=np.float64)
    n_valid = int(sum((s >= 0).sum() for s in shards))
    del grads_np
    log(f"data: word count {N_MAPPERS} x {TOKENS_PER_MAPPER} tokens, vocab {VOCAB}, top word "
        f"{want_counts.max() / want_counts.sum():.4f} of tokens; aggregation 8 x {GRAD_SIZE} "
        f"fp32 ({grads.numel() * 4 / 1e9:.3f} GB); {time.perf_counter() - t:.2f} s on the host")

    launches = {k: 0 for k in ops.LAUNCHES}
    walls: dict[str, float] = {}
    outs: dict[str, object] = {}
    path_peak_gb: dict[str, float] = {}
    compile_ms: dict[str, float] = {}
    host_s: dict[str, float] = {}  # host-side runs beside the paths: checks, simulations
    plans = compile_plans(compile_ms)
    t = time.perf_counter()
    plans["plan_wordcount_autotuned"], tuned_telemetry = autotuned_wordcount()
    compile_ms["plan_wordcount_autotuned"] = (time.perf_counter() - t) * 1e3
    on_cpu = {name: host.submit(plan_on_cpu, plan, str(saved)) for name, plan in plans.items()
              if name.startswith("plan_scenario_")}
    from repro_torch.launch.dryrun import card_memory
    rec_depth = host.submit(rec_tp_depth, *REC_TP, card_memory())
    schedule, sched_s = scheduled.result()
    compile_ms["scheduler_two_tenants"] = sched_s * 1e3
    paths = main_paths(words, grads, plans, schedule)
    makespans = {}
    for name, plan in plans.items():
        width = plan.program.nodes[plan.program.sources()[0]].items
        # a fresh simulation: the plan's own memo may hold the compile's run
        t = time.perf_counter()
        makespans[name] = simulate_timing(plan.program, plan.routes, plan.cost_model).makespan_ticks
        host_s[f"{name}.simulate_timing"] = time.perf_counter() - t
        if name == "simulator_device_step":
            what = f"{plan.flow_spec().total_packets} packets on a k={SIM_K} fat-tree"
        else:
            what = (f"one ppermute each of a ({PLAN_RING}, {width}) value, "
                    f"{PLAN_RING * width * 4 / 1e9:.3f} GB at fp32")
        log(f"compiled {name}: {compile_ms[name]:.3f} ms on the host, {len(plan.program)} nodes, "
            f"{plan.routes.total_hops} wire hops ({what}); simulated makespan "
            f"{makespans[name]} ticks ({host_s[f'{name}.simulate_timing'] * 1e3:.3f} ms)")
        log("  " + "; ".join(f"{r.name}: {r.summary}" for r in plan.pass_records))
        if name == "plan_wordcount_autotuned":
            tune, tel = plan.tuning, tuned_telemetry.metrics.to_dict()
            log(f"  autotune: accepted {tune.accepted_by_kind()} of {len(tune.actions)} actions; "
                f"streamed makespan {tune.initial_makespan_ticks} -> {tune.final_makespan_ticks} "
                f"ticks (model ticks); telemetry verify.runs "
                f"{tel['counters'].get('verify.runs', 0)}, "
                f"{len(tuned_telemetry.tracer.spans)} spans")
            if tune.final_makespan_ticks > tune.initial_makespan_ticks:
                raise AssertionError("the autotuned plan is slower than the plan it started from")
    rep_s, tenant_plans = schedule
    schedule_ticks = {"scheduled": rep_s.makespan_ticks,
                      "unscheduled": rep_s.unscheduled_makespan_ticks,
                      "solo": rep_s.solo_makespan_ticks,
                      "hot_swaps_accepted": sum(h.accepted for h in rep_s.hot_swaps),
                      "anomalies": len(rep_s.anomalies)}
    log(f"scheduled scheduler_two_tenants: {compile_ms['scheduler_two_tenants']:.3f} ms on the "
        f"host; {rep_s.summary()}; makespan scheduled {rep_s.makespan_ticks}, unscheduled "
        f"{rep_s.unscheduled_makespan_ticks}, solo {rep_s.solo_makespan_ticks} ticks; hot swaps "
        + "; ".join(f"{h.name} {h.makespan_before}->{h.makespan_after} "
                    f"({'accepted' if h.accepted else 'kept'})" for h in rep_s.hot_swaps))
    if sorted(tenant_plans) != sorted(TENANTS):
        raise AssertionError(f"the scheduler admitted {sorted(tenant_plans)}, not both tenants")
    if rep_s.makespan_ticks > rep_s.unscheduled_makespan_ticks:
        raise AssertionError("the schedule is worse than the unscheduled merge")

    def drive(name, fn):
        """One path's call: kernel launch counts and the simulator's card
        steps zeroed just before it and read just after, its wall and its
        own peak device memory logged. Returns (out, launches, steps)."""
        ops.reset_launches()
        vectorized.STEPS["torch"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        path_peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
        got = dict(ops.LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        copies = (f", ring_fused_step copied {ops.COPIES['ring_fused_step']} hop inputs"
                  if got["ring_fused_step"] else "")
        log(f"path {name}: {walls[name] * 1e3:.3f} ms wall, launches {got}{copies}, peak "
            f"device memory {path_peak_gb[name]:.3f} GB ({path_peak_gb[name] - base_gb:.3f} GB "
            f"over the {base_gb:.3f} GB held before the call)")
        return out, got, vectorized.STEPS["torch"]

    # the phase's peak so far: each path below resets the counter to read its own
    pre_paths_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    procs_ref = {}  # what phase 11's process mesh is held to
    card_bits = {}  # the scenario plans' results on the card, held to the CPU's after phase 6
    for name, fn in paths.items():
        out, got, torch_steps = drive(name, fn)
        if name in PROCS_PATHS:
            procs_ref[name] = procs_record(name, out, N_MAPPERS)

        if name == "wordcount_token":
            reducer_counts, recv = out
            if not np.array_equal(reducer_counts.sum(0).to(torch.int64).cpu().numpy(), want_counts):
                raise AssertionError("token path counts differ from wordcount_reference")
            owner = ref.hash_bucket(torch.arange(VOCAB, device="cuda"), N_MAPPERS)
            seen = (reducer_counts > 0).nonzero()
            if not bool((seen[:, 0] == owner[seen[:, 1]]).all()):
                raise AssertionError("a word was counted on a reducer that does not own its bucket")
            if int((recv >= 0).sum()) != n_valid:
                raise AssertionError("the token shuffle dropped tokens")
            outs["recv"] = recv
            log(f"  capacity {recv.shape[-1] // N_MAPPERS}, send buffer {recv.numel() * 4 / 1e9:.3f} GB, "
                "counts bitwise == wordcount_reference")
        elif name.startswith("wordcount_"):
            if not np.array_equal(out.reshape(-1).to(torch.int64).cpu().numpy(), want_counts):
                raise AssertionError(f"{name} counts differ from wordcount_reference")
            log("  counts bitwise == wordcount_reference")
        elif name.startswith("plan_wordcount_"):
            counts = out["OUT"]
            if got["segment_reduce"] != 1:
                raise AssertionError(f"{name} made {got['segment_reduce']} segment_reduce launches")
            if not counts.max() < wc.MAX_EXACT_COUNT:
                raise AssertionError(f"{name}: a count reaches 2**24, past exact fp32")
            if counts.dtype != np.float64 or not np.array_equal(counts, want_counts.astype(np.float64)):
                raise AssertionError(f"{name} counts differ from wordcount_reference")
            log(f"  counts bitwise == wordcount_reference (top count {int(counts.max())} < 2**24)")
            if name == "plan_wordcount_session":
                # the same compile's own entry point: on the card (its default:
                # kernel_histogram, then the plan's torch step in float64), and
                # on the host (numpy histograms, then the packet simulator)
                for where, kw in (("on the card", {}), ("on the host", {"backend": "simulate"})):
                    t = time.perf_counter()
                    via_counts, sim = wc.wordcount_via_plan(shards, VOCAB, **kw)
                    key = f"wordcount_via_plan {where}"
                    host_s[key] = time.perf_counter() - t
                    if not np.array_equal(via_counts, want_counts):
                        raise AssertionError(f"{key}: counts differ from wordcount_reference")
                    log(f"  {key}: counts bitwise == wordcount_reference, simulated makespan "
                        f"{sim.report.makespan_ticks} ticks ({sim.report.time_s!r} s modelled), "
                        f"{host_s[key]:.2f} s wall")
        elif name.startswith("plan_scenario_"):
            sc = SCENARIOS[name.removeprefix("plan_scenario_")]
            tol = AGG_TOL[sc]
            got_sum = out["OUT"]
            err = float(np.linalg.norm(got_sum - want_sum) / np.linalg.norm(want_sum))
            # the same plan object on the CPU at full width (a lowered plan's
            # bucket windows are fixed at GRAD_SIZE, so a prefix would not do),
            # in the host process (``plan_on_cpu``): its bits held to these after phase 6
            card_bits[name] = digest(got_sum)
            log(f"  normwise err vs float64 host sum {err!r} (limit {tol}); all {GRAD_SIZE} "
                f"elements held bitwise to the plan run on the CPU after phase 6")
            if not np.isfinite(got_sum).all() or got_sum.shape != (GRAD_SIZE,) or err > tol:
                raise AssertionError(f"{name}: beyond {tol} of the float64 sum, or malformed")
        elif name == "scheduler_two_tenants":
            if got["segment_reduce"] != 1:
                raise AssertionError(f"{name} made {got['segment_reduce']} segment_reduce launches")
            for tenant, counts in ((n, o["OUT"]) for n, o in out.items()):
                mine = wc.wordcount_reference([shards[m] for m in TENANTS[tenant][0]], VOCAB)
                if counts.dtype != np.float64 or not np.array_equal(counts, mine.astype(np.float64)):
                    raise AssertionError(f"{name}: {tenant}'s counts differ from "
                                         "wordcount_reference over its shards")
            log("  each tenant's counts bitwise == wordcount_reference over its own 4 shards")
        elif name == "simulator_device_step":
            plan = plans[name]
            if not torch_steps:
                raise AssertionError("the simulator took no step on the card")
            t = time.perf_counter()
            rep_np = simulate_vectorized(plan.program, plan.flow_spec(), plan.cost_model)
            host_s["simulator_numpy"] = time.perf_counter() - t
            log(f"  {plan.flow_spec().total_packets} packets: makespan {out.makespan_ticks} ticks "
                f"with the step on the card ({torch_steps} steps) vs {rep_np.makespan_ticks} on the numpy path "
                f"({host_s['simulator_numpy'] * 1e3:.3f} ms wall there); busy ticks "
                f"{'equal' if out.switch_busy_ticks == rep_np.switch_busy_ticks else 'DIFFER'}")
            if (out.makespan_ticks != rep_np.makespan_ticks
                    or out.switch_busy_ticks != rep_np.switch_busy_ticks):
                raise AssertionError("the simulator's step on the card differs from numpy's")
        elif name.startswith("plan_aggregate_"):
            sc = SCENARIOS[name.removeprefix("plan_aggregate_")]
            tol = AGG_TOL[sc]
            got_sum = out["OUT"]
            err = float(np.linalg.norm(got_sum - want_sum) / np.linalg.norm(want_sum))
            cpu = plans[name].run({f"g{i}": grads[i, :PREFIX].cpu() for i in range(8)},
                                  backend="torch", device="cpu")["OUT"]
            same = np.array_equal(got_sum[:PREFIX].view(np.uint64), cpu.view(np.uint64))
            log(f"  normwise err vs float64 host sum {err!r} (limit {tol}); first {PREFIX} "
                f"elements {'bitwise ==' if same else 'DIFFER from'} the plan run on the CPU")
            if not np.isfinite(got_sum).all() or got_sum.shape != (GRAD_SIZE,) or err > tol:
                raise AssertionError(f"{name}: beyond {tol} of the float64 sum, or malformed")
            if not same:
                raise AssertionError(f"{name}: the card's result differs from the CPU's")
        else:
            sc = ("s3_in_net_map" if name == "aggregate_s3_plan_order"
                  else name.removeprefix("aggregate_"))
            tol = AGG_TOL[sc]
            err = (out.reshape(8, GRAD_SIZE).double() - want_mean).abs()
            bad = not bool((err <= tol + tol * want_mean.abs()).all())
            log(f"  max abs err vs float64 mean {float(err.max())!r} (rtol=atol={tol})")
            if bad:
                raise AssertionError(f"{sc}: beyond rtol=atol={tol}")
            if sc == "s3_in_net_map" and got["ring_fused_step"] != 7:
                raise AssertionError(f"S3 over 8 ranks made {got['ring_fused_step']} hops, not 7")
        del out

    # 4. kernels at their main-path shapes: agreement and time ---------------
    stage("phase 4 kernels at the main paths' shapes")
    # the world-dim ring's hop: every device's chunk, gathered into a new tensor
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    world_hop = ((N_MAPPERS, GRAD_SIZE // N_MAPPERS), (GRAD_SIZE // N_MAPPERS, 1), 0, GRAD_SIZE)
    rows = data_plane_rows(words, outs["recv"], seeded_hop(world_hop, gen))
    # and at one rank's shapes of phase 11: rank 0's shard, its received
    # words, its first hop's chunk as a view of its chunks (launch counts
    # from phase 11)
    procs_rows = data_plane_rows(words[:1], outs.pop("recv")[:1],
                                 seeded_hop(process_hop_layout(GRAD_SIZE, N_MAPPERS), gen),
                                 "procs_")
    seg_mod = importlib.import_module("repro_torch.kernels.segment_reduce")
    sr = bare_launchers()[1]  # the MoE combine's row, after phase 10

    peak_wc_gb = max(pre_paths_peak_gb, torch.cuda.max_memory_allocated() / 1e9,
                     *path_peak_gb.values())
    del words, grads, outs, shards, want_counts, want_mean, want_sum
    # the paths' closures hold the corpus, the gradients and the plans; the
    # checks left the token path's buffers and a float64 error tensor
    del paths, schedule, tenant_plans, recv, reducer_counts, err

    # 3b. the recurrences: a phase of its own, with its own peak (the
    # allocator keeps its cached blocks, as it did for the paths above)
    stage("phase 3b recurrences")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    recurrence = recurrence_inputs()
    torch.cuda.synchronize()
    log(f"data: recurrence a, b ({SCAN_RANKS}, {SCAN_LEN}, {SCAN_BATCH}, {SCAN_WIDTH}) fp32 "
        f"({recurrence[0].numel() * 4 / 1e9:.3f} GB each), {PIPE_STAGES} stage weights "
        f"({PIPE_SHAPE[-1]}, {PIPE_SHAPE[-1]}), {PIPE_MICRO} microbatches {PIPE_SHAPE} fp32; "
        f"{time.perf_counter() - t:.2f} s on the card")
    pre_paths_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, fn in recurrence_paths(*recurrence).items():
        out, _, _ = drive(name, fn)
        if name == "ring_scan_linear_recurrence":
            t = time.perf_counter()
            want = sequential_recurrence(*recurrence[:2])
            host_s["ring_scan_float64_reference"] = time.perf_counter() - t
            err, ratio = beyond_tol(out, want)
            del want
            log(f"  max abs err vs the float64 sequential recurrence {err!r}, "
                f"{ratio!r} of the rtol=atol={RECURRENCE_TOL} limit "
                f"({host_s['ring_scan_float64_reference']:.2f} s for the reference)")
            if out.shape != recurrence[0].shape or not bool(torch.isfinite(out).all()) or ratio > 1:
                raise AssertionError(f"{name}: beyond rtol=atol={RECURRENCE_TOL}, or malformed")
        elif name == "pipeline_apply":
            from repro_torch.core.pipeline import pipeline_stats

            ws, micro = recurrence[2].double(), recurrence[3].double()
            want = micro
            for s in range(PIPE_STAGES):
                want = torch.tanh(want @ ws[s])
            err, ratio = beyond_tol(out[0], want)
            rows_same = all(out[r].data_ptr() == out[0].data_ptr() for r in range(PIPE_STAGES))
            del want, ws, micro
            st = pipeline_stats(PIPE_STAGES, PIPE_MICRO)
            log(f"  {st.ticks} ticks, bubble fraction {st.bubble_fraction!r}; max abs err vs "
                f"the stages applied in sequence (float64) {err!r}, {ratio!r} of the "
                f"rtol=atol={RECURRENCE_TOL} limit; every stage row a view of the last's: "
                f"{rows_same}")
            if (tuple(out.shape) != (PIPE_STAGES, PIPE_MICRO) + PIPE_SHAPE or ratio > 1
                    or not rows_same):
                raise AssertionError(f"{name}: beyond rtol=atol={RECURRENCE_TOL}, or malformed")
        del out
    peak_rec_gb = max(pre_paths_peak_gb, torch.cuda.max_memory_allocated() / 1e9,
                      *(path_peak_gb[n] for n in ("ring_scan_linear_recurrence", "pipeline_apply")))
    del recurrence

    # 5. serving at full width -------------------------------------------------
    stage("phase 5 serving")
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, prompts = serve_inputs()
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"serve: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads "
        f"(kv {cfg.n_kv_heads}) of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.param_count() / 1e6:.1f} M parameters in fp32 with bf16 copies, random from seed "
        f"{SEED}; {SERVE_BATCH} prompts x {SERVE_PROMPT} tokens, {SERVE_GEN} greedy tokens. "
        f"Reduced from prefill_32k/decode_32k (src/repro/launch/shapes.py, sized for a 256-chip "
        f"pod) to batch {SERVE_BATCH} at train_4k's {SERVE_PROMPT}-token sequence; depth and "
        f"widths are the config's. Built in {time.perf_counter() - t:.2f} s")
    serve_stats = {}
    for name, fn in serve_paths(model, prompts).items():
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        log(f"path {name}: {walls[name] * 1e3:.3f} ms wall, launches {got}")
        if got["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"prefill made {got['flash_attention']} flash_attention launches, "
                                 f"not one per layer ({cfg.n_layers})")
        toks = res["tokens"]
        if toks.shape != (SERVE_BATCH, SERVE_GEN) or not bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"generated tokens {tuple(toks.shape)} out of shape or vocab")
        serve_stats[name] = {**serve_walls(res),
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  cold: {json.dumps(serve_stats[name])}")
    flash_toks = res["tokens"]
    del res
    serve_stats["serve_flash_warm"] = serve_walls(
        serve.generate(model, prompts, SERVE_GEN, impl="flash"))
    log(f"  warm (second run, not counted): {json.dumps(serve_stats['serve_flash_warm'])}")
    masked = serve.generate(model, prompts, SERVE_GEN, impl="masked")
    serve_stats["serve_masked"] = serve_walls(masked)
    same = flash_toks == masked["tokens"]
    prefix = int(same.int().cumprod(1).sum())
    log(f"  masked prefill (the JAX model's chunked attention): "
        f"{json.dumps(serve_stats['serve_masked'])}; "
        f"greedy tokens equal to flash's at {int(same.sum())} of {same.numel()} positions, "
        f"{prefix} before a sequence's first difference")
    del masked

    # flash vs masked prefill: on the served weights, then on the same model
    # sharpened; then a control that the limits must reject, the kernel run
    # without its causal mask
    log(f"  flash vs masked prefill, normwise relative (limits: K/V cache of every layer and "
        f"final hidden {SERVE_TOL}, layer 0's attention output {ATTN_TOL}):")
    want = prefill_run(model, prompts, "masked")
    serve_checks = {"served": prefill_readings(prefill_run(model, prompts, "flash"), want)}
    sharpen(model)
    want = prefill_run(model, prompts, "masked")
    serve_checks["sharpened"] = prefill_readings(prefill_run(model, prompts, "flash"), want)
    real = ops.flash_attention
    with mock.patch.object(ops, "flash_attention",
                           lambda q, k, v, causal=True: real(q, k, v, causal=False)):
        serve_checks["control"] = prefill_readings(prefill_run(model, prompts, "flash"), want)
    del want
    for label, r in serve_checks.items():
        log(f"    {label}: {json.dumps(r)}")
    for label in ("served", "sharpened"):
        if not within(serve_checks[label]):
            raise AssertionError(f"flash prefill differs from masked ({label} weights): "
                                 f"{serve_checks[label]}")
    ctl = serve_checks["control"]
    if ctl["kv_worst"] <= SERVE_TOL or ctl["attn0"] <= ATTN_TOL:
        raise AssertionError(f"the flash-vs-masked limits pass a kernel without its causal "
                             f"mask: {ctl}")
    log(f"    (sharpened: wq, wk x {QK_GAIN}, random biases and norm scales; control: the "
        f"sharpened model with the kernel run non-causal, rejected by the limits)")

    # flash_attention at the prefill's shape: agreement and time
    fa = importlib.import_module("repro_torch.kernels.flash_attention").flash_attention
    fb, fh, fs, fd = SERVE_BATCH, cfg.n_heads, SERVE_PROMPT, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((fb, fs, fh, fd), generator=g, device="cuda").to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))  # the model's (b, s, h, d) layout, as views
    kout, pout = fa(q, k, v, causal=True), ref.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(kout.float(), pout.float(), rtol=3e-2, atol=3e-2)
    err, row_err = max_abs_err([(kout, pout)]), row_rel_err(kout, pout)
    norm_err = rel_err(kout, pout)
    log(f"flash_attention at the prefill's shape vs plain: max abs {err!r}, normwise "
        f"{norm_err!r}, worst row {row_err!r} (limit {ROW_TOL[str(kout.dtype)]})")
    if row_err > ROW_TOL[str(kout.dtype)]:
        raise AssertionError(f"flash_attention at the prefill's shape: a row is {row_err} "
                             f"off normwise")
    del kout, pout
    b, b_by = bound_ms(4 * fb * fh * fs * fd * 2, 4 * fd * fb * fh * fs * (fs + 1) / 2,
                       BF16_TC_OPS_PER_S)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "ms": cuda_ms(lambda: fa(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v, causal=True), iters=3, warmup=1),
        "bound_ms": b, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "norm_rel_err": norm_err, "max_row_rel_err": row_err,
        "path": "serve_flash",
        "shape": f"q, k, v ({fb}, {fh}, {fs}, {fd}) bf16 views of (b, s, h, d), causal",
    })

    peak_serve_gb = torch.cuda.max_memory_allocated() / 1e9
    del q, k, v, model, prompts, flash_toks, fn  # fn: serve_paths' closure holds the model

    # 6. the other block kinds at full width, one model at a time -------------
    stage("phase 6 block kinds")
    family_checks: dict[str, dict] = {}
    combine = {}
    for arch in FAMILY_ARCHS:
        stage(f"phase 6 {arch}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model, batch = family_inputs(arch)
        torch.cuda.synchronize()
        cfg = model.cfg
        n_params = sum(p.numel() for p in model.parameters())
        held_gb = torch.cuda.memory_allocated() / 1e9
        b, s = FAMILY_BATCH, (DEC_PROMPT if cfg.enc_layers else FAMILY_PROMPT)
        enc = f" + {cfg.enc_layers} encoder" if cfg.enc_layers else ""
        frames = f" tokens and {ENC_FRAMES} encoder frames" if cfg.enc_layers else " positions"
        log(f"serve {arch}: {cfg.n_layers} layers{enc}, d {cfg.d_model}, vocab {cfg.vocab}, "
            f"{n_params / 1e9:.3f} B parameters in fp32 with bf16 copies ({held_gb:.3f} GB on "
            f"the card), random from seed {SEED}, built in {time.perf_counter() - t:.2f} s; "
            f"{b} prompts x {s}{frames}, {FAMILY_GEN} greedy tokens")
        (name, fn), = family_paths(model, batch).items()
        res, got, _ = drive(name, fn)
        serve_stats[name] = {**serve_walls(res, b, FAMILY_GEN), "peak_mem_gb": path_peak_gb[name],
                             "held_gb": held_gb}
        want_flash, want_sr = FAMILY_LAUNCHES[arch]
        if got["flash_attention"] != want_flash or got["segment_reduce"] != want_sr:
            raise AssertionError(f"{name} made {got} launches, not {want_flash} flash_attention "
                                 f"and {want_sr} segment_reduce")
        toks = res["tokens"]
        if toks.shape != (b, FAMILY_GEN) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{name}: generated tokens {tuple(toks.shape)} out of shape "
                                 "or vocab")
        del res, toks
        serve_stats[f"{name}_warm"] = serve_walls(serve.generate(model, batch, FAMILY_GEN,
                                                                 impl="flash"), b, FAMILY_GEN)
        log(f"  cold: {json.dumps(serve_stats[name])}")
        log(f"  warm (second run, not counted): {json.dumps(serve_stats[f'{name}_warm'])}")
        if want_sr:
            # the combine's inputs in a served prefill (uncounted): layer 0's
            real_sr = ops.segment_reduce

            def capture(values, ids, n):
                combine.setdefault("args", (values.clone(), ids.clone(), n))
                return real_sr(values, ids, n)

            with mock.patch.object(ops, "segment_reduce", capture):
                prefill_run(model, batch, "flash")
        checks = {"consistency": cache_consistency(model, batch, "flash")}
        c = checks["consistency"]
        log(f"  cache consistency (prefill {s} + one decode step vs prefill {s + 1}, normwise "
            f"relative, limit {CONSIST_TOL}): {json.dumps(c)}")
        if not c["finite"] or c["decode_vs_prefill"] > CONSIST_TOL or c["control"] <= CONSIST_TOL:
            raise AssertionError(f"{name}: decode over the prefill's cache differs from the longer "
                                 f"prefill, or the limit passes an empty cache: {c}")
        if want_flash or want_sr:
            # the kernel route against the plain route: the whole prefill on
            # the served weights, with the plain route replaying the kernel
            # route's expert choices (a router near-tie that the two round
            # apart is counted, not compared); and each kernel layer on its
            # own input, on the served and the sharpened weights
            depth = cfg.n_layers + cfg.enc_layers
            tol = SERVE_TOL * max(1.0, depth / 24) ** 0.5
            routes, flips = [], []
            with recorded_routes(routes):
                got = prefill_run(model, batch, "flash")
            with (mock.patch.object(ops, "segment_reduce", ref.segment_reduce),
                  replayed_routes(routes, flips)):
                want = prefill_run(model, batch, "masked")
            checks["served"] = {**prefill_readings(got, want), "router_flips": sum(flips)}
            del got, want, routes
            log(f"  kernels vs plain route (masked attention, ref.segment_reduce), served weights: "
                f"{json.dumps(checks['served'])} (limits {tol!r} over {depth} layers, {ATTN_TOL})")
            if not within(checks["served"], depth):
                raise AssertionError(f"{name}: the kernels' prefill differs from the plain route: "
                                     f"{checks['served']}")
            for weights in ("served", "sharpened"):
                if weights == "sharpened":
                    sharpen(model)
                r = layer_readings(model, batch)
                checks[f"{weights}_by_layer"] = r
                log(f"  each kernel layer vs its plain route on the same input, {weights} weights: "
                    f"{json.dumps(r)} (limit {ATTN_TOL})")
                if r["attention_worst"] > ATTN_TOL or r["moe_worst"] > ATTN_TOL or (
                        r["attention_layers"], r["moe_layers"]) != (want_flash, want_sr):
                    raise AssertionError(f"{name}: a kernel layer differs from its plain route "
                                         f"({weights} weights): {r}")
        family_checks[name] = checks
        del model, batch, fn

    # phase 3's scenario plans on the CPU, run in the host process meanwhile
    for name, job in on_cpu.items():
        cpu_bits, host_s[f"{name}.cpu_run"] = job.result()
        same = cpu_bits == card_bits.pop(name)
        log(f"{name}: all {GRAD_SIZE} elements {'bitwise ==' if same else 'DIFFER from'} the "
            f"plan run on the CPU ({host_s[f'{name}.cpu_run']:.2f} s wall there, in the host "
            f"process)")
        if not same:
            raise AssertionError(f"{name}: the card's result differs from the CPU's")

    # 7. training at full width, phase 8's dry run on the host beside it ----------
    stage("phase 7 training")
    t = time.perf_counter()
    pending = dryrun_start()
    try:
        training = train_phase(launches)
    except BaseException:
        pending["executor"].shutdown(wait=True, cancel_futures=True)
        raise
    training["wall_s"] = time.perf_counter() - t
    log(f"training phase: {training['wall_s']:.2f} s")

    # 8. restart and dry run -----------------------------------------------------
    stage("phase 8 restart and dry run")
    t = time.perf_counter()
    restart = restart_phase(launches, pending)
    restart["wall_s"] = time.perf_counter() - t
    log(f"restart and dry run phase: {restart['wall_s']:.2f} s")

    # 9. serving across a (data, model) mesh ------------------------------------
    stage("phase 9 serving across a mesh")
    t = time.perf_counter()
    mesh_serving = mesh_phase(drive, launches, rows)
    mesh_serving["wall_s"] = time.perf_counter() - t
    log(f"serving across a mesh phase: {mesh_serving['wall_s']:.2f} s")

    # 10. training under tensor parallelism ---------------------------------------
    stage("phase 10 training under TP")
    t = time.perf_counter()
    tp_training = tp_train_phase(launches, rec_depth.result())
    host.shutdown()
    tp_training["wall_s"] = time.perf_counter() - t
    log(f"training under tensor parallelism phase: {tp_training['wall_s']:.2f} s")

    # 11-13. the process mesh, one process per device, each its shard: the data
    # plane, serving and training
    refs = tempfile.TemporaryDirectory()  # phases 12-13's four-rank references, for phase 14
    p = procs_phases(procs_ref, saved, Path(refs.name))
    procs, procs_serving, procs_training = p["procs"], p["procs_serving"], p["procs_training"]
    kept = p["kept"]
    for k in launches:
        launches[k] += p["launches"][k]

    # 14. the process mesh under nccl, one card per rank (four cards or more) ---------
    stage("phase 14 the process mesh under nccl")
    nccl_rows = []  # the kernels at a rank's shapes, with phase 14's launches
    nccl = nccl_phase(launches, nccl_rows, kept, saved)
    refs.cleanup()
    saved_inputs.cleanup()
    if nccl["ran"]:
        log(f"process mesh under nccl phase: {nccl['wall_s']:.2f} s")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was never launched on the main paths")

    # segment_reduce at the MoE combine's shape: agreement and time
    values, ids, nseg = combine.pop("args")
    ks, ps = sr(values, ids, nseg), ref.segment_reduce(values, ids, nseg)
    # fp32 sums of top_k bf16 rows per token in another order (atomics)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-5 * float(ps.abs().max()))
    vals32, ids64 = values.float(), ids.long()
    lib_out = torch.zeros_like(ps)
    b_ms, b_by = bound_ms(values.numel() * values.element_size() + ids.numel() * 4 + ps.numel() * 4,
                          values.numel())
    rows.append({
        "name": "segment_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:55",
        "launches": launches["segment_reduce"], "max_abs_err": max_abs_err([(ks, ps)]),
        "ms": cuda_ms(lambda: sr(values, ids, nseg)),
        "plain_ms": cuda_ms(lambda: ref.segment_reduce(values, ids, nseg)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, ids64, vals32)),
        "branch": ("shared-memory histogram"
                   if nseg * values.shape[-1] * 4 <= seg_mod.max_bin_bytes() else "global atomics"),
        "path": f"serve_{FAMILY_ARCHS[0]}",
        "shape": f"values {tuple(values.shape)} {str(values.dtype).removeprefix('torch.')}, ids "
                 f"({ids.numel()},) int32 sorted by expert, nseg={nseg} tokens: the MoE combine",
    })
    del values, ids, ks, ps, vals32, ids64, lib_out
    for row in rows:  # launches over every main path, the later phases' included
        row["launches"] = launches[row["name"]]
    for row in procs_rows:  # the process mesh's launches, summed over its ranks
        row["launches"] = procs["launches"][row["name"]]
    rows += procs_rows + p["rows"] + nccl_rows

    log(json.dumps({"paths_wall_s": walls, "serve": serve_stats, "serve_checks": serve_checks,
                    "family_checks": family_checks, "training": training,
                    "mesh_serving": mesh_serving, "tp_training": tp_training, "procs": procs,
                    "procs_serving": procs_serving, "procs_training": procs_training,
                    "nccl": nccl,
                    "restart": {k: v for k, v in restart.items() if k != "dryrun"},
                    "dryrun": {k: v for k, v in restart["dryrun"].items() if k != "records"},
                    "plan_compile_ms": compile_ms, "plan_makespan_ticks": makespans,
                    "autotune": plans["plan_wordcount_autotuned"].tuning.summary(),
                    "schedule_ticks": schedule_ticks,
                    "host_s": host_s, "path_peak_mem_gb": path_peak_gb,
                    "peak_mem_gb": {"wordcount_aggregation": peak_wc_gb,
                                    "recurrence": peak_rec_gb, "serve": peak_serve_gb},
                    "build_s": build_s}))
    log(f"script: {time.perf_counter() - START:.1f} s")
    stage("done")
    log(json.dumps({"phase_walls_s": phase_walls()}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def nccl_phase_alone() -> int:
    """``chip_smoke.py --nccl-phase``: phase 14 alone (``nccl_phase``, which
    computes every reference itself) after the kernels' build, its checks
    as in the whole script; prints its lines, then the restart's readings,
    the references', spawns' and ranks' times and the kernels' launches as one JSON
    object, and the card's name and power limit. Returns 1 on a host with
    fewer than ``NCCL_WORLD`` cards."""
    import torch

    if torch.cuda.device_count() < NCCL_WORLD:
        print(f"chip_smoke --nccl-phase: needs {NCCL_WORLD} cards, not "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build, ops

    log(f"build: {_build.build_all():.2f} s for {len(_build.NAMES)} kernels")
    launches, rows = dict.fromkeys(ops.LAUNCHES, 0), []
    t = time.perf_counter()
    res = nccl_phase(launches, rows)
    log(f"phase 14 alone: {time.perf_counter() - t:.2f} s")
    log(json.dumps({"restart": res["restart"], "launches": launches,
                    "times": {k: v for k, v in res.items()
                              if k in ("world_s", "gloo_s") or k.endswith(("spawn_s", "rank_s"))}}))
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True
                       ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--nccl-phase"]:
        sys.exit(nccl_phase_alone())
    if sys.argv[1:2] == ["--ring-hops"]:
        sys.exit(ring_hops(Path(sys.argv[2] if len(sys.argv) > 2 else Path(__file__).parent)
                           .resolve()))
    sys.exit(main())
