"""Training on a process mesh: one ``torch.distributed`` process per mesh
device, each holding only its device's shard of the parameters and of the
fp32 moments, against the JAX reference and against the world-dim port, on
the CPU.

Three ``multidevice`` subprocesses on 8 fake devices, side by side, run the
reference's ``make_train_step`` (compiled at XLA's backend optimization
level 0, ``JAX_XLA``, as ``test_torch_procs_serve`` does) for every case of
``CASES``: smoke configs, sequence 32, ``TrainPipeline`` seed 3, parameters
from ``init_params`` perturbed as ``test_torch_tp_train``'s, two steps; each
step's metrics, and the parameters and moments after the second, in the
reference's storage layout. Cases: qwen1.5 at (4, 2) (tp 2) under
``native``, ``s1_host``, ``s2_in_net`` and ``s3_in_net_map``; at (2, 2, 2)
under ``hierarchical`` with two microbatches; at (1, 8) (tp 4, rep 2: the
rep groups' rings) under ``s3_in_net_map`` on a global batch of 3, which does
not split over the rep groups; granite-moe at (1, 8) (tp 4, rep 2, its 2 kv
heads over a span of 2, one expert a rank) on the ``a2a`` dispatch and at
(2, 4) on the ``replicated`` one; mamba2 at (4, 2) (its ``resolve_tp``'s
2); and the other block kinds under S3: minicpm3 (MLA: the latent norms
and projections held whole, summed over the mesh) at (4, 2), recurrentgemma
(the RG-LRU's vectors gathered over the rep groups only, local attention's
one kv head) at (1, 8) on 3 rows, qwen2-vl (M-RoPE over embeddings) at
(2, 4), seamless (enc-dec) at (4, 2), and grok (bf16 parameters) at (4, 2)
with 8-bit moments at ``test_torch_tp_train_kinds.EIGHTBIT``'s lr, its
(codes, scales) read device by device.

Eight gloo ranks on the CPU are spawned once for the file
(``launch.procs.spawn``, one thread each) while the reference runs. Each
first checks every differentiable collective of ``models.parallel`` on its
(2, 4) and (2, 2, 2) meshes (``function_checks``: the adjoint identity Σ
⟨f(x), y⟩ = Σ ⟨x, fᵀ(y)⟩ over the ranks, which holds only where the
backward is the transpose, per scenario for the weight fetch), then runs the
first world of the reference's end-to-end target (``E2E``, the twin of
``tests/test_train_e2e.py:5-22``), then waits for the reference's outputs
and takes each case's two steps from its device's shard of the same
parameters (``params_from_jax`` under its process mesh's env), on its block
of the same batches, S3's hops counted; the shards go back gathered into
whole leaves (``convert.gather_shards``), 8-bit rows into the world-dim
step's rows (``train.gather_rows``). After grok's steps rank 0 writes their
checkpoint, every rank restores it into a model from other weights, and a
restore on the world's other mesh, (2, 4), is refused. Then the
``FP32_CASES`` from seeded weights (an RG-LRU one, and grok's 8-bit steps),
grok's 8-bit case again with its update at ``FAULT_LR`` × lr, and what
training on processes refuses (an 8-bit run's restart among it).
The e2e restarts inside the world: at its failure ranks 0-3 form (2, 2)
over a group of their own and train on to its last step, while ranks 4-7
return and go on to the cases. Its relaunch form, a new world of 4 ranks
on (2, 2) from a copy of the checkpoints without the survivors' last one,
is spawned once the first world has ended: the yardstick of the restart.

Tolerances: against the reference, ``test_torch_train``'s (``LOSS_TOL``,
``NORM_TOL``, ``MOMENT_TOL``, ``MOMENTS_TOL``, each parameter within two
steps of lr, the update within ``UPDATE_TOL``). Against the world-dim port
on the same inputs: the two run the same products on other shapes (a
process's rows and its tp rank's slice, against every row and every rank
folded), whose bf16 roundings differ, and gloo adds a group's fp32 values
in its own order. Measured: the first losses bitwise, the second 2.2e-5
apart at most, the norms 4.4e-4, the moments 5e-3 over the tree but up to
7e-2 on a leaf whose gradient is rounding noise (qwen1.5's key bias cancels
in the softmax), as far apart as either is from the reference; so the
world-dim port is held to ``WORLD_LOSS_TOL``, ``WORLD_NORM_TOL`` and
``WORLD_MOMENTS_TOL`` over the tree, and the parameters as against the
reference (a noise element takes an lr step of either sign). The sharp
comparison is ``FP32_CASES``: the same steps computed in fp32 on both, where
only the order of fp32 sums differs (measured 1.7e-7 at most on a leaf of
the first step's moments, normwise against the tree, and 1.1e-7 on the
losses and norms), within ``FP32_TOL``. A copy of the code whose psum's
backward passes the cotangent through, or whose activation all-gather's
backward halves it, fails those cases far above it. 8-bit moments:
``EIGHTBIT_TREE_TOL``, ``FP32_CODE_SHARE`` and ``FP32_8BIT_TOL`` below, and
the second step's loss against the reference ``EIGHTBIT_LOSS_TOL``, derived
from the loss's response to the first step's rounding noise; the 8-bit case
run again with a wrong first update must fail it.
"""
import contextlib
import dataclasses
import functools
import os
import re
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.data.pipeline import TrainPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ring_fused_step import plan as ring_plan  # noqa: E402
from repro_torch.launch import procs, steps, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.mesh import ProcessMesh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import parallel as P  # noqa: E402
from repro_torch.models.convert import params_from_jax, to_jax  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.adamw import (dequantize_block8, quantize_block8, shard_rows,  # noqa: E402
                                     unshard_rows)
from test_torch_tp_train import logical, subtree  # noqa: E402
from test_torch_tp_train_kinds import (EIGHTBIT, EIGHTBIT_TOL, EXPLODED_SHARE,  # noqa: E402
                                       LR_NORM_TOL, STEP_BOUND, reference_eightbit)
from test_torch_train import (LOSS_TOL, MOMENT_TOL, MOMENTS_TOL, NORM_TOL,  # noqa: E402
                              UPDATE_TOL, rel)

WORLD = 8
TIMEOUT_S = 240
JAX_WAIT_S = 200  # how long a rank waits for the reference's outputs
SEQ, SEED, STEPS = 32, 3, 2
CASES = {  # tag: (arch, mesh, scenario, global batch, microbatches)
    "native": ("qwen1_5_0_5b", (4, 2), "native", 8, 1),
    "s1_host": ("qwen1_5_0_5b", (4, 2), "s1_host", 8, 1),
    "s2_in_net": ("qwen1_5_0_5b", (4, 2), "s2_in_net", 8, 1),
    "s3_in_net_map": ("qwen1_5_0_5b", (4, 2), "s3_in_net_map", 8, 1),
    "hierarchical": ("qwen1_5_0_5b", (2, 2, 2), "hierarchical", 8, 2),
    "rep_s3": ("qwen1_5_0_5b", (1, 8), "s3_in_net_map", 3, 1),
    "granite_a2a": ("granite_moe_1b_a400m", (1, 8), "s3_in_net_map", 3, 1),
    "mamba2": ("mamba2_1_3b", (4, 2), "s3_in_net_map", 8, 1),
    "minicpm3": ("minicpm3_4b", (4, 2), "s3_in_net_map", 8, 1),
    "recurrentgemma": ("recurrentgemma_2b", (1, 8), "s3_in_net_map", 3, 1),
    "qwen2_vl": ("qwen2_vl_7b", (2, 4), "s3_in_net_map", 8, 1),
    "seamless": ("seamless_m4t_large_v2", (4, 2), "s3_in_net_map", 8, 1),
    "granite_replicated": ("granite_moe_1b_a400m", (2, 4), "s3_in_net_map", 8, 1),
    "grok_8bit": ("grok_1_314b", (4, 2), "s3_in_net_map", 8, 1),
}
# the cases on the MoE's replicated dispatch (the config's is a2a)
DISPATCH = {"granite_replicated": "replicated"}
# the same two steps computed in fp32 (``COMPUTE_DTYPE`` and the config's
# compute dtype float32, in the ranks and on world dims), held to the
# world-dim port only: (arch, mesh, scenario, global batch, microbatches)
FP32_CASES = {
    "fp32_s2": ("qwen1_5_0_5b", (4, 2), "s2_in_net", 8, 2),
    "fp32_granite": ("granite_moe_1b_a400m", (1, 8), "native", 3, 1),
    "fp32_mamba2": ("mamba2_1_3b", (4, 2), "s1_host", 8, 1),
    "fp32_recurrentgemma": ("recurrentgemma_2b", (2, 4), "s2_in_net", 8, 1),
    "fp32_grok_8bit": ("grok_1_314b", (4, 2), "s2_in_net", 8, 1),
}
# the cases with 8-bit moments: ``test_torch_tp_train_kinds.EIGHTBIT``'s AdamW
OPT8 = {tag: EIGHTBIT["grok_8bit"] for tag in ("grok_8bit", "fp32_grok_8bit")}
CKPT8 = "grok_8bit"  # its checkpoint, written by rank 0, restored both ways
# the process form against the world-dim form on the same inputs (see the
# module doc), relative: the loss, the gradient's norm, and the moments over
# the tree; in fp32 each step's loss and norm and each leaf of the first
# step's moments (normwise against the whole tree's: a leaf whose gradient
# is rounding noise, the key bias, has no relative scale of its own)
WORLD_LOSS_TOL, WORLD_NORM_TOL, WORLD_MOMENTS_TOL = 1e-4, 1e-3, 1e-2
FP32_TOL = 1e-5
# grok's dequantized 8-bit moments over the tree (per leaf against the
# reference at test_torch_tp_train_kinds' EIGHTBIT_TOL, measured 9.7e-2 on
# ln1's 64 elements; against the world-dim port, whose own noise adds, over
# the tree alone): at (4, 2) the process form is
# 4.8e-2 (m) and 5.0e-2 (v) from the reference and 4.8e-2, 4.9e-2 from the
# world-dim port, which is itself 4.2e-2 and 3.7e-2 from the reference: a
# gradient's bf16 rounding turns a code by a step of its block's absmax /
# 127. In fp32 (``fp32_grok_8bit``) the two forms' codes agree but for
# FP32_CODE_SHARE of them, each within one step (measured 36 of 40,960:
# fp32 sums in another order at a rounding tie), and the dequantized
# moments within FP32_8BIT_TOL normwise against the tree (measured 4.7e-5)
EIGHTBIT_TREE_TOL = 7.5e-2
FP32_CODE_SHARE, FP32_8BIT_TOL = 1e-2, 2e-4
# grok's second 8-bit step's loss against the reference. Its moments start
# at 0, so the first step moves about every element by lr · sign(g): the
# second loss depends on the first gradient's signs, and an element whose
# gradient is rounding noise takes ±lr in either package
# (``test_torch_tp_train_kinds``' LR_NORM_TOL). Measured on the world-dim
# port (``eightbit_response``, one 8-core CPU): from the reference's own
# first-step parameters its second loss is 6.8e-6 from the reference's (the
# second step's forward agrees); it is 1.38e-4 away from its own, and the
# process form 2.07e-4 (7.0e-5 from the world-dim port). The noise elements
# (462 of 35,104, 1.3%: those whose gradient's bf16 rounding, against the
# same gradient computed in fp32, is at least the gradient itself) with
# their first step of the other sign move the second loss by 2.13e-4. The
# bound is twice that response, rounded down; step 0 and every other case
# keep LOSS_TOL
EIGHTBIT_LOSS_TOL = 4e-4
# a wrong 8-bit process step that the bound must catch: the first update at
# FAULT_LR × lr, a tenth too long (measured on the processes 2.14e-3 from the
# reference's second loss, 5.4 × the bound)
FAULT_LR = 1.1
# the adjoint identity, relative to Σ |⟨f(x), y⟩|: fp32 sums in two orders
# (measured 7e-9 at most); S3's fetch rounds every hop's partial to bf16 on
# the wire, a relative 2^-9 each (measured 3.7e-4)
ADJOINT_TOL = {"fp32": 1e-6, "s3_in_net_map": 5e-3}
# the reference's end-to-end target on processes: qwen1.5 smoke at (4, 2)
# under S2, a failure at step 16, the survivors (ranks 0-3) on (2, 2) from
# the step-16 checkpoint to step 24 inside the same world
E2E = ["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "24", "--mesh", "4,2",
       "--scenario", "s2_in_net", "--global-batch", "8", "--seq", "32", "--microbatches", "2",
       "--ckpt-every", "8", "--fail-step", "16", "--shrink-to", "4", "--log-every", "100"]
E2E_FAIL, E2E_STEPS, E2E_SURVIVORS = 16, 24, 4
E2E_FALL = 0.02  # the mean of the last 4 losses below the first 4's, less this
# the survivors' losses after the restart against the relaunch form's, which
# takes the same steps on the same shapes in a new world, relative
E2E_RELAUNCH_TOL = 1e-5
# an 8-bit run whose restart inside the world is refused: qwen1.5 smoke at
# (4, 2), a failure at step 2 for 4 devices
EIGHTBIT_RESTART = ["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "3", "--mesh", "4,2",
                    "--global-batch", "8", "--seq", "16", "--ckpt-every", "2", "--fail-step",
                    "2", "--shrink-to", "4", "--log-every", "100", "--device", "cpu"]


def axes(dims) -> tuple[str, ...]:
    return ("data", "model") if len(dims) == 2 else ("pod", "data", "model")


def on_dispatch(cfg, tag: str):
    """``cfg`` (either package's) on the case's MoE dispatch (``DISPATCH``)."""
    if tag in DISPATCH:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=DISPATCH[tag]))
    return cfg


def case_config(tag: str):
    """A case's smoke config in the port."""
    return on_dispatch(get_smoke_config({**CASES, **FP32_CASES}[tag][0]), tag)


def world_env(tag: str):
    _, dims, sc, _, _ = CASES[tag]
    return steps.make_env(case_config(tag), make_mesh(dims, device="cpu"), sc)


# ---------------------------------------------------------------------------
# the reference (runs in the JAX subprocess)
# ---------------------------------------------------------------------------
def jax_side(tags) -> dict:
    import jax
    import jax.numpy as jnp

    import test_torch_serve as TS
    import test_torch_tp_serve as TP
    from repro.configs import get_smoke_config as ref_cfg
    from repro.data.pipeline import TrainPipeline as RefPipeline
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh as ref_mesh
    from repro.models.common import init_params
    from repro.optim.adamw import AdamW as RefAdamW

    def rows(tree):  # 8-bit moments: {path/0: codes, path/1: scales}, every device's
        paths, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
                for p, v in paths}

    out = {}
    for tag in tags:
        arch, dims, sc, gb, mb = CASES[tag]
        cfg = on_dispatch(ref_cfg(arch), tag)
        mesh = ref_mesh(dims)
        opt = RefAdamW(**OPT8[tag]) if tag in OPT8 else None
        step, env, bundle = jsteps.make_train_step(cfg, mesh, scenario=sc, global_batch=gb,
                                                   seq=SEQ, microbatches=mb, optimizer=opt)
        dtype = jnp.dtype(cfg.param_dtype)
        params = init_params(bundle["param_leafspecs"], 0, dtype, env)
        flat = TP.perturb(TS.flat_tree(params), cfg, env)
        _, treedef = jax.tree_util.tree_flatten(params)
        params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k], dtype)
                                                        for k in TS.flat_tree(params)])
        out.update({f"{tag}/param0/{k}": v for k, v in TS.flat_tree(params).items()})
        shard = jax.tree_util.tree_map(lambda p: jax.sharding.NamedSharding(mesh, p),
                                       bundle["param_partition"])
        params = jax.device_put(params, shard)
        state = bundle["init_state"](params)
        pipe = RefPipeline(cfg, env, gb, SEQ, seed=SEED)
        for k in range(STEPS):
            params, state, m = step(params, state, pipe.batch_at(k))
            for n in ("loss", "grad_norm", "lr", "ntok"):
                out[f"{tag}/{k}/{n}"] = np.asarray(m[n])
            if tag in OPT8 and k == 0:  # the parameters the second 8-bit step starts from
                out.update({f"{tag}/param1/{n}": v for n, v in TS.flat_tree(params).items()})
        out.update({f"{tag}/param/{k}": v for k, v in TS.flat_tree(params).items()})
        for what in ("m", "v"):
            tree = getattr(state, what)
            out.update({f"{tag}/{what}8/{k}": v for k, v in rows(tree).items()}
                       if tag in OPT8 else
                       {f"{tag}/{what}/{k}": v for k, v in TS.flat_tree(tree).items()})
    return out


JAX_PARTS = (("native", "s1_host", "s2_in_net", "minicpm3", "grok_8bit"),
             ("s3_in_net_map", "hierarchical", "rep_s3", "recurrentgemma", "seamless"),
             ("granite_a2a", "mamba2", "qwen2_vl", "granite_replicated"))
JAX_XLA = "--xla_backend_optimization_level=0"
JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] += " " + {xla!r}
import sys, numpy as np
sys.path.insert(0, {tests!r})
import test_torch_procs_train as T
np.savez({path!r}, **T.jax_side({tags!r}))
print("OK")
"""


@pytest.fixture(scope="module")
def spawned(multidevice, tmp_path_factory):
    """(the reference's outputs, every rank's results, the e2e's relaunch
    form's losses, the e2e's checkpoint directory, the 8-bit case's
    checkpoint directory). The ranks are spawned
    while the reference's parts run side by side; they check the
    collectives and run the e2e (its restart inside the world) meanwhile,
    then wait for the reference's npz (``_rank``). The relaunch form
    restores step 16 from a copy of the e2e's checkpoints without the
    survivors' step 24."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("jax_procs_train")
    tests = os.path.dirname(os.path.abspath(__file__))
    path = tmp / "out.npz"
    ckpt, ckpt8 = str(tmp / "ckpt"), str(tmp / "ckpt8")

    def run(i):
        part = str(tmp / f"part{i}.npz")
        assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=part, tags=JAX_PARTS[i],
                                                     xla=JAX_XLA))
        with np.load(part) as f:
            return dict(f)

    with ThreadPoolExecutor(len(JAX_PARTS) + 1) as pool:
        ranks = pool.submit(procs.spawn, functools.partial(_rank, str(path), ckpt, ckpt8), WORLD,
                            backend="gloo", device="cpu", store_path=tmp / "store",
                            timeout_s=TIMEOUT_S)
        out = {}
        try:
            for part in pool.map(run, range(len(JAX_PARTS))):
                out.update(part)
            np.savez(tmp / "out.partial.npz", **out)
            os.replace(tmp / "out.partial.npz", path)  # whole when the ranks see it
        except BaseException:
            (tmp / "out.failed").touch()  # the ranks stop waiting
            raise
        got = ranks.result()
    relaunch = str(tmp / "ckpt_relaunch")
    shutil.copytree(ckpt, relaunch, ignore=shutil.ignore_patterns(f"step_{E2E_STEPS:08d}"))
    world2 = train.spawn_run(train.relaunch_args(e2e_args(relaunch)), tmp / "store2",
                             device="cpu", timeout_s=TIMEOUT_S)
    return out, got, world2, ckpt, ckpt8


@pytest.fixture(scope="module")
def jax_out(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[1]


def e2e_args(ckpt: str):
    return train.parser().parse_args(E2E + ["--ckpt", ckpt])


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sum(a.double() * b.double()))


def function_checks(device) -> dict:
    """Each differentiable collective on this rank: (⟨f(x), y⟩, ⟨x, fᵀ(y)⟩,
    Σ|f(x)·y|) for seeded x and y of its own, fᵀ being the autograd
    backward; the test sums them over the ranks. The weight fetch on a
    plain TP leaf (FSDP dim 1, TP dim 0: the FSDP gather, then the rep
    groups') and on an FSDP-only one, under every scenario."""
    pm24 = ProcessMesh(("data", "model"), (2, 4), device=device)
    pm222 = ProcessMesh(("pod", "data", "model"), (2, 2, 2), device=device)
    gen = torch.Generator().manual_seed(100 + pm24.rank)
    out = {}

    def check(name, f, shape):
        x = torch.randn(shape, generator=gen, dtype=torch.float32).requires_grad_()
        fx = f(x)
        y = torch.randn(fx.shape, generator=gen, dtype=torch.float32)
        (gx,) = torch.autograd.grad(fx, x, grad_outputs=y)
        out[name] = (_dot(fx, y), _dot(x, gx), float(torch.sum((fx.double() * y).abs())))

    env24 = P.ShardEnv(4, 2, tp=2, mesh=pm24)  # tp 2, rep 2
    block = pm24.block
    check("psum/tp_groups", lambda x: P.psum(x, pm24, "model", env24.tp_groups), block + (3, 5))
    check("psum/data", lambda x: P.psum(x, pm24, "data"), block + (7,))
    check("psum/tp_sum", env24.tp_sum, (4, 3))
    check("all_gather/rep_groups", lambda x: P.all_gather(x, pm24, "model",
                                                          groups=env24.rep_groups), block + (3, 2))
    check("all_gather/data_tiled", lambda x: P.all_gather(x, pm24, "data", tiled=True),
          block + (4, 3))
    check("all_to_all/tp_groups", lambda x: P.all_to_all(x, pm24, "model", 0, 0,
                                                         groups=env24.tp_groups), block + (2, 3))
    check("all_to_all/model_tiled", lambda x: P.all_to_all(x, pm24, "model", 1, 0, tiled=True),
          block + (3, 8))
    for sc in ("native", "s1_host", "s2_in_net", "s3_in_net_map", "hierarchical"):
        for pm in (pm24, pm222):
            env = steps.make_env(get_smoke_config("qwen1_5_0_5b"), pm, sc)
            where = "x".join(map(str, pm.shape))
            check(f"fetch/{sc}/{where}/tp", lambda w, env=env: P.fetch_weight(
                w, env, P.LeafPlace(1, 0, 0)), (6, 8))
            check(f"fetch/{sc}/{where}/fsdp", lambda w, env=env: P.fetch_weight(
                w, env, P.NORM), (6,))
    return out


@contextlib.contextmanager
def computing(dtype):
    """The models' matmuls and activations in ``dtype`` (bf16: as they are)."""
    from repro_torch.models import attention, layers

    with contextlib.ExitStack() as stack:
        if dtype != torch.bfloat16:
            for mod in (P, layers, attention):
                stack.enter_context(mock.patch.object(mod, "COMPUTE_DTYPE", dtype))
        yield


def case_model(tag: str, mesh, jax_out: dict | None, device):
    """A case's config, and its model on ``mesh`` (world dims or this
    process's), from the reference's parameters or, for an fp32 case,
    seeded."""
    _, dims, sc, gb, mb = {**CASES, **FP32_CASES}[tag]
    cfg = case_config(tag)
    if tag in FP32_CASES:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    env = steps.make_env(cfg, mesh, sc)
    if jax_out is None:
        return cfg, M.Model(cfg, device=device, seed=1, env=env)
    return cfg, params_from_jax(subtree(jax_out, f"{tag}/param0/"), cfg, env=env, device=device)


def two_steps(tag: str, mesh, jax_out: dict | None, device, gather, after=None,
              lr_scale: float = 1.0) -> dict:
    """A case's two steps on ``mesh``: each step's metrics and S3 hops
    (``ring_fused_step``'s plain version counted, and the hops whose ``acc``
    is a view of its ring's chunked gradient that the kernel's wrapper plans
    to read without a copy), ``ring_hops()``, and the
    first step's moments and the second's parameters and moments through
    ``gather`` (``gather(model, step, tree)`` → {JAX leaf path: numpy}; 8-bit
    moments: {JAX leaf path: (codes, scales)} in the world-dim rows). With
    8-bit moments also the world-dim rows of the starting parameters
    quantized through the step's layout (``probe``: the layout alone), and
    the world-dim step's ``layout`` and stacked shapes. ``after(step,
    state)``: what else to return, after the steps. ``lr_scale``: an 8-bit
    case's lr times this (a deliberate fault)."""
    _, dims, sc, gb, mb = {**CASES, **FP32_CASES}[tag]
    cfg, model = case_model(tag, mesh, jax_out, device)
    step = steps.make_train_step(model, mesh, scenario=sc, global_batch=gb, seq=SEQ,
                                 microbatches=mb, optimizer=eightbit_opt(tag, lr_scale))
    extra = {}
    if step.stacked:
        tree = step.opt_tree(step.params)
        extra = {"probe": gather(model, step, {k: quantize_block8(shard_rows(
            t.to(torch.float32), step.layout.get(k))) for k, t in tree.items()}),
            "layout": step.layout, "shapes": {k: tuple(t.shape) for k, t in tree.items()}}
    state = step.init_state()
    pipe = TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED)
    real, hops, in_place, metrics = ops.ring_fused_step, [], [], []
    real_ring, rings = coll.ring_reduce_scatter, []
    dtype = torch.float32 if tag in FP32_CASES else torch.bfloat16

    def ring(x, *args, **kw):
        rings.append(x)
        return real_ring(x, *args, **kw)

    for k in range(STEPS):
        hops.append(0)
        in_place.append(0)

        def counted(acc, wire):
            hops[-1] += 1
            # a view of its ring's chunked gradient that the kernel reads as it lies
            in_place[-1] += (acc.untyped_storage().data_ptr()
                             == rings[-1].untyped_storage().data_ptr()
                             and ring_plan(acc.shape, acc.stride(), wire.stride()).route
                             != "copy")
            return real(acc, wire)

        with (mock.patch.object(ops, "ring_fused_step", counted),
              mock.patch.object(coll, "ring_reduce_scatter", ring), computing(dtype)):
            state, m = step(state, pipe.batch_at(k))
        metrics.append({n: float(m[n]) for n in ("loss", "grad_norm", "lr", "ntok")})
        if k == 0:
            m1 = gather(model, step, state.m)
    return {"metrics": metrics, "hops": hops, "in_place": in_place,
            "ring_hops": step.ring_hops(), "m1": m1,
            "param": gather(model, step, step.params), "m": gather(model, step, state.m),
            "v": gather(model, step, state.v), **extra,
            **({} if after is None else {"after": after(step, state)})}


def eightbit_opt(tag: str, lr_scale: float = 1.0):
    """A case's AdamW with 8-bit moments (``OPT8``) at ``lr_scale`` × its
    lr; None for the others (the step's default)."""
    if tag not in OPT8:
        return None
    return AdamW(**{**OPT8[tag], "lr": OPT8[tag]["lr"] * lr_scale})


def moments_round_trip(tag: str, pm, jax_out: dict, device) -> dict:
    """The reference's moments after a case's steps loaded as this rank's
    shards (``convert.opt_state_from_jax`` under its process mesh's env)
    and gathered back into whole leaves (rank 0's)."""
    cfg, model = case_model(tag, pm, jax_out, device)
    state = convert.opt_state_from_jax({"count": STEPS, "m": subtree(jax_out, f"{tag}/m/"),
                                        "v": subtree(jax_out, f"{tag}/v/")}, model)
    step = steps.make_train_step(model, pm, global_batch=CASES[tag][3], seq=SEQ)
    return {"count": state.count, "m": gathered(model, step, state.m),
            "v": gathered(model, step, state.v)}


def numpy_rows(tree: dict) -> dict:
    """8-bit moments' (codes, scales) rows as numpy pairs."""
    return {k: tuple(t.numpy() for t in pair) for k, pair in tree.items()}


def gathered(model, step, tree: dict) -> dict:
    """This rank's shards of ``tree`` (named as the parameters) gathered into
    whole leaves in the reference's storage layout, or its 8-bit rows ({JAX
    leaf path: (codes, scales)}) into the world-dim rows, numpy, on rank 0
    ({} elsewhere)."""
    if isinstance(next(iter(tree.values())), tuple):
        return numpy_rows(train.gather_rows(step, tree))
    got = convert.gather_shards(convert.stack_leaves(model, tree), model.cfg, step.env)
    return {k: v.to(torch.float32).numpy() for k, v in got.items()}


def held(model, step, tree: dict) -> dict:
    """A world-dim step's tensors as the JAX tree's logical leaves, fp32
    (8-bit rows as they are)."""
    if isinstance(next(iter(tree.values())), tuple):
        return numpy_rows(tree)
    return {k: np.asarray(v, np.float32) for k, v in to_jax(model, tree).items()}


def eightbit_checkpoint(directory: str, meshes: dict, device):
    """``after`` of an 8-bit case in the ranks: its checkpoint, gathered and
    written by rank 0 (``train.save``), restored in every rank of the same
    world into a model from other weights: the step, and whether the
    parameters, the (codes, scales) rows and the count came back bitwise;
    and the message of a restore on the world's other mesh, (2, 4)."""
    def after(step, state):
        store = CheckpointStore(directory)
        train.save(store, STEPS, step, state, blocking=True)
        torch.distributed.barrier()
        cfg = step.model.cfg

        def fresh(pm):
            model = M.Model(cfg, device=device, seed=5, env=steps.make_env(cfg, pm))
            return steps.make_train_step(model, pm, scenario=step.scenario,
                                         global_batch=step.global_batch, seq=SEQ,
                                         optimizer=step.optimizer)

        again = fresh(step.pmesh)
        got, at = train.restore(again, store)
        out = {"at": at, "count": got.count == state.count,
               "params": all(torch.equal(p, again.params[k]) for k, p in step.params.items()),
               "moments": all(torch.equal(a, b) for what in ("m", "v")
                              for k, pair in getattr(state, what).items()
                              for a, b in zip(pair, getattr(got, what)[k]))}
        other = meshes.setdefault((2, 4), ProcessMesh(axes((2, 4)), (2, 4), device=device))
        try:
            train.restore(fresh(other), store)
            out["other_mesh"] = None
        except ValueError as e:
            out["other_mesh"] = f"ValueError: {e}"
        return out

    return after


def refusals(device, ckpt: str) -> dict:
    """The messages of what training on a process mesh refuses: among them
    the restart inside the world of an 8-bit run (``EIGHTBIT_RESTART``,
    checkpoints in ``ckpt``), refused on every rank before any leaves."""
    pm = ProcessMesh(("data", "model"), (4, 2), device=device)
    cfg = get_smoke_config("qwen1_5_0_5b")
    model = M.Model(cfg, device=device, seed=0, env=steps.make_env(cfg, pm))
    cases = {
        "flash": lambda: steps.make_train_step(model, pm, impl="flash", global_batch=8, seq=SEQ),
        "world_model": lambda: steps.make_train_step(
            M.Model(cfg, device=device, seed=0, env=steps.make_env(cfg, pm).world()), pm,
            global_batch=8, seq=SEQ),
        "eightbit_restart": lambda: train.run(train.parser().parse_args(
            EIGHTBIT_RESTART + ["--ckpt", ckpt]), optimizer=AdamW(eightbit=True)),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _rank(path: str, ckpt: str, ckpt8: str, device) -> dict:
    """This rank's part of the file (``spawned``): the collectives' checks,
    the refusals, the e2e (ranks 0-3 restart inside the world and train on;
    the others return at the failure), then every case once the
    reference's npz at ``path`` is written, the 8-bit one's checkpoint in
    ``ckpt8``."""
    torch.set_num_threads(1)
    res = {"functions": function_checks(device),
           "refusals": refusals(device, f"{ckpt8}_restart")}
    t = time.perf_counter()
    res["e2e"] = train.run(train.parser().parse_args(E2E + ["--ckpt", ckpt, "--device", "cpu"]))
    res["e2e_s"] = time.perf_counter() - t
    failed = os.path.join(os.path.dirname(path), "out.failed")
    deadline = time.monotonic() + JAX_WAIT_S
    while not os.path.exists(path):
        if os.path.exists(failed) or time.monotonic() > deadline:
            raise RuntimeError("the reference's outputs never came")
        time.sleep(0.1)
    with np.load(path) as f:
        jax_out = dict(f)
    meshes = {}
    for tag, (_, dims, _, _, _) in {**CASES, **FP32_CASES}.items():
        pm = meshes.setdefault(dims, ProcessMesh(axes(dims), dims, device=device))
        after = eightbit_checkpoint(ckpt8, meshes, device) if tag == CKPT8 else None
        res[tag] = two_steps(tag, pm, None if tag in FP32_CASES else jax_out, device, gathered,
                             after)
        if after is not None:
            res["refusals"]["eightbit_other_mesh"] = res[tag]["after"].pop("other_mesh")
    res["round_trip"] = moments_round_trip("granite_a2a", meshes[CASES["granite_a2a"][1]],
                                           jax_out, device)
    res["fault"] = two_steps(CKPT8, meshes[CASES[CKPT8][1]], jax_out, device, gathered,
                             lr_scale=FAULT_LR)["metrics"]
    return res


# ---------------------------------------------------------------------------
# the world-dim port on the same inputs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(jax_out):
    """Every case on the world-dim port from the same parameters and batches."""
    return {tag: two_steps(tag, make_mesh(dims, device="cpu"),
                           None if tag in FP32_CASES else jax_out, "cpu", held)
            for tag, (_, dims, _, _, _) in {**CASES, **FP32_CASES}.items()}


@pytest.fixture(scope="module")
def eightbit_response(jax_out):
    """The 8-bit case (``CKPT8``) on the world-dim port from the
    reference's parameters: its two losses; its second loss from the
    reference's own first-step parameters (``param1``); and from its own
    first step with the noise elements' first step of the other sign: the
    elements whose gradient's bf16 rounding (the first gradient as the
    step computes it, against the same computed in fp32) is at least the
    gradient itself. Returns those losses and the count of noise elements
    and of all elements."""
    tag = CKPT8
    _, dims, sc, gb, mb = CASES[tag]

    def built():
        mesh = make_mesh(dims, device="cpu")
        cfg, model = case_model(tag, mesh, jax_out, "cpu")
        step = steps.make_train_step(model, mesh, scenario=sc, global_batch=gb, seq=SEQ,
                                     microbatches=mb, optimizer=eightbit_opt(tag))
        return step, TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED)

    def gradient(dtype):
        step, pipe = built()
        with computing(dtype):
            grads = step.aggregate(step.rank_gradients(pipe.batch_at(0))[0])
        return {k: g.to(torch.float32) for k, g in grads.items()}

    def losses(first=None):
        """The two losses; ``first(p0, p1)`` gives the parameters the
        second step starts from."""
        step, pipe = built()
        p0 = {k: p.detach().clone() for k, p in step.params.items()}
        state, m0 = step(step.init_state(), pipe.batch_at(0))
        if first is not None:
            new = first(p0, step.params)
            with torch.no_grad():
                for k, p in step.params.items():
                    p.copy_(new[k])
            step.model.cast_weights()
        _, m1 = step(state, pipe.batch_at(1))
        return float(m0["loss"]), float(m1["loss"])

    step, _ = built()
    ref1 = dict(params_from_jax(subtree(jax_out, f"{tag}/param1/"), step.model.cfg, env=step.env,
                                device="cpu").named_parameters())
    g16, g32 = gradient(torch.bfloat16), gradient(torch.float32)
    noise = {k: (g16[k] - g32[k]).abs() >= g32[k].abs() for k in g32}

    def other_sign(p0, p1):
        return {k: torch.where(noise[k], (2 * p0[k].float() - p1[k].float()).to(p.dtype), p)
                for k, p in p1.items()}

    return {"own": losses(),
            "from_reference": losses(lambda p0, p1: {k: ref1[k].detach() for k in p1}),
            "noise_flipped": losses(other_sign),
            "noise": sum(int(v.sum()) for v in noise.values()),
            "elements": sum(v.numel() for v in noise.values())}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
def moments_close(got: dict, want: dict, leaf_tol: float | None, tree_tol: float, what: str
                  ) -> None:
    """Moments (logical leaves) within ``leaf_tol`` per leaf and
    ``tree_tol`` over the tree, relative."""
    if leaf_tol is not None:
        worst = max((rel(got[k], w), k) for k, w in want.items())
        assert worst[0] <= leaf_tol, (what, worst)
    whole = [np.concatenate([t[k].ravel() for k in want]) for t in (got, want)]
    assert rel(*whole) <= tree_tol, (what, rel(*whole))


def params_close(got: dict, want: dict, p0: dict, lrs: list, what: str) -> None:
    """Each parameter within two steps of lr of ``want``, the update
    within ``UPDATE_TOL`` normwise."""
    step_atol = 2 * sum(lrs) * 1.01
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=step_atol, err_msg=f"{what} {k}")
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    assert rel(d_got, d_want) <= UPDATE_TOL, what


def rank_metrics(ranks, tag: str) -> list:
    """Rank 0's metrics of a case, which every rank's equal (psum'd)."""
    for r in ranks:
        assert r[tag]["metrics"] == ranks[0][tag]["metrics"], tag
    return ranks[0][tag]["metrics"]


def dequantized(rows: dict, world_case: dict) -> dict:
    """8-bit (codes, scales) rows in the world-dim layout → the logical
    stacked leaves, fp32 (the world-dim step's ``layout`` and shapes)."""
    shapes, layout = world_case["shapes"], world_case["layout"]
    out = {}
    for k, (c, sc) in rows.items():
        c, sc = torch.from_numpy(c), torch.from_numpy(sc)
        n = int(np.prod(shapes[k])) // c.shape[0]
        out[k] = unshard_rows(dequantize_block8(c, sc, n), shapes[k], layout[k]).numpy()
    return out


def eightbit_params_close(got: dict, want: dict, p0: dict, lrs: list, v_rows: tuple,
                          what: str) -> None:
    """``test_torch_tp_train_kinds``' comparison of parameters after 8-bit
    steps: where both updates are within ``STEP_BOUND`` steps of lr, within
    two steps of lr and ``UPDATE_TOL`` normwise; the others few
    (``EXPLODED_SHARE``), each with a v code at 0 in ``v_rows``' one or
    other dequantized moments."""
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    ok = (np.abs(d_got) <= STEP_BOUND * sum(lrs)) & (np.abs(d_want) <= STEP_BOUND * sum(lrs))
    v_zero = np.concatenate([((v_rows[0][k] == 0) | (v_rows[1][k] == 0)).ravel() for k in want])
    assert (~ok).mean() <= EXPLODED_SHARE, (what, (~ok).mean())
    assert v_zero[~ok].all(), (what, (~ok & ~v_zero).sum())
    np.testing.assert_allclose(d_got[ok], d_want[ok], rtol=0, atol=2 * sum(lrs) * 1.01,
                               err_msg=what)
    assert rel(d_got[ok], d_want[ok]) <= UPDATE_TOL, what


@pytest.mark.parametrize("tag", list(CASES))
def test_train_on_processes_matches_reference(ranks, world, jax_out, tag):
    """Two steps on every rank from its shard: each step's loss, gradient
    norm, lr and ``ntok`` (psum'd over the mesh, every rank the same), the
    moments and parameters gathered back, as the reference's and as the
    world-dim port's. The gathered kv and expert slots read back to logical
    leaves only where their copies are equal (``from_slots`` refuses
    others): ``sync_gradients`` kept them in sync. 8-bit moments (grok)
    are compared as ``test_torch_tp_train_kinds`` compares them: dequantized
    per leaf within ``EIGHTBIT_TOL``, the second step's norm within
    ``LR_NORM_TOL``, its loss within ``EIGHTBIT_LOSS_TOL``, the parameters
    where no v code at 0 decides the step; against the world-dim port so
    too, the loss at ``LOSS_TOL``."""
    cfg, env = case_config(tag), world_env(tag)
    eight = tag in OPT8
    for k, got in enumerate(rank_metrics(ranks, tag)):
        want = {n: float(jax_out[f"{tag}/{k}/{n}"]) for n in ("loss", "grad_norm", "lr", "ntok")}
        w = world[tag]["metrics"][k]
        norm_tol = LR_NORM_TOL if eight and k else NORM_TOL
        ref_loss_tol = EIGHTBIT_LOSS_TOL if eight and k else LOSS_TOL
        assert abs(got["loss"] - want["loss"]) <= ref_loss_tol * want["loss"], (k, got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= norm_tol * want["grad_norm"], \
            (k, got, want)
        assert abs(got["lr"] - want["lr"]) <= 1e-6 * want["lr"]
        assert int(got["ntok"]) == want["ntok"] == int(w["ntok"])
        loss_tol, norm_tol = (LOSS_TOL, norm_tol) if eight else (WORLD_LOSS_TOL, WORLD_NORM_TOL)
        assert abs(got["loss"] - w["loss"]) <= loss_tol * w["loss"], (k, got, w)
        assert abs(got["grad_norm"] - w["grad_norm"]) <= norm_tol * w["grad_norm"], (k, got, w)
    mine = ranks[0][tag]
    lrs = [m["lr"] for m in mine["metrics"]]
    got = logical(mine["param"], cfg, env)
    p0 = logical(subtree(jax_out, f"{tag}/param0/"), cfg, env)
    want = logical(subtree(jax_out, f"{tag}/param/"), cfg, env)
    if eight:
        stepish = SimpleNamespace(env=env, model=SimpleNamespace(cfg=cfg))
        v = {}
        for what in ("m", "v"):
            mom = dequantized(mine[what], world[tag])
            ref = reference_eightbit(jax_out, tag, what, stepish)
            wd = dequantized(world[tag][what], world[tag])
            v[what] = (mom, ref, wd)
            moments_close(mom, ref, EIGHTBIT_TOL, EIGHTBIT_TREE_TOL, f"{what} vs reference")
            moments_close(mom, wd, None, EIGHTBIT_TREE_TOL, f"{what} vs world-dim")
        eightbit_params_close(got, want, p0, lrs, v["v"][:2], "vs reference")
        eightbit_params_close(got, world[tag]["param"], p0, lrs, v["v"][::2], "vs world-dim")
        return
    for what in ("m", "v"):
        mom = logical(mine[what], cfg, env)
        moments_close(mom, logical(subtree(jax_out, f"{tag}/{what}/"), cfg, env), MOMENT_TOL,
                      MOMENTS_TOL, f"{what} vs reference")
        moments_close(mom, world[tag][what], None, WORLD_MOMENTS_TOL, f"{what} vs world-dim")
    params_close(got, want, p0, lrs, "vs reference")
    params_close(got, world[tag]["param"], p0, lrs, "vs world-dim")


def test_eightbit_second_loss_gap_is_the_first_step(eightbit_response, jax_out):
    """The 8-bit case's second loss is off the reference's by its first
    step's parameters alone: the world-dim port started from the
    reference's own first-step parameters gives the reference's second loss
    within ``LOSS_TOL``, the bf16 forward's bound (measured 6.8e-6)."""
    want = float(jax_out[f"{CKPT8}/1/loss"])
    got = eightbit_response["from_reference"][1]
    assert abs(got - want) <= LOSS_TOL * want, (got, want)


def test_eightbit_loss_bound_is_twice_the_noise_response(eightbit_response):
    """``EIGHTBIT_LOSS_TOL`` against the response it was derived from: the
    second loss moved by the noise elements' first step of the other sign
    (measured 2.13e-4 with 1.3% of the elements noise) lies within the
    bound, and the bound within three times it."""
    r = eightbit_response
    own = r["own"][1]
    response = abs(r["noise_flipped"][1] - own) / own
    assert 0 < r["noise"] <= 0.05 * r["elements"], (r["noise"], r["elements"])
    assert response <= EIGHTBIT_LOSS_TOL <= 3 * response, response


def test_wrong_eightbit_process_step_fails_the_bound(ranks, jax_out):
    """A wrong 8-bit step on the processes, the first update at
    ``FAULT_LR`` × lr: its first loss is the reference's within
    ``LOSS_TOL`` (the fault comes after it), its second beyond
    ``EIGHTBIT_LOSS_TOL``."""
    got = ranks[0]["fault"]
    want = [float(jax_out[f"{CKPT8}/{k}/loss"]) for k in range(STEPS)]
    assert abs(got[0]["loss"] - want[0]) <= LOSS_TOL * want[0], (got, want)
    assert abs(got[1]["loss"] - want[1]) > EIGHTBIT_LOSS_TOL * want[1], (got, want)


@pytest.mark.parametrize("tag", list(FP32_CASES))
def test_fp32_train_on_processes_matches_world_dims(ranks, world, tag):
    """The same steps computed in fp32, where the two forms differ only in
    the order of fp32 sums: each step's loss and gradient norm, and every
    leaf of the first step's moments (0.1 × the aggregated, clipped
    gradient), normwise against the tree's, within ``FP32_TOL``. A
    transpose that were off (a psum's backward, a sequence all-gather's, the
    MoE's all-to-all's, a scenario's reduce-scatter) would show here far
    above rounding."""
    arch, dims, sc, gb, mb = FP32_CASES[tag]
    for got, w in zip(rank_metrics(ranks, tag), world[tag]["metrics"]):
        assert int(got["ntok"]) == int(w["ntok"])
        for n in ("loss", "grad_norm"):
            assert abs(got[n] - w[n]) <= FP32_TOL * w[n], (n, got, w)
    env = steps.make_env(get_smoke_config(arch), make_mesh(dims, device="cpu"), sc)
    if tag in OPT8:
        eightbit_fp32_close(ranks[0][tag], world[tag])
        return
    got, want = logical(ranks[0][tag]["m1"], get_smoke_config(arch), env), world[tag]["m1"]
    scale = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in want.values()))
    worst = max((float(np.linalg.norm(got[k] - v)) / scale, k) for k, v in want.items())
    assert worst[0] <= FP32_TOL, worst


def eightbit_fp32_close(mine: dict, want: dict) -> None:
    """8-bit moments computed in fp32 in both forms, after each step (the
    first step's m, the second's m and v): the codes of every row equal but
    for ``FP32_CODE_SHARE`` of them, each within one step, and the
    dequantized moments within ``FP32_8BIT_TOL`` per leaf normwise against
    the tree's."""
    for what in ("m1", "m", "v"):
        codes = [np.concatenate([t[what][k][0].ravel().astype(np.int32) for k in want[what]])
                 for t in (mine, want)]
        assert np.abs(codes[0] - codes[1]).max() <= 1, what
        share = (codes[0] != codes[1]).mean()
        assert share <= FP32_CODE_SHARE, (what, share)
        got, ref = dequantized(mine[what], want), dequantized(want[what], want)
        scale = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in ref.values()))
        worst = max((float(np.linalg.norm(got[k] - v)) / scale, k) for k, v in ref.items())
        assert worst[0] <= FP32_8BIT_TOL, (what, worst)


def test_reference_moments_load_as_shards(ranks, jax_out):
    """granite-moe's moments as the reference stores them (kv heads and
    experts in their slots) load into every rank's shards and gather back
    to the same leaves, bitwise."""
    got = ranks[0]["round_trip"]
    assert got["count"] == STEPS
    for what in ("m", "v"):
        want = subtree(jax_out, f"granite_a2a/{what}/")
        assert set(got[what]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[what][k], v, err_msg=f"{what} {k}")


@pytest.mark.parametrize("tag", list(CASES))
def test_s3_hops_are_ring_fused_steps(ranks, tag):
    """Under S3 every rank ran ``ring_fused_step`` (its plain version on the
    CPU) once a ring hop of its fetches' backward: ``ring_hops()``, the data
    rings' and the rep groups'; under another scenario never."""
    sc = CASES[tag][2]
    for r in ranks:
        want = r[tag]["ring_hops"] if sc == "s3_in_net_map" else 0
        assert r[tag]["hops"] == [want] * STEPS
    if sc == "s3_in_net_map":
        assert ranks[0][tag]["ring_hops"] > 0


@pytest.mark.parametrize("tag", [t for t in CASES if CASES[t][2] == "s3_in_net_map"])
def test_s3_hops_read_the_chunked_gradient_in_place(ranks, tag):
    """On a process mesh every S3 hop's ``acc`` shares storage with the
    chunked gradient its ring reduce-scatters (the ring's chunk index is on
    the host, so no gather copies it), and ``ring_fused_step``'s wrapper
    plans to read it as it lies; the ring's results are held to the
    reference and to world dims by the tests above."""
    assert ranks[0][tag]["hops"][0] > 0
    for r in ranks:
        assert r[tag]["in_place"] == r[tag]["hops"]


def test_collectives_backward_is_the_transpose(ranks):
    """Every differentiable collective's backward is its transpose over the
    ranks (Σ_r ⟨f(x)_r, y_r⟩ = Σ_r ⟨x_r, fᵀ(y)_r⟩): psum → psum, the
    activation all-gather → reduce-scatter, all-to-all → the inverse one,
    and the weight fetch → the scenario's reduce-scatter (S3 to its bf16
    wire's rounding)."""
    names = ranks[0]["functions"]
    assert len(names) == 7 + 5 * 2 * 2
    for name in names:
        fy, xg, scale = (sum(r["functions"][name][i] for r in ranks) for i in range(3))
        tol = ADJOINT_TOL["s3_in_net_map" if "s3_in_net_map" in name else "fp32"]
        assert abs(fy - xg) <= tol * scale, (name, fy, xg, scale)


@pytest.mark.parametrize("name,match", [
    ("flash", "no backward"),
    ("world_model", "made for"),
    ("eightbit_other_mesh", "8-bit moments of step 2 were cut per device shard at world 4 "
                            r"\(mesh \[4, 2\]\) and do not restore at world 2 \(mesh \[2, 4\]\)"),
    ("eightbit_restart", "8-bit moments of step 2 were cut per device shard at world 4 "
                         r"\(mesh \[4, 2\]\) and do not restore at world 2 \(mesh \[2, 2\]\)")])
def test_process_training_refuses(ranks, name, match):
    for r in ranks:
        assert r["refusals"][name] is not None and re.search(match, r["refusals"][name]), \
            r["refusals"][name]


@pytest.mark.parametrize("tag", list(OPT8))
def test_eightbit_rows_take_the_world_dim_layout(ranks, world, tag):
    """Each process quantizes the blocks of its device's shard of the
    stacked leaf: the starting parameters quantized through the process
    step's layout (one row, no cut) and gathered (``train.gather_rows``)
    are the world-dim step's rows of the same mesh, bitwise, row for row;
    the moments after the steps take the same rows and blocks."""
    mine, want = ranks[0][tag], world[tag]
    assert set(mine["probe"]) == set(want["probe"]) == set(want["shapes"])
    for k, (c, sc) in want["probe"].items():
        np.testing.assert_array_equal(mine["probe"][k][0], c, err_msg=k)
        np.testing.assert_array_equal(mine["probe"][k][1], sc, err_msg=k)
    assert any(c.shape[0] > 1 for c, _ in want["probe"].values())  # leaves cut in rows
    for what in ("m", "v"):
        for k, (c, sc) in want[what].items():
            assert mine[what][k][0].shape == c.shape and mine[what][k][1].shape == sc.shape, k


def test_eightbit_process_checkpoint_restores_on_both_forms(spawned, tmp_path):
    """Rank 0's 8-bit checkpoint restores in every rank of the same world,
    into a model from other weights, bitwise; and in the world-dim step of
    the same mesh: the parameters and the (codes, scales) rows are the
    processes' bitwise, and written again from there they are the same
    files, byte for byte. On another mesh's world dims it raises (on the
    processes: ``test_process_training_refuses``)."""
    _, ranks_, _, _, ckpt8 = spawned
    tag = CKPT8
    for r in ranks_:
        assert r[tag]["after"] == {"at": STEPS, "count": True, "params": True, "moments": True}
    _, dims, sc, gb, mb = CASES[tag]
    cfg = case_config(tag)

    def world_step(shape):
        mesh = make_mesh(shape, device="cpu")
        model = M.Model(cfg, device="cpu", seed=5, env=steps.make_env(cfg, mesh, sc))
        return steps.make_train_step(model, mesh, scenario=sc, global_batch=gb, seq=SEQ,
                                     microbatches=mb, optimizer=AdamW(**OPT8[tag]))

    step = world_step(dims)
    state, at = train.restore(step, CheckpointStore(ckpt8))
    assert at == STEPS and state.count == STEPS
    mine = ranks_[0][tag]
    for k, v in train.checkpoint_tree(step, state)["params"].items():
        np.testing.assert_array_equal(v.to(torch.float32).numpy(), mine["param"][k], err_msg=k)
    for what in ("m", "v"):
        for k, pair in numpy_rows(getattr(state, what)).items():
            for a, b in zip(pair, mine[what][k]):
                np.testing.assert_array_equal(a, b, err_msg=(what, k))
    again = CheckpointStore(str(tmp_path))
    train.save(again, STEPS, step, state, blocking=True)
    theirs = CheckpointStore(ckpt8).manifest()
    ours = again.manifest()
    assert ours["leaves"] == theirs["leaves"] and ours["meta"] == theirs["meta"]
    for leaf in theirs["leaves"].values():
        a = os.path.join(ckpt8, f"step_{STEPS:08d}", leaf["file"])
        b = os.path.join(str(tmp_path), f"step_{STEPS:08d}", leaf["file"])
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), leaf["file"]
    with pytest.raises(ValueError, match="do not restore at world 2"):
        train.restore(world_step((2, 4)), CheckpointStore(ckpt8))


def test_e2e_restart_on_processes(spawned):
    """The reference's end-to-end target on gloo processes: qwen1.5 smoke at
    (4, 2) under S2; at the failure at step 16, once the checkpoint is
    written, ranks 0-3 restore step 16 on (2, 2) over a group of their own
    and run to 24 in the same processes, and ranks 4-7 return the 16
    losses they took: the loss falls by more than ``E2E_FALL``, the four
    survivors agree, and their losses after the restart are the relaunch
    form's (a new world of 4 from the same checkpoint) within
    ``E2E_RELAUNCH_TOL``."""
    _, ranks_, world2, ckpt, _ = spawned
    losses = ranks_[0]["e2e"]
    assert len(losses) == E2E_STEPS and len(world2) == E2E_STEPS - E2E_FAIL
    assert all(r["e2e"] == losses for r in ranks_[:E2E_SURVIVORS])
    assert all(r["e2e"] == losses[:E2E_FAIL] for r in ranks_[E2E_SURVIVORS:])
    for got, want in zip(losses[E2E_FAIL:], world2):
        assert abs(got - want) <= E2E_RELAUNCH_TOL * want, (losses[E2E_FAIL:], world2)
    a, b = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    assert b < a - E2E_FALL, (a, b)
    meta = CheckpointStore(ckpt).manifest()["meta"]
    assert meta["mesh"] == [2, 2] and meta["tp"] == 2
    assert CheckpointStore(ckpt).latest_step() == E2E_STEPS


def test_process_checkpoint_restores_on_world_dims(spawned):
    """The step-16 checkpoint that the processes wrote (rank 0, the gathered
    whole leaves) restores in the world-dim port on (2, 2), whose step 16
    is then the new world's to ``WORLD_LOSS_TOL``; and the reference's store
    reads it into the reference's parameter tree of that mesh: every leaf's
    global shape (the vocab padded, kv heads in their slots)."""
    _, _, world2, ckpt, _ = spawned
    args = train.relaunch_args(e2e_args(ckpt))
    cfg = get_smoke_config("qwen1_5_0_5b")
    mesh = make_mesh((2, 2), device="cpu")
    model = M.Model(cfg, device="cpu", seed=0, env=steps.make_env(cfg, mesh))
    step, pipe = train.build(model, mesh, args)
    state, k = train.restore(step, CheckpointStore(ckpt), at=16)
    assert k == 16 and state.count == 16
    _, m = step(state, pipe.batch_at(16))
    assert abs(float(m["loss"]) - world2[0]) <= WORLD_LOSS_TOL * world2[0]

    import jax

    from repro.checkpoint.store import CheckpointStore as RefStore
    from repro.models import model as JM
    from repro.models.common import LeafSpec
    from repro.models.parallel import ShardEnv as RefEnv

    specs = JM.param_specs(get_ref_config(), RefEnv(model_size=2, data_size=2, tp=2))
    template = jax.tree_util.tree_map(lambda s: np.zeros(()), specs,
                                      is_leaf=lambda v: isinstance(v, LeafSpec))
    tree, manifest = RefStore(ckpt).restore({"params": template}, step=16)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda v: isinstance(v, LeafSpec))
    got = dict(jax.tree_util.tree_flatten_with_path(tree["params"])[0])
    for path, ls in leaves:
        assert tuple(got[path].shape) == tuple(ls.shape), path
    assert manifest["meta"]["mesh"] == [4, 2]


def get_ref_config():
    from repro.configs import get_smoke_config as ref_cfg

    return ref_cfg("qwen1_5_0_5b")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
# (arch, mesh, global batch, 8-bit moments) of the card's cases
CARD_CASES = {"qwen1.5": ("qwen1_5_0_5b", (2, 2), 4, False),
              "seamless": ("seamless_m4t_large_v2", (2, 2), 4, False),
              "qwen1.5_8bit": ("qwen1_5_0_5b", (2, 2), 4, True)}


def card_step(tag: str, mesh, device):
    arch, _, gb, eightbit = CARD_CASES[tag]
    cfg = get_smoke_config(arch)
    model = M.Model(cfg, device=device, seed=1, env=steps.make_env(cfg, mesh, "s3_in_net_map"))
    step = steps.make_train_step(model, mesh, scenario="s3_in_net_map", global_batch=gb, seq=SEQ,
                                 optimizer=AdamW(eightbit=eightbit))
    return cfg, step


def _card_rank(tag, device):
    _, dims, gb, _ = CARD_CASES[tag]
    cfg, step = card_step(tag, ProcessMesh(("data", "model"), dims, device=device), device)
    ops.reset_launches()
    _, m = step(step.init_state(), TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED).batch_at(0))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "launches": ops.LAUNCHES["ring_fused_step"], "hops": step.ring_hops()}


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(CARD_CASES))
def test_process_training_on_the_card_matches_the_world_dim_port(tmp_path, tag):
    """A smoke config at (2, 2) on 4 gloo ranks staged through host memory
    on one card, one S3 step (qwen1.5; seamless's enc-dec; qwen1.5 with
    8-bit moments): the loss and gradient norm as the world-dim step's on
    the card, and every rank's ``ring_fused_step`` launches (the kernel)
    equal to its ring hops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    from repro_torch.kernels import _build

    _build.build_all()
    _, dims, gb, _ = CARD_CASES[tag]
    got = procs.spawn(functools.partial(_card_rank, tag), dims[0] * dims[1], backend="gloo",
                      store_path=tmp_path / "s", timeout_s=TIMEOUT_S)
    cfg, step = card_step(tag, make_mesh(dims, device="cuda"), "cuda")
    _, m = step(step.init_state(), TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED).batch_at(0))
    for r in got:
        assert abs(r["loss"] - float(m["loss"])) <= WORLD_LOSS_TOL * float(m["loss"])
        assert abs(r["grad_norm"] - float(m["grad_norm"])) <= WORLD_NORM_TOL * float(
            m["grad_norm"])
        assert r["launches"] == r["hops"] > 0
