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
heads over a span of 2, one expert a rank) on the ``a2a`` dispatch; mamba2
at (4, 2) (its ``resolve_tp``'s 2).

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
whole leaves (``convert.gather_shards``). Then the ``FP32_CASES`` from
seeded weights, and what training on processes refuses. The e2e's second
world, 4 ranks on (2, 2), is spawned once the first has ended.

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
backward halves it, fails those cases far above it.
"""
import contextlib
import dataclasses
import functools
import os
import time
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TrainPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import procs, steps, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.mesh import ProcessMesh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import parallel as P  # noqa: E402
from repro_torch.models.convert import params_from_jax, to_jax  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from test_torch_tp_train import logical, subtree  # noqa: E402
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
}
# the same two steps computed in fp32 (``COMPUTE_DTYPE`` and the config's
# compute dtype float32, in the ranks and on world dims), held to the
# world-dim port only: (arch, mesh, scenario, global batch, microbatches)
FP32_CASES = {
    "fp32_s2": ("qwen1_5_0_5b", (4, 2), "s2_in_net", 8, 2),
    "fp32_granite": ("granite_moe_1b_a400m", (1, 8), "native", 3, 1),
    "fp32_mamba2": ("mamba2_1_3b", (4, 2), "s1_host", 8, 1),
}
# the process form against the world-dim form on the same inputs (see the
# module doc), relative: the loss, the gradient's norm, and the moments over
# the tree; in fp32 each step's loss and norm and each leaf of the first
# step's moments (normwise against the whole tree's: a leaf whose gradient
# is rounding noise, the key bias, has no relative scale of its own)
WORLD_LOSS_TOL, WORLD_NORM_TOL, WORLD_MOMENTS_TOL = 1e-4, 1e-3, 1e-2
FP32_TOL = 1e-5
# the adjoint identity, relative to Σ |⟨f(x), y⟩|: fp32 sums in two orders
# (measured 7e-9 at most); S3's fetch rounds every hop's partial to bf16 on
# the wire, a relative 2^-9 each (measured 3.7e-4)
ADJOINT_TOL = {"fp32": 1e-6, "s3_in_net_map": 5e-3}
# the reference's end-to-end target on processes: qwen1.5 smoke at (4, 2)
# under S2, a failure at step 16, the new world of 4 on (2, 2) from the
# step-16 checkpoint to step 24
E2E = ["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "24", "--mesh", "4,2",
       "--scenario", "s2_in_net", "--global-batch", "8", "--seq", "32", "--microbatches", "2",
       "--ckpt-every", "8", "--fail-step", "16", "--shrink-to", "4", "--log-every", "100"]
E2E_FALL = 0.02  # the mean of the last 4 losses below the first 4's, less this


def axes(dims) -> tuple[str, ...]:
    return ("data", "model") if len(dims) == 2 else ("pod", "data", "model")


def world_env(tag: str):
    arch, dims, sc, _, _ = CASES[tag]
    cfg = get_smoke_config(arch)
    return steps.make_env(cfg, make_mesh(dims, device="cpu"), sc)


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

    out = {}
    for tag in tags:
        arch, dims, sc, gb, mb = CASES[tag]
        cfg = ref_cfg(arch)
        mesh = ref_mesh(dims)
        step, env, bundle = jsteps.make_train_step(cfg, mesh, scenario=sc, global_batch=gb,
                                                   seq=SEQ, microbatches=mb)
        params = init_params(bundle["param_leafspecs"], 0, jnp.float32, env)
        flat = TP.perturb(TS.flat_tree(params), cfg, env)
        _, treedef = jax.tree_util.tree_flatten(params)
        params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k])
                                                        for k in TS.flat_tree(params)])
        out.update({f"{tag}/param0/{k}": v for k, v in flat.items()})
        shard = jax.tree_util.tree_map(lambda p: jax.sharding.NamedSharding(mesh, p),
                                       bundle["param_partition"])
        params = jax.device_put(params, shard)
        state = bundle["init_state"](params)
        pipe = RefPipeline(cfg, env, gb, SEQ, seed=SEED)
        for k in range(STEPS):
            params, state, m = step(params, state, pipe.batch_at(k))
            for n in ("loss", "grad_norm", "lr", "ntok"):
                out[f"{tag}/{k}/{n}"] = np.asarray(m[n])
        out.update({f"{tag}/param/{k}": v for k, v in TS.flat_tree(params).items()})
        out.update({f"{tag}/m/{k}": v for k, v in TS.flat_tree(state.m).items()})
        out.update({f"{tag}/v/{k}": v for k, v in TS.flat_tree(state.v).items()})
    return out


JAX_PARTS = (("native", "s1_host", "s2_in_net"), ("s3_in_net_map", "hierarchical", "rep_s3"),
             ("granite_a2a", "mamba2"))
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
    """(the reference's outputs, every rank's results, the e2e's second
    world's losses, the e2e's checkpoint directory). The ranks are spawned
    while the reference's parts run side by side; they check the
    collectives and run the e2e's first world meanwhile, then wait for the
    reference's npz (``_rank``)."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("jax_procs_train")
    tests = os.path.dirname(os.path.abspath(__file__))
    path = tmp / "out.npz"
    ckpt = str(tmp / "ckpt")

    def run(i):
        part = str(tmp / f"part{i}.npz")
        assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=part, tags=JAX_PARTS[i],
                                                     xla=JAX_XLA))
        with np.load(part) as f:
            return dict(f)

    with ThreadPoolExecutor(len(JAX_PARTS) + 1) as pool:
        ranks = pool.submit(procs.spawn, functools.partial(_rank, str(path), ckpt), WORLD,
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
    (world2,) = train.spawn_run(train.relaunch_args(e2e_args(ckpt)), tmp / "store2",
                                device="cpu", timeout_s=TIMEOUT_S)
    return out, got, world2, ckpt


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
    arch, dims, sc, gb, mb = {**CASES, **FP32_CASES}[tag]
    cfg = get_smoke_config(arch)
    if tag in FP32_CASES:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    env = steps.make_env(cfg, mesh, sc)
    if jax_out is None:
        return cfg, M.Model(cfg, device=device, seed=1, env=env)
    return cfg, params_from_jax(subtree(jax_out, f"{tag}/param0/"), cfg, env=env, device=device)


def two_steps(tag: str, mesh, jax_out: dict | None, device, gather) -> dict:
    """A case's two steps on ``mesh``: each step's metrics and S3 hops
    (``ring_fused_step``'s plain version counted), ``ring_hops()``, and the
    first step's moments and the second's parameters and moments through
    ``gather`` (``gather(model, step, tree)`` → {JAX leaf path: numpy})."""
    arch, dims, sc, gb, mb = {**CASES, **FP32_CASES}[tag]
    cfg, model = case_model(tag, mesh, jax_out, device)
    step = steps.make_train_step(model, mesh, scenario=sc, global_batch=gb, seq=SEQ,
                                 microbatches=mb)
    state = step.init_state()
    pipe = TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED)
    real, hops, metrics = ops.ring_fused_step, [], []
    dtype = torch.float32 if tag in FP32_CASES else torch.bfloat16
    for k in range(STEPS):
        hops.append(0)

        def counted(acc, wire):
            hops[-1] += 1
            return real(acc, wire)

        with mock.patch.object(ops, "ring_fused_step", counted), computing(dtype):
            state, m = step(state, pipe.batch_at(k))
        metrics.append({n: float(m[n]) for n in ("loss", "grad_norm", "lr", "ntok")})
        if k == 0:
            m1 = gather(model, step, state.m)
    return {"metrics": metrics, "hops": hops, "ring_hops": step.ring_hops(), "m1": m1,
            "param": gather(model, step, step.params), "m": gather(model, step, state.m),
            "v": gather(model, step, state.v)}


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


def gathered(model, step, tree: dict) -> dict:
    """This rank's shards of ``tree`` (named as the parameters) gathered into
    whole leaves in the reference's storage layout, numpy, on rank 0 ({}
    elsewhere)."""
    got = convert.gather_shards(convert.stack_leaves(model, tree), model.cfg, step.env)
    return {k: v.numpy() for k, v in got.items()}


def held(model, step, tree: dict) -> dict:
    """A world-dim step's tensors as the JAX tree's logical leaves."""
    return to_jax(model, tree)


def refusals(device) -> dict:
    """The messages of what training on a process mesh refuses."""
    pm = ProcessMesh(("data", "model"), (4, 2), device=device)
    cfg = get_smoke_config("qwen1_5_0_5b")
    model = M.Model(cfg, device=device, seed=0, env=steps.make_env(cfg, pm))
    def kind(arch):  # a model of a kind that serves on the process mesh but does not train there
        c = get_smoke_config(arch)
        return lambda: steps.make_train_step(
            M.Model(c, device=device, seed=0, env=steps.make_env(c, pm)), pm, global_batch=8,
            seq=SEQ)

    cases = {
        "eightbit": lambda: steps.make_train_step(model, pm, optimizer=AdamW(eightbit=True),
                                                  global_batch=8, seq=SEQ),
        "flash": lambda: steps.make_train_step(model, pm, impl="flash", global_batch=8, seq=SEQ),
        "mla": kind("minicpm3_4b"),
        "rglru": kind("recurrentgemma_2b"),
        "mrope": kind("qwen2_vl_7b"),
        "encdec": kind("seamless_m4t_large_v2"),
        "world_model": lambda: steps.make_train_step(
            M.Model(cfg, device=device, seed=0, env=steps.make_env(cfg, pm).world()), pm,
            global_batch=8, seq=SEQ),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _rank(path: str, ckpt: str, device) -> dict:
    """This rank's part of the file (``spawned``): the collectives' checks,
    the refusals, the e2e's first world, then every case once the
    reference's npz at ``path`` is written."""
    torch.set_num_threads(1)
    res = {"functions": function_checks(device), "refusals": refusals(device)}
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
        res[tag] = two_steps(tag, pm, None if tag in FP32_CASES else jax_out, device, gathered)
    res["round_trip"] = moments_round_trip("granite_a2a", meshes[CASES["granite_a2a"][1]],
                                           jax_out, device)
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


@pytest.mark.parametrize("tag", list(CASES))
def test_train_on_processes_matches_reference(ranks, world, jax_out, tag):
    """Two steps on every rank from its shard: each step's loss, gradient
    norm, lr and ``ntok`` (psum'd over the mesh, every rank the same), the
    moments and parameters gathered back, as the reference's and as the
    world-dim port's. The gathered kv and expert slots read back to logical
    leaves only where their copies are equal (``from_slots`` refuses
    others): ``sync_gradients`` kept them in sync."""
    arch, dims, sc, gb, mb = CASES[tag]
    cfg, env = get_smoke_config(arch), world_env(tag)
    for k, got in enumerate(rank_metrics(ranks, tag)):
        want = {n: float(jax_out[f"{tag}/{k}/{n}"]) for n in ("loss", "grad_norm", "lr", "ntok")}
        w = world[tag]["metrics"][k]
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * want["loss"], (k, got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= NORM_TOL * want["grad_norm"], \
            (k, got, want)
        assert abs(got["lr"] - want["lr"]) <= 1e-6 * want["lr"]
        assert int(got["ntok"]) == want["ntok"] == int(w["ntok"])
        assert abs(got["loss"] - w["loss"]) <= WORLD_LOSS_TOL * w["loss"], (k, got, w)
        assert abs(got["grad_norm"] - w["grad_norm"]) <= WORLD_NORM_TOL * w["grad_norm"], \
            (k, got, w)
    mine = ranks[0][tag]
    lrs = [m["lr"] for m in mine["metrics"]]
    for what in ("m", "v"):
        got = logical(mine[what], cfg, env)
        moments_close(got, logical(subtree(jax_out, f"{tag}/{what}/"), cfg, env), MOMENT_TOL,
                      MOMENTS_TOL, f"{what} vs reference")
        moments_close(got, world[tag][what], None, WORLD_MOMENTS_TOL, f"{what} vs world-dim")
    got = logical(mine["param"], cfg, env)
    p0 = logical(subtree(jax_out, f"{tag}/param0/"), cfg, env)
    params_close(got, logical(subtree(jax_out, f"{tag}/param/"), cfg, env), p0, lrs,
                 "vs reference")
    params_close(got, world[tag]["param"], p0, lrs, "vs world-dim")


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
    got, want = logical(ranks[0][tag]["m1"], get_smoke_config(arch), env), world[tag]["m1"]
    scale = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in want.values()))
    worst = max((float(np.linalg.norm(got[k] - v)) / scale, k) for k, v in want.items())
    assert worst[0] <= FP32_TOL, worst


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
    ("eightbit", "8-bit moments on a process mesh wait"),
    ("flash", "no backward"),
    ("mla", "process mesh waits"),
    ("rglru", "process mesh waits (ROADMAP.md §1 item 2)"),
    ("mrope", "process mesh waits (ROADMAP.md §1 item 2)"),
    ("encdec", "process mesh waits (ROADMAP.md §1 item 2)"),
    ("world_model", "made for")])
def test_process_training_refuses(ranks, name, match):
    for r in ranks:
        assert r["refusals"][name] is not None and match in r["refusals"][name], \
            r["refusals"][name]


def test_e2e_restart_on_processes(spawned):
    """The reference's end-to-end target on gloo processes: qwen1.5 smoke at
    (4, 2) under S2, the failure at step 16 ends the first world once its
    checkpoint is written, and a new world of 4 ranks on (2, 2) restores
    step 16 and runs to 24: the loss falls by more than ``E2E_FALL``."""
    _, ranks_, world2, ckpt = spawned
    first = ranks_[0]["e2e"]
    assert all(r["e2e"] == first for r in ranks_)
    assert len(first) == 16 and len(world2) == 8
    losses = first + world2
    a, b = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    assert b < a - E2E_FALL, (a, b)
    meta = CheckpointStore(ckpt).manifest()["meta"]
    assert meta["mesh"] == [2, 2] and meta["tp"] == 2 and CheckpointStore(ckpt).latest_step() == 24


def test_process_checkpoint_restores_on_world_dims(spawned):
    """The step-16 checkpoint that the processes wrote (rank 0, the gathered
    whole leaves) restores in the world-dim port on (2, 2), whose step 16
    is then the new world's to ``WORLD_LOSS_TOL``; and the reference's store
    reads it into the reference's parameter tree of that mesh: every leaf's
    global shape (the vocab padded, kv heads in their slots)."""
    _, _, world2, ckpt = spawned
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
def _card_rank(device):
    pm = ProcessMesh(("data", "model"), (2, 2), device=device)
    cfg = get_smoke_config("qwen1_5_0_5b")
    model = M.Model(cfg, device=device, seed=1, env=steps.make_env(cfg, pm, "s3_in_net_map"))
    step = steps.make_train_step(model, pm, scenario="s3_in_net_map", global_batch=4, seq=SEQ)
    ops.reset_launches()
    _, m = step(step.init_state(), TrainPipeline(cfg, step.env, 4, SEQ, seed=SEED).batch_at(0))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "launches": ops.LAUNCHES["ring_fused_step"], "hops": step.ring_hops()}


@pytest.mark.cuda
def test_process_training_on_the_card_matches_the_world_dim_port(tmp_path):
    """qwen1.5 smoke at (2, 2) on 4 gloo ranks staged through host memory on
    one card, one S3 step: the loss and gradient norm as the world-dim
    step's on the card, and every rank's ``ring_fused_step`` launches (the
    kernel) equal to its ring hops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    from repro_torch.kernels import _build

    _build.build_all()
    got = procs.spawn(_card_rank, 4, backend="gloo", store_path=tmp_path / "s",
                      timeout_s=TIMEOUT_S)
    cfg = get_smoke_config("qwen1_5_0_5b")
    mesh = make_mesh((2, 2), device="cuda")
    model = M.Model(cfg, device="cuda", seed=1, env=steps.make_env(cfg, mesh))
    step = steps.make_train_step(model, mesh, scenario="s3_in_net_map", global_batch=4, seq=SEQ)
    _, m = step(step.init_state(), TrainPipeline(cfg, step.env, 4, SEQ, seed=SEED).batch_at(0))
    for r in got:
        assert abs(r["loss"] - float(m["loss"])) <= WORLD_LOSS_TOL * float(m["loss"])
        assert abs(r["grad_norm"] - float(m["grad_norm"])) <= WORLD_NORM_TOL * float(
            m["grad_norm"])
        assert r["launches"] == r["hops"] > 0
