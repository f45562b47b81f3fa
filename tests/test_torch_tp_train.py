"""Training across a ("data", "model") mesh: the port's train step vs the JAX
package's ``make_train_step``, on the CPU.

One subprocess on 8 fake CPU devices runs the reference for qwen1.5's smoke
config (global batch 8, sequence 32, ``TrainPipeline`` seed 3): (4, 2) at
tp 2 under ``native``, ``s1_host``, ``s2_in_net`` and ``s3_in_net_map``;
(2, 2, 2) under ``hierarchical``; (1, 8) at tp 4 and rep 2 under
``s3_in_net_map`` and ``native`` on a global batch of 3, which does not split
over the rep groups (a batch that does would mix rows, ROADMAP.md §3); and
(4, 1) ``native`` from the (4, 2) parameters, the reference's own
check that its gradient at a model axis of 2 is its gradient at 1. Parameters
come from ``init_params(param_specs(cfg, env))`` perturbed as
``test_torch_tp_serve.perturb`` perturbs them (kv biases one value a
logical head, laid out in the slots); two steps each. It saves each step's
metrics, and the parameters and moments after the second step, in the
reference's storage layout.

The port loads the same parameters (``params_from_jax(..., env=)``) and
takes the same two steps on the same mesh. The reference's parameters and
moments are read back to logical leaves by ``params_from_jax`` and
``convert.from_slots``, which refuse slot copies that differ: the copies of
kv heads stayed in sync.

Tolerances are ``test_torch_train``'s (the loss, the gradient's norm, the
moments per leaf and over the tree, each parameter within two steps of lr
and the whole update normwise). The reference sums the row-parallel bf16
partials in bf16 and the port in fp32 (ROADMAP.md §3); measured on this
config it stays inside them (``test_torch_train``'s limits hold; the worst
per-leaf moment difference is printed by the assertions' messages).
"""
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TrainPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax, to_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from test_torch_train import (LOSS_TOL, MOMENT_TOL, MOMENTS_TOL, NORM_TOL,  # noqa: E402
                              UPDATE_TOL, rel)

ARCH = "qwen1_5_0_5b"
SEQ, SEED, STEPS = 32, 3, 2
CASES = {  # tag: (mesh, scenario, global batch)
    "native": ((4, 2), "native", 8),
    "s1_host": ((4, 2), "s1_host", 8),
    "s2_in_net": ((4, 2), "s2_in_net", 8),
    "s3_in_net_map": ((4, 2), "s3_in_net_map", 8),
    "hierarchical": ((2, 2, 2), "hierarchical", 8),
    "rep_s3": ((1, 8), "s3_in_net_map", 3),
    "rep_native": ((1, 8), "native", 3),
}
MODEL1 = ((4, 1), "native", 8)  # the (4, 2) native case's parameters at a model axis of 1
# the reference's gradient at (4, 2) against its own at (4, 1), the first
# step's m = 0.1·g normwise over the tree: bf16 rounding of the row-parallel
# partials; and its loss
MODEL1_TOL = 1e-2

JAX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_serve as TS
import test_torch_tp_serve as TP
import test_torch_tp_train as T
from repro.configs import get_smoke_config
from repro.data.pipeline import TrainPipeline
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.models.common import init_params

out = {{}}
cfg = get_smoke_config(T.ARCH)
for tag, (shape, sc, gb) in list(T.CASES.items()) + [("model1", T.MODEL1)]:
    mesh = make_mesh(shape)
    step, env, bundle = steps.make_train_step(cfg, mesh, scenario=sc, global_batch=gb, seq=T.SEQ)
    params = init_params(bundle["param_leafspecs"], 0, jnp.float32, env)
    if tag == "model1":
        flat = {{k[len("native/param0/"):]: v for k, v in out.items()
                 if k.startswith("native/param0/")}}
    else:
        flat = TP.perturb(TS.flat_tree(params), cfg, env)
    _, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k])
                                                    for k in TS.flat_tree(params)])
    out.update({{f"{{tag}}/param0/{{k}}": v for k, v in flat.items()}})
    shard = jax.tree_util.tree_map(lambda p: jax.sharding.NamedSharding(mesh, p),
                                   bundle["param_partition"])
    params = jax.device_put(params, shard)
    state = bundle["init_state"](params)
    pipe = TrainPipeline(cfg, env, gb, T.SEQ, seed=T.SEED)
    for k in range(T.STEPS):
        params, state, m = step(params, state, pipe.batch_at(k))
        for n in ("loss", "grad_norm", "lr", "ntok"):
            out[f"{{tag}}/{{k}}/{{n}}"] = np.asarray(m[n])
        if k == 0:
            out.update({{f"{{tag}}/m1/{{n}}": v for n, v in TS.flat_tree(state.m).items()}})
    out.update({{f"{{tag}}/param/{{k}}": v for k, v in TS.flat_tree(params).items()}})
    out.update({{f"{{tag}}/m/{{k}}": v for k, v in TS.flat_tree(state.m).items()}})
    out.update({{f"{{tag}}/v/{{k}}": v for k, v in TS.flat_tree(state.v).items()}})
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_tp_train") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=8)
    with np.load(path) as f:
        return dict(f)


def subtree(jax_out, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}


def logical(tree: dict, cfg, env) -> dict:
    """A stacked tree in the reference's storage layout → logical numpy
    leaves (``from_slots``: copies must be equal)."""
    t = convert.from_slots({k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()},
                           cfg, env)
    return {k: v.numpy() for k, v in t.items()}


def cpu_mesh(shape):
    return make_mesh(shape, device="cpu")


@pytest.mark.parametrize("tag", list(CASES))
def test_tp_train_step_matches_jax(jax_out, tag):
    """Two steps on the mesh: the loss, ``ntok`` (every tp rank counts its
    rows' tokens), the gradient's norm, the moments and the parameters."""
    shape, scenario, gb = CASES[tag]
    cfg = get_smoke_config(ARCH)
    mesh = cpu_mesh(shape)
    env = steps.make_env(cfg, mesh, scenario)
    p0 = subtree(jax_out, f"{tag}/param0/")
    model = params_from_jax(p0, cfg, env=env, device="cpu")
    step = steps.make_train_step(model, mesh, scenario=scenario, global_batch=gb, seq=SEQ)
    assert step.world == env.dp_world and step.env.tp == env.tp
    state = step.init_state()
    pipe = TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED)
    lrs = []
    for k in range(STEPS):
        state, m = step(state, pipe.batch_at(k))
        want = {n: float(jax_out[f"{tag}/{k}/{n}"]) for n in ("loss", "grad_norm", "lr", "ntok")}
        assert abs(float(m["loss"]) - want["loss"]) <= LOSS_TOL * want["loss"], (k, m, want)
        assert abs(float(m["grad_norm"]) - want["grad_norm"]) <= NORM_TOL * want["grad_norm"], \
            (k, m, want)
        assert abs(m["lr"] - want["lr"]) <= 1e-6 * want["lr"]
        assert int(m["ntok"]) == want["ntok"]
        lrs.append(m["lr"])
    for what, tree in (("m", state.m), ("v", state.v)):
        got, want = to_jax(model, tree), logical(subtree(jax_out, f"{tag}/{what}/"), cfg, env)
        worst = max((rel(got[k], w), k) for k, w in want.items())
        assert worst[0] <= MOMENT_TOL, (what, worst)
        whole = [np.concatenate([t[k].ravel() for k in want]) for t in (got, want)]
        assert rel(*whole) <= MOMENTS_TOL, what
    got = params_to_jax(model)
    want = params_to_jax(params_from_jax(subtree(jax_out, f"{tag}/param/"), cfg, env=env,
                                         device="cpu"))  # refuses kv copies out of sync
    lp0 = logical(p0, cfg, env)
    step_atol = 2 * sum(lrs) * 1.01
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=step_atol, err_msg=k)
    d_got = np.concatenate([(got[k] - lp0[k]).ravel() for k in want])
    d_want = np.concatenate([(want[k] - lp0[k]).ravel() for k in want])
    assert rel(d_got, d_want) <= UPDATE_TOL


def test_reference_gradient_at_model_2_is_its_gradient_at_model_1(jax_out):
    """The semantics the port copies: under ``shard_map(check_vma=False)``
    the reference's loss is psum'd inside ``sharded_xent``, its normaliser
    counts the model axis, and psum transposes to psum; the gradient of the
    sum over devices is still the logical one. Its first step's moments
    (0.1 · the clipped gradient) at (4, 2) and at (4, 1) from the same
    parameters and batch agree to bf16 rounding, and so do the losses;
    ``ntok`` counts each tp rank's tokens."""
    m2, m1 = subtree(jax_out, "native/m1/"), subtree(jax_out, "model1/m1/")
    whole = [np.concatenate([t[k].ravel() for k in sorted(m1)]) for t in (m2, m1)]
    assert 0 < rel(*whole) <= MODEL1_TOL
    l2, l1 = float(jax_out["native/0/loss"]), float(jax_out["model1/0/loss"])
    assert abs(l2 - l1) <= LOSS_TOL * l1
    assert int(jax_out["native/0/ntok"]) == 2 * int(jax_out["model1/0/ntok"])


def test_tp_train_loss_and_gradient_match_tp1():
    """The port's own twin of that check: the TP step's loss and aggregated
    gradient at (4, 2) and (1, 8) (rep 2) against the tp = 1 step on the same
    weights and batch."""
    cfg = get_smoke_config(ARCH)
    for shape, gb in (((4, 2), 8), ((1, 8), 3)):
        out = {}
        for sh in (shape, (shape[0], 1)):
            mesh = cpu_mesh(sh)
            model = Model(cfg, device="cpu", seed=1, env=steps.make_env(cfg, mesh))
            step = steps.make_train_step(model, mesh, scenario="s3_in_net_map",
                                         global_batch=gb, seq=SEQ)
            batch = TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED).batch_at(0)
            ranks, nll, ntok = step.rank_gradients(batch)
            out[sh] = (step.aggregate(ranks), float(nll * step.norm), int(ntok), step.env.tp)
        (g, loss, ntok, tp), (g1, loss1, ntok1, _) = out[shape], out[(shape[0], 1)]
        assert tp > 1 and ntok == shape[1] * ntok1  # every device of the model axis counts
        assert abs(loss - loss1) <= LOSS_TOL * loss1
        whole = [torch.cat([t[k].flatten() for k in g1]) for t in (g, g1)]
        assert float((whole[0] - whole[1]).norm() / whole[1].norm()) <= MODEL1_TOL


def test_s3_rep_rings_run_ring_fused_step():
    """At (1, 8) (tp 4, rep 2) the only rings are the rep groups': S3 makes
    one hop, one ``ring_fused_step`` launch, per leaf that the weight fetch
    gathers over them (a TP dim that is not kv slots), and its result is the
    sum to bf16 rounding."""
    cfg = get_smoke_config(ARCH)
    mesh = cpu_mesh((1, 8))
    model = Model(cfg, device="cpu", seed=1, env=steps.make_env(cfg, mesh))
    step = steps.make_train_step(model, mesh, scenario="s3_in_net_map", global_batch=3, seq=SEQ)
    ranks, _, _ = step.rank_gradients(
        TrainPipeline(cfg, step.env, 3, SEQ, seed=SEED).batch_at(0))
    hops = []
    real = ops.ring_fused_step
    with mock.patch.object(ops, "ring_fused_step",
                           lambda a, w: hops.append(a.shape) or real(a, w)):
        grads = step.aggregate(ranks)
    rep_leaves = sum(pl.tp_dim is not None and not pl.dup_of for pl in step.places.values())
    assert step.env.rep == 2 and rep_leaves > 0
    assert len(hops) == rep_leaves  # one hop a ring of two, every tp group's ring at once
    for k, g in grads.items():
        want = ranks[k].sum((0, 1))
        torch.testing.assert_close(g, want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))


def test_rep_split_batch_raises():
    """A global batch that splits over the rep groups gives every model index
    rows of its own (the reference's ``TrainPipeline``): the tp ranks of a
    group would compute on different rows, and the step says so."""
    cfg = get_smoke_config(ARCH)
    mesh = cpu_mesh((1, 8))
    model = Model(cfg, device="cpu", env=steps.make_env(cfg, mesh))
    step = steps.make_train_step(model, mesh, global_batch=8, seq=SEQ)
    assert step.split_rep
    with pytest.raises(ValueError, match="psum_tp mixes"):
        step(step.init_state(), TrainPipeline(cfg, step.env, 8, SEQ).batch_at(0))
    rows = torch.arange(8 * SEQ, dtype=torch.int32).reshape(8, SEQ) % cfg.vocab
    batch = {k: steps.device_major(step.env, rows, 8) for k in ("tokens", "labels")}
    step(step.init_state(), batch)  # each rep group's rows at every tp rank of the group


def test_train_cli_restarts_a_tp_mesh_elastically(tmp_path, capsys):
    """The port's twin of ``tests/test_train_e2e.py:5-22``: qwen1.5 smoke at
    ``--mesh 4,2`` under S2, a failure at step 16 and the restart on 4
    devices, which keeps the model axis: (2, 2). The loss falls."""
    losses = train.run(train.parser().parse_args(
        ["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "24", "--mesh", "4,2",
         "--scenario", "s2_in_net", "--global-batch", "8", "--seq", "32", "--microbatches", "2",
         "--ckpt", str(tmp_path), "--ckpt-every", "8", "--fail-step", "16", "--shrink-to", "4",
         "--device", "cpu", "--log-every", "100"]))
    a, b = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    assert b < a - 0.02, (a, b)
    assert len(losses) == 24  # steps 0-15, then 16-23 on (2, 2) from the step-16 checkpoint
    out = capsys.readouterr().out
    assert "shrinking to 4 devices" in out and "restored step 16" in out
    from repro_torch.checkpoint.store import CheckpointStore

    meta = CheckpointStore(str(tmp_path)).manifest()["meta"]
    assert meta["mesh"] == [2, 2] and meta["tp"] == 2 and meta["world"] == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape,gb", [("qwen1_5_0_5b", (2, 2), 4),
                                           ("qwen1_5_0_5b", (1, 8), 3),
                                           ("granite_moe_1b_a400m", (2, 4), 8)])
def test_tp_train_step_on_the_card_matches_the_cpu(cuda, arch, shape, gb):
    """One S3 step of a smoke config on a TP mesh on the card and on the CPU
    from the same parameters: the metrics and new parameters agree to bf16
    rounding, S3 launched ``ring_fused_step`` once a ring hop (the data
    rings' and the rep groups'), and the MoE's a2a combine ran on
    ``segment_reduce``."""
    cfg = get_smoke_config(arch)
    out = {}
    for where in ("cpu", "cuda"):
        mesh = make_mesh(shape, device=where)
        model = Model(cfg, device="cpu", seed=0, env=steps.make_env(cfg, mesh)).to(where)
        step = steps.make_train_step(model, mesh, scenario="s3_in_net_map", global_batch=gb,
                                     seq=SEQ)
        ops.reset_launches()
        _, m = step(step.init_state(),
                    TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED).batch_at(0))
        out[where] = (m, dict(ops.LAUNCHES), params_to_jax(model), step.ring_hops())
    (mc, _, pc, _), (mg, launches, pg, hops) = out["cpu"], out["cuda"]
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-2 * float(mc["loss"])
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 5e-2 * float(mc["grad_norm"])
    assert launches["ring_fused_step"] == hops > 0
    assert (launches["segment_reduce"] > 0) == (cfg.moe is not None)
    for k in pc:
        np.testing.assert_allclose(pg[k], pc[k], rtol=0, atol=2 * mc["lr"] * 1.01, err_msg=k)
