"""The port's train step, data pipeline and train CLI vs the JAX package's,
on the CPU.

One subprocess runs the JAX side: ``make_train_step`` for qwen1.5's smoke
config on a (4, 1) mesh of fake CPU devices under ``native``, ``s1_host``,
``s2_in_net`` and ``s3_in_net_map``, and on (2, 2, 1) under ``hierarchical``
with two microbatches; parameters from ``init_params`` seed 0 then
``test_torch_serve.perturb``; two steps on ``TrainPipeline`` batches (seed
3, global batch 8, sequence 32). It saves each step's metrics, and the
parameters and moments after the second step; and ``TrainPipeline``'s
batches for a dense, an M-RoPE and an enc-dec config, and
``markov_tokens``. The port runs the same steps on a data world of 4 ranks
(``("data",) = 4`` or ``("pod", "data") = (2, 2)``) on the CPU.

Tolerances. The gradients agree to bf16 rounding (``test_torch_train_loss``),
and S3 adds the bf16 wire's rounding in both packages: the loss within
``LOSS_TOL`` and the gradient's norm within ``NORM_TOL`` relative; the
moments (0.1·g after a step: they carry the aggregated, clipped gradient)
within ``MOMENT_TOL`` normwise per leaf (as ``test_torch_train_loss``'s
dense leaves) and ``MOMENTS_TOL`` over the whole tree. An early AdamW step is lr·sign(m)
for most elements, so a parameter differs by a whole step where an element's
gradient is rounding only (qwen1.5's key bias: a bias shared by every key
cancels in the softmax): each parameter within two steps of lr
elementwise, and the whole update within ``UPDATE_TOL`` normwise (an update
of a few lr = 3e-6 is also rounded to the parameter's fp32 ulp, 1.2e-7 at a
norm scale near 1: 4% of it). Batches and Markov tokens bitwise.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, TrainPipeline, markov_tokens, _rng  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, shapes, steps, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models.convert import (from_jax, opt_state_from_jax, params_from_jax,  # noqa: E402
                                        params_to_jax, to_jax)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

ARCH = "qwen1_5_0_5b"
GB, SEQ, SEED, STEPS = 8, 32, 3, 2
CASES = {"native": ((4, 1), 1), "s1_host": ((4, 1), 1), "s2_in_net": ((4, 1), 1),
         "s3_in_net_map": ((4, 1), 1), "hierarchical": ((2, 2, 1), 2)}
PIPE_ARCHS = ("qwen1_5_0_5b", "qwen2_vl_7b", "seamless_m4t_large_v2")
LOSS_TOL = 2e-4
NORM_TOL = 1e-3
MOMENT_TOL = 5e-2
MOMENTS_TOL = 1e-2
UPDATE_TOL = 0.15

JAX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_serve as TS
import test_torch_train as T
from repro.configs import get_smoke_config
from repro.data.pipeline import TrainPipeline, _rng, markov_tokens
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.models.common import init_params

out = {{}}
cfg = get_smoke_config(T.ARCH)
for sc, (shape, mb) in T.CASES.items():
    mesh = make_mesh(shape)
    step, env, bundle = steps.make_train_step(cfg, mesh, scenario=sc, microbatches=mb,
                                              global_batch=T.GB, seq=T.SEQ)
    params = init_params(bundle["param_leafspecs"], 0, jnp.float32, env)
    flat = TS.perturb(TS.flat_tree(params))
    _, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in TS.flat_tree(params)])
    out.update({{f"{{sc}}/param0/{{k}}": v for k, v in flat.items()}})
    shard = jax.tree_util.tree_map(lambda p: jax.sharding.NamedSharding(mesh, p),
                                   bundle["param_partition"])
    params = jax.device_put(params, shard)
    state = bundle["init_state"](params)
    pipe = TrainPipeline(cfg, env, T.GB, T.SEQ, seed=T.SEED)
    for k in range(T.STEPS):
        params, state, m = step(params, state, pipe.batch_at(k))
        for n in ("loss", "grad_norm", "lr", "ntok"):
            out[f"{{sc}}/{{k}}/{{n}}"] = np.asarray(m[n])
    out.update({{f"{{sc}}/param/{{k}}": v for k, v in TS.flat_tree(params).items()}})
    out.update({{f"{{sc}}/m/{{k}}": v for k, v in TS.flat_tree(state.m).items()}})
    out.update({{f"{{sc}}/v/{{k}}": v for k, v in TS.flat_tree(state.v).items()}})
    out[f"{{sc}}/count"] = np.asarray(state.count)
for arch in T.PIPE_ARCHS:
    for shape in ((4, 1), (2, 2, 1)):
        env = steps.make_env(get_smoke_config(arch), make_mesh(shape))
        b = TrainPipeline(get_smoke_config(arch), env, T.GB, T.SEQ, seed=T.SEED).batch_at(5)
        out.update({{f"pipe/{{arch}}/{{len(shape)}}/{{k}}": np.asarray(v) for k, v in b.items()}})
out["markov"] = markov_tokens(_rng(7, 2), 1000, 3, 50)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_train") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=4)
    with np.load(path) as f:
        return dict(f)


def subtree(jax_out, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}


def data_mesh(shape) -> Mesh:
    """A launcher's mesh on the CPU: (4, 1) → data 4 × model 1; (2, 2, 1) →
    pod 2 × data 2 × model 1."""
    return make_mesh(shape, device="cpu")


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("scenario", list(CASES))
def test_train_step_matches_jax(jax_out, scenario):
    shape, mb = CASES[scenario]
    cfg = get_smoke_config(ARCH)
    p0 = subtree(jax_out, f"{scenario}/param0/")
    model = params_from_jax(p0, cfg, device="cpu")
    mesh = data_mesh(shape)
    step = steps.make_train_step(model, mesh, scenario=scenario, microbatches=mb,
                                 global_batch=GB, seq=SEQ)
    assert step.microbatches == mb and step.world == 4
    state = step.init_state()
    pipe = TrainPipeline(cfg, step.env, GB, SEQ, seed=SEED)
    lrs = []
    for k in range(STEPS):
        state, m = step(state, pipe.batch_at(k))
        want = {n: float(jax_out[f"{scenario}/{k}/{n}"]) for n in ("loss", "grad_norm", "lr", "ntok")}
        assert abs(float(m["loss"]) - want["loss"]) <= LOSS_TOL * want["loss"]
        assert abs(float(m["grad_norm"]) - want["grad_norm"]) <= NORM_TOL * want["grad_norm"]
        assert abs(m["lr"] - want["lr"]) <= 1e-6 * want["lr"]
        assert int(m["ntok"]) == want["ntok"]
        lrs.append(m["lr"])
    assert state.count == int(jax_out[f"{scenario}/count"]) == STEPS
    for what, tree in (("m", state.m), ("v", state.v)):
        got, want = to_jax(model, tree), subtree(jax_out, f"{scenario}/{what}/")
        for k, w in want.items():
            assert rel(got[k], w) <= MOMENT_TOL, (what, k, rel(got[k], w))
        whole = [np.concatenate([t[k].ravel() for k in want]) for t in (got, want)]
        assert rel(*whole) <= MOMENTS_TOL, what
    got, want = params_to_jax(model), subtree(jax_out, f"{scenario}/param/")
    step_atol = 2 * sum(lrs) * 1.01
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=step_atol, err_msg=k)
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    assert rel(d_got, d_want) <= UPDATE_TOL


def test_opt_state_round_trip(jax_out):
    """``opt_state_from_jax`` splits the reference's stacked fp32 moments
    into the port's layers (``to_jax`` stacks them back)."""
    model = params_from_jax(subtree(jax_out, "native/param0/"), get_smoke_config(ARCH),
                            device="cpu")
    st = opt_state_from_jax({"count": jax_out["native/count"],
                             "m": subtree(jax_out, "native/m/"),
                             "v": subtree(jax_out, "native/v/")}, model)
    assert st.count == STEPS
    for k, v in to_jax(model, st.m).items():
        np.testing.assert_array_equal(v, jax_out[f"native/m/{k}"])
    with pytest.raises(ValueError, match="8-bit"):
        opt_state_from_jax({"count": 1, "m": {"embed": (np.zeros(1), np.zeros(1))}, "v": {}},
                           model)
    with pytest.raises(ValueError, match="missing"):
        from_jax(model, {"embed": jax_out["native/m/embed"]})


@pytest.mark.parametrize("arch", PIPE_ARCHS)
@pytest.mark.parametrize("shape", [(4, 1), (2, 2, 1)])
def test_train_pipeline_matches_jax(jax_out, arch, shape):
    """Device-major batches: the reference's, bitwise; shapes as
    ``train_input_specs`` says."""
    cfg = get_smoke_config(arch)
    env = steps.make_env(cfg, data_mesh(shape))
    got = TrainPipeline(cfg, env, GB, SEQ, seed=SEED).batch_at(5)
    want = subtree(jax_out, f"pipe/{arch}/{len(shape)}/")
    specs = shapes.train_input_specs(cfg, env, SEQ, GB)
    assert set(got) == set(want) == set(specs)
    for k, w in want.items():
        assert got[k].shape == specs[k][0]
        np.testing.assert_array_equal(got[k], w.reshape(got[k].shape), err_msg=k)
        assert got[k].dtype == w.dtype


def test_markov_tokens_and_prefetcher(jax_out):
    np.testing.assert_array_equal(markov_tokens(_rng(7, 2), 1000, 3, 50), jax_out["markov"])
    cfg = get_smoke_config(ARCH)
    pipe = TrainPipeline(cfg, steps.make_env(cfg, data_mesh((4, 1))), GB, SEQ, seed=SEED)
    fetched = Prefetcher(iter(pipe), depth=2)
    for k in range(4):
        b = next(fetched)
        assert all(np.array_equal(v, pipe.batch_at(k)[n]) for n, v in b.items())
    assert list(Prefetcher(iter(range(7)), depth=3)) == list(range(7))


def test_serving_after_a_train_step_reads_the_new_weights():
    """A train step remakes the bf16 copies: serving the trained model equals
    serving a fresh model that loads its parameters."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, device="cpu", seed=5)
    mesh = data_mesh((4, 1))
    step = steps.make_train_step(model, mesh, scenario="s3_in_net_map",
                                 optimizer=AdamW(lr=1e-2, warmup_steps=1),
                                 global_batch=GB, seq=SEQ)
    before = serve.generate(model, serve.prompt_batch(model, 2, 16, seed=1), 4, impl="masked")
    step(step.init_state(), TrainPipeline(cfg, step.env, GB, SEQ, seed=SEED).batch_at(0))
    fresh = params_from_jax(params_to_jax(model), cfg, device="cpu")
    prompts = serve.prompt_batch(model, 2, 16, seed=1)
    got = serve.generate(model, prompts, 4, impl="masked")
    want = serve.generate(fresh, prompts, 4, impl="masked")
    assert torch.equal(got["tokens"], want["tokens"])
    for k, v in want["cache"]["blocks"]["0_attn_mlp"]["attn"].items():
        assert torch.equal(got["cache"]["blocks"]["0_attn_mlp"]["attn"][k], v)
    assert not torch.equal(before["cache"]["blocks"]["0_attn_mlp"]["attn"]["k"],
                           got["cache"]["blocks"]["0_attn_mlp"]["attn"]["k"])


def test_train_cli_loss_falls(capsys):
    """``python -m repro_torch.launch.train`` at smoke size on the CPU with
    S2 aggregation over 4 ranks: the loss of the last 5 of 20 steps is
    below the first 5's (the reference's ``test_train_e2e``)."""
    losses = train.run(train.parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--mesh", "4,1", "--scenario", "s2_in_net",
         "--device", "cpu", "--steps", "20"]))
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.01, losses
    assert "[train] step    20" in capsys.readouterr().out


def test_training_refuses_what_it_cannot_run():
    """``impl="flash"`` (no backward), a mesh without the launcher's model
    axis, the elastic restart without a checkpoint directory and a batch
    laid out for another world raise. A model axis above 1 no longer does:
    the CLI's ``--mesh 4,2`` trains, and a mesh with that axis given to the
    train step runs its tp ranks."""
    model = Model(get_smoke_config(ARCH), device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        steps.make_train_step(model, data_mesh((4, 1)), impl="flash")
    with pytest.raises(ValueError, match="launcher's mesh"):
        steps.make_train_step(model, Mesh(("data",), (4,), device="cpu"))
    losses = train.run(train.parser().parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--device",
                                                  "cpu", "--mesh", "4,2", "--steps", "2"]))
    assert len(losses) == 2 and np.isfinite(losses).all()
    tp_step = steps.make_train_step(model, make_mesh((2, 2), device="cpu"))
    assert (tp_step.env.tp, tp_step.env.rep, tp_step.world) == (2, 1, 2)
    with pytest.raises(ValueError, match="needs --ckpt"):
        train.run(train.parser().parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--device",
                                             "cpu", "--fail-step", "3", "--shrink-to", "2"]))
    with pytest.raises(ValueError, match="does not lead with the world"):
        step = steps.make_train_step(model, data_mesh((4, 1)), global_batch=GB, seq=SEQ)
        other = steps.make_env(model.cfg, data_mesh((2, 1)))
        step(step.init_state(), TrainPipeline(model.cfg, other, GB, SEQ).batch_at(0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "granite_moe_1b_a400m", "mamba2_1_3b",
                                  "minicpm3_4b", "recurrentgemma_2b", "qwen2_vl_7b",
                                  "seamless_m4t_large_v2", "granite_8b", "phi3_medium_14b",
                                  "grok_1_314b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One S3 step of each smoke config on a data world of 2 on the card and
    on the CPU from the same parameters: the metrics and new parameters
    agree to bf16 rounding, S3 made one ``ring_fused_step`` per FSDP leaf
    (2 ranks: one hop), and the MoE configs' combine ran on
    ``segment_reduce``."""
    cfg = get_smoke_config(arch)
    models = {"cpu": Model(cfg, device="cpu", seed=0)}
    models["cuda"] = Model(cfg, device="cpu", seed=0).to(cuda)
    out = {}
    for where, model in models.items():
        mesh = make_mesh((2, 1), device=model.device)
        step = steps.make_train_step(model, mesh, scenario="s3_in_net_map",
                                     global_batch=4, seq=SEQ)
        ops.reset_launches()
        _, m = step(step.init_state(), TrainPipeline(cfg, step.env, 4, SEQ, seed=SEED).batch_at(0))
        out[where] = (m, dict(ops.LAUNCHES), params_to_jax(model))
        if where == "cuda":
            n_fsdp = sum(d is not None for d in step.dims.values())
    (mc, _, pc), (mg, launches, pg) = out["cpu"], out["cuda"]
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-2 * float(mc["loss"])
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 5e-2 * float(mc["grad_norm"])
    assert launches["ring_fused_step"] == n_fsdp
    assert (launches["segment_reduce"] > 0) == (cfg.moe is not None)
    for k in pc:
        np.testing.assert_allclose(pg[k], pc[k], rtol=0, atol=2 * mc["lr"] * 1.01, err_msg=k)
