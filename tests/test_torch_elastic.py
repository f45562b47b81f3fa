"""The port's checkpoints, elastic restart and fault-tolerance runtime vs the
JAX package's, on the CPU.

One subprocess runs the JAX side on 8 fake CPU devices: the reference's
train CLI at qwen1.5's smoke size, ``--mesh 8,1 --ckpt-every 4
--fail-step 14 --shrink-to 4`` for 20 steps (its store keeps every step,
so the step-8 checkpoint is still there), and grok-1-314b's smoke config,
whose parameters are bf16 (``param_dtype``), for three steps on one device
from ``init_params`` then ``test_torch_serve.perturb`` (rounded to bf16),
with AdamW at lr 1e-2 (one warmup step) so that each update moves a bf16
parameter.

The port restores the reference's step-8 checkpoint and takes the same
restart; it trains grok from the same bf16 parameters. Tolerances are
``test_torch_train``'s: each loss within ``LOSS_TOL`` relative, each
parameter within two steps of lr elementwise and the whole update within
``UPDATE_TOL`` normwise. Checkpoint files and the fault-tolerance runtime
are held bitwise and exactly: the reference's store and
``runtime/fault_tolerance.py`` are imported here (neither runs a
computation in JAX).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TrainPipeline  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.optim import AdamW, OptState  # noqa: E402
from repro_torch.runtime import fault_tolerance as ft  # noqa: E402
from test_torch_train import LOSS_TOL, UPDATE_TOL  # noqa: E402

CLI = ["--arch", "qwen1.5-0.5b", "--smoke", "--mesh", "8,1", "--ckpt-every", "4",
       "--fail-step", "14", "--shrink-to", "4", "--steps", "20", "--log-every", "100"]
RESTORE_AT = 8
GROK, GB, SEQ, SEED, STEPS, GROK_LR = "grok_1_314b", 4, 32, 3, 3, 1e-2

JAX_SCRIPT = r"""
import functools, sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_serve as TS
import test_torch_elastic as T
import repro.checkpoint.store as S
from repro.configs import get_smoke_config
from repro.data.pipeline import TrainPipeline
from repro.launch import steps, train
from repro.launch.mesh import make_mesh
from repro.models.common import init_params
from repro.optim.adamw import AdamW

out = {{}}
S.CheckpointStore = functools.partial(S.CheckpointStore, keep=100)  # keep step 8
out["cli_losses"] = np.asarray(train.run(train.parser().parse_args(T.CLI + ["--ckpt", {ckpt!r}])))

cfg = get_smoke_config(T.GROK)
step, env, bundle = steps.make_train_step(
    cfg, make_mesh((1, 1)), optimizer=AdamW(lr=T.GROK_LR, warmup_steps=1),
    global_batch=T.GB, seq=T.SEQ)
params = init_params(bundle["param_leafspecs"], 0, jnp.dtype(cfg.param_dtype), env)
leaves, treedef = jax.tree_util.tree_flatten(params)
out["grok/init_dtypes"] = np.asarray(sorted({{str(l.dtype) for l in leaves}}))
flat = TS.perturb(TS.flat_tree(params))
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(flat[k], jnp.bfloat16) for k in TS.flat_tree(params)])
out.update({{f"grok/param0/{{k}}": v for k, v in TS.flat_tree(params).items()}})
state = bundle["init_state"](params)
pipe = TrainPipeline(cfg, env, T.GB, T.SEQ, seed=T.SEED)
for k in range(T.STEPS):
    params, state, m = step(params, state, pipe.batch_at(k))
    for n in ("loss", "grad_norm", "lr"):
        out[f"grok/{{k}}/{{n}}"] = np.asarray(m[n])
out.update({{f"grok/param/{{k}}": v for k, v in TS.flat_tree(params).items()}})
out["grok/dtypes"] = np.asarray(sorted({{str(l.dtype) for l in jax.tree_util.tree_leaves(params)}}))
out["grok/moment_dtypes"] = np.asarray(
    sorted({{str(l.dtype) for l in jax.tree_util.tree_leaves(state.m)}}))
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_elastic")
    path, ckpt = str(d / "out.npz"), str(d / "ckpt")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path, ckpt=ckpt),
                               n_devices=8)
    with np.load(path) as f:
        out = dict(f)
    out["ckpt"] = ckpt
    return out


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- runtime --
def _monitor_trace(mod):
    now = [0.0]
    hb = mod.HeartbeatMonitor(timeout_s=5.0, clock=lambda: now[0])
    trace = []
    for h in ("a", "b", "c", "d"):
        hb.register(h)
    for t, beats in ((3.0, "ab"), (6.0, "a"), (9.0, "ac"), (12.0, ""), (13.0, "bd"),
                     (20.0, "abcd")):
        now[0] = t
        for h in beats:
            hb.beat(h)
        trace.append((sorted(hb.dead_hosts()), list(hb.alive)))
    sp = mod.StragglerPolicy(factor=1.5, patience=2)
    for times in ({"a": 1.0, "b": 1.1, "c": 2.0}, {"a": 1.0, "b": 1.6, "c": 2.0},
                  {"a": 1.0, "b": 1.6, "c": 1.0}, {}, {"a": 0.0, "b": 0.0},
                  {"a": 1.0, "b": 1.7, "c": 1.0, "d": 3.0}):
        trace.append(sorted(sp.observe(times)))
    return trace


def test_heartbeat_and_straggler_policy_match_the_reference():
    from repro.runtime import fault_tolerance as ref

    assert _monitor_trace(ft) == _monitor_trace(ref)


@pytest.mark.parametrize("model_size", [1, 2, 4, 8, 16])
def test_elastic_mesh_plan_matches_the_reference(model_size):
    """Over a grid of device counts and pod sizes: the same plan, or the
    same error."""
    from repro.runtime import fault_tolerance as ref

    for n in list(range(0, 70)) + [255, 256, 257, 400, 511, 512, 513, 1000]:
        for pod in (1, 2, 4):
            got = want = None
            try:
                want = ref.elastic_mesh_plan(n, model_size=model_size, pod_size=pod)
            except ValueError as e:
                want = ("raise", str(e))
                with pytest.raises(ValueError) as info:
                    ft.elastic_mesh_plan(n, model_size=model_size, pod_size=pod)
                got = ("raise", str(info.value))
            if got is None:
                p = ft.elastic_mesh_plan(n, model_size=model_size, pod_size=pod)
                got, want = (p.shape, p.axes, p.devices), (want.shape, want.axes, want.devices)
            assert got == want, (n, model_size, pod)


def test_fleet_simulator_matches_the_reference():
    from repro.runtime import fault_tolerance as ref

    kw = dict(n_hosts=6, fail_at={3: ["host1", "host4"], 5: ["host0"]},
              recover_at={6: ["host1"], 9: ["host0", "host4"]})
    for step in range(12):
        assert ft.FleetSimulator(**kw).hosts_at(step) == ref.FleetSimulator(**kw).hosts_at(step)


# ------------------------------------------------------------------ store --
def _leaf(dtype: str, shape=(3, 5)):
    rs = np.random.RandomState(len(dtype))
    if dtype == "bfloat16":
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(torch.bfloat16)
    if dtype in ("int8", "int32"):
        return torch.from_numpy(rs.randint(-100, 100, shape).astype(dtype))
    return torch.from_numpy(rs.randn(*shape).astype(dtype))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, in the same dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32"])
def test_store_round_trip(tmp_path, dtype):
    """A leaf of each dtype and a 0-d count come back bitwise, in their
    dtype, flat or into a template (a NamedTuple's fields by index)."""
    store = CheckpointStore(str(tmp_path))
    tree = {"params": {"w": _leaf(dtype), "b": _leaf(dtype, (4,))},
            "opt": OptState(np.int32(7), {"w": _leaf("float32")}, {"w": _leaf("float32")})}
    store.save(3, tree, meta={"arch": "x"})
    flat, manifest = store.restore(device="cpu")
    assert manifest["step"] == 3 and manifest["meta"] == {"arch": "x"}
    assert manifest["leaves"]["params/w"]["dtype"] == dtype
    assert _same(flat["params/w"], tree["params"]["w"])
    assert flat["opt/0"].dtype == torch.int32 and int(flat["opt/0"]) == 7
    back, _ = store.restore(tree, device="cpu")
    assert isinstance(back["opt"], OptState)
    assert _same(back["params"]["b"], tree["params"]["b"])
    assert _same(back["opt"].v["w"], tree["opt"].v["w"])
    with pytest.raises(ValueError, match="template"):
        store.restore({"params": {"w": torch.zeros(2, 2), "b": None}, "opt": tree["opt"]},
                      device="cpu")


def test_store_keeps_the_newest_and_ignores_unfinished_writes(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, {"x": np.full((2,), s, np.float32)})
    os.makedirs(tmp_path / "step_00000009.tmp123_456")  # a write that did not finish
    assert store.list_steps() == [3, 4] and store.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004",
                                            "step_00000009.tmp123_456"]
    assert float(store.restore(step=3, device="cpu")[0]["x"][0]) == 3
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path / "empty")).restore(device="cpu")


def test_async_save_holds_the_values_before_an_in_place_update(tmp_path):
    """The snapshot is a copy: an update in place right after ``save``
    returns (as AdamW's next step would make) does not reach the files."""
    store = CheckpointStore(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.ones(8, dtype=torch.bfloat16)
    store.save(1, {"w": w, "b": b}, blocking=False)
    w.add_(1.0)
    b.mul_(3)
    store.wait()
    flat, _ = store.restore(device="cpu")
    assert torch.equal(flat["w"], torch.arange(1 << 16, dtype=torch.float32))
    assert torch.equal(flat["b"], torch.ones(8, dtype=torch.bfloat16))
    assert store.stats[0]["bytes"] == (1 << 16) * 4 + 16 and store.stats[0]["write_ms"] > 0


def _mixed_tree():
    import ml_dtypes

    rs = np.random.RandomState(0)
    return {"params": {"embed": rs.randn(6, 4).astype(np.float32),
                       "blocks": {"0_attn_moe": {"moe": {
                           "router": rs.randn(4, 2).astype(ml_dtypes.bfloat16)}}}},
            "opt": (np.int32(11), {"codes": rs.randint(-127, 128, (2, 256)).astype(np.int8)},
                    {"ids": rs.randint(0, 9, (5,)).astype(np.int32)})}


def test_the_reference_s_checkpoint_restores_bitwise_in_the_port(tmp_path):
    from repro.checkpoint.store import CheckpointStore as RefStore

    tree = _mixed_tree()
    RefStore(str(tmp_path)).save(5, tree, meta={"arch": "ref"})
    flat, manifest = CheckpointStore(str(tmp_path)).restore(device="cpu")
    assert manifest["meta"] == {"arch": "ref"}
    router = flat["params/blocks/0_attn_moe/moe/router"]
    assert router.dtype == torch.bfloat16
    want = tree["params"]["blocks"]["0_attn_moe"]["moe"]["router"].view(np.int16)
    np.testing.assert_array_equal(router.view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(flat["params/embed"].numpy(), tree["params"]["embed"])
    np.testing.assert_array_equal(flat["opt/1/codes"].numpy(), tree["opt"][1]["codes"])
    np.testing.assert_array_equal(flat["opt/2/ids"].numpy(), tree["opt"][2]["ids"])
    assert int(flat["opt/0"]) == 11 and flat["opt/0"].dtype == torch.int32


def test_the_port_s_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    """The reference's store loads the port's files bitwise (a bf16 leaf as
    the 2-byte words its own ``np.load`` gives), and the two packages write
    the same bytes for the same tree."""
    from repro.checkpoint.store import CheckpointStore as RefStore

    tree = _mixed_tree()
    port_tree = {"params": {"embed": torch.from_numpy(tree["params"]["embed"]),
                            "blocks": {"0_attn_moe": {"moe": {"router": torch.from_numpy(
                                tree["params"]["blocks"]["0_attn_moe"]["moe"]["router"]
                                .view(np.int16)).view(torch.bfloat16)}}}},
                 "opt": (np.int32(11), {"codes": torch.from_numpy(tree["opt"][1]["codes"])},
                         {"ids": torch.from_numpy(tree["opt"][2]["ids"])})}
    CheckpointStore(str(tmp_path / "port")).save(5, port_tree, meta={"arch": "port"})
    RefStore(str(tmp_path / "ref")).save(5, tree, meta={"arch": "port"})
    got, manifest = RefStore(str(tmp_path / "port")).restore(tree)
    ref_manifest = RefStore(str(tmp_path / "ref")).restore(tree)[1]
    assert manifest == ref_manifest
    router = got["params"]["blocks"]["0_attn_moe"]["moe"]["router"]
    want = tree["params"]["blocks"]["0_attn_moe"]["moe"]["router"]
    np.testing.assert_array_equal(router.view(np.int16), want.view(np.int16))
    np.testing.assert_array_equal(got["opt"][1]["codes"], tree["opt"][1]["codes"])
    for name in os.listdir(tmp_path / "ref" / "step_00000005"):
        a = (tmp_path / "ref" / "step_00000005" / name).read_bytes()
        assert a == (tmp_path / "port" / "step_00000005" / name).read_bytes(), name


# ------------------------------------------------------- elastic restart --
def test_restart_from_the_reference_s_checkpoint_matches_its_losses(jax_out, tmp_path):
    """The port's CLI starts from the reference's step-8 checkpoint at world
    8, fails at step 14, restores its own step 12 at world 4 and runs to 20:
    every loss after step 8 within ``LOSS_TOL`` of the reference's."""
    ckpt = tmp_path / "ckpt"
    src = os.path.join(jax_out["ckpt"], f"step_{RESTORE_AT:08d}")
    shutil.copytree(src, ckpt / f"step_{RESTORE_AT:08d}")
    losses = train.run(train.parser().parse_args(CLI + ["--ckpt", str(ckpt), "--device", "cpu"]))
    want = jax_out["cli_losses"][RESTORE_AT:]
    assert len(losses) == len(want) == 14
    np.testing.assert_allclose(losses, want, rtol=LOSS_TOL, atol=0)
    assert CheckpointStore(str(ckpt)).list_steps() == [12, 16, 20]


def test_restored_state_equals_the_saved_state(tmp_path):
    """``restore`` puts back the parameters and fp32 moments that
    ``checkpoint_tree`` saved, bitwise, on a train step of another world."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = train.Model(cfg, device="cpu", seed=1)
    step = steps.make_train_step(model, make_mesh((4, 1), device="cpu"), global_batch=8, seq=16)
    state = step.init_state()
    state, _ = step(state, TrainPipeline(cfg, step.env, 8, 16, seed=1).batch_at(0))
    saved = {k: p.detach().clone() for k, p in step.params.items()}
    store = CheckpointStore(str(tmp_path))
    store.save(1, train.checkpoint_tree(step, state), meta={"world": 4})
    fresh = train.Model(cfg, device="cpu", seed=2)
    step2 = steps.make_train_step(fresh, make_mesh((2, 1), device="cpu"), global_batch=8, seq=16)
    state2, at = train.restore(step2, store)
    assert at == 1 and state2.count == state.count == 1
    for k, p in step2.params.items():
        assert torch.equal(p, saved[k]), k
        assert torch.equal(state2.m[k], state.m[k]) and torch.equal(state2.v[k], state.v[k]), k
    assert torch.equal(fresh.blocks[0].mlp.wo_c, saved["blocks.0.mlp.wo"].to(torch.bfloat16))


def _run8(tmp_path, mesh: str, steps_: int, *extra):
    return train.run(train.parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--mesh", mesh, "--steps", str(steps_),
         "--ckpt", str(tmp_path), "--ckpt-every", "2", "--device", "cpu", "--seq", "16",
         *extra]), optimizer=AdamW(eightbit=True))


def test_eightbit_moments_restore_at_their_world_and_refuse_another(tmp_path):
    """8-bit moments are cut per rank's FSDP shard: a restart at the same
    world carries on bitwise, a change of world raises."""
    straight = _run8(tmp_path / "a", "4,1", 6)
    first = _run8(tmp_path / "b", "4,1", 4)
    resumed = _run8(tmp_path / "b", "4,1", 6)
    assert first + resumed == straight
    with pytest.raises(ValueError, match="8-bit moments .* world 4 .* world 2"):
        _run8(tmp_path / "b", "2,1", 8)
    with pytest.raises(ValueError, match="8-bit moments .* world 4 .* world 2"):
        _run8(tmp_path / "c", "4,1", 6, "--fail-step", "5", "--shrink-to", "2")


# ------------------------------------------------------ param_dtype repair --
def test_grok_trains_in_bf16_in_step_with_the_reference(jax_out):
    """grok-1-314b stores its parameters in bf16 (``param_dtype``), its
    moments in fp32, and AdamW rounds each update to bf16 as the
    reference's does: three steps' losses, and the parameters after them,
    within ``test_torch_train``'s tolerances of the reference's. With fp32
    masters (the port before it honoured ``param_dtype``) the parameters
    are not bf16 and drift from the reference's from the second step."""
    assert list(jax_out["grok/init_dtypes"]) == ["bfloat16"]
    assert list(jax_out["grok/dtypes"]) == ["bfloat16"]
    assert list(jax_out["grok/moment_dtypes"]) == ["float32"]
    cfg = get_smoke_config(GROK)
    p0 = {k[len("grok/param0/"):]: v for k, v in jax_out.items() if k.startswith("grok/param0/")}
    model = params_from_jax(p0, cfg, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert model.blocks[0].moe.wo_c.untyped_storage().data_ptr() == \
        model.blocks[0].moe.wo.untyped_storage().data_ptr()  # its own compute copy
    mesh = make_mesh((1, 1), device="cpu")
    step = steps.make_train_step(model, mesh, optimizer=AdamW(lr=GROK_LR, warmup_steps=1),
                                 global_batch=GB, seq=SEQ)
    state = step.init_state()
    pipe = TrainPipeline(cfg, step.env, GB, SEQ, seed=SEED)
    lrs = []
    for k in range(STEPS):
        state, m = step(state, pipe.batch_at(k))
        want = float(jax_out[f"grok/{k}/loss"])
        assert abs(float(m["loss"]) - want) <= LOSS_TOL * want, k
        assert abs(m["lr"] - float(jax_out[f"grok/{k}/lr"])) <= 1e-6 * m["lr"]
        lrs.append(m["lr"])
    assert {t.dtype for t in state.m.values()} == {torch.float32}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    got = {k: v.astype(np.float32) for k, v in params_to_jax(model).items()}
    want = {k[len("grok/param/"):]: v for k, v in jax_out.items() if k.startswith("grok/param/")}
    assert set(got) == set(want)
    step_atol = 2 * sum(lrs) * 1.01
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=step_atol, err_msg=k)
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    assert rel(d_got, d_want) <= UPDATE_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the snapshot into pinned memory runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_async_save_from_the_card_snapshots_before_an_update(cuda, tmp_path):
    """Tensors on the card are copied into pinned host memory before
    ``save`` returns: an in-place update right after it does not reach the
    files, and the restore puts fp32 and bf16 leaves back on the card
    bitwise."""
    store = CheckpointStore(str(tmp_path))
    w = torch.randn(1 << 20, device=cuda)
    b = torch.randn(1 << 10, device=cuda).to(torch.bfloat16)
    want_w, want_b = w.clone(), b.clone()
    store.save(2, {"w": w, "b": b}, blocking=False)
    w.mul_(2)
    b.add_(1)
    store.wait()
    flat, _ = store.restore(device=cuda)
    assert flat["w"].device.type == "cuda"
    assert _same(flat["w"], want_w) and _same(flat["b"], want_b)
