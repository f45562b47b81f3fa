"""Training every other block kind across a ("data", "model") mesh: the
port's train step vs the JAX package's ``make_train_step``, on the CPU.

One subprocess on 8 fake CPU devices runs the reference (``CASES``, smoke
configs, sequence 32, ``TrainPipeline`` seed 3, S3 aggregation): granite-moe
at (2, 4) (tp 4, its 2 kv heads over span 2, 4 experts a slot a rank) on the
``a2a`` dispatch and on the ``replicated`` one, two steps each; minicpm3
(MLA) and mamba2 (SSD) at (2, 2); recurrentgemma (RG-LRU with local
attention) at (1, 8), where its smoke heads give tp 4 and rep 2, on a global
batch of 3 that does not split over the rep groups; qwen2-vl (M-RoPE over
embeddings) at (1, 4); seamless (enc-dec) at (2, 2); and grok-1 (bf16
parameters) at (2, 2) with 8-bit moments, two steps at lr 1e-2. Parameters
as ``test_torch_tp_train``'s. After its granite-moe ``a2a`` steps it writes
a checkpoint with its own store (fp32 moments).

The port takes the same steps from the same parameters; parameters and
moments are read back to logical leaves, which refuses kv and expert copies
that differ. Tolerances are ``test_torch_train``'s. The 8-bit moments are
cut per device shard in both packages, the FSDP chunk × the model axis's
chunk of the TP dim of the stacked leaf, so both quantize the same
256-element blocks; the gradients differ by bf16 rounding (the
row-parallel partials), which turns some codes the other way, and the
dequantized moments differ by a quantization step there: ``EIGHTBIT_TOL``
per leaf (measured 6.2e-2), ``MOMENT_TOL`` over the tree.

Checkpoints at tp > 1 cross both ways: the port restores the reference's
(its parameters and moments bitwise), and the reference's store reads the
port's tree back with the reference's keys, shapes (kv slots, expert slots,
the vocab padded to the model axis) and values, bitwise.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TrainPipeline  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax, to_jax  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.adamw import dequantize_block8, unshard_rows  # noqa: E402
from test_torch_tp_train import logical, subtree  # noqa: E402
from test_torch_train import (LOSS_TOL, MOMENT_TOL, MOMENTS_TOL, NORM_TOL,  # noqa: E402
                              UPDATE_TOL, rel)

SEQ, SEED = 32, 3
SCENARIO = "s3_in_net_map"
CASES = {  # tag: (arch, mesh, global batch, steps, moe dispatch)
    "granite_a2a": ("granite_moe_1b_a400m", (2, 4), 8, 2, "a2a"),
    "granite_replicated": ("granite_moe_1b_a400m", (2, 4), 8, 2, "replicated"),
    "minicpm3": ("minicpm3_4b", (2, 2), 8, 1, None),
    "mamba2": ("mamba2_1_3b", (2, 2), 8, 1, None),
    "recurrentgemma": ("recurrentgemma_2b", (1, 8), 3, 1, None),
    "qwen2_vl": ("qwen2_vl_7b", (1, 4), 4, 1, None),
    "seamless": ("seamless_m4t_large_v2", (2, 2), 8, 1, None),
    "grok_8bit": ("grok_1_314b", (2, 2), 4, 2, None),
}
EIGHTBIT = {"grok_8bit": {"lr": 1e-2, "warmup_steps": 1, "eightbit": True}}
CKPT_CASE = "granite_a2a"
# the dequantized 8-bit moments after two steps, per leaf (measured 5.9e-2
# for m, 6.2e-2 for v: a gradient's bf16 rounding turns a code by one step
# of its block's absmax / 127, large against the block's typical element)
# and over the tree at MOMENT_TOL (measured 2.7e-2 and 2.4e-2)
EIGHTBIT_TOL = 1e-1
# A second 8-bit step divides by a v that its codes rounded toward 0 while
# m's did not (an embedding row its batch does not use has g = 0: the step
# is m / eps): updates of 0.1 to 1e3 in both packages, at elements that a
# rounding of the codes decides (ROADMAP.md §3). Parameters compare where
# both updates are within ``STEP_BOUND`` steps of lr (an Adam step is about
# lr); the others must stay few (measured 2.0% of the elements), and each
# of them must hold a v code at 0 in one package or the other (measured:
# all of them; 11.7% of all elements do)
STEP_BOUND, EXPLODED_SHARE = 1.5, 0.05
# grok's second step at lr 1e-2 (bf16 parameters move only with a large
# step): the first step is lr · sign(g) for most elements, so an element
# whose gradient is rounding noise moved by ±lr in either package, and the
# second gradient's norm differs by more than NORM_TOL (measured 3.2e-3)
LR_NORM_TOL = 1e-2

JAX_SCRIPT = r"""
import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_serve as TS
import test_torch_tp_serve as TP
import test_torch_tp_train_kinds as T
import repro.checkpoint.store as S
from repro.configs import get_smoke_config
from repro.data.pipeline import TrainPipeline
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.models.common import init_params
from repro.optim.adamw import AdamW


def flat8(tree):
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {{jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(l) for p, l in paths}}


out = {{}}
for tag, (arch, shape, gb, n_steps, dispatch) in T.CASES.items():
    cfg = get_smoke_config(arch)
    if dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    mesh = make_mesh(shape)
    opt = AdamW(**T.EIGHTBIT[tag]) if tag in T.EIGHTBIT else None
    step, env, bundle = steps.make_train_step(cfg, mesh, scenario=T.SCENARIO, optimizer=opt,
                                              global_batch=gb, seq=T.SEQ)
    params = init_params(bundle["param_leafspecs"], 0, jnp.dtype(cfg.param_dtype), env)
    flat = TP.perturb(TS.flat_tree(params), cfg, env)
    _, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[k], jnp.dtype(cfg.param_dtype)) for k in TS.flat_tree(params)])
    out.update({{f"{{tag}}/param0/{{k}}": v for k, v in TS.flat_tree(params).items()}})
    shard = jax.tree_util.tree_map(lambda p: jax.sharding.NamedSharding(mesh, p),
                                   bundle["param_partition"])
    params = jax.device_put(params, shard)
    state = bundle["init_state"](params)
    pipe = TrainPipeline(cfg, env, gb, T.SEQ, seed=T.SEED)
    for k in range(n_steps):
        params, state, m = step(params, state, pipe.batch_at(k))
        for n in ("loss", "grad_norm", "lr", "ntok"):
            out[f"{{tag}}/{{k}}/{{n}}"] = np.asarray(m[n])
    out.update({{f"{{tag}}/param/{{k}}": v for k, v in TS.flat_tree(params).items()}})
    if tag in T.EIGHTBIT:
        out.update({{f"{{tag}}/m8/{{k}}": v for k, v in flat8(state.m).items()}})
        out.update({{f"{{tag}}/v8/{{k}}": v for k, v in flat8(state.v).items()}})
    else:
        out.update({{f"{{tag}}/m/{{k}}": v for k, v in TS.flat_tree(state.m).items()}})
        out.update({{f"{{tag}}/v/{{k}}": v for k, v in TS.flat_tree(state.v).items()}})
    if tag == T.CKPT_CASE:
        S.CheckpointStore({ckpt!r}).save(n_steps, {{"params": params, "opt": state}},
                                         meta={{"arch": cfg.name}})
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_tp_kinds")
    path, ckpt = str(d / "out.npz"), str(d / "ckpt")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path, ckpt=ckpt),
                               n_devices=8)
    with np.load(path) as f:
        out = dict(f)
    out["ckpt"] = ckpt
    return out


def case_config(tag):
    arch, shape, gb, n_steps, dispatch = CASES[tag]
    cfg = get_smoke_config(arch)
    if dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return cfg, shape, gb, n_steps


def port_steps(jax_out, tag, n_steps=None):
    """(train step, state, [metrics], [lr]) of the port's steps from the
    case's parameters."""
    cfg, shape, gb, steps_ = case_config(tag)
    mesh = make_mesh(shape, device="cpu")
    env = steps.make_env(cfg, mesh, SCENARIO)
    model = params_from_jax(subtree(jax_out, f"{tag}/param0/"), cfg, env=env, device="cpu")
    opt = AdamW(**EIGHTBIT[tag]) if tag in EIGHTBIT else None
    step = steps.make_train_step(model, mesh, scenario=SCENARIO, optimizer=opt,
                                 global_batch=gb, seq=SEQ)
    state = step.init_state()
    pipe = TrainPipeline(cfg, step.env, gb, SEQ, seed=SEED)
    metrics = []
    for k in range(steps_ if n_steps is None else n_steps):
        state, m = step(state, pipe.batch_at(k))
        metrics.append(m)
    return step, state, metrics


def reference_eightbit(jax_out, tag: str, what: str, step) -> dict:
    """The reference's device-major 8-bit moments → logical fp32 leaves: each
    device's (codes, scales) dequantized into its shard of the stacked
    storage leaf, the shards put in place, the slots read back."""
    from repro_torch.models import specs

    env = step.env

    want_shapes = {k[len(f"{tag}/param/"):]: v.shape for k, v in jax_out.items()
                   if k.startswith(f"{tag}/param/")}
    tree = {}
    for path, shape in want_shapes.items():
        codes = jax_out[f"{tag}/{what}8/{path}/0"]  # (data, model, nb, 256)
        scale = jax_out[f"{tag}/{what}8/{path}/1"]
        key = specs.layer_leaf(path)
        stacked = int(path.split("/")[0] in ("blocks", "enc_blocks"))
        fd, td = specs.FSDP_DIM[key], specs.TP_DIM[key]
        cuts = [(d + stacked, n) for d, n in ((fd, env.fsdp_size), (td, env.model_size))
                if d is not None]
        local = list(shape)
        for d, n in cuts:
            local[d] //= n
        full = np.zeros(shape, np.float32)
        for f in range(env.data_size):
            for m in range(env.model_size):
                vals = (codes[f, m].astype(np.float32) * scale[f, m][:, None]).reshape(-1)
                idx = [slice(None)] * len(shape)
                for (d, n), i in zip(cuts, (f, m) if fd is not None else (m,)):
                    idx[d] = slice(i * local[d], (i + 1) * local[d])
                full[tuple(idx)] = vals[:int(np.prod(local))].reshape(local)
        tree[path] = full
    return logical(tree, step.model.cfg, env)


@pytest.mark.parametrize("tag", list(CASES))
def test_tp_train_step_of_each_kind_matches_jax(jax_out, tag):
    cfg, shape, gb, n_steps = case_config(tag)
    p0 = subtree(jax_out, f"{tag}/param0/")
    step, state, metrics = port_steps(jax_out, tag)
    env = step.env
    assert env.tp > 1
    lrs = []
    for k, m in enumerate(metrics):
        want = {n: float(jax_out[f"{tag}/{k}/{n}"]) for n in ("loss", "grad_norm", "lr", "ntok")}
        assert abs(float(m["loss"]) - want["loss"]) <= LOSS_TOL * want["loss"], (k, m, want)
        norm_tol = LR_NORM_TOL if tag in EIGHTBIT and k else NORM_TOL
        assert abs(float(m["grad_norm"]) - want["grad_norm"]) <= norm_tol * want["grad_norm"], \
            (k, m, want)
        assert abs(m["lr"] - want["lr"]) <= 1e-6 * want["lr"]
        assert int(m["ntok"]) == want["ntok"]
        lrs.append(m["lr"])
    model = step.model
    eight = {}  # what: (the port's, the reference's) dequantized 8-bit moments
    for what, tree in (("m", state.m), ("v", state.v)):
        if tag in EIGHTBIT:  # keyed by the stacked leaves, a row a device shard
            shapes = {k: p.shape for k, p in step.opt_tree(step.params).items()}
            got = {k: unshard_rows(dequantize_block8(c, sc, c[0].numel() and
                                                     int(np.prod(shapes[k])) // len(sc)),
                                   shapes[k], step.layout[k]).numpy()
                   for k, (c, sc) in tree.items()}
            want = reference_eightbit(jax_out, tag, what, step)
            worst = max((rel(got[k], w), k) for k, w in want.items())
            assert worst[0] <= EIGHTBIT_TOL, (what, worst)
            eight[what] = (got, want)
            whole = [np.concatenate([t[k].ravel() for k in want]) for t in (got, want)]
            assert rel(*whole) <= MOMENT_TOL, what
            continue
        got, want = to_jax(model, tree), logical(subtree(jax_out, f"{tag}/{what}/"), cfg, env)
        worst = max((rel(got[k], w), k) for k, w in want.items())
        assert worst[0] <= MOMENT_TOL, (what, worst)
        whole = [np.concatenate([t[k].ravel() for k in want]) for t in (got, want)]
        assert rel(*whole) <= MOMENTS_TOL, what
    f32 = {k: v.astype(np.float32) for k, v in params_to_jax(model).items()}
    want = {k: v.astype(np.float32) for k, v in params_to_jax(params_from_jax(
        subtree(jax_out, f"{tag}/param/"), cfg, env=env, device="cpu")).items()}
    lp0 = logical(p0, cfg, env)
    step_atol = 2 * sum(lrs) * 1.01
    d_got = np.concatenate([(f32[k] - lp0[k]).ravel() for k in want])
    d_want = np.concatenate([(want[k] - lp0[k]).ravel() for k in want])
    if tag in EIGHTBIT:
        ok = (np.abs(d_got) <= STEP_BOUND * sum(lrs)) & (np.abs(d_want) <= STEP_BOUND * sum(lrs))
        v_zero = np.concatenate([((eight["v"][0][k] == 0) | (eight["v"][1][k] == 0)).ravel()
                                 for k in want])
        assert 0 < (~ok).mean() <= EXPLODED_SHARE, (~ok).mean()
        # every element left out is one the text above names: a v code at 0
        assert v_zero[~ok].all(), (~ok & ~v_zero).sum()
        np.testing.assert_allclose(d_got[ok], d_want[ok], rtol=0, atol=step_atol)
        assert rel(d_got[ok], d_want[ok]) <= UPDATE_TOL
        return
    for k, w in want.items():
        np.testing.assert_allclose(f32[k], w, rtol=0, atol=step_atol, err_msg=k)
    assert rel(d_got, d_want) <= UPDATE_TOL


def test_the_reference_s_tp_checkpoint_restores_in_the_port(jax_out):
    """The reference's checkpoint of granite-moe at (2, 4) (kv and expert
    slots, fp32 moments) restores into the port's step on that mesh: the
    parameters and moments are the reference's, bitwise."""
    cfg, shape, gb, n_steps = case_config(CKPT_CASE)
    step, _, _ = port_steps(jax_out, CKPT_CASE, n_steps=0)
    state, at = train.restore(step, CheckpointStore(jax_out["ckpt"]))
    assert at == n_steps and state.count == n_steps
    env = step.env
    want = logical(subtree(jax_out, f"{CKPT_CASE}/param/"), cfg, env)
    for k, v in params_to_jax(step.model).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for what, tree in (("m", state.m), ("v", state.v)):
        want = logical(subtree(jax_out, f"{CKPT_CASE}/{what}/"), cfg, env)
        for k, v in to_jax(step.model, tree).items():
            np.testing.assert_array_equal(v, want[k], err_msg=(what, k))


def test_the_port_s_tp_checkpoint_restores_in_the_reference(jax_out, tmp_path):
    """The port's ``checkpoint_tree`` at (2, 4), read by the reference's
    store: the reference's keys, shapes (the slots, the padded vocab) and,
    after the port restored the reference's state, its values bitwise."""
    from repro.checkpoint.store import CheckpointStore as RefStore

    cfg, shape, gb, n_steps = case_config(CKPT_CASE)
    step, _, _ = port_steps(jax_out, CKPT_CASE, n_steps=0)
    state, _ = train.restore(step, CheckpointStore(jax_out["ckpt"]))
    CheckpointStore(str(tmp_path)).save(n_steps, train.checkpoint_tree(step, state),
                                        meta=train.checkpoint_meta(step, arch=cfg.name))
    from repro.checkpoint.store import _flatten

    # the reference's own tree, its leaves' names from its manifest
    tree = {}
    for k in CheckpointStore(jax_out["ckpt"]).manifest()["leaves"]:
        *parents, leaf = k.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = None
    tree["opt"] = tuple(tree["opt"][i] for i in ("0", "1", "2"))
    ours, manifest = RefStore(str(tmp_path)).restore(tree)
    theirs, _ = RefStore(jax_out["ckpt"]).restore(tree)
    assert manifest["meta"]["mesh"] == list(shape) and manifest["meta"]["tp"] == step.env.tp
    ours, theirs = _flatten(ours), _flatten(theirs)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        got = np.asarray(ours[k])
        assert got.shape == np.asarray(v).shape and got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
