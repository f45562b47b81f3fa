"""``Model.train_loss`` and its gradients vs the JAX package's, on the CPU,
for every smoke config.

One subprocess runs the JAX side: each smoke config's parameters
(``init_params`` seed 0, then ``test_torch_serve.perturb``, so that biases,
norm scales and the recurrences' vectors matter), one ``TrainPipeline``
batch (seed 4, global batch 2, sequence 32, a (1, 1) mesh), and
``jax.value_and_grad`` of ``models.model.train_loss`` inside a ``shard_map``
(remat on, as the configs ask; the MoE configs' load-balance loss in the
loss). The port loads the same parameters (``convert.params_from_jax``) and
batch, and compares the loss, Σ nll, the token count and every leaf's
gradient (``convert.to_jax``).

Both run every product in bf16, and XLA fuses and rounds in other places,
so the two agree to bf16 rounding: the loss within ``LOSS_TOL`` relative,
the whole gradient within ``GRAD_TOL`` and each leaf within
``LEAF_TOL[family]`` normwise relative (a few bf16 roundings, 2**-9 each, on
the way back; the recurrent families chain more of them through their
scans, and qwen1.5's key bias has a gradient that is rounding only, since a
bias shared by every key cancels in the softmax).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax, to_jax  # noqa: E402

B, S, SEED = 2, 32, 4
LOSS_TOL = 2e-4
GRAD_TOL = 2e-2
LEAF_TOL = {"dense": 5e-2, "moe": 3e-2, "ssm": 3e-2, "hybrid": 5e-2, "encdec": 3e-2}
# the load-balance loss (loss − Σ nll): fp32 means of fp32 softmaxes of bf16 inputs
AUX_TOL = 1e-3

JAX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_serve as TS
import test_torch_train_loss as T
from repro.configs import ARCHS, get_smoke_config
from repro.data.pipeline import TrainPipeline
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.models.common import init_params, tree_partition_specs

out = {{}}
mesh = make_mesh((1, 1), ("data", "model"))
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    env = steps.make_env(cfg, mesh)
    specs = M.param_specs(cfg, env)
    params = init_params(specs, 0, jnp.float32, env)
    flat = TS.perturb(TS.flat_tree(params))
    _, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in TS.flat_tree(params)])
    out.update({{f"{{arch}}/param/{{k}}": v for k, v in flat.items()}})
    batch = TrainPipeline(cfg, env, T.B, T.S, seed=T.SEED).batch_at(0)
    out.update({{f"{{arch}}/batch/{{k}}": np.asarray(v) for k, v in batch.items()}})

    def f(p, b):
        (loss, aux), g = jax.value_and_grad(
            lambda q: M.train_loss(q, steps._strip(b, 2), cfg, env), has_aux=True)(p)
        return loss, aux["nll_sum"], aux["ntok"], g

    p_part = tree_partition_specs(specs, env.fsdp_axes)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(p_part, P("data", "model")),
                               out_specs=(P(), P(), P(), p_part), check_vma=False))
    loss, nll, ntok, g = fn(params, batch)
    out[f"{{arch}}/loss"], out[f"{{arch}}/nll"] = np.asarray(loss), np.asarray(nll)
    out[f"{{arch}}/ntok"] = np.asarray(ntok)
    out.update({{f"{{arch}}/grad/{{k}}": v for k, v in TS.flat_tree(g).items()}})
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_train_loss") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=1)
    with np.load(path) as f:
        return dict(f)


def port_loss(jax_out, arch, cfg=None):
    """(loss, aux, {port name: gradient}, model) of the port on the JAX
    run's parameters and batch (its (1, 1) mesh dims dropped)."""
    cfg = cfg or get_smoke_config(arch)
    pre = f"{arch}/param/"
    model = params_from_jax({k[len(pre):]: v for k, v in jax_out.items() if k.startswith(pre)},
                            cfg, device="cpu")
    model.requires_grad_(True)
    pre = f"{arch}/batch/"
    batch = {k[len(pre):]: torch.from_numpy(v.reshape(v.shape[2:]))
             for k, v in jax_out.items() if k.startswith(pre)}
    loss, aux = model.train_loss(batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), aux, dict(zip(params, grads)), model


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(jax_out, arch):
    cfg = get_smoke_config(arch)
    loss, aux, grads, model = port_loss(jax_out, arch)
    want_loss, want_nll = float(jax_out[f"{arch}/loss"]), float(jax_out[f"{arch}/nll"])
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert abs(float(aux["nll_sum"]) - want_nll) <= LOSS_TOL * abs(want_nll)
    assert int(aux["ntok"]) == int(jax_out[f"{arch}/ntok"])
    if cfg.moe is not None:  # the router's load-balance loss is in the loss
        want_aux = want_loss - want_nll
        assert want_aux > 0
        assert abs(float(loss - aux["nll_sum"]) - want_aux) <= AUX_TOL * want_aux + 1e-5
    got = to_jax(model, grads)
    want = {k[len(f"{arch}/grad/"):]: v for k, v in jax_out.items()
            if k.startswith(f"{arch}/grad/")}
    assert set(got) == set(want)
    num = sum(np.sum((got[k] - want[k]) ** 2) for k in want)
    assert np.sqrt(num / sum(np.sum(w ** 2) for w in want.values())) <= GRAD_TOL
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if np.any(w):
            assert rel(got[k], w) <= LEAF_TOL[cfg.family], (k, rel(got[k], w))
        else:  # a leaf the loss does not reach (qwen2-vl's embedding: embeds come in)
            assert not np.any(got[k]), k


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "granite_moe_1b_a400m", "recurrentgemma_2b"])
def test_remat_gives_the_same_numbers(jax_out, arch):
    """Each layer under ``torch.utils.checkpoint`` (the configs' remat) and
    without it: the same loss and gradients, bitwise."""
    cfg = get_smoke_config(arch)
    assert cfg.remat
    loss, _, grads, _ = port_loss(jax_out, arch, cfg)
    loss0, _, grads0, _ = port_loss(jax_out, arch, dataclasses.replace(cfg, remat=False))
    assert torch.equal(loss, loss0)
    for k, g in grads.items():
        assert (g is None and grads0[k] is None) or torch.equal(g, grads0[k]), k


def test_flash_raises_in_training(jax_out):
    model = params_from_jax({k.split("/", 2)[2]: v for k, v in jax_out.items()
                             if k.startswith("qwen1_5_0_5b/param/")},
                            get_smoke_config("qwen1.5-0.5b"), device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        model.train_loss({"tokens": toks, "labels": toks}, impl="flash")
