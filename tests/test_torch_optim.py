"""The port's optimizer, FSDP-dim table and gradient aggregation vs the JAX
package's, on the CPU; and the autograd the training path needs.

One subprocess runs the JAX side: ``quantize_block8``/``dequantize_block8``
on seeded inputs (with exact halves, which round to even, and an all-zero
block), ``AdamW.schedule`` at the steps around warmup and decay, three
``AdamW.update``s of a seeded tree with fp32 and with 8-bit moments, the
8-bit blocks of each FSDP shard of a leaf, and every leaf's
``LeafSpec.fsdp_dim`` from ``param_specs`` for all ten configs.

Tolerances: the codes and scales bitwise (the same IEEE fp32 divisions and
round-half-even); the schedule and the updated parameters and moments
within ``UPDATE_TOL`` relative (fp32 elementwise chains; XLA may contract
or reorder a few of them); the aggregations on a data world against float64
sums within ``AGG_TOL`` (fp32 sums of 4 ranks), S3 within ``S3_TOL`` (bf16 on
the wire: 2**-9 relative per hop, 3 hops).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import ring_scan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.parallel import fsdp_aggregate  # noqa: E402
from repro_torch.models.specs import LeafPlace, leaf_places  # noqa: E402
from repro_torch.optim import AdamW, clip_by_global_norm, global_grad_norm, sync_gradients  # noqa: E402
from repro_torch.optim.adamw import (dequantize_block8, quantize_block8, shard_rows,  # noqa: E402
                                     unshard_rows)

UPDATE_TOL = 1e-6
AGG_TOL = 1e-6
S3_TOL = 8e-3
SHAPES = {"a": (300,), "b": (8, 64), "c": (3, 5, 7)}
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=5)  # the three updates cross warmup and decay
SCHED_STEPS = (0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 12000)
SHARD = ("b", 1, 4)  # leaf, FSDP dim, world of the 8-bit shard case


def quant_inputs() -> dict:
    rs = np.random.RandomState(3)
    halves = np.zeros(256, np.float32)
    halves[:5] = [127.0, 0.5, 1.5, 2.5, -2.5]  # scale 1: codes round half to even
    return {"rand": rs.randn(1000).astype(np.float32) * 0.3,
            "halves": np.concatenate([halves, np.zeros(256, np.float32), -halves]),
            "tiny": rs.randn(77).astype(np.float32) * 1e-25}


def tree(seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


JAX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_optim as T
from repro.configs import ARCHS, get_config
from repro.models import model as JM
from repro.models.common import LeafSpec
from repro.models.parallel import ShardEnv
from repro.optim.adamw import AdamW, dequantize_block8, quantize_block8

out = {{}}
for k, x in T.quant_inputs().items():
    codes, scale = quantize_block8(jnp.asarray(x))
    out[f"q/{{k}}/codes"], out[f"q/{{k}}/scale"] = np.asarray(codes), np.asarray(scale)
    out[f"q/{{k}}/deq"] = np.asarray(dequantize_block8(codes, scale, x.shape))
sched = AdamW()
out["sched"] = np.array([float(sched.schedule(jnp.asarray(s))) for s in T.SCHED_STEPS], np.float32)
for tag, eightbit in (("fp32", False), ("8bit", True)):
    opt = AdamW(eightbit=eightbit, **T.OPT)
    params = {{k: jnp.asarray(v) for k, v in T.tree(0).items()}}
    state = opt.init(params)
    for i in range(3):
        grads = {{k: jnp.asarray(v) for k, v in T.tree(10 + i).items()}}
        params, state = opt.update(grads, state, params)
        out[f"{{tag}}/lr{{i}}"] = np.asarray(opt.schedule(state.count))
        for k in T.SHAPES:
            out[f"{{tag}}/{{i}}/p/{{k}}"] = np.asarray(params[k])
            if eightbit:
                m = dequantize_block8(*state.m[k], params[k].shape)
                v = dequantize_block8(*state.v[k], params[k].shape)
            else:
                m, v = state.m[k], state.v[k]
            out[f"{{tag}}/{{i}}/m/{{k}}"], out[f"{{tag}}/{{i}}/v/{{k}}"] = np.asarray(m), np.asarray(v)
name, dim, world = T.SHARD
x = T.tree(0)[name]
for r, shard in enumerate(np.split(x, world, axis=dim)):
    codes, scale = quantize_block8(jnp.asarray(shard))
    out[f"shard/{{r}}/codes"], out[f"shard/{{r}}/scale"] = np.asarray(codes), np.asarray(scale)
env = ShardEnv(model_size=1, data_size=1)
for arch in ARCHS:
    specs = JM.param_specs(get_config(arch), env)
    leaves, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda v: isinstance(v, LeafSpec))
    for path, ls in leaves:
        key = "/".join(p.key for p in path)
        stacked = key.split("/")[0] in ("blocks", "enc_blocks")
        d = -1 if ls.fsdp_dim is None else ls.fsdp_dim - stacked
        out[f"fsdp/{{arch}}/{{key}}"] = np.asarray(d)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_optim") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=1)
    with np.load(path) as f:
        return dict(f)


def close(got: torch.Tensor, want: np.ndarray, tol: float = UPDATE_TOL, what: str = ""):
    got = got.numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", list(quant_inputs()))
def test_quantize_block8_bitwise(jax_out, name):
    x = torch.from_numpy(quant_inputs()[name])
    codes, scale = quantize_block8(x)
    np.testing.assert_array_equal(codes.numpy(), jax_out[f"q/{name}/codes"])
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  jax_out[f"q/{name}/scale"].view(np.uint32))
    np.testing.assert_array_equal(dequantize_block8(codes, scale, x.numel()).numpy(),
                                  jax_out[f"q/{name}/deq"])


def test_schedule_matches_jax(jax_out):
    got = np.array([AdamW().schedule(s) for s in SCHED_STEPS], np.float32)
    np.testing.assert_allclose(got, jax_out["sched"], rtol=UPDATE_TOL, atol=0)
    assert got[0] == 0 and got[4] == np.float32(3e-4)  # warmup from 0 to lr at step 100


@pytest.mark.parametrize("tag", ["fp32", "8bit"])
def test_adamw_updates_match_jax(jax_out, tag):
    opt = AdamW(eightbit=tag == "8bit", **OPT)
    params = {k: torch.from_numpy(v) for k, v in tree(0).items()}
    state = opt.init(params)
    for i in range(3):
        grads = {k: torch.from_numpy(v) for k, v in tree(10 + i).items()}
        params, state = opt.update(grads, state, params)
        assert state.count == i + 1
        np.testing.assert_allclose(opt.schedule(state.count), jax_out[f"{tag}/lr{i}"],
                                   rtol=UPDATE_TOL)
        for k, p in params.items():
            close(p, jax_out[f"{tag}/{i}/p/{k}"], what=f"step {i} param {k}")
            m, v = state.m[k], state.v[k]
            if opt.eightbit:
                m = unshard_rows(dequantize_block8(*m, p.numel()), p.shape, None)
                v = unshard_rows(dequantize_block8(*v, p.numel()), p.shape, None)
            close(m, jax_out[f"{tag}/{i}/m/{k}"], what=f"step {i} m {k}")
            close(v, jax_out[f"{tag}/{i}/v/{k}"], what=f"step {i} v {k}")


def test_eightbit_blocks_are_cut_from_each_shard(jax_out):
    """With a layout, each rank's FSDP shard is quantized on its own (the
    reference's device-major moments): the codes of shard r are the JAX
    codes of that shard, and the rows map back onto the leaf."""
    name, dim, world = SHARD
    x = torch.from_numpy(tree(0)[name])
    rows = shard_rows(x, ((dim, world),))
    codes, scale = quantize_block8(rows)
    for r in range(world):
        np.testing.assert_array_equal(codes[r].numpy(), jax_out[f"shard/{r}/codes"])
        np.testing.assert_array_equal(scale[r].numpy(), jax_out[f"shard/{r}/scale"])
    assert torch.equal(unshard_rows(rows, x.shape, ((dim, world),)), x)
    opt = AdamW(eightbit=True)
    state = opt.init({name: x}, {name: ((dim, world),)})
    assert state.m[name][0].shape == (world, 1, 256)  # 8 × 16 elements a shard: one block


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_dims_match_param_specs(jax_out, arch):
    """The port's table gives every parameter of the full config the FSDP
    dim of its JAX leaf, the stacked-layer dim dropped (-1: None)."""
    from repro_torch.models.convert import leaf_paths

    model = Model(get_config(arch), device="meta")
    paths = leaf_paths(model)
    want = {k.split("/", 2)[2]: int(v) for k, v in jax_out.items()
            if k.startswith(f"fsdp/{arch}/")}
    got = {}
    for name, pl in leaf_places(model).items():
        dim = pl.fsdp_dim
        got.setdefault(paths[name][0], set()).add(-1 if dim is None else dim)
    assert set(got) == set(want)
    for path, dims in got.items():
        assert dims == {want[path]}, path


def _grads(shape, world_shape, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(*(world_shape + shape)).astype(np.float32)


@pytest.mark.parametrize("mesh_shape", [(4,), (2, 2)])
@pytest.mark.parametrize("scenario", ["native", "s1_host", "s2_in_net", "s3_in_net_map",
                                      "hierarchical"])
def test_fsdp_aggregate_is_the_world_sum(scenario, mesh_shape):
    """Every scenario's aggregation of a leaf along each of its dims (and
    None) is the sum of the ranks' gradients; S3 to bf16 wire rounding."""
    axes = ("data",) if len(mesh_shape) == 1 else ("pod", "data")
    mesh = Mesh(axes, mesh_shape, device="cpu")
    g = _grads((8, 12, 3), mesh_shape)
    want = g.reshape((-1,) + g.shape[len(mesh_shape):]).astype(np.float64).sum(0)
    for dim in (0, 1, None):
        got = fsdp_aggregate(torch.from_numpy(g), mesh, dim, scenario).numpy()
        assert got.shape == want.shape
        wired = scenario == "s3_in_net_map" and dim is not None
        tol = S3_TOL if wired else AGG_TOL
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= tol, (dim, err)
        if wired:
            assert err > 0  # the wire rounds: S3 really ran its bf16 ring
    with pytest.raises(ValueError, match="does not split"):
        fsdp_aggregate(torch.from_numpy(_grads((6, 3), mesh_shape)), mesh, 0, scenario)


def test_sync_and_clip_by_global_norm():
    mesh = Mesh(("data",), (4,), device="cpu")
    rank = {"w": torch.from_numpy(_grads((8, 4), (4,), 1)),
            "b": torch.from_numpy(_grads((3,), (4,), 2))}
    places = {"w": LeafPlace(1, None, 0), "b": LeafPlace(None, None, 0)}
    grads = sync_gradients(rank, places, mesh, "s2_in_net")
    whole = {k: v.numpy().astype(np.float64).sum(0) for k, v in rank.items()}
    for k in rank:
        np.testing.assert_allclose(grads[k].numpy(), whole[k], rtol=AGG_TOL, atol=AGG_TOL)
    norm = np.sqrt(sum((v ** 2).sum() for v in whole.values()))
    np.testing.assert_allclose(float(global_grad_norm(grads)), norm, rtol=1e-6)
    clipped, n = clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(global_grad_norm(clipped)), 1.0, rtol=1e-6)
    same, _ = clip_by_global_norm(grads, 2 * float(n))
    assert all(torch.equal(same[k], grads[k]) for k in grads)


def test_segment_reduce_gradient():
    """The autograd function: gradcheck in float64 (its plain version on the
    CPU), and an id outside [0, num_segments) gets a zero gradient."""
    g = torch.Generator().manual_seed(0)
    vals = torch.randn((2, 7, 3), generator=g, dtype=torch.float64, requires_grad=True)
    ids = torch.tensor([[0, 2, 2, -1, 1, 4, 0], [3, 3, 0, 1, -1, 2, 2]], dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda v: ops.segment_reduce(v, ids, 4), (vals,))
    out = ops.segment_reduce(vals, ids, 4)
    (grad,) = torch.autograd.grad(out, vals, torch.ones_like(out) * 2)
    assert grad.dtype == vals.dtype
    dropped = (ids < 0) | (ids >= 4)
    assert bool((grad[dropped] == 0).all()) and bool((grad[~dropped] == 2).all())
    half = vals.detach().to(torch.bfloat16).requires_grad_()
    (gh,) = torch.autograd.grad(ops.segment_reduce(half, ids, 4).sum(), half)
    assert gh.dtype == torch.bfloat16  # cast back to the values' dtype


def test_linear_scan_under_autograd():
    """The doubling scan recorded by autograd (out of place) gives the
    in-place scan's numbers bitwise, and its gradient checks out."""
    g = torch.Generator().manual_seed(1)
    a = torch.rand((2, 13, 3), generator=g) * 0.9
    b = torch.randn((2, 13, 3), generator=g)
    want = ring_scan.inclusive_linear_scan(a, b, 1)
    got = ring_scan.inclusive_linear_scan(a.clone().requires_grad_(), b.clone().requires_grad_(), 1)
    assert all(torch.equal(x.detach(), y) for x, y in zip(got, want))
    ad, bd = (t.double().requires_grad_() for t in (a[:, :6], b[:, :6]))
    assert torch.autograd.gradcheck(lambda x, y: ring_scan.inclusive_linear_scan(x, y, 1),
                                    (ad, bd))


def test_chunked_attention_under_autograd():
    """The chunked attention's loop keeps no in-place state: autograd records
    it, with the numbers of the unrecorded run."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((1, 40, 2, 8), generator=g).to(torch.bfloat16) for _ in range(3))
    kw = dict(scale=8 ** -0.5, chunk_q=16, chunk_k=16)  # 3 × 3 blocks, padded
    with torch.no_grad():
        want = chunked_attention(q, k, v, **kw)
    qg = q.clone().requires_grad_()
    got = chunked_attention(qg, k, v, **kw)
    assert torch.equal(got.detach(), want)
    (dq,) = torch.autograd.grad(got.float().sum(), qg)
    assert dq.shape == q.shape and bool(torch.isfinite(dq.float()).all())
