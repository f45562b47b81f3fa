"""In-transit collectives and the §4 scenarios: port vs JAX reference.

One subprocess runs ``repro.core.collectives`` and ``scenarios.aggregate``
on 8 fake CPU devices (``(8,)`` and ``(2, 4)`` meshes, a plan-derived
``ring_order``) and writes an ``.npz``; the port computes the same on the
CPU from the same numpy shards. Tolerances are the reference tests':
1e-5, and 3e-2 for S3 against the exact mean (bf16 on the wire).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import scenarios  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402

X = np.random.RandomState(0).randn(8, 16, 5).astype(np.float32)
G24 = np.random.RandomState(1).randn(2, 4, 33).astype(np.float32)
G8 = np.random.RandomState(3).randn(8, 37).astype(np.float32)
GROUPS = [[0, 1, 2, 3], [4, 5, 6, 7]]
SCENARIOS = [("s1_host", 1e-5), ("s2_in_net", 1e-5), ("native", 1e-5),
             ("hierarchical", 1e-5), ("s3_in_net_map", 3e-2)]

JAX_SCRIPT = r"""
import sys, numpy as np, jax
from functools import partial
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_collectives as T
from repro.core import collectives as coll, scenarios, topology
m8 = jax.make_mesh((8,), ("all",), axis_types=(jax.sharding.AxisType.Auto,))
d8 = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
m24 = jax.make_mesh((2, 4), ("pod", "data"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
on8 = lambda f, mesh=m8, ax="all": jax.shard_map(lambda v: f(v[0])[None], mesh=mesh,
                                                 in_specs=P(ax), out_specs=P(ax))
on24 = lambda f: jax.shard_map(lambda v: f(v[0, 0])[None, None], mesh=m24,
                               in_specs=P("pod", "data"), out_specs=P("pod", "data"))
out = {{}}
out["rs"] = on8(lambda v: coll.ring_reduce_scatter(v.reshape(8, -1), "all"))(T.X)
out["rs_s3"] = on8(lambda v: coll.ring_reduce_scatter(
    v.reshape(8, -1), "all", wire_map=coll.bf16_wire, unmap=coll.fp32_unwire))(T.X)
out["ag"] = on8(lambda v: coll.ring_all_gather(v, "all"))(T.X)
out["ag_groups"] = on8(lambda v: coll.ring_all_gather(v, "all", groups=T.GROUPS))(T.X)
out["ar"] = on8(lambda v: coll.ring_all_reduce(v, "all"))(T.X)
out["ar_groups"] = on8(lambda v: coll.ring_all_reduce(v, "all", groups=T.GROUPS))(T.X)
out["ar_s3_groups"] = on8(lambda v: coll.ring_all_reduce(
    v, "all", groups=T.GROUPS, wire_map=coll.bf16_wire, unmap=coll.fp32_unwire))(T.X)
out["tree"] = on8(lambda v: coll.tree_all_reduce(v, "all"))(T.X)
out["tree_groups"] = on8(lambda v: coll.tree_all_reduce(v, "all", groups=T.GROUPS))(T.X)
out["hier"] = on24(lambda v: coll.hierarchical_all_reduce(v, "data", "pod"))(T.G24)
for sc, _ in T.SCENARIOS:
    out["agg_" + sc] = on24(lambda v, sc=sc: scenarios.aggregate(v, sc, data_axis="data", pod_axis="pod"))(T.G24)
order = scenarios.plan_ring_order(8, topo=topology.TorusTopology(dims=(2, 4)))
out["ring_order"] = np.asarray(order)
for sc in ("s2_in_net", "s3_in_net_map"):
    out["order_" + sc] = on8(lambda v, sc=sc: scenarios.aggregate(v, sc, data_axis="data", ring_order=order),
                             d8, "data")(T.G8)
out["wire_bytes"] = np.array([[scenarios.wire_bytes_per_device(1000.0, w, sc) for sc, _ in T.SCENARIOS]
                              for w in (1, 2, 8)])
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_collectives") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path))
    with np.load(path) as f:
        return dict(f)


def _m8(axis="all"):
    return Mesh((axis,), (8,), device="cpu")


def _m24():
    return Mesh(("pod", "data"), (2, 4), device="cpu")


S3 = dict(wire_map=coll.bf16_wire, unmap=coll.fp32_unwire)
COLLECTIVE_CASES = {
    "rs": lambda m, x: coll.ring_reduce_scatter(x.reshape(8, 8, -1), m, "all"),
    "rs_s3": lambda m, x: coll.ring_reduce_scatter(x.reshape(8, 8, -1), m, "all", **S3),
    "ag": lambda m, x: coll.ring_all_gather(x, m, "all"),
    "ag_groups": lambda m, x: coll.ring_all_gather(x, m, "all", groups=GROUPS),
    "ar": lambda m, x: coll.ring_all_reduce(x, m, "all"),
    "ar_groups": lambda m, x: coll.ring_all_reduce(x, m, "all", groups=GROUPS),
    "ar_s3_groups": lambda m, x: coll.ring_all_reduce(x, m, "all", groups=GROUPS, **S3),
    "tree": lambda m, x: coll.tree_all_reduce(x, m, "all"),
    "tree_groups": lambda m, x: coll.tree_all_reduce(x, m, "all", groups=GROUPS),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVE_CASES))
def test_collective_matches_jax(jax_out, name):
    m = _m8()
    got = COLLECTIVE_CASES[name](m, m.shard(X)).numpy()
    want = jax_out[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ring_reduce_scatter_sums_each_chunk():
    m = _m8()
    got = coll.ring_reduce_scatter(m.shard(X).reshape(8, 8, -1), m, "all").numpy()
    np.testing.assert_allclose(got, X.sum(0).reshape(8, -1), rtol=1e-5)


def test_hierarchical_matches_jax(jax_out):
    m = _m24()
    got = coll.hierarchical_all_reduce(m.shard(G24), m, "data", "pod").numpy()
    np.testing.assert_allclose(got, jax_out["hier"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.broadcast_to(G24.sum((0, 1)), G24.shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sc,tol", SCENARIOS)
def test_aggregate_matches_jax(jax_out, sc, tol):
    m = _m24()
    got = scenarios.aggregate(m.shard(G24), m, sc, data_axis="data", pod_axis="pod").numpy()
    np.testing.assert_allclose(got, jax_out["agg_" + sc], rtol=1e-5, atol=1e-5)
    want = np.broadcast_to(G24.mean((0, 1)), G24.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=sc)


@pytest.mark.parametrize("sc,tol", [("s2_in_net", 1e-5), ("s3_in_net_map", 3e-2)])
def test_aggregate_with_plan_ring_order(jax_out, sc, tol):
    order = [int(i) for i in jax_out["ring_order"]]
    assert sorted(order) == list(range(8))
    m = _m8("data")
    g = m.shard(G8)
    got = scenarios.aggregate(g, m, sc, data_axis="data", ring_order=order).numpy()
    np.testing.assert_allclose(got, jax_out["order_" + sc], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.broadcast_to(G8.mean(0), G8.shape), rtol=tol, atol=tol)
    default = scenarios.aggregate(g, m, sc, data_axis="data").numpy()
    np.testing.assert_allclose(got, default, rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="permutation"):
        scenarios.aggregate(g, m, sc, data_axis="data", ring_order=[0, 0, 1, 2, 3, 4, 5, 6])


def test_aggregate_with_replica_groups_and_nests():
    # lax.psum's axis_index_groups has no shard_map lowering on this jax; numpy is the oracle
    m = Mesh(("data", "model"), (4, 2), device="cpu")
    g = np.random.RandomState(5).randn(4, 2, 6).astype(np.float32)
    grads = {"w": m.shard(g), "b": [m.shard(g[..., :2])]}
    out = scenarios.aggregate(grads, m, "s2_in_net", data_axis="data",
                              rep_groups=[[0, 1]], rep_axis="model")
    want = np.broadcast_to(g.sum(1, keepdims=True).mean(0, keepdims=True), g.shape)
    np.testing.assert_allclose(out["w"].numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["b"][0].numpy(), want[..., :2], rtol=1e-5, atol=1e-5)


def test_s3_ring_runs_one_fused_step_per_hop(monkeypatch):
    """An S3 ring reduce-scatter over p ranks calls ring_fused_step p-1 times,
    and the hop is bitwise the reference's unwire + add + rewire."""
    calls = []
    real = ops.ring_fused_step

    def counting(acc, wire):
        calls.append(acc.shape)
        return real(acc, wire)

    monkeypatch.setattr(ops, "ring_fused_step", counting)
    m = _m8()
    x = m.shard(X).reshape(8, 8, -1)
    fused = coll.ring_reduce_scatter(x, m, "all", **S3)
    assert len(calls) == 7
    plain = coll.ring_reduce_scatter(
        x, m, "all", wire_map=lambda a: a.to(torch.bfloat16), unmap=lambda a: a.to(torch.float32))
    assert torch.equal(fused, plain)


def test_wire_bytes_match_jax(jax_out):
    got = np.array([[scenarios.wire_bytes_per_device(1000.0, w, sc) for sc, _ in SCENARIOS]
                    for w in (1, 2, 8)])
    np.testing.assert_array_equal(got, jax_out["wire_bytes"])
