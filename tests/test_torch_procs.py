"""The process mesh (``repro_torch.mesh.ProcessMesh``): one
``torch.distributed`` process per mesh device, against the world-dim
``Mesh`` and against the JAX reference.

Eight gloo ranks on the CPU are spawned once for the file
(``launch.procs.spawn``: a ``file://`` store under the test's tmp dir, a
120 s timeout, one thread each). Each runs every case below on its own
shard and hands back its block; the test process stacks the blocks and
holds them:

* every collective bitwise to the world-dim ``Mesh`` on the same inputs
  (integer-valued data, so sums agree whatever order gloo adds in), and
  ``count_collectives`` summed over the ranks equal to the world-dim count;
* the word count (both forms, and the S1 host baseline), the compiled
  word-count plans and ``wordcount_via_plan`` bitwise to the JAX reference
  on 8 fake devices (one ``multidevice`` subprocess);
* ``aggregate`` under S1/S2/S3/NATIVE/HIERARCHICAL within the reference
  test's tolerance (1e-5, S3 3e-2), S1/S2/S3 bitwise to the world-dim mesh
  and S3 bitwise to the plain ring (the wire maps as separate steps);
* ``sequence_parallel_linear_scan``, ``ring_exclusive_scan`` and
  ``pipeline_apply`` at the reference tests' 2e-5.

Also the refusals, the kernels' inter-process build lock, and
``cuda``-marked cases (gloo staged through host memory on one card, nccl
with one card per rank) that skip without a card.
"""
import os
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import compiler  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import scenarios  # noqa: E402
from repro_torch.core import wordcount as wc  # noqa: E402
from repro_torch.core.pipeline import pipeline_apply  # noqa: E402
from repro_torch.core.ring_scan import (  # noqa: E402
    ring_exclusive_scan,
    sequence_parallel_linear_scan,
)
from repro_torch.core.topology import TorusTopology  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import procs  # noqa: E402
from repro_torch.mesh import Mesh, ProcessMesh, count_collectives, count_staging  # noqa: E402
from repro_torch.mesh import process_device  # noqa: E402

WORLD = 8
TIMEOUT_S = 120
MESHES = {"8": (("all",), (8,)), "24": (("pod", "data"), (2, 4))}
ODD = [[1, 3, 5, 7], [6, 4, 2, 0]]  # groups whose member order is not rank order


def _ints(seed, shape, dtype=np.float32):
    return np.random.RandomState(seed).randint(-50, 50, shape).astype(dtype)


INPUTS = {
    "a8": _ints(0, (8, 8, 8, 8)),  # local (8, 8, 8): every untiled split/concat
    "t8": _ints(1, (8, 16, 8, 24)),  # local (16, 8, 24): every tiled split/concat
    "g4": _ints(2, (8, 4, 8)),  # local (4, 8): groups of 4
    "i8": _ints(3, (8, 8, 6), np.int32),
    "a24": _ints(4, (2, 4, 4, 6)),
}
RING = [(i, (i + 1) % 8) for i in range(8)]
COLLECTIVES = {
    "ppermute_ring": ("8", "a8", lambda m, x: m.ppermute(x, "all", RING)),
    "ppermute_partial": ("8", "a8", lambda m, x: m.ppermute(x, "all", [(0, 3), (2, 5), (7, 0)])),
    "ppermute_self": ("8", "i8", lambda m, x: m.ppermute(x, "all", [(i, i) for i in range(8)])),
    "ppermute_data_ring": ("24", "a24", lambda m, x: m.ppermute(
        x, "data", [(i, (i + 1) % 4) for i in range(4)])),
    "ppermute_pod_swap": ("24", "a24", lambda m, x: m.ppermute(x, "pod", [(0, 1), (1, 0)])),
    "a2a_groups": ("8", "g4", lambda m, x: m.all_to_all(x, "all", 0, 1, axis_index_groups=ODD)),
    "a2a_groups_tiled": ("8", "g4", lambda m, x: m.all_to_all(
        x, "all", 1, 0, tiled=True, axis_index_groups=ODD)),
    "a2a_data": ("24", "a24", lambda m, x: m.all_to_all(x, "data", 0, 1)),
    "a2a_pod_tiled": ("24", "a24", lambda m, x: m.all_to_all(x, "pod", 0, 1, tiled=True)),
    "gather": ("8", "a8", lambda m, x: m.all_gather(x, "all")),
    "gather_tiled": ("8", "a8", lambda m, x: m.all_gather(x, "all", tiled=True)),
    "gather_groups": ("8", "g4", lambda m, x: m.all_gather(x, "all", axis_index_groups=ODD)),
    "gather_groups_tiled": ("8", "g4", lambda m, x: m.all_gather(
        x, "all", tiled=True, axis_index_groups=ODD)),
    "gather_pod": ("24", "a24", lambda m, x: m.all_gather(x, "pod")),
    "gather_data_tiled": ("24", "a24", lambda m, x: m.all_gather(x, "data", tiled=True)),
    "psum": ("8", "a8", lambda m, x: m.psum(x, "all")),
    "psum_groups": ("8", "g4", lambda m, x: m.psum(x, "all", axis_index_groups=ODD)),
    "psum_data": ("24", "a24", lambda m, x: m.psum(x, "data")),
    "psum_pod": ("24", "a24", lambda m, x: m.psum(x, "pod")),
    "psum_both": ("24", "a24", lambda m, x: m.psum(x, ("pod", "data"))),
    "pmax": ("8", "i8", lambda m, x: m.pmax(x, "all")),
    "pmax_groups": ("8", "i8", lambda m, x: m.pmax(x, "all", axis_index_groups=ODD)),
    "pmin": ("8", "i8", lambda m, x: m.pmin(x, "all")),
    "pmin_both": ("24", "a24", lambda m, x: m.pmin(x, ("data", "pod"))),
    "pmax_data": ("24", "a24", lambda m, x: m.pmax(x, "data")),
    "psum_scatter": ("8", "a8", lambda m, x: m.psum_scatter(x, "all")),
    "psum_scatter_dim1": ("8", "a8", lambda m, x: m.psum_scatter(x, "all", 1)),
    "psum_scatter_tiled": ("8", "t8", lambda m, x: m.psum_scatter(x, "all", tiled=True)),
    "psum_scatter_tiled_dim2": ("8", "t8", lambda m, x: m.psum_scatter(x, "all", 2, tiled=True)),
    "psum_scatter_groups": ("8", "g4", lambda m, x: m.psum_scatter(
        x, "all", axis_index_groups=ODD)),
    "psum_scatter_data": ("24", "a24", lambda m, x: m.psum_scatter(x, "data")),
    "axis_index": ("8", "a8", lambda m, x: m.axis_index("all")),
    "axis_index_pod": ("24", "a24", lambda m, x: m.axis_index("pod")),
    "axis_index_data": ("24", "a24", lambda m, x: m.axis_index("data")),
    "broadcast": ("8", "a8", lambda m, x: m.broadcast(x, "all", 5)),
    "broadcast_data": ("24", "a24", lambda m, x: m.broadcast(x, "data", 2)),
    "broadcast_pod": ("24", "a24", lambda m, x: m.broadcast(x, "pod", 1)),
    "dyn_index": ("8", "a8", lambda m, x: m.dynamic_index_in_dim(x, (m.axis_index("all") * 3) % 8)),
    "dyn_slice": ("8", "a8", lambda m, x: m.dynamic_slice_in_dim(x, m.axis_index("all") - 2, 3)),
    "dyn_update": ("24", "a24", lambda m, x: m.dynamic_update_index_in_dim(
        x.clone(), x[..., 0, :] * 0 - 1, m.axis_index("data"))),
}
for _s in range(3):
    for _c in range(3):
        COLLECTIVES[f"a2a_s{_s}_c{_c}"] = ("8", "a8", lambda m, x, s=_s, c=_c: m.all_to_all(
            x, "all", s, c))
        COLLECTIVES[f"a2a_tiled_s{_s}_c{_c}"] = ("8", "t8", lambda m, x, s=_s, c=_c: m.all_to_all(
            x, "all", s, c, tiled=True))

# the modules: word count, aggregation, plans, scan, pipeline
VOCAB = 512
TOKENS = 4096
GRAD = 10_000
SCENARIOS = {"s1_host": 1e-5, "s2_in_net": 1e-5, "s3_in_net_map": 3e-2, "native": 1e-5,
             "hierarchical": 1e-5}
BITWISE_TO_WORLD = ("s1_host", "s2_in_net", "s3_in_net_map")
SCAN_TOL = 2e-5  # tests/test_ring_scan.py, tests/test_pipeline.py
PLAN_PASSES = ("parse", "validate", "dead-node-elim", "rebalance-reduce-tree",
               "insert-combiners", "place", "route", "emit", "verify")
N_MICRO, D = 5, 16


def word_shards():
    rs = np.random.RandomState(7)
    shards = [np.minimum(rs.zipf(1.3, TOKENS) - 1, VOCAB - 1).astype(np.int32) for _ in range(8)]
    shards[3][-5:] = -1  # padding, not counted
    return shards


def grads():
    return np.random.RandomState(8).randn(8, GRAD).astype(np.float32)


def scan_inputs():
    rs = np.random.RandomState(9)
    a = (0.5 + 0.5 * rs.rand(8 * 16, 5)).astype(np.float32)
    return a, rs.randn(8 * 16, 5).astype(np.float32)


def pipe_inputs():
    rs = np.random.RandomState(10)
    return ((rs.randn(8, D, D) * 0.3).astype(np.float32),
            rs.randn(N_MICRO, 3, D).astype(np.float32))


def stage(w, h):
    """tanh(h @ w): each device's (d, d) weights over its microbatch rows."""
    return torch.tanh(h @ w)


def plans():
    """The word-count plans on the 8-ring: the rebalanced in-network tree,
    and ``wordcount_via_plan``'s compile (a session over lowered shuffles)."""
    topo = TorusTopology(dims=(8,))
    return {"tree": compiler.compile(wc.wordcount_program(8, VOCAB), topo, passes=PLAN_PASSES),
            "session": wc._compile_wordcount_plan(8, VOCAB)}


def plain_s3(g, mesh):
    """S3 as the plain ring: bf16 on the wire and back as separate steps,
    without ``ring_fused_step``."""
    out = coll.ring_all_reduce(g, mesh, "data", wire_map=lambda a: a.to(torch.bfloat16),
                               unmap=lambda a: a.to(torch.float32))
    return out * (1.0 / 8)


def module_cases(meshes, shard):
    """name → output of every module case on ``meshes`` ({"all", "data",
    "pod_data", "seq"}: meshes of those axes), with ``shard`` laying numpy
    per-device data onto a mesh."""
    m8, d8, d24 = meshes["all"], meshes["data"], meshes["pod_data"]
    words = shard(m8, word_shards())
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out["wordcount_step"] = wc.wordcount_step(words, VOCAB, m8, "all")
        out["wordcount_step_kernel"] = wc.wordcount_step(words, VOCAB, m8, "all",
                                                         histogram_fn=wc.kernel_histogram)
    out["wordcount_host"] = wc.wordcount_host_baseline(words, VOCAB, m8, "all")
    out["token_counts"], out["token_recv"] = wc.wordcount_token_shuffle(words, VOCAB, m8, "all")
    g = shard(d8, grads())
    for sc in SCENARIOS:
        if sc == "hierarchical":
            x = shard(d24, grads().reshape(2, 4, GRAD))
            out[f"agg_{sc}"] = scenarios.aggregate(x, d24, sc, data_axis="data", pod_axis="pod")
        else:
            out[f"agg_{sc}"] = scenarios.aggregate(g, d8, sc, data_axis="data")
    out["plain_s3"] = plain_s3(g, d8)
    order = scenarios.plan_ring_order(8, topo=TorusTopology(dims=(2, 4)))
    out["agg_s3_plan_order"] = scenarios.aggregate(g, d8, "s3_in_net_map", data_axis="data",
                                                   ring_order=order)
    a, b = scan_inputs()
    seq = meshes["seq"]
    chunk = lambda v: shard(seq, v.reshape((8, -1) + v.shape[1:]))  # noqa: E731
    out["scan"] = sequence_parallel_linear_scan(chunk(a), chunk(b), seq, "seq")
    out["exclusive_a"], out["exclusive_s"] = ring_exclusive_scan(
        shard(seq, a[:8]), shard(seq, b[:8]), seq, "seq")
    ws, micro = pipe_inputs()
    out["pipeline"] = pipeline_apply(stage, shard(seq, ws), torch.from_numpy(micro), seq, "seq")
    return out


def plan_inputs():
    return {f"s{i}": wc.wordcount_reference([ws], VOCAB).astype(np.float64)
            for i, ws in enumerate(word_shards())}


# --------------------------------------------------------------- the ranks --
def _rank(device):
    """One rank's run of every case: {name: its block as numpy}, the
    collectives' counts, and the refusals' messages."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    pm = {k: ProcessMesh(axes, shape, device=device) for k, (axes, shape) in MESHES.items()}
    out, counts = {}, {}
    for name, (mk, xk, fn) in COLLECTIVES.items():
        with count_collectives() as c:
            out[name] = fn(pm[mk], pm[mk].shard(INPUTS[xk])).numpy()
        counts[name] = dict(c)
    meshes = {"all": ProcessMesh(("all",), (8,), device=device),
              "data": ProcessMesh(("data",), (8,), device=device),
              "pod_data": ProcessMesh(("pod", "data"), (2, 4), device=device),
              "seq": ProcessMesh(("seq",), (8,), device=device)}
    for k, v in module_cases(meshes, lambda m, d: m.shard(d)).items():
        out[k] = v.numpy()
    inputs = plan_inputs()
    for k, plan in plans().items():
        # a rank's inputs count only for the Store on its own switch
        mine = {s: (v if int(plan.placement.switch_of(s)) == rank else np.zeros_like(v))
                for s, v in inputs.items()}
        out[f"plan_{k}"] = plan.run(mine, device="cpu")["OUT"]
    out["via_plan"] = wc.wordcount_via_plan(word_shards(), VOCAB, device="cpu")[0]
    refusals = {}
    for name, make in (
            ("world", lambda: ProcessMesh(("all",), (4,), device="cpu")),
            ("device", lambda: ProcessMesh(("all",), (8,))),
            ("plan", lambda: compiler.compile(
                wc.wordcount_program(4, 8), TorusTopology(dims=(4,))).run(
                    {f"s{i}": np.ones(8) for i in range(4)}, device="cpu"))):
        try:
            make()
            refusals[name] = None
        except (ValueError, RuntimeError) as e:
            refusals[name] = f"{type(e).__name__}: {e}"
    return {"out": out, "counts": counts, "refusals": refusals, "transport": pm["8"].transport}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("procs") / "store"
    return procs.spawn(_rank, WORLD, backend="gloo", device="cpu", store_path=store,
                       timeout_s=TIMEOUT_S)


def stacked(ranks, name, mesh_shape):
    """The ranks' blocks of output ``name`` as one world-dim array."""
    blocks = [r["out"][name] for r in ranks]
    local = blocks[0].shape[len(mesh_shape):]
    assert all(b.shape == (1,) * len(mesh_shape) + local for b in blocks)
    return np.stack([b.reshape(local) for b in blocks]).reshape(tuple(mesh_shape) + local)


def world_meshes():
    return {"all": Mesh(("all",), (8,), device="cpu"), "data": Mesh(("data",), (8,), device="cpu"),
            "pod_data": Mesh(("pod", "data"), (2, 4), device="cpu"),
            "seq": Mesh(("seq",), (8,), device="cpu")}


@pytest.fixture(scope="module")
def world():
    return {k: v.numpy() for k, v in module_cases(world_meshes(), lambda m, d: m.shard(d)).items()}


# ---------------------------------------------------------- the collectives --
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_bitwise_to_the_world_dim_mesh(ranks, name):
    mk, xk, fn = COLLECTIVES[name]
    axes, shape = MESHES[mk]
    m = Mesh(axes, shape, device="cpu")
    want = fn(m, m.shard(INPUTS[xk])).numpy()
    got = stacked(ranks, name, shape)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_count_collectives_summed_over_ranks_is_the_world_dim_count(ranks):
    for name, (mk, xk, fn) in COLLECTIVES.items():
        axes, shape = MESHES[mk]
        m = Mesh(axes, shape, device="cpu")
        with count_collectives() as want:
            fn(m, m.shard(INPUTS[xk]))
        got = {k: sum(r["counts"][name][k] for r in ranks) for k in want}
        assert got == want, name


def test_ranks_report_their_transport(ranks):
    assert {r["transport"] for r in ranks} == {"gloo"}


# ------------------------------------------------------------ the modules --
JAX_HEAD = r"""
import sys, warnings, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_procs as T
from repro import compiler
from repro.core import pipeline, ring_scan, scenarios, topology, wordcount as wc
from repro.shuffle import spmd
warnings.simplefilter("ignore", DeprecationWarning)
auto = jax.sharding.AxisType.Auto
m8 = jax.make_mesh((8,), ("all",), axis_types=(auto,))
d8 = jax.make_mesh((8,), ("data",), axis_types=(auto,))
m24 = jax.make_mesh((2, 4), ("pod", "data"), axis_types=(auto,) * 2)
s8 = jax.make_mesh((8,), ("seq",), axis_types=(auto,))
on = lambda f, mesh, ax: jax.shard_map(lambda v: f(v[0])[None], mesh=mesh, in_specs=P(ax),
                                       out_specs=P(ax), check_vma=False)
W, G = np.stack(T.word_shards()), T.grads()
out = {{}}
"""
# the reference's cases in parts that run side by side (its shard_map
# compiles take most of the time: about 11 s for each ring)
JAX_PARTS = {
    "wordcount": r"""
out["wordcount_step"] = on(lambda w: wc.wordcount_step(w, T.VOCAB, "all"), m8, "all")(W)
out["wordcount_host"] = on(lambda w: wc.wordcount_host_baseline(w, T.VOCAB, "all"), m8, "all")(W)
cap = max(int(np.asarray(spmd.partition_tokens(jnp.asarray(w), 8, capacity=1, interpret=True)[1]).max())
          for w in W)
out["token_recv"] = on(lambda w: spmd.token_shuffle(w, "all", capacity=cap)[0], m8, "all")(W)
out["reference"] = wc.wordcount_reference(list(W), T.VOCAB)
topo = topology.TorusTopology(dims=(8,))
out["plan_tree"] = compiler.compile(wc.wordcount_program(8, T.VOCAB), topo,
                                    passes=T.PLAN_PASSES).run(T.plan_inputs(), backend="jax")["OUT"]
out["via_plan"] = wc.wordcount_via_plan(list(W), T.VOCAB)[0]
ws, micro = T.pipe_inputs()
f = jax.shard_map(lambda w, m: pipeline.pipeline_apply(lambda w_, h: jnp.tanh(h @ w_), w[0], m, "seq"),
                  mesh=s8, in_specs=(P("seq"), P()), out_specs=P())
out["pipeline"] = f(jnp.asarray(ws), jnp.asarray(micro))
""",
    "rings": r"""
for sc in ("s1_host", "s2_in_net", "native"):
    out["agg_" + sc] = on(lambda v, sc=sc: scenarios.aggregate(v, sc, data_axis="data"), d8, "data")(G)
""",
    "mapped": r"""
out["agg_s3_in_net_map"] = on(lambda v: scenarios.aggregate(v, "s3_in_net_map", data_axis="data"),
                              d8, "data")(G)
f = jax.shard_map(lambda v: scenarios.aggregate(v[0, 0], "hierarchical", data_axis="data",
                                                pod_axis="pod")[None, None],
                  mesh=m24, in_specs=P("pod", "data"), out_specs=P("pod", "data"))
out["agg_hierarchical"] = f(G.reshape(2, 4, -1))
""",
    "scan": r"""
a, b = T.scan_inputs()
f = jax.shard_map(lambda a_, b_: ring_scan.sequence_parallel_linear_scan(a_, b_, "seq"), mesh=s8,
                  in_specs=(P("seq"), P("seq")), out_specs=P("seq"))
out["scan"] = f(jnp.asarray(a), jnp.asarray(b))
""",
}
JAX_TAIL = r"""
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("jax_procs")
    tests = os.path.dirname(os.path.abspath(__file__))

    def run(part):
        path = str(tmp / f"{part}.npz")
        script = JAX_HEAD.format(tests=tests) + JAX_PARTS[part] + JAX_TAIL.format(path=path)
        assert "OK" in multidevice(script)
        with np.load(path) as f:
            return dict(f)

    out = {}
    with ThreadPoolExecutor(len(JAX_PARTS)) as pool:
        for part in pool.map(run, JAX_PARTS):
            out.update(part)
    return out


@pytest.mark.parametrize("name", ["wordcount_step", "wordcount_step_kernel", "wordcount_host"])
def test_wordcount_bitwise_to_the_reference(ranks, jax_out, world, name):
    got = stacked(ranks, name, (8,))
    want = jax_out[name.removesuffix("_kernel")]
    assert got.dtype == world[name].dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, world[name])
    np.testing.assert_array_equal(got.reshape(-1), jax_out["reference"])


def test_token_shuffle_wordcount_bitwise_to_the_reference(ranks, jax_out, world):
    recv = stacked(ranks, "token_recv", (8,))
    np.testing.assert_array_equal(recv, jax_out["token_recv"])
    np.testing.assert_array_equal(recv, world["token_recv"])
    counts = stacked(ranks, "token_counts", (8,))
    np.testing.assert_array_equal(counts, world["token_counts"])
    np.testing.assert_array_equal(counts.sum(0), jax_out["reference"])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_aggregate_matches_the_reference(ranks, jax_out, world, scenario):
    name = f"agg_{scenario}"
    shape = (2, 4) if scenario == "hierarchical" else (8,)
    got = stacked(ranks, name, shape)
    tol = SCENARIOS[scenario]
    assert got.dtype == np.float32 and got.shape == jax_out[name].shape
    np.testing.assert_allclose(got, jax_out[name], rtol=tol, atol=tol)
    if scenario in BITWISE_TO_WORLD:
        np.testing.assert_array_equal(got, world[name])
    else:
        np.testing.assert_allclose(got, world[name], rtol=1e-5, atol=1e-5)


def test_s3_in_a_plan_derived_ring_order_is_bitwise_the_world_dim_mesh(ranks, world):
    """``ring_order`` from ``plan_ring_order`` on a (2, 4) torus: the
    world-dim run is held to the reference in ``test_torch_collectives``."""
    got = stacked(ranks, "agg_s3_plan_order", (8,))
    np.testing.assert_array_equal(got, world["agg_s3_plan_order"])
    np.testing.assert_allclose(got, stacked(ranks, "agg_s3_in_net_map", (8,)), rtol=3e-2, atol=3e-2)


def test_s3_is_bitwise_the_plain_ring(ranks, world):
    got = stacked(ranks, "agg_s3_in_net_map", (8,))
    np.testing.assert_array_equal(got, stacked(ranks, "plain_s3", (8,)))
    np.testing.assert_array_equal(got, world["plain_s3"])


@pytest.mark.parametrize("name", ["plan_tree", "plan_session", "via_plan"])
def test_wordcount_plans_bitwise_to_the_reference(ranks, jax_out, name):
    outs = [r["out"][name] for r in ranks]
    want = jax_out["reference"] if name == "plan_session" else jax_out[name]
    for got in outs:  # every rank returns the same outputs
        np.testing.assert_array_equal(got, outs[0])
    assert outs[0].dtype == (np.int64 if name == "via_plan" else np.float64)
    np.testing.assert_array_equal(outs[0].astype(np.float64).view(np.uint64),
                                  want.astype(np.float64).view(np.uint64))


def test_scans_and_pipeline_match_the_reference(ranks, jax_out, world):
    a, b = scan_inputs()
    got = stacked(ranks, "scan", (8,))
    np.testing.assert_allclose(got.reshape(a.shape), jax_out["scan"], rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_array_equal(got, world["scan"])
    for k in ("exclusive_a", "exclusive_s"):
        np.testing.assert_array_equal(stacked(ranks, k, (8,)), world[k])
    pipe = stacked(ranks, "pipeline", (8,))
    for r in range(8):
        np.testing.assert_allclose(pipe[r], jax_out["pipeline"], rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_array_equal(pipe, world["pipeline"])


# ------------------------------------------------------------- refusals --
@pytest.mark.parametrize("name, match", [("world", "needs 4 processes"),
                                         ("device", "CUDA device"),
                                         ("plan", "4 switches need 4 processes")])
def test_ranks_refuse(ranks, name, match):
    for r in ranks:
        assert r["refusals"][name] is not None and match in r["refusals"][name]


def test_spawn_refuses_nccl_without_a_card_per_rank(tmp_path):
    if torch.cuda.device_count() >= WORLD:
        pytest.skip("this host has a card for every rank")
    with pytest.raises(RuntimeError, match="one card per local rank"):
        procs.spawn(_rank, WORLD, backend="nccl", device="cpu", store_path=tmp_path / "s")


def test_init_process_mesh_refuses_a_wrong_world_and_nccl_without_cards(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="needs 8 processes"):
        procs.init_process_mesh((8,), ("all",), backend="gloo", device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per local rank"):
        procs.init_process_mesh((8,), ("all",), backend="nccl")


def test_process_mesh_needs_cuda_or_the_cpu_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        process_device(None, "gloo")
    with pytest.raises(RuntimeError, match="CUDA device"):
        procs.spawn(_rank, 2, backend="gloo", store_path="unused")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        process_device("cpu", "nccl")
    assert process_device("cpu", "gloo") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        ProcessMesh(("all",), (8,), device="cpu")


# ------------------------------------------------------- the build lock --
FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(f"start {{time.time()!r}}\\n")
time.sleep(3.0)
open(args[args.index("-o") + 1], "w").write("built")
with open({log!r}, "a") as f:
    f.write(f"end {{time.time()!r}}\\n")
"""


def _build_in(root, stamp):
    """One process's ``build_all`` of the stale source under ``root`` with
    the fake compiler; writes when it called and what it returned."""
    root = Path(root)
    _build.BUILD, _build.CSRC, _build.NAMES = root / "build", root / "csrc", ("k",)
    _build._nvcc = lambda: str(root / "nvcc")
    t = time.time()
    took = _build.build_all()
    Path(stamp).write_text(f"{t!r} {took!r}")


def test_concurrent_builds_run_the_compiler_once(tmp_path):
    import sys

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// a stale source\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    ctx = torch.multiprocessing.get_context("spawn")
    ps = [ctx.Process(target=_build_in, args=(str(tmp_path), str(tmp_path / f"stamp{i}")))
          for i in range(2)]
    for p in ps:
        p.start()
    for p in ps:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    lines = log.read_text().split()
    assert lines[0::2] == ["start", "end"], "the compiler ran more than once"
    end = float(lines[3])
    calls = [tuple(map(float, (tmp_path / f"stamp{i}").read_text().split())) for i in range(2)]
    # both processes asked while the one compile ran, and one of them built
    assert all(t < end for t, _ in calls)
    assert sorted(took > 0 for _, took in calls) == [False, True]
    assert (tmp_path / "build" / "libk.so").read_text() == "built"


# ------------------------------------------------------------ on the card --
def _card_rank(device):
    """Collectives of CUDA tensors on a process mesh: outputs, staged copies."""
    m = ProcessMesh(("all",), (torch.distributed.get_world_size(),), device=device)
    p = m.axis_size("all")
    x = m.shard(np.arange(p * p * 3, dtype=np.float32).reshape(p, p, 3))
    with count_staging() as staged:
        out = {"ring": m.ppermute(x, "all", [(i, (i + 1) % p) for i in range(p)]),
               "gather": m.all_gather(x, "all"), "psum": m.psum(x, "all"),
               "a2a": m.all_to_all(x, "all", 0, 0), "scatter": m.psum_scatter(x, "all")}
    assert all(v.device == device for v in out.values())
    return {"out": {k: v.cpu().numpy() for k, v in out.items()}, "staged": dict(staged),
            "transport": m.transport}


def _card_cases(res, p):
    w = Mesh(("all",), (p,), device="cuda")
    x = w.shard(np.arange(p * p * 3, dtype=np.float32).reshape(p, p, 3))
    want = {"ring": w.ppermute(x, "all", [(i, (i + 1) % p) for i in range(p)]),
            "gather": w.all_gather(x, "all"), "psum": w.psum(x, "all"),
            "a2a": w.all_to_all(x, "all", 0, 0), "scatter": w.psum_scatter(x, "all")}
    for k, v in want.items():
        got = np.concatenate([r["out"][k] for r in res])
        np.testing.assert_array_equal(got, v.cpu().numpy())


@pytest.mark.cuda
def test_gloo_on_one_card_stages_through_host_memory(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = procs.spawn(_card_rank, 4, backend="gloo", store_path=tmp_path / "s",
                      timeout_s=TIMEOUT_S)
    _card_cases(res, 4)
    for r in res:
        assert r["transport"] == "gloo, staged through pinned host memory"
        assert r["staged"]["copies"] > 0 and r["staged"]["bytes"] > 0


NCCL_PROMPT, NCCL_GEN, NCCL_BATCH, NCCL_SEQ = 32, 3, 4, 32
# test_torch_procs_train's WORLD_LOSS_TOL and WORLD_NORM_TOL: the same products
# on other shapes, the collectives' fp32 sums in their own order
NCCL_LOSS_TOL, NCCL_NORM_TOL = 1e-4, 1e-3


def _nccl_models(mesh, device):
    """qwen1.5's smoke config on ``mesh`` from seed 0: (config, the served
    model, the S3 train step of another copy)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models.model import Model

    cfg = get_smoke_config("qwen1.5-0.5b")
    served = Model(cfg, device=device, seed=0, env=steps.make_env(cfg, mesh))
    trained = Model(cfg, device=device, seed=0, env=steps.make_env(cfg, mesh, "s3_in_net_map"))
    step = steps.make_train_step(trained, mesh, scenario="s3_in_net_map",
                                 global_batch=NCCL_BATCH, seq=NCCL_SEQ)
    return cfg, served, step


def _nccl_run(cfg, served, step, mesh, device, held):
    """A served call (prefill and NCCL_GEN greedy tokens, ``impl="flash"``)
    of seeded prompts, ``held`` distinct rows, and one train step: (tokens,
    loss, gradient norm)."""
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.launch import serve, steps

    prompts = serve.prompt_batch(served, held, NCCL_PROMPT, seed=0)
    if isinstance(mesh, ProcessMesh):
        prompts = steps.rank_rows(served.env, prompts, NCCL_BATCH)
    toks = serve.generate(served, prompts, NCCL_GEN, impl="flash", mesh=mesh,
                          global_batch=NCCL_BATCH)["tokens"]
    batch = TrainPipeline(cfg, step.env, NCCL_BATCH, NCCL_SEQ, seed=0).batch_at(0)
    _, m = step(step.init_state(), batch)
    return toks.cpu().numpy(), float(m["loss"]), float(m["grad_norm"])


def _nccl_rank(device):
    """``_card_rank``'s collectives, then qwen1.5's smoke config served and
    trained a step on a (ranks / 2, 2) process mesh."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    out = _card_rank(device)
    p = torch.distributed.get_world_size()
    pm = ProcessMesh(("data", "model"), (p // 2, 2), device=device)
    cfg, served, step = _nccl_models(pm, device)
    ops.reset_launches()
    with count_staging() as staged:
        toks, loss, norm = _nccl_run(cfg, served, step, pm, device,
                                     steps.held_rows(served.env.world(), NCCL_BATCH))
    return {**out, "tokens": toks, "loss": loss, "grad_norm": norm, "model_staged": dict(staged),
            "launches": dict(ops.LAUNCHES), "hops": step.ring_hops()}


@pytest.mark.cuda
def test_nccl_with_one_card_per_rank(tmp_path):
    """4 nccl ranks (2 on a host of 2 or 3 cards), one card each: the collectives bitwise to
    the world-dim mesh, nothing staged; then qwen1.5's smoke config on
    (ranks / 2, 2), its served tokens (prefill and greedy decode) equal to
    the world-dim port's on the card, and one S3 train step's loss and norm
    within NCCL_LOSS_TOL and NCCL_NORM_TOL of the world-dim step's, its ring
    hops on the ``ring_fused_step`` kernel."""
    if torch.cuda.device_count() < 2:
        pytest.skip("nccl needs one card per rank; this host has fewer than 2")
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    _build.build_all()
    p = 4 if torch.cuda.device_count() >= 4 else 2
    res = procs.spawn(_nccl_rank, p, backend="nccl", store_path=tmp_path / "s",
                      timeout_s=TIMEOUT_S)
    _card_cases(res, p)
    dims = (p // 2, 2)
    mesh = make_mesh(dims, device="cuda")
    cfg, served, step = _nccl_models(mesh, "cuda")
    want, loss, norm = _nccl_run(cfg, served, step, mesh, "cuda",
                                 steps.held_rows(served.env, NCCL_BATCH))
    blocks = np.stack([r["tokens"] for r in res]).reshape(dims + (-1, NCCL_GEN))[:, 0]
    np.testing.assert_array_equal(blocks.reshape(-1, NCCL_GEN), want)
    for r in res:
        assert r["transport"] == "nccl" and r["staged"]["copies"] == 0
        assert r["model_staged"]["copies"] == 0
        assert abs(r["loss"] - loss) <= NCCL_LOSS_TOL * loss
        assert abs(r["grad_norm"] - norm) <= NCCL_NORM_TOL * norm
        assert r["launches"]["ring_fused_step"] == r["hops"] and (p < 4 or r["hops"] > 0)
