"""Word count and the shuffle on the port's mesh vs the JAX reference.

One subprocess runs the reference on 8 fake CPU devices — ``wordcount_step``
(default and ``segment_reduce`` histograms), ``wordcount_host_baseline``,
``partition_tokens`` and ``token_shuffle`` (``check_vma=False``), and
``wordcount_shards`` — and writes an ``.npz``. The port then computes the
same on the CPU from the same numpy shards; everything matches bitwise.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import wordcount as wc  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.shuffle import spmd  # noqa: E402

VOCAB = 64
SHARD_ARGS = [(8 * 77, 8, 64, 2), (3000, 3, 50_000, 1), (1000, 8, 50_000, 0)]
CAPACITIES = [64, 16, 3]  # 64 holds every token; the others overflow and drop


def word_shards():
    rs = np.random.RandomState(2)
    shards = [rs.randint(0, VOCAB, size=(77,)).astype(np.int32) for _ in range(8)]
    shards[3][-5:] = -1  # padding, not counted
    return shards


def token_shards():
    rs = np.random.RandomState(4)
    shards = [rs.randint(0, 1000, size=(64,)).astype(np.int32) for _ in range(8)]
    shards[3][-5:] = -1
    return shards


JAX_SCRIPT = r"""
import sys, warnings, numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_wordcount as T
from repro.core import wordcount as wc
from repro.data import pipeline
from repro.kernels import ops
from repro.shuffle import spmd
warnings.simplefilter("ignore", DeprecationWarning)
mesh = jax.make_mesh((8,), ("all",), axis_types=(jax.sharding.AxisType.Auto,))
spec = dict(mesh=mesh, in_specs=P("all"), out_specs=P("all"))
W = np.stack(T.word_shards())
seg_hist = lambda w, v: ops.segment_reduce(
    jnp.ones((w.shape[0], 1), jnp.float32), w, v, interpret=True)[:, 0].astype(jnp.int32)
out = {{}}
out["step"] = jax.shard_map(lambda w: wc.wordcount_step(w[0], T.VOCAB, "all")[None], **spec)(W)
out["step_kernel"] = jax.shard_map(
    lambda w: wc.wordcount_step(w[0], T.VOCAB, "all", histogram_fn=seg_hist)[None],
    check_vma=False, **spec)(W)
out["host"] = jax.shard_map(lambda w: wc.wordcount_host_baseline(w[0], T.VOCAB, "all")[None], **spec)(W)
out["local_hist"] = jax.vmap(lambda w: wc.local_histogram(w, T.VOCAB))(W)
out["reference"] = wc.wordcount_reference(list(W), T.VOCAB)
TK = np.stack(T.token_shards())
for cap in T.CAPACITIES:
    bufs = [spmd.partition_tokens(jnp.asarray(s), 8, capacity=cap, interpret=True) for s in TK]
    out[f"buf{{cap}}"] = np.stack([np.asarray(b) for b, _ in bufs])
    out[f"hist{{cap}}"] = np.stack([np.asarray(h) for _, h in bufs])
recv, hist = jax.shard_map(
    lambda w: tuple(x[None] for x in spmd.token_shuffle(w[0], "all", capacity=64)),
    mesh=mesh, in_specs=P("all"), out_specs=(P("all"), P("all")), check_vma=False)(TK)
out["recv"], out["recv_hist"] = recv, hist
for i, args in enumerate(T.SHARD_ARGS):
    out[f"shards{{i}}"] = np.stack(pipeline.wordcount_shards(*args))
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_wordcount") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path))
    with np.load(path) as f:
        return dict(f)


@pytest.fixture
def mesh():
    return Mesh(("all",), (8,), device="cpu")


@pytest.mark.parametrize("hist", ["default", "kernel"])
def test_wordcount_step_matches_jax(jax_out, mesh, hist):
    fn = wc.kernel_histogram if hist == "kernel" else None
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = wc.wordcount_step(mesh.shard(word_shards()), VOCAB, mesh, "all", histogram_fn=fn)
    want = jax_out["step_kernel" if fn else "step"]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), jax_out["reference"])


def test_host_baseline_matches_jax(jax_out, mesh):
    got = wc.wordcount_host_baseline(mesh.shard(word_shards()), VOCAB, mesh, "all")
    np.testing.assert_array_equal(got.numpy(), jax_out["host"])


def test_local_histograms_match_jax(jax_out, mesh):
    words = mesh.shard(word_shards())
    np.testing.assert_array_equal(wc.local_histogram(words, VOCAB).numpy(), jax_out["local_hist"])
    np.testing.assert_array_equal(wc.kernel_histogram(words, VOCAB).numpy(), jax_out["local_hist"])


def test_wordcount_reference_matches_jax(jax_out):
    np.testing.assert_array_equal(wc.wordcount_reference(word_shards(), VOCAB), jax_out["reference"])


@pytest.mark.parametrize("cap", CAPACITIES)
def test_partition_tokens_buffers_match_jax_bitwise(jax_out, cap):
    """Slot = rank within the bucket in stream order, overflow dropped,
    padding -1 — the reference's layout, for every mapper in one call."""
    buf, hist = spmd.partition_tokens(torch.from_numpy(np.stack(token_shards())), 8, capacity=cap)
    assert buf.shape == (8, 8, cap) and buf.dtype == torch.int32
    np.testing.assert_array_equal(buf.numpy(), jax_out[f"buf{cap}"])
    np.testing.assert_array_equal(hist.numpy(), jax_out[f"hist{cap}"])


def test_token_shuffle_matches_jax_bitwise(jax_out, mesh):
    recv, hist = spmd.token_shuffle(mesh.shard(token_shards()), mesh, "all", capacity=64)
    np.testing.assert_array_equal(recv.numpy(), jax_out["recv"])
    np.testing.assert_array_equal(hist.numpy(), jax_out["recv_hist"])


def test_token_path_counts_equal_the_reference(mesh):
    """Token shuffle then a per-reducer segment_reduce count: each reducer
    counts only words it owns, and the counts add up to the oracle."""
    from repro_torch.kernels import ref

    shards = token_shards()
    counts, recv = wc.wordcount_token_shuffle(mesh.shard(shards), 1000, mesh, "all")
    assert counts.shape == (8, 1000) and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.sum(0).to(torch.int64).numpy(),
                                  wc.wordcount_reference(shards, 1000))
    owner = ref.hash_bucket(torch.arange(1000), 8)
    reducer, word = counts.nonzero(as_tuple=True)
    assert torch.equal(reducer, owner[word])
    assert int((recv >= 0).sum()) == sum(int((s >= 0).sum()) for s in shards)


def test_token_path_refuses_counts_beyond_fp32(monkeypatch, mesh):
    monkeypatch.setattr(wc, "MAX_EXACT_COUNT", 3)
    words = mesh.shard([np.full((4,), 5, np.int32)] * 8)
    with pytest.raises(ValueError, match="exact"):
        wc.wordcount_token_shuffle(words, 8, mesh, "all")


@pytest.mark.parametrize("i", range(len(SHARD_ARGS)))
def test_wordcount_shards_match_jax_bitwise(jax_out, i):
    got = np.stack(pipeline.wordcount_shards(*SHARD_ARGS[i]))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_out[f"shards{i}"])


def test_shuffle_reduce_rejects_indivisible_width(mesh):
    with pytest.raises(ValueError, match="divisible"):
        spmd.shuffle_reduce(torch.zeros((8, 12)), mesh, "all")


def test_kernel_histogram_refuses_counts_beyond_fp32(mesh):
    big = torch.zeros((1, 2**24 + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="exact"):
        wc.kernel_histogram(big, 4)
