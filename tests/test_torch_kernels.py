"""Port kernels vs the JAX Pallas kernels and oracles, on the CPU.

The JAX side (``ops.*`` in interpret mode and ``ref.*``) runs once, in one
subprocess, over the sweeps of ``tests/test_kernels.py``; its results come
back through an ``.npz``. Each case then runs through the port's CPU path
(``repro_torch.kernels.ops``, which takes the plain version for a CPU
tensor) on the same numpy inputs. Hash ids, histograms and the bf16 wire
match bitwise; float segment sums at the reference test's 2e-2, integer
counts bitwise. Tests marked ``cuda`` hold the CUDA kernels against their
plain versions and run only where a GPU is present.
"""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402

# the bare launchers (CUDA only); the package's names of the same spelling are
# the dispatching wrappers of ``ops``
hash_partition = importlib.import_module("repro_torch.kernels.hash_partition")
segment_reduce = importlib.import_module("repro_torch.kernels.segment_reduce")
ring_fused_step = importlib.import_module("repro_torch.kernels.ring_fused_step")

HP_CASES = [  # (n, buckets, low token): the sweep, the property range, edges
    (1, 2, 0), (1023, 8, 0), (1024, 8, 0), (1025, 8, 0), (3000, 16, 0),
    (1, 2, -1), (17, 3, -1), (700, 8, -1), (1500, 33, -1), (2999, 64, -1),
    (4096, 61, -(2**31)),
]
SR_CASES = [  # (n, d, nseg, dtype) from test_segment_reduce_sweep
    (64, 8, 4, "float32"), (1000, 32, 16, "float32"),
    (513, 128, 7, "bfloat16"), (2048, 16, 64, "float32"),
]
RF_CASES = [100, 16384, 40000]


def _hp_tokens(n, b, low):
    rs = np.random.RandomState(n * b + 7)
    return rs.randint(low, 100000 if low >= -1 else 2**31 - 1, n).astype(np.int32)


def _padded_tokens():
    toks = np.random.RandomState(11).randint(0, 500, 700).astype(np.int32)
    toks[::7] = -1
    return toks


def _sr_inputs(n, d, nseg):
    rs = np.random.RandomState(n)
    return rs.randn(n, d).astype(np.float32), rs.randint(-1, nseg, n).astype(np.int32)


def _rf_inputs(n):
    rs = np.random.RandomState(n)
    return rs.randn(n).astype(np.float32), rs.randn(n).astype(np.float32)


JAX_SCRIPT = r"""
import sys, numpy as np, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_kernels as T
from repro.kernels import ops, ref
out = {{}}
for i, (n, b, low) in enumerate(T.HP_CASES):
    t = jnp.asarray(T._hp_tokens(n, b, low))
    ids, hist = ops.hash_partition(t, b, interpret=True)
    rids, rhist = ref.hash_partition(t, b)
    out.update({{f"hp{{i}}_ids": ids, f"hp{{i}}_hist": hist, f"hp{{i}}_rids": rids, f"hp{{i}}_rhist": rhist}})
for name, toks, b in [("pad", T._padded_tokens(), 8), ("allpad", np.full((256,), -1, np.int32), 4)]:
    ids, hist = ops.hash_partition(jnp.asarray(toks), b, interpret=True)
    out[f"hp_{{name}}_ids"], out[f"hp_{{name}}_hist"] = ids, hist
for i, (n, d, nseg, dt) in enumerate(T.SR_CASES):
    v, ids = T._sr_inputs(n, d, nseg)
    v = jnp.asarray(v).astype(getattr(jnp, dt))
    out[f"sr{{i}}"] = ops.segment_reduce(v, jnp.asarray(ids), nseg, interpret=True)
    out[f"sr{{i}}_ref"] = ref.segment_reduce(v, jnp.asarray(ids), nseg)
toks = np.random.RandomState(3).randint(0, 32, 500).astype(np.int32)
out["sr_counts"] = ops.segment_reduce(jnp.ones((500, 1), jnp.float32), jnp.asarray(toks), 32, interpret=True)
for n in T.RF_CASES:
    acc, w = T._rf_inputs(n)
    wire = jnp.asarray(w).astype(jnp.bfloat16)
    a, ww = ops.ring_fused_step(jnp.asarray(acc), wire, interpret=True)
    ra, rw = ref.ring_fused_step(jnp.asarray(acc), wire)
    out[f"rf{{n}}_acc"], out[f"rf{{n}}_ref_acc"] = a, ra
    out[f"rf{{n}}_wire"] = np.asarray(ww).view(np.uint16)
    out[f"rf{{n}}_ref_wire"] = np.asarray(rw).view(np.uint16)
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    import os

    path = str(tmp_path_factory.mktemp("jax_kernels") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=1)
    with np.load(path) as f:
        return dict(f)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", range(len(HP_CASES)))
def test_hash_partition_matches_jax(jax_out, case):
    n, b, low = HP_CASES[case]
    ids, hist = ops.hash_partition(_t(_hp_tokens(n, b, low)), b)
    for got, key in [(ids, "ids"), (hist, "hist")]:
        np.testing.assert_array_equal(got.numpy(), jax_out[f"hp{case}_{key}"])
        np.testing.assert_array_equal(got.numpy(), jax_out[f"hp{case}_r{key}"])
    assert ids.dtype == hist.dtype == torch.int32


@pytest.mark.parametrize("name,b", [("pad", 8), ("allpad", 4)])
def test_hash_partition_padding_matches_jax(jax_out, name, b):
    toks = _padded_tokens() if name == "pad" else np.full((256,), -1, np.int32)
    ids, hist = ops.hash_partition(_t(toks), b)
    np.testing.assert_array_equal(ids.numpy(), jax_out[f"hp_{name}_ids"])
    np.testing.assert_array_equal(hist.numpy(), jax_out[f"hp_{name}_hist"])
    np.testing.assert_array_equal(ids.numpy()[toks < 0], -1)
    assert int(hist.sum()) == int((toks >= 0).sum())


def test_hash_partition_batched_rows_match_single_rows():
    toks = np.random.RandomState(5).randint(-1, 5000, (8, 333)).astype(np.int32)
    ids, hist = ops.hash_partition(_t(toks), 8)
    assert ids.shape == (8, 333) and hist.shape == (8, 8)
    for r in range(8):
        rid, rhist = ops.hash_partition(_t(toks[r]), 8)
        np.testing.assert_array_equal(ids[r].numpy(), rid.numpy())
        np.testing.assert_array_equal(hist[r].numpy(), rhist.numpy())


@pytest.mark.parametrize("case", range(len(SR_CASES)))
def test_segment_reduce_matches_jax(jax_out, case):
    n, d, nseg, dt = SR_CASES[case]
    v, ids = _sr_inputs(n, d, nseg)
    got = ops.segment_reduce(_t(v).to(getattr(torch, dt)), _t(ids), nseg)
    assert got.dtype == torch.float32 and got.shape == (nseg, d)
    np.testing.assert_allclose(got.numpy(), jax_out[f"sr{case}"], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), jax_out[f"sr{case}_ref"], rtol=2e-2, atol=2e-2)


def test_segment_reduce_counts_match_jax_bitwise(jax_out):
    toks = np.random.RandomState(3).randint(0, 32, 500).astype(np.int32)
    ones = torch.ones((1, 1)).expand(500, 1)  # a broadcast count, as the word count uses
    got = ops.segment_reduce(ones, _t(toks), 32)
    np.testing.assert_array_equal(got.numpy(), jax_out["sr_counts"])


def test_segment_reduce_batched_rows_and_out_of_range_ids():
    rs = np.random.RandomState(9)
    v = rs.randn(4, 100, 3).astype(np.float32)
    ids = rs.randint(-1, 7, (4, 100)).astype(np.int32)
    ids[0, :5] = 6  # outside [0, 5): dropped like padding
    got = ops.segment_reduce(_t(v), _t(ids), 5)
    assert got.shape == (4, 5, 3)
    for r in range(4):
        want = np.zeros((5, 3), np.float64)
        for i in range(100):
            if 0 <= ids[r, i] < 5:
                want[ids[r, i]] += v[r, i]
        np.testing.assert_allclose(got[r].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", RF_CASES)
def test_ring_fused_step_matches_jax_bitwise(jax_out, n):
    acc, w = _rf_inputs(n)
    got_acc, got_wire = ops.ring_fused_step(_t(acc), _t(w).to(torch.bfloat16))
    assert got_acc.dtype == torch.float32 and got_wire.dtype == torch.bfloat16
    for key in ("acc", "ref_acc"):
        np.testing.assert_array_equal(got_acc.numpy(), jax_out[f"rf{n}_{key}"])
    bits = got_wire.view(torch.int16).numpy().view(np.uint16)
    for key in ("wire", "ref_wire"):
        np.testing.assert_array_equal(bits, jax_out[f"rf{n}_{key}"])


def test_hash_bucket_keeps_uint32_wraparound():
    toks = np.array([0, 1, 7, 65535, 65536, 2**31 - 1, -1, -(2**31)], np.int32)
    want = ((toks.astype(np.uint32).astype(np.uint64) * ref.HASH_MULT) % 2**32) >> 16
    got = ref.hash_bucket(_t(toks), 1 << 16)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_cpu_calls_take_the_plain_path_and_do_not_count():
    ops.reset_launches()
    ops.hash_partition(torch.zeros(4, dtype=torch.int32), 2)
    ops.segment_reduce(torch.ones(4, 1), torch.zeros(4, dtype=torch.int32), 2)
    ops.ring_fused_step(torch.ones(4), torch.ones(4, dtype=torch.bfloat16))
    ops.ring_fused_step(torch.ones(4, 8)[:, ::2], torch.ones(4, 4, dtype=torch.bfloat16))
    assert ops.LAUNCHES == {"hash_partition": 0, "segment_reduce": 0, "ring_fused_step": 0,
                            "flash_attention": 0}
    assert ops.COPIES == {"ring_fused_step": 0}


@pytest.mark.parametrize("name", ["hash_partition", "ring_fused_step", "segment_reduce"])
def test_kernel_launchers_refuse_cpu_tensors(name):
    args = {
        "hash_partition": (torch.zeros(4, dtype=torch.int32), 2),
        "segment_reduce": (torch.ones(4, 1), torch.zeros(4, dtype=torch.int32), 2),
        "ring_fused_step": (torch.ones(4), torch.ones(4, dtype=torch.bfloat16)),
    }[name]
    module = {"hash_partition": hash_partition, "segment_reduce": segment_reduce,
              "ring_fused_step": ring_fused_step}[name]
    launcher = getattr(module, name)
    with pytest.raises(ValueError, match="CUDA"):
        launcher(*args)


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_timed_hops_take_their_inputs_in_turn():
    """``chip_smoke.in_turn``, which times a hop on inputs that are not in
    L2: each call takes the next pair, and the outputs of the last
    ``len(pairs)`` calls stay alive, so no call writes where the one before
    it wrote."""
    import weakref

    pairs = [(torch.full((2,), float(i)), torch.zeros(2, dtype=torch.bfloat16)) for i in range(3)]
    seen, outs = [], []

    def hop(acc, wire):
        seen.append(float(acc[0]))
        out = acc + wire.float()
        outs.append(weakref.ref(out))
        return out

    call = _smoke().in_turn(hop, pairs)
    for _ in range(7):
        call()
    assert seen == [0.0, 1.0, 2.0, 0.0, 1.0, 2.0, 0.0]
    assert [o() is not None for o in outs] == [False] * 4 + [True] * 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda):
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(-1, 100000, (8, 3001), generator=g, dtype=torch.int32).to(cuda)
    for k, p in zip(hash_partition.hash_partition(toks, 8), ref.hash_partition(toks, 8)):
        assert torch.equal(k, p)
    ones = torch.ones((1, 1, 1), device=cuda).expand(8, 3001, 1)
    ids = toks.clamp(max=999)
    assert torch.equal(segment_reduce.segment_reduce(ones, ids, 1000),
                       ref.segment_reduce(ones, ids, 1000))
    v = torch.randn((3001, 5), generator=g).to(cuda, torch.bfloat16)
    torch.testing.assert_close(segment_reduce.segment_reduce(v, ids[0], 1000),
                               ref.segment_reduce(v, ids[0], 1000), rtol=2e-2, atol=2e-2)
    acc = torch.randn(40001, generator=g).to(cuda)
    wire = torch.randn(40001, generator=g).to(cuda, torch.bfloat16)
    for k, p in zip(ring_fused_step.ring_fused_step(acc, wire), ref.ring_fused_step(acc, wire)):
        assert torch.equal(k, p)


def _smoke():
    """``chip_smoke.py`` as a module: the edge sweeps' one definition."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
def test_kernels_match_plain_versions_at_edges_on_the_card(cuda):
    """The edge sweep of ``chip_smoke.py`` (its one definition), with both
    branches of ``segment_reduce``: the shared-memory histogram up to the
    largest segment count that fits and the global atomics past it."""
    _smoke().check_kernels_at_edges(torch)


@pytest.mark.cuda
def test_ring_fused_step_reads_every_layout_on_the_card(cuda):
    """``ring_fused_step`` on the layout sweep of ``chip_smoke.py``
    (``check_kernels_at_edges``, its one definition): bitwise its plain
    version on each layout, and no input copied on the layouts a kernel
    route reads, one on each of ``RING_COPIED``."""
    smoke = _smoke()
    copies = smoke.check_kernels_at_edges(torch)
    assert len(copies) > len(smoke.RING_COPIED)
    assert {k: v for k, v in copies.items() if v} == dict.fromkeys(smoke.RING_COPIED, 1)


@pytest.mark.cuda
def test_wrappers_count_kernel_launches_on_the_card(cuda):
    ops.reset_launches()
    ops.hash_partition(torch.zeros(4, dtype=torch.int32, device=cuda), 2)
    ops.segment_reduce(torch.ones(4, 1, device=cuda), torch.zeros(4, dtype=torch.int32, device=cuda), 2)
    ops.ring_fused_step(torch.ones(4, device=cuda), torch.ones(4, dtype=torch.bfloat16, device=cuda))
    # a transposed acc is read where it lies; a strided slice is copied first
    ops.ring_fused_step(torch.ones(8, 4, device=cuda).t(),
                        torch.ones(4, 8, dtype=torch.bfloat16, device=cuda))
    assert ops.COPIES == {"ring_fused_step": 0}
    ops.ring_fused_step(torch.ones(4, 8, device=cuda)[:, ::2],
                        torch.ones(4, 4, dtype=torch.bfloat16, device=cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"hash_partition": 1, "segment_reduce": 1, "ring_fused_step": 3,
                            "flash_attention": 0}
    assert ops.COPIES == {"ring_fused_step": 1}
    ops.reset_launches()
    assert ops.COPIES == {"ring_fused_step": 0}
