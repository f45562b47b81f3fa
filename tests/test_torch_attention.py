"""The port's attention vs the JAX package's, on the CPU.

The JAX side runs once, in one subprocess: its ``ref.flash_attention`` over
the four cases of ``tests/test_kernels.py::test_flash_attention_sweep``,
its ``chunked_attention`` on the case of
``test_flash_matches_model_chunked_attention`` and on fp32 inputs through
the single-block, chunked-with-padding, windowed and decode (``kv_len``)
paths. The Pallas kernel itself is no oracle here: it calls ``pl.load``,
which jax 0.9 no longer has. Each case then runs through the port on the
same numpy inputs: ``ops.flash_attention`` (its plain version for a CPU
tensor) at the reference test's 3e-4 (fp32) and 3e-2 (bf16), and the port's
``chunked_attention`` at 1e-5 (the same fp32 arithmetic in another
library: exp, sums and products round alike to a few ulp). Tests marked
``cuda`` hold the kernel against its plain version on the card.
"""
import importlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

flash_kernel = importlib.import_module("repro_torch.kernels.flash_attention")

SWEEP = [  # (b, h, s, d, causal, dtype) of test_flash_attention_sweep
    (1, 2, 128, 64, True, "float32"),
    (2, 3, 256, 64, True, "float32"),
    (2, 2, 256, 128, False, "float32"),
    (1, 2, 384, 64, True, "bfloat16"),
]
# chunked_attention paths on fp32 (b, sq, h, d) inputs:
# (name, b, sq, sk, h, d, kwargs of both chunked_attention calls)
CHUNKED = [
    ("single_block", 2, 48, 48, 3, 16, {"causal": True}),
    ("single_block_noncausal", 1, 40, 72, 2, 16, {"causal": False}),
    ("chunked_padded_masked", 2, 200, 200, 2, 16,
     {"causal": True, "impl": "masked", "chunk_q": 64, "chunk_k": 64}),
    ("chunked_padded_triangle", 1, 200, 200, 3, 8,
     {"causal": True, "impl": "triangle", "chunk_q": 64, "chunk_k": 64}),
    ("chunked_window", 1, 150, 150, 2, 8,
     {"causal": True, "window": 40, "chunk_q": 32, "chunk_k": 32}),
    ("decode_kv_len", 2, 1, 96, 4, 16, {"causal": True, "q_offset": 40, "kv_len": 41}),
]


def _sweep_inputs(b, h, s, d):
    rs = np.random.RandomState(s + d)
    return [rs.randn(b, h, s, d) for _ in range(3)]


def _chunked_inputs(case):
    _, b, sq, sk, h, d, _ = case
    rs = np.random.RandomState(sq * 7 + sk)
    return (rs.randn(b, sq, h, d).astype(np.float32), rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32))


def _model_case_inputs():
    rs = np.random.RandomState(0)
    return [rs.randn(2, 2, 256, 32).astype(np.float32) for _ in range(3)]


JAX_SCRIPT = r"""
import sys, numpy as np, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_attention as T
from repro.kernels import ref
from repro.models.attention import chunked_attention
out = {{}}
for i, (b, h, s, d, causal, dt) in enumerate(T.SWEEP):
    q, k, v = (jnp.asarray(a).astype(getattr(jnp, dt)) for a in T._sweep_inputs(b, h, s, d))
    out[f"sweep{{i}}"] = np.asarray(ref.flash_attention(q, k, v, causal=causal), np.float32)
q, k, v = (jnp.asarray(a) for a in T._model_case_inputs())
ch = chunked_attention(jnp.moveaxis(q, 1, 2), jnp.moveaxis(k, 1, 2), jnp.moveaxis(v, 1, 2),
                       scale=1.0 / np.sqrt(32), causal=True, impl="triangle",
                       chunk_q=64, chunk_k=64)
out["model_case"] = np.asarray(jnp.moveaxis(ch, 2, 1))
for case in T.CHUNKED:
    q, k, v = (jnp.asarray(a) for a in T._chunked_inputs(case))
    d = q.shape[-1]
    out[case[0]] = np.asarray(chunked_attention(q, k, v, scale=1.0 / np.sqrt(d), **case[-1]))
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    import os

    path = str(tmp_path_factory.mktemp("jax_attention") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=1)
    with np.load(path) as f:
        return dict(f)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_flash_attention_matches_jax_oracle(jax_out, case):
    b, h, s, d, causal, dt = SWEEP[case]
    dtype = getattr(torch, dt)
    q, k, v = (_t(a, dtype) for a in _sweep_inputs(b, h, s, d))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, h, s, d)
    tol = 3e-2 if dt == "bfloat16" else 3e-4
    np.testing.assert_allclose(got.float().numpy(), jax_out[f"sweep{case}"], rtol=tol, atol=tol)


def test_flash_attention_matches_jax_chunked_attention(jax_out):
    q, k, v = (_t(a) for a in _model_case_inputs())
    got = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), jax_out["model_case"], rtol=3e-4, atol=3e-4)
    ch = A.chunked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             scale=1.0 / math.sqrt(32), causal=True, impl="triangle",
                             chunk_q=64, chunk_k=64)
    np.testing.assert_allclose(ch.transpose(1, 2).numpy(), jax_out["model_case"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CHUNKED, ids=[c[0] for c in CHUNKED])
def test_chunked_attention_matches_jax(jax_out, case):
    q, k, v = (_t(a) for a in _chunked_inputs(case))
    got = A.chunked_attention(q, k, v, scale=1.0 / math.sqrt(q.shape[-1]), **case[-1])
    assert got.shape == tuple(jax_out[case[0]].shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_out[case[0]], rtol=1e-5, atol=1e-5)


def test_plain_flash_attention_reads_grouped_kv_heads():
    """h_kv < h: query head i reads kv head i // (h // h_kv), as the model's
    repeated copy does."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 6, 33, 16, generator=g)
    k, v = torch.randn(2, 2, 33, 16, generator=g), torch.randn(2, 2, 33, 16, generator=g)
    want = ref.flash_attention(q, k.repeat_interleave(3, 1), v.repeat_interleave(3, 1))
    torch.testing.assert_close(ops.flash_attention(q, k, v), want, rtol=0, atol=0)


def test_flash_impl_matches_chunked_attention_in_fp32():
    """The model's two prefill cores, on fp32 (b, s, h, d) inputs: the same
    function, so 1e-5."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 300, 4, 64, generator=g) for _ in range(3))
    flash = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    ch = A.chunked_attention(q, k, v, scale=0.125, causal=True, chunk_q=128, chunk_k=128)
    torch.testing.assert_close(flash.transpose(1, 2), ch, rtol=1e-5, atol=1e-5)


def test_cpu_flash_call_takes_the_plain_path_and_does_not_count():
    ops.reset_launches()
    ops.flash_attention(*(torch.ones(1, 1, 4, 64) for _ in range(3)))
    assert ops.LAUNCHES["flash_attention"] == 0


def test_flash_kernel_reads_the_model_layout_in_place_and_copies_what_tma_cannot():
    """The bf16 kernel loads through tensor maps: a 16-byte aligned start and
    positive strides of multiples of 16 bytes along every dimension longer
    than 1. The model's (b, s, h, d) views qualify and are read in place."""
    x = torch.zeros(2, 40, 4, 64, dtype=torch.bfloat16)
    view = x.transpose(1, 2)  # (b, h, s, d) seen through the model's layout
    assert flash_kernel._readable(view).data_ptr() == view.data_ptr()
    one_head = x[:, :, :1].transpose(1, 2)  # a dimension of size 1 keeps its stride
    assert flash_kernel._readable(one_head).data_ptr() == one_head.data_ptr()
    bcast = x[:, :, :1].expand(2, 40, 4, 64).transpose(1, 2)  # stride 0 over heads
    copied = flash_kernel._readable(bcast)
    assert copied.is_contiguous() and torch.equal(copied, bcast)
    offset = torch.zeros(2 * 4 * 40 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 4, 40, 64)
    assert flash_kernel._readable(offset).data_ptr() != offset.data_ptr()  # 2-byte offset start
    f32 = bcast.float()
    assert flash_kernel._readable(f32).data_ptr() == f32.data_ptr()  # CUDA-core kernel: strides


def test_flash_kernel_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(*(torch.ones(1, 1, 4, 64) for _ in range(3)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version_on_the_card(cuda, dtype):
    """The edge sweep of ``chip_smoke.py`` (its one definition), one dtype."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.check_flash_at_edges(torch, dtypes=(getattr(torch, dtype),)) == 74


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.ones(1, 2, 8, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_kernel.flash_attention(x, x, x)
    x = torch.ones(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sq == sk"):
        flash_kernel.flash_attention(x, x[:, :, :4], x[:, :, :4], causal=True)
    with pytest.raises(TypeError):
        flash_kernel.flash_attention(x.half(), x.half(), x.half())
