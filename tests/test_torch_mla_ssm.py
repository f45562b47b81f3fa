"""The port's MLA (minicpm3) and Mamba-2 SSD (mamba2) vs the JAX package's,
on the CPU.

One subprocess runs the JAX side: both smoke configs served by
``test_torch_serve.jax_serve`` (perturbed parameters, prefill cache and
logits, three decode steps), and, on layer 0's parameters, ``mla_apply``'s
expanded prefill and absorbed decode, ``ssm_apply``'s chunked prefill and
one decode step, ``_ssd_chunked`` and ``causal_conv1d`` on seeded inputs.
The port loads the same parameters (``convert.params_from_jax``).

Tolerances. bf16 results (activations, caches, conv outputs) agree to bf16
rounding: ``test_torch_serve.CACHE_TOL``, about two bf16 ulps relative and
the same absolute near zero. MLA's decode and the SSD scan run in fp32 on
the same bf16 inputs, with sums in another order (the port's doubling scan
in place of ``lax.associative_scan``, einsums contracted in another order):
``F32_TOL``. Module outputs are held at rtol = tol and atol = tol × their
largest magnitude. Logits at ``LOGIT_TOL``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_serve as TS  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

ARCHS = ["minicpm3-4b", "mamba2-1.3b"]
# prompt 20: mamba2-smoke's chunk is 8, so the SSD scan also pads
B, S, GEN = 2, 20, 4
# fp32 sums of at most a few hundred terms in another order: a few ulps
# (2**-24 each) of the largest term, with room for cancellation
F32_TOL = 1e-5
# logits reach about 0.6 (bf16 ulp 2**-8 = 3.9e-3 above 0.5): one ulp at the top
LOGIT_TOL = 4e-3
# SSD inputs: (b, s, heads, head_dim), d_state; mamba2-smoke's
SSD_SHAPE, SSD_N, SSD_CHUNK = (B, S, 4, 16), 8, 8


def batch(arch: str) -> dict:
    cfg = get_smoke_config(arch)
    return {"tokens": np.random.RandomState(17).randint(0, cfg.vocab, (B, S)).astype(np.int32)}


def module_inputs() -> dict:
    """Seeded fp32 numpy inputs of the module cases (bf16 ones are rounded
    by each package alike)."""
    rs = np.random.RandomState(19)
    b, s, h, p = SSD_SHAPE
    return {
        "x": rs.randn(B, S, 32).astype(np.float32),  # both smoke configs have d 32
        "x1": rs.randn(B, 1, 32).astype(np.float32),
        "conv_x": rs.randn(B, S, 24).astype(np.float32),
        "conv_w": rs.randn(24, 4).astype(np.float32) * 0.3,
        "conv_state": rs.randn(B, 3, 24).astype(np.float32),
        "ssd_x": rs.randn(b, s, h, p).astype(np.float32),
        "ssd_dt": np.log1p(np.exp(rs.randn(b, s, h))).astype(np.float32),
        "ssd_A": -np.exp(0.5 * rs.randn(h)).astype(np.float32),
        "ssd_B": rs.randn(b, s, h, SSD_N).astype(np.float32),
        "ssd_C": rs.randn(b, s, h, SSD_N).astype(np.float32),
        "ssm_conv_x": rs.randn(B, 3, 64).astype(np.float32),
        "ssm_conv_bc": rs.randn(B, 3, 16).astype(np.float32),
        "ssm_state": rs.randn(B, 4, 8, 16).astype(np.float32),
    }


JAX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_serve as TS
import test_torch_mla_ssm as T
from repro.configs import get_smoke_config
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.models import attention as JA, layers as JL, model as JM, ssm as JS

out = {{}}
for arch in T.ARCHS:
    out.update(TS.jax_serve(get_smoke_config(arch), T.batch(arch), T.GEN, arch))
mi = T.module_inputs()
bf = lambda k: jnp.asarray(mi[k]).astype(jnp.bfloat16)
f32 = lambda a: np.asarray(a, np.float32)
mesh = make_mesh((1, 1), ("data", "model"))

def layer0(arch, sub):
    pre = f"{{arch}}/param/blocks/" + sub + "/"
    return {{k[len(pre):]: jnp.asarray(v[0]) for k, v in out.items() if k.startswith(pre)}}

def on_mesh(f, *args):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(),) * len(args), out_specs=P(),
                                 check_vma=False))(*args)

# causal_conv1d, without and with a state
for name, st in (("conv", None), ("conv_state", bf("conv_state"))):
    y, ns = JL.causal_conv1d(bf("conv_x"), jnp.asarray(mi["conv_w"]), st)
    out[name + "/y"], out[name + "/state"] = f32(y), f32(ns)

# MLA: expanded prefill, then absorbed decode at position S over a cache of S + 1
cfg = get_smoke_config("minicpm3-4b")
env = steps.make_env(cfg, mesh)
p = layer0("minicpm3-4b", "0_attn_mlp/attn")
dr = cfg.mla.qk_rope_head_dim
rope = lambda pos: JM.rope_for(cfg, jnp.broadcast_to(pos[None], (T.B, pos.shape[0])), dr)
y, c = on_mesh(lambda p, x: JA.mla_apply(p, x, cfg, env, rope=rope(jnp.arange(T.S)),
                                         want_cache=True), p, bf("x"))
out["mla/prefill_y"] = f32(y)
out.update({{f"mla/prefill_cache/{{k}}": f32(v) for k, v in c.items()}})
c = {{k: jnp.pad(v, ((0, 0), (0, 1), (0, 0))) for k, v in c.items()}}
y, c = on_mesh(lambda p, x, c: JA.mla_apply(p, x, cfg, env, rope=rope(jnp.arange(T.S, T.S + 1)),
                                            cache=c, cache_len=T.S), p, bf("x1"), c)
out["mla/decode_y"] = f32(y)
out.update({{f"mla/decode_cache/{{k}}": f32(v) for k, v in c.items()}})

# SSD scan alone, then the SSM block: chunked prefill and one decode step
y, last = JS._ssd_chunked(bf("ssd_x"), jnp.asarray(mi["ssd_dt"]), jnp.asarray(mi["ssd_A"]),
                          bf("ssd_B"), bf("ssd_C"), T.SSD_CHUNK)
out["ssd/y"], out["ssd/last"] = f32(y), f32(last)
cfg = get_smoke_config("mamba2-1.3b")
env = steps.make_env(cfg, mesh)
p = layer0("mamba2-1.3b", "0_ssm/ssm")
y, st = on_mesh(lambda p, x: JS.ssm_apply(p, x, cfg, env, want_state=True), p, bf("x"))
out["ssm/prefill_y"] = f32(y)
out.update({{f"ssm/prefill_state/{{k}}": f32(v) for k, v in st.items()}})
st = {{"conv_x": bf("ssm_conv_x"), "conv_bc": bf("ssm_conv_bc"),
      "ssm": jnp.asarray(mi["ssm_state"])}}
y, st = on_mesh(lambda p, x, st: JS.ssm_apply(p, x, cfg, env, state=st), p, bf("x1"), st)
out["ssm/decode_y"] = f32(y)
out.update({{f"ssm/decode_state/{{k}}": f32(v) for k, v in st.items()}})
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_mla_ssm") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=1)
    with np.load(path) as f:
        return dict(f)


def _bf(name: str) -> torch.Tensor:
    return torch.from_numpy(module_inputs()[name]).to(torch.bfloat16)


def _close(got: torch.Tensor, want: np.ndarray, tol: float, what: str = "") -> None:
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("case", ["conv", "conv_state"])
def test_causal_conv1d_matches_jax(jax_out, case):
    mi = module_inputs()
    state = _bf("conv_state") if case == "conv_state" else None
    y, st = L.causal_conv1d(_bf("conv_x"), torch.from_numpy(mi["conv_w"]), state)
    # the taps sum in fp32 in the same order; silu and the bf16 rounding may
    # differ by one bf16 ulp (2**-8 relative)
    np.testing.assert_allclose(y.float().numpy(), jax_out[f"{case}/y"], rtol=2**-8, atol=1e-6)
    np.testing.assert_array_equal(st.float().numpy(), jax_out[f"{case}/state"])
    assert y.dtype == torch.bfloat16


def _layer0(jax_out, arch):
    return TS.load_model(jax_out, arch, get_smoke_config(arch)).blocks[0]


def test_mla_prefill_and_decode_match_jax(jax_out):
    """The expanded prefill over a fresh latent cache, then the absorbed
    decode at position S over that cache (S + 1 slots)."""
    cfg = get_smoke_config("minicpm3-4b")
    attn = _layer0(jax_out, "minicpm3-4b").attn
    m = cfg.mla
    dr = m.qk_rope_head_dim

    def rope(lo, hi):
        return M.rope_for(cfg, torch.arange(lo, hi)[None].expand(B, hi - lo), dr)

    cache = {"c_kv": torch.zeros(B, S + 1, m.kv_lora_rank, dtype=torch.bfloat16),
             "k_rope": torch.zeros(B, S + 1, dr, dtype=torch.bfloat16)}
    with torch.inference_mode():
        y, c = attn(_bf("x"), rope=rope(0, S), prefill_cache=cache, impl="masked")
        _close(y, jax_out["mla/prefill_y"], TS.CACHE_TOL, "prefill y")
        for k in cache:
            _close(c[k][:, :S], jax_out[f"mla/prefill_cache/{k}"], TS.CACHE_TOL, k)
        y, c = attn(_bf("x1"), rope=rope(S, S + 1), cache=cache, cache_len=S)
    # fp32 attention over the same latent cache; y is rounded to bf16
    _close(y, jax_out["mla/decode_y"], TS.CACHE_TOL, "decode y")
    for k in cache:
        _close(c[k], jax_out[f"mla/decode_cache/{k}"], TS.CACHE_TOL, k)
    assert c is cache


def test_ssd_chunked_matches_jax(jax_out):
    mi = module_inputs()
    y, last = ssd_chunked(_bf("ssd_x"), torch.from_numpy(mi["ssd_dt"]),
                          torch.from_numpy(mi["ssd_A"]), _bf("ssd_B"), _bf("ssd_C"), SSD_CHUNK)
    _close(y, jax_out["ssd/y"], F32_TOL, "y")
    _close(last, jax_out["ssd/last"], F32_TOL, "last state")
    assert y.dtype == last.dtype == torch.float32


def test_ssm_prefill_and_decode_match_jax(jax_out):
    """``ssm_apply``'s chunked prefill with its final state, then one decode
    step from a seeded state (bf16 conv states, fp32 SSM state)."""
    mi = module_inputs()
    ssm = _layer0(jax_out, "mamba2-1.3b").ssm
    state = {"conv_x": torch.zeros(B, 3, 64, dtype=torch.bfloat16),
             "conv_bc": torch.zeros(B, 3, 16, dtype=torch.bfloat16),
             "ssm": torch.zeros(B, 4, 8, 16)}
    with torch.inference_mode():
        y = ssm(_bf("x"), prefill_state=state)
        _close(y, jax_out["ssm/prefill_y"], TS.CACHE_TOL, "prefill y")
        for k, v in state.items():
            _close(v, jax_out[f"ssm/prefill_state/{k}"],
                   F32_TOL if k == "ssm" else TS.CACHE_TOL, k)
        state = {"conv_x": _bf("ssm_conv_x"), "conv_bc": _bf("ssm_conv_bc"),
                 "ssm": torch.from_numpy(mi["ssm_state"]).clone()}
        y = ssm(_bf("x1"), state=state)
    _close(y, jax_out["ssm/decode_y"], TS.CACHE_TOL, "decode y")
    for k, v in state.items():
        _close(v, jax_out[f"ssm/decode_state/{k}"], F32_TOL if k == "ssm" else TS.CACHE_TOL, k)


@pytest.mark.parametrize("impl", ["masked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax(jax_out, arch, impl):
    """Whole models: MLA's latent cache, the SSM's conv and SSD states,
    logits and greedy tokens through prefill and three decode steps
    (``impl="flash"`` leaves MLA's 96/64 heads on the chunked path)."""
    compared = TS.check_serving(jax_out, arch, get_smoke_config(arch), batch(arch), GEN, impl,
                                cache_tol=TS.CACHE_TOL, logit_tol=LOGIT_TOL)
    assert compared >= B


def test_mla_and_ssm_configs():
    cfg = get_config("minicpm3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.mla.kv_lora_rank,
            cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim) == (
        62, 2560, 40, 256, 96, 64)
    assert M.attention_impl(cfg, "attn_mlp", "flash") == "masked"
    cfg = get_config("mamba2-1.3b")
    assert M.block_pattern(cfg) == (("ssm",), (), 48)
    assert (cfg.ssm.d_state, cfg.ssm.chunk, cfg.ssm.head_dim) == (128, 256, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_the_card_matches_the_cpu(cuda, arch):
    TS.card_matches_cpu(arch, cuda)
