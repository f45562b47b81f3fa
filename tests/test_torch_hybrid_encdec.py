"""The port's hybrid (recurrentgemma), vision-language (qwen2-vl), enc-dec
(seamless) and two more dense models (granite-8b, phi3) vs the JAX
package's, on the CPU.

One subprocess runs the JAX side: each smoke config served by
``test_torch_serve.jax_serve`` (perturbed parameters, prefill cache and
logits, three decode steps) and, on recurrentgemma's parameters,
``rglru_apply`` in both modes, the local-attention rolling cache
(``gqa_apply`` with a window) and ``mrope_angles``. recurrentgemma's window
is 16 and its prompt 20: longer than the window and not a multiple of it,
so its decode steps write the rolling cache's slots 4, 5 and 6, which hold
positions 8, 9 and 10, not the oldest ones (the reference's rolling write,
copied bit for bit). qwen2-vl's prefill takes patch embeddings and a (t, h,
w) position grid (``launch.serve.grid_positions``); seamless's encoder takes
16 frame embeddings and its decoder a 12-token prompt, and decode reuses the
cross cache built at prefill.

Tolerances: bf16 results at ``test_torch_serve.CACHE_TOL`` (two bf16 ulps);
the RG-LRU scan and state in fp32 at ``F32_TOL`` (the port's doubling scan
sums in another order than ``lax.associative_scan``); M-RoPE's cos/sin at
``ANGLE_TOL``; logits at ``LOGIT_TOL``. Module outputs are held at rtol =
tol and atol = tol × their largest magnitude.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_serve as TS  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCHS = ["recurrentgemma-2b", "qwen2-vl-7b", "seamless-m4t-large-v2", "granite-8b",
         "phi3-medium-14b"]
B, S, GEN = 2, 20, 4
ENC_LEN, DEC_LEN = 16, 12  # seamless: frames into the encoder, tokens into the decoder
F32_TOL = 1e-5
# cos/sin of the same fp32 angles from two libraries: a few fp32 ulps of 1
ANGLE_TOL = 1e-6
# logits reach about 0.7 (bf16 ulp 2**-8 = 3.9e-3 above 0.5): one ulp at the top
LOGIT_TOL = 4e-3


def batch(arch: str) -> dict:
    cfg = get_smoke_config(arch)
    rs = np.random.RandomState(23)
    if cfg.enc_layers:
        return {"tokens": rs.randint(0, cfg.vocab, (B, DEC_LEN)).astype(np.int32),
                "enc_embeds": rs.randn(B, ENC_LEN, cfg.d_model).astype(np.float32),
                "enc_positions": np.broadcast_to(np.arange(ENC_LEN, dtype=np.int32),
                                                 (B, ENC_LEN)).copy()}
    if cfg.embed_input:
        return {"embeds": rs.randn(B, S, cfg.d_model).astype(np.float32),
                "positions": serve.grid_positions(B, S, "cpu").numpy().copy()}
    return {"tokens": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)}


def module_inputs() -> dict:
    rs = np.random.RandomState(29)
    return {"x": rs.randn(B, S, 32).astype(np.float32),  # recurrentgemma-smoke's d 32
            "x1": rs.randn(B, 1, 32).astype(np.float32),
            "rec_conv": rs.randn(B, 3, 32).astype(np.float32),
            "rec_h": rs.randn(B, 32).astype(np.float32),
            "grid": rs.randint(0, 50, (B, S, 3)).astype(np.int32)}


JAX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_serve as TS
import test_torch_hybrid_encdec as T
from repro.configs import get_smoke_config
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.models import attention as JA, layers as JL, model as JM, rglru as JR

out = {{}}
for arch in T.ARCHS:
    out.update(TS.jax_serve(get_smoke_config(arch), T.batch(arch), T.GEN, arch))
mi = T.module_inputs()
bf = lambda k: jnp.asarray(mi[k]).astype(jnp.bfloat16)
f32 = lambda a: np.asarray(a, np.float32)
mesh = make_mesh((1, 1), ("data", "model"))

def on_mesh(f, *args):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(),) * len(args), out_specs=P(),
                                 check_vma=False))(*args)

def layer0(sub):
    pre = "recurrentgemma-2b/param/blocks/" + sub + "/"
    return {{k[len(pre):]: jnp.asarray(v[0]) for k, v in out.items() if k.startswith(pre)}}

cfg = get_smoke_config("recurrentgemma-2b")
env = steps.make_env(cfg, mesh)
p = layer0("0_rec/rec")
y, st = on_mesh(lambda p, x: JR.rglru_apply(p, x, cfg, env, want_state=True), p, bf("x"))
out["rec/prefill_y"] = f32(y)
out.update({{f"rec/prefill_state/{{k}}": f32(v) for k, v in st.items()}})
st = {{"conv": bf("rec_conv"), "h": jnp.asarray(mi["rec_h"])}}
y, st = on_mesh(lambda p, x, st: JR.rglru_apply(p, x, cfg, env, state=st), p, bf("x1"), st)
out["rec/decode_y"] = f32(y)
out.update({{f"rec/decode_state/{{k}}": f32(v) for k, v in st.items()}})

# the rolling window cache: a prefill of S = 20 keeps the last 16 k/v, then
# one decode step at position 20 writes slot 20 % 16 = 4
p = layer0("2_attn_local/attn")
rope = lambda lo, hi: JM.rope_for(
    cfg, jnp.broadcast_to(jnp.arange(lo, hi)[None], (T.B, hi - lo)), cfg.hd)
y, c = on_mesh(lambda p, x: JA.gqa_apply(p, x, cfg, env, rope=rope(0, T.S), window=cfg.window,
                                         want_cache=True), p, bf("x"))
out["local/prefill_y"] = f32(y)
out.update({{f"local/prefill_cache/{{k}}": f32(v) for k, v in c.items()}})
y, c = on_mesh(lambda p, x, c: JA.gqa_apply(p, x, cfg, env, rope=rope(T.S, T.S + 1), cache=c,
                                            cache_len=T.S, window=cfg.window), p, bf("x1"), c)
out["local/decode_y"] = f32(y)
out.update({{f"local/decode_cache/{{k}}": f32(v) for k, v in c.items()}})

qcfg = get_smoke_config("qwen2-vl-7b")
cos, sin = JL.mrope_angles(jnp.asarray(mi["grid"]), qcfg.hd, qcfg.rope_theta, qcfg.mrope_sections)
out["mrope/cos"], out["mrope/sin"] = f32(cos), f32(sin)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_hybrid") / "out.npz")
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


def _rg_block(jax_out, i: int):
    return TS.load_model(jax_out, "recurrentgemma-2b",
                         get_smoke_config("recurrentgemma-2b")).blocks[i]


def test_mrope_angles_match_jax(jax_out):
    cfg = get_smoke_config("qwen2-vl-7b")
    cos, sin = L.mrope_angles(torch.from_numpy(module_inputs()["grid"]), cfg.hd, cfg.rope_theta,
                              cfg.mrope_sections)
    _close(cos, jax_out["mrope/cos"], ANGLE_TOL)
    _close(sin, jax_out["mrope/sin"], ANGLE_TOL)
    # all three grids equal: M-RoPE is the plain rotary embedding
    same = torch.arange(7)[None, :, None].expand(1, 7, 3)
    for a, b in zip(L.mrope_angles(same, cfg.hd, cfg.rope_theta, cfg.mrope_sections),
                    L.rope_angles(same[..., 0], cfg.hd, cfg.rope_theta)):
        torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match="sections"):
        L.mrope_angles(same, cfg.hd, cfg.rope_theta, (1, 1, 1))


def test_rglru_prefill_and_decode_match_jax(jax_out):
    """``rglru_apply``'s scan over the prompt with its final state, then one
    decode step from a seeded state (bf16 conv inputs, fp32 h)."""
    mi = module_inputs()
    rec = _rg_block(jax_out, 0).rec
    state = {"conv": torch.zeros(B, 3, 32, dtype=torch.bfloat16), "h": torch.zeros(B, 32)}
    with torch.inference_mode():
        y = rec(_bf("x"), prefill_state=state)
        _close(y, jax_out["rec/prefill_y"], TS.CACHE_TOL, "prefill y")
        _close(state["conv"], jax_out["rec/prefill_state/conv"], TS.CACHE_TOL, "conv")
        _close(state["h"], jax_out["rec/prefill_state/h"], F32_TOL, "h")
        state = {"conv": _bf("rec_conv"), "h": torch.from_numpy(mi["rec_h"]).clone()}
        y = rec(_bf("x1"), state=state)
    _close(y, jax_out["rec/decode_y"], TS.CACHE_TOL, "decode y")
    _close(state["conv"], jax_out["rec/decode_state/conv"], TS.CACHE_TOL, "conv")
    _close(state["h"], jax_out["rec/decode_state/h"], F32_TOL, "h")


def test_rolling_window_cache_matches_jax(jax_out):
    """Window 16, prompt 20: the prefill keeps positions 4..19 in slots
    0..15; the decode step at position 20 writes slot 20 % 16 = 4, over
    position 8 (not the oldest, position 4), and attends over all 16 slots
    without a mask — as the reference does."""
    cfg = get_smoke_config("recurrentgemma-2b")
    block = _rg_block(jax_out, 2)
    assert block.kind == "attn_local" and cfg.window == 16
    attn = block.attn

    def rope(lo, hi):
        return M.rope_for(cfg, torch.arange(lo, hi)[None].expand(B, hi - lo), cfg.hd)

    shape = (B, cfg.window, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
             "v": torch.zeros(shape, dtype=torch.bfloat16)}
    with torch.inference_mode():
        y, _ = attn(_bf("x"), rope=rope(0, S), prefill_cache=cache, window=cfg.window)
        _close(y, jax_out["local/prefill_y"], TS.CACHE_TOL, "prefill y")
        for k in cache:
            _close(cache[k], jax_out[f"local/prefill_cache/{k}"], TS.CACHE_TOL, k)
        before = cache["k"].clone()
        y, _ = attn(_bf("x1"), rope=rope(S, S + 1), cache=cache, cache_len=S, window=cfg.window)
    _close(y, jax_out["local/decode_y"], TS.CACHE_TOL, "decode y")
    for k in cache:
        _close(cache[k], jax_out[f"local/decode_cache/{k}"], TS.CACHE_TOL, k)
    changed = (cache["k"] != before).flatten(2).any(-1).any(0)
    assert changed.nonzero().flatten().tolist() == [S % cfg.window]


@pytest.mark.parametrize("impl", ["masked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax(jax_out, arch, impl):
    """Whole models: KV, rolling-window, RG-LRU and cross caches, logits and
    greedy tokens through prefill and three decode steps."""
    compared = TS.check_serving(jax_out, arch, get_smoke_config(arch), batch(arch), GEN, impl,
                                cache_tol=TS.CACHE_TOL, logit_tol=LOGIT_TOL)
    assert compared >= B


def test_hybrid_layout_and_impls():
    cfg = get_config("recurrentgemma-2b")
    model_layout = [(g, k, i) for g, k, i in M.Model(get_smoke_config("recurrentgemma-2b"),
                                                      device="cpu").layout]
    assert model_layout == [("blocks", "0_rec", 0), ("blocks", "1_rec", 0),
                            ("blocks", "2_attn_local", 0), ("blocks", "0_rec", 1),
                            ("blocks", "1_rec", 1), ("blocks", "2_attn_local", 1),
                            ("tail", "0_rec", None), ("tail", "1_rec", None)]
    assert M.block_pattern(cfg) == (("rec", "rec", "attn_local"), ("rec", "rec"), 8)
    assert M.attention_impl(cfg, "attn_local", "flash") == "masked"  # window, head dim 256
    assert M.attention_impl(get_config("qwen2-vl-7b"), "attn_mlp", "flash") == "flash"
    assert M.attention_impl(get_config("seamless-m4t-large-v2"), "enc", "flash") == "flash"


def test_rolling_cache_is_the_window_and_cross_cache_the_encoder():
    model = M.Model(get_smoke_config("recurrentgemma-2b"), device="cpu")
    cache = model.init_cache(B, 40)
    assert cache["blocks"]["2_attn_local"]["attn"]["k"].shape[2] == 16
    assert cache["tail"]["0_rec"]["rec"]["h"].shape == (B, 32)
    model = M.Model(get_smoke_config("seamless-m4t-large-v2"), device="cpu")
    with pytest.raises(ValueError, match="enc_len"):
        model.init_cache(B, 40)
    cache = model.init_cache(B, 40, enc_len=ENC_LEN)
    assert cache["blocks"]["0_dec"]["cross"]["k"].shape[2] == ENC_LEN
    assert cache["blocks"]["0_dec"]["attn"]["k"].shape[2] == 40


def test_serve_cli_runs_every_new_arch(capsys):
    for arch in ("granite-moe-1b-a400m", "minicpm3-4b", "mamba2-1.3b", "recurrentgemma-2b",
                 "qwen2-vl-7b", "seamless-m4t-large-v2"):
        gen = serve.run(serve.parser().parse_args(
            ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "20", "--gen", "3",
             "--device", "cpu", "--enc-len", "8"]))
        assert gen.shape == (2, 3) and ((gen >= 0) & (gen < 64)).all()
    assert capsys.readouterr().out.count("[serve]") == 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_serving_on_the_card_matches_the_cpu(cuda, arch):
    TS.card_matches_cpu(arch, cuda)
