"""The port's MoE models (granite-moe, grok) vs the JAX package's, on the CPU.

One subprocess runs the JAX side (``test_torch_serve.jax_serve``) on both
smoke configs: initialized and perturbed parameters, the prefill's cache and
logits, and three decode steps; and, on layer 0's MoE parameters of
granite-moe, ``_router`` and ``moe_apply_replicated`` over seeded inputs.
The port loads the same parameters (``convert.params_from_jax``).

On one device the JAX model's MoE is ``moe_apply_replicated`` (bf16 sum of
every expert's gated output, in expert order); the port's prefill dispatches
each token to its experts and sums the gated rows in fp32 with
``ops.segment_reduce`` (its plain version on the CPU), its decode runs the
replicated form as batched products and sums over the experts in fp32. So
the outputs agree to bf16 rounding: ``MOE_TOL``, two
bf16 ulps (2**-7 = 7.8e-3 each, relative) of the sum, absolute for values
near zero. A token whose k-th and (k+1)-th router probabilities lie within
``TIE_TOL`` could pick another expert in the other package (fp32 sums in
another order); its rows are left out of the module comparison. The
whole-model runs compare every token: a flipped expert would move that
token's next-layer caches far outside ``test_torch_serve.CACHE_TOL``.
Logits at ``LOGIT_TOL`` below.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_serve as TS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "grok-1-314b"]
B, S, GEN = 2, 24, 4
MOE_TOL = 2e-2
# router probabilities closer than this may order differently in the two packages
TIE_TOL = 1e-4
# logits of these models reach about 0.63, where a bf16 ulp is 2**-8 = 3.9e-3: one
# ulp at the top (the logits are bf16 products read as fp32)
LOGIT_TOL = 4e-3


def batch(arch: str) -> dict:
    cfg = get_smoke_config(arch)
    return {"tokens": np.random.RandomState(11).randint(0, cfg.vocab, (B, S)).astype(np.int32)}


def moe_input(arch: str) -> np.ndarray:
    """(B, S, d) fp32 N(0, 1); both packages round it to bf16."""
    return np.random.RandomState(13).randn(B, S, get_smoke_config(arch).d_model).astype(np.float32)


JAX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_serve as TS
import test_torch_moe as T
from repro.configs import get_smoke_config
from repro.launch import steps
from repro.launch.mesh import make_mesh
from repro.models import moe

out = {{}}
for arch in T.ARCHS:
    out.update(TS.jax_serve(get_smoke_config(arch), T.batch(arch), T.GEN, arch))
arch = T.ARCHS[0]
cfg = get_smoke_config(arch)
mesh = make_mesh((1, 1), ("data", "model"))
env = steps.make_env(cfg, mesh)
pre = f"{{arch}}/param/blocks/0_attn_moe/moe/"
p = {{k[len(pre):]: jnp.asarray(v[0]) for k, v in out.items() if k.startswith(pre)}}
x = jnp.asarray(T.moe_input(arch)).astype(jnp.bfloat16)
run = lambda f: jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                                      check_vma=False))(p, x)
g, e, _ = run(lambda p, x: moe._router(p, x.reshape(-1, x.shape[-1]), cfg, env))
y, _ = run(lambda p, x: moe.moe_apply_replicated(p, x, cfg, env))
out["router/gates"] = np.asarray(g, np.float32)
out["router/experts"] = np.asarray(e)
out["moe/y"] = np.asarray(y, np.float32)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_moe") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=1)
    with np.load(path) as f:
        return dict(f)


def _moe(jax_out):
    arch = ARCHS[0]
    return TS.load_model(jax_out, arch, get_smoke_config(arch)).blocks[0].moe


def _decisive(moe, x) -> np.ndarray:
    """Tokens whose k-th and (k+1)-th router probabilities differ by more
    than TIE_TOL (the port's fp32 probabilities)."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ moe.router, -1)
    top = torch.topk(probs, moe.cfg.moe.top_k + 1, dim=-1).values
    return (top[:, -2] - top[:, -1] > TIE_TOL).numpy()


def test_router_matches_jax(jax_out):
    moe = _moe(jax_out)
    x = torch.from_numpy(moe_input(ARCHS[0])).to(torch.bfloat16)
    gates, experts = moe.route(x.reshape(-1, x.shape[-1]))
    ok = _decisive(moe, x)
    assert ok.sum() >= 0.9 * ok.size
    np.testing.assert_array_equal(experts.numpy()[ok], jax_out["router/experts"][ok])
    # gates are fp32 quotients rounded to bf16: one bf16 ulp (2**-8 relative)
    np.testing.assert_allclose(gates.float().numpy()[ok], jax_out["router/gates"][ok],
                               rtol=2**-8, atol=0)
    assert gates.dtype == torch.bfloat16


@pytest.mark.parametrize("decode", [False, True], ids=["dispatched", "replicated"])
def test_moe_layer_matches_jax_replicated(jax_out, decode):
    """The prefill's dispatched layer (``segment_reduce``'s plain version)
    and the decode's replicated one, against ``moe_apply_replicated``."""
    moe = _moe(jax_out)
    x = torch.from_numpy(moe_input(ARCHS[0])).to(torch.bfloat16)
    with torch.inference_mode():
        y = moe(x, decode=decode)
    ok = _decisive(moe, x)
    got = y.float().reshape(-1, y.shape[-1]).numpy()[ok]
    want = jax_out["moe/y"].reshape(-1, y.shape[-1])[ok]
    np.testing.assert_allclose(got, want, rtol=MOE_TOL, atol=MOE_TOL * np.abs(want).max())
    assert y.shape == x.shape and y.dtype == torch.bfloat16


def test_prefill_combines_through_segment_reduce(monkeypatch):
    """Each MoE layer of a prefill sums its gated rows into tokens by one
    ``ops.segment_reduce`` call, (n·k, d) rows into n tokens; decode makes
    none."""
    cfg = get_smoke_config(ARCHS[0])
    calls = []

    def spy(values, ids, n):
        calls.append((tuple(values.shape), n))
        return ref.segment_reduce(values, ids, n)

    monkeypatch.setattr(ops, "segment_reduce", spy)
    from repro_torch.models.model import Model, decode_step, prefill

    model = Model(cfg, device="cpu", seed=2)
    toks = torch.from_numpy(batch(ARCHS[0])["tokens"])
    cache = model.init_cache(B, S + 1)
    with torch.inference_mode():
        cache, nxt = prefill(model, toks, cache=cache)
        assert calls == [((B * S * cfg.moe.top_k, cfg.d_model), B * S)] * cfg.n_layers
        decode_step(model, cache, nxt, S)
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("impl", ["masked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax(jax_out, arch, impl):
    compared = TS.check_serving(jax_out, arch, get_smoke_config(arch), batch(arch), GEN, impl,
                                cache_tol=TS.CACHE_TOL, logit_tol=LOGIT_TOL)
    assert compared >= B


def test_moe_configs():
    from repro_torch.configs import get_config

    for arch, (e, k, de) in {"granite-moe-1b-a400m": (32, 8, 512),
                             "grok-1-314b": (8, 2, 32768)}.items():
        cfg = get_config(arch)
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert) == (e, k, de)
    assert 1.33e9 < get_config("granite-moe-1b-a400m").param_count() < 1.34e9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_serving_on_the_card_matches_the_cpu(cuda):
    ops.reset_launches()
    TS.card_matches_cpu(ARCHS[0], cuda)
    assert ops.LAUNCHES["segment_reduce"] == get_smoke_config(ARCHS[0]).n_layers
