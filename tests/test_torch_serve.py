"""The port's serving path vs the JAX package's, on the CPU.

One subprocess runs ``qwen1.5-smoke`` through the JAX package's
``make_prefill_step``/``make_serve_step`` on a (1, 1) mesh, as
``tests/test_models_smoke.py`` does, in two variants: the smoke config
itself (4 kv heads, rep_q = 1) and one with 2 kv heads (rep_q = 2). Its
parameters (``init_params``, then biases and norm scales set to random
values and wq/wk scaled ×10 so that every leaf matters and attention is far
from uniform) come back as numpy with the last-position logits, computed
inside a ``shard_map`` as ``argmax_logits`` computes them, the greedy
tokens of prefill and of three decode steps, and the KV caches. The port
loads the same parameters (``convert.params_from_jax``) and runs the same
prompts with both prefill impls.

The JAX model runs in bf16 (``parallel.py:297-328`` casts every product's
inputs), and XLA may keep intermediates of a fusion in fp32 where PyTorch
rounds each op, so the two agree to bf16 rounding, not bitwise: caches at
``CACHE_TOL`` and logits at ``LOGIT_TOL`` (a few bf16 ulps at their
magnitudes). ``impl="flash"`` keeps p in fp32 where the JAX model rounds it
to bf16 (``attention.py:102``), which stays inside the same tolerances.
Greedy tokens are compared wherever JAX's margin between its top two logits
exceeds ``LOGIT_TOL``; decode steps take JAX's tokens as input, so each
step is compared on its own.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import cache_to_jax, flatten, params_from_jax  # noqa: E402

B, S, GEN = 2, 24, 4  # prompts, prompt length, tokens generated (prefill + 3 decode steps)
VARIANTS = [("kv4", 4), ("kv2", 2)]
# bf16 keeps 8 significant bits: one ulp is 2**-7 = 7.8e-3 of a value at most.
# Caches: about two ulps relative, the same absolute for values near zero.
CACHE_TOL = 2e-2
# Logits reach about 0.32, where a bf16 ulp is 2**-9 = 2.0e-3: two ulps, absolute.
LOGIT_TOL = 4e-3


def smoke_cfg(kv: int):
    return dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), n_kv_heads=kv)


def prompts(vocab: int) -> np.ndarray:
    return np.random.RandomState(5).randint(0, vocab, (B, S)).astype(np.int32)


NORMS = ("ln1", "ln2", "lnx", "final_norm", "enc_norm", "q_norm", "kv_norm", "out_norm")


def perturb(flat: dict) -> dict:
    """Random biases and norm scales (init makes them zeros and ones), and
    the query/key projections ×10, so the comparison sees every leaf and a
    peaked softmax. The SSM's A_log, dt_bias and D and the RG-LRU's lam and
    gate biases, also zeros and ones at init, get random values too."""
    rs = np.random.RandomState(7)
    out = {}
    for key, a in sorted(flat.items()):
        a = np.asarray(a, np.float32)
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("bq", "bk", "bv", "A_log", "dt_bias", "gate_a_b", "gate_i_b"):
            a = rs.randn(*a.shape).astype(np.float32) * 0.5
        elif leaf in NORMS + ("D", "lam"):
            a = (1 + 0.2 * rs.randn(*a.shape)).astype(np.float32)
        elif leaf in ("wq", "wk", "wq_b", "wkv_b"):
            a = a * 10
        out[key] = a
    return out


def flat_tree(tree) -> dict:
    """A JAX pytree → {"a/b/c": numpy leaf} (run where jax is imported)."""
    import jax

    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in paths}


def jax_serve(cfg, batch: dict, gen: int, tag: str) -> dict:
    """Serve ``cfg`` on the JAX package, on a (1, 1) mesh (run in the JAX
    subprocess). ``batch``: numpy inputs of its prefill (``tokens``, or
    ``embeds`` and ``positions``, and ``enc_embeds``/``enc_positions`` for
    enc-dec). Parameters: ``init_params`` seed 0, then ``perturb``. Prefill,
    then ``gen - 1`` decode steps, each fed the argmax of the last logits,
    into a cache padded as ``launch/serve.py``'s ``pad_cache`` pads it: to
    the prefill's cache at ``prompt + gen`` positions (the encoder's length
    unchanged). The last position's logits come from the reference's own
    ``prefill``/``decode_step``, with ``argmax_logits`` replaced by the
    logits it takes the argmax of. Returns {f"{tag}/param/<leaf>",
    f"{tag}/prefill/<leaf>" (cache), f"{tag}/logits<i>", f"{tag}/tok<i>",
    f"{tag}/final/<leaf>"} as numpy; caches keep the mesh's two dims."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.launch import serve as jserve
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
    from repro.models import model as JM
    from repro.models.common import init_params, tree_partition_specs
    from repro.models.parallel import sharded_logits

    mesh = make_mesh((1, 1), ("data", "model"))
    env = jsteps.make_env(cfg, mesh)
    specs = JM.param_specs(cfg, env)
    p_part = tree_partition_specs(specs, env.fsdp_axes)
    params = init_params(specs, 0, jnp.float32, env)
    flat = perturb(flat_tree(params))
    _, treedef = jax.tree_util.tree_flatten(params)
    keys = list(flat_tree(params))
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])
    out = {f"{tag}/param/{k}": v for k, v in flat.items()}
    JM.argmax_logits = lambda x, table, e, vocab: sharded_logits(x, table, e).astype(jnp.float32)
    m2 = P("data", "model")
    prefill = jax.jit(jax.shard_map(
        lambda p, bt: jsteps._expand(JM.prefill(p, jsteps._strip(bt, 2), cfg, env), 2),
        mesh=mesh, in_specs=(p_part, m2), out_specs=m2, check_vma=False))
    decode = jax.jit(jax.shard_map(
        lambda p, c, t, cl: jsteps._expand(
            JM.decode_step(p, jsteps._strip(c, 2), t, cl, cfg, env), 2),
        mesh=mesh, in_specs=(p_part, m2, P(), P()), out_specs=m2, check_vma=False))
    b, s = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[:2]
    dev_batch = {k: jnp.asarray(v[None, None]) for k, v in batch.items()}
    cache, lg = prefill(params, dev_batch)
    longer = {k: jax.ShapeDtypeStruct(v.shape[:3] + (s + gen,) + v.shape[4:], v.dtype)
              if k in ("tokens", "embeds", "positions") else v for k, v in dev_batch.items()}
    tmpl, _ = jax.eval_shape(prefill, params, longer)
    out.update({f"{tag}/prefill/{k}": v for k, v in flat_tree(cache).items()})
    cache = jserve.pad_cache(
        cache, jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape, t.dtype), tmpl))
    for i in range(gen):
        lg = np.asarray(lg, np.float32).reshape(b, -1)
        out[f"{tag}/logits{i}"] = lg
        out[f"{tag}/tok{i}"] = np.argmax(lg, -1).astype(np.int32)
        if i + 1 < gen:
            lg, cache = decode(params, cache, jnp.asarray(out[f"{tag}/tok{i}"]),
                               jnp.asarray(s + i, jnp.int32))
    out.update({f"{tag}/final/{k}": v for k, v in flat_tree(cache).items()})
    return out


JAX_SCRIPT = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_serve as T
from repro.configs import get_smoke_config
from repro.launch import serve, steps
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.models.common import init_params
from repro.models.parallel import embed_lookup, pad_vocab, sharded_logits
import dataclasses

mesh = make_mesh((1, 1), ("data", "model"))
out = {{}}
for name, kv in T.VARIANTS:
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), n_kv_heads=kv)
    pstep, env, pb = steps.make_prefill_step(cfg, mesh, global_batch=T.B, seq=T.S)
    sstep, _, sb = steps.make_serve_step(cfg, mesh, global_batch=T.B, seq_max=T.S + T.GEN)
    params = init_params(pb["param_leafspecs"], 0, jnp.float32, env)
    paths, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = ["/".join(p.key for p in path) for path, _ in paths]
    flat = T.perturb({{k: np.asarray(leaf) for k, (_, leaf) in zip(keys, paths)}})
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])
    for k in keys:
        out[f"{{name}}/param/{{k}}"] = flat[k]
    vp = pad_vocab(cfg.vocab, env.model_size)

    def prefill_logits(params, batch):
        x = embed_lookup(steps._strip(batch, 2)["tokens"], params["embed"], env, vp)
        b, s = x.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        ctx = {{"rope": M.rope_for(cfg, pos, cfg.hd), "impl": "masked", "want_cache": True,
               "cache": None, "cache_len": None}}
        x, _, _ = M.backbone(params, x, cfg, env, ctx)
        x = M._ln(params["final_norm"], x, cfg, env)
        return steps._expand(sharded_logits(x[:, -1], params["embed"], env).astype(jnp.float32), 2)

    def decode_logits(params, cache, tokens, cache_len):
        cache = steps._strip(cache, 2)
        toks = steps._strip({{"t": tokens}}, 2)["t"]
        x = embed_lookup(toks[:, None], params["embed"], env, vp)
        pos = jnp.broadcast_to(cache_len[None, None], (x.shape[0], 1))
        ctx = {{"rope": M.rope_for(cfg, pos, cfg.hd), "impl": "masked", "want_cache": True,
               "cache_len": cache_len, "decode": True}}
        x, _, _ = M.backbone(params, x, cfg, env, ctx, caches=cache)
        x = M._ln(params["final_norm"], x, cfg, env)
        return steps._expand(sharded_logits(x[:, 0], params["embed"], env).astype(jnp.float32), 2)

    plog = jax.jit(jax.shard_map(prefill_logits, mesh=mesh,
                                 in_specs=(pb["param_partition"], pb["batch_partition"]),
                                 out_specs=P("data", "model"), check_vma=False))
    tp = sb["token_partition"]
    dlog = jax.jit(jax.shard_map(decode_logits, mesh=mesh,
                                 in_specs=(sb["param_partition"], sb["cache_partition"],
                                           tp["tokens"], tp["cache_len"]),
                                 out_specs=P("data", "model"), check_vma=False))
    batch = {{"tokens": jnp.asarray(T.prompts(cfg.vocab).reshape(pb["batch_sds"]["tokens"].shape))}}
    cache, toks = pstep(params, batch)
    attn = cache["blocks"]["0_attn_mlp"]["attn"]
    out[f"{{name}}/prefill_k"] = np.asarray(attn["k"], np.float32)
    out[f"{{name}}/prefill_v"] = np.asarray(attn["v"], np.float32)
    out[f"{{name}}/logits0"] = np.asarray(plog(params, batch)).reshape(T.B, -1)
    out[f"{{name}}/tok0"] = np.asarray(toks).reshape(-1)
    cache = serve.pad_cache(cache, jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), sb["cache_sds"]))
    for i in range(T.GEN - 1):
        cl = jnp.asarray(T.S + i, jnp.int32)
        lg = dlog(params, cache, toks, cl)
        out[f"{{name}}/logits{{i + 1}}"] = np.asarray(lg).reshape(T.B, -1)
        toks, cache = sstep(params, cache, toks, cl)
        out[f"{{name}}/tok{{i + 1}}"] = np.asarray(toks).reshape(-1)
    attn = cache["blocks"]["0_attn_mlp"]["attn"]
    out[f"{{name}}/final_k"] = np.asarray(attn["k"], np.float32)
    out[f"{{name}}/final_v"] = np.asarray(attn["v"], np.float32)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    import os

    path = str(tmp_path_factory.mktemp("jax_serve") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path), n_devices=1)
    with np.load(path) as f:
        return dict(f)


def _model(jax_out, name, kv):
    prefix = f"{name}/param/"
    tree = {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}
    return params_from_jax(tree, smoke_cfg(kv), device="cpu")


def _tokens_agree(got, want, logits, tol=LOGIT_TOL):
    """Tokens equal wherever JAX's top-two margin exceeds ``tol``; returns
    how many positions were compared."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > tol
    np.testing.assert_array_equal(np.asarray(got)[decisive], np.asarray(want)[decisive])
    assert np.array_equal(np.argmax(logits, -1), want)  # JAX's own tokens are its argmax
    return int(decisive.sum())


def _close_cache(got: dict, jax_out, name, stage, mesh_dims=2):
    attn = cache_to_jax(got, mesh_dims)["blocks"]["0_attn_mlp"]["attn"]
    for kv in ("k", "v"):
        want = jax_out[f"{name}/{stage}_{kv}"]
        assert attn[kv].shape == want.shape
        np.testing.assert_allclose(attn[kv], want, rtol=CACHE_TOL, atol=CACHE_TOL)


def port_batch(batch: dict):
    """A numpy prompt batch (``jax_serve``'s) → the port's prefill input:
    the tokens tensor alone, or the dict of tensors."""
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    return t["tokens"] if list(t) == ["tokens"] else t


def load_model(jax_out, tag: str, cfg):
    prefix = f"{tag}/param/"
    tree = {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}
    return params_from_jax(tree, cfg, device="cpu")


def close_cache_tree(got: dict, jax_out, prefix: str, tol: float) -> None:
    """Every leaf of the port's cache against the JAX cache saved under
    ``prefix``: the same tree, shapes, and values within ``tol`` (rtol = atol)."""
    flat = flatten(cache_to_jax(got, 2))
    want = {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].shape == v.shape, k
        np.testing.assert_allclose(flat[k], v, rtol=tol, atol=tol, err_msg=k)


def check_serving(jax_out, tag: str, cfg, batch: dict, gen: int, impl: str, *,
                  cache_tol: float, logit_tol: float) -> int:
    """The port against ``jax_serve``'s run of the same model: the prefill's
    cache (every leaf), last-position logits and greedy token; then, over a
    cache of prompt + gen positions filled by the prefill step, ``gen - 1``
    decode steps fed JAX's tokens: logits and tokens at each, and the final
    cache. Tokens are compared where JAX's top-two margin exceeds
    ``logit_tol``. Returns how many tokens were compared."""
    model = load_model(jax_out, tag, cfg)
    pb = port_batch(batch)
    b, s = steps.batch_shape(pb)
    with torch.inference_mode():
        cache, h = model.prefill_hidden(pb, impl=impl)
        lg = model.logits(h)
    close_cache_tree(cache, jax_out, f"{tag}/prefill/", cache_tol)
    np.testing.assert_allclose(lg.numpy(), jax_out[f"{tag}/logits0"], rtol=0, atol=logit_tol)
    compared = _tokens_agree(model.greedy(h).numpy(), jax_out[f"{tag}/tok0"],
                             jax_out[f"{tag}/logits0"], logit_tol)
    enc = batch.get("enc_embeds")
    cache = model.init_cache(b, s + gen, enc_len=None if enc is None else enc.shape[1])
    cache, _ = steps.make_prefill_step(model, global_batch=b, seq=s, impl=impl)(pb, cache)
    for i in range(1, gen):
        with torch.inference_mode():
            fed = torch.from_numpy(jax_out[f"{tag}/tok{i - 1}"])
            h = model.decode_hidden(cache, fed, s + i - 1)
            lg = model.logits(h)
        np.testing.assert_allclose(lg.numpy(), jax_out[f"{tag}/logits{i}"], rtol=0,
                                   atol=logit_tol, err_msg=f"decode step {i}")
        compared += _tokens_agree(model.greedy(h).numpy(), jax_out[f"{tag}/tok{i}"],
                                  jax_out[f"{tag}/logits{i}"], logit_tol)
    close_cache_tree(cache, jax_out, f"{tag}/final/", cache_tol)
    return compared


def card_matches_cpu(arch: str, device) -> None:
    """``arch``'s smoke config served on the card (``impl="flash"``, the
    kernels where they apply) and on the CPU (``masked``, the plain
    versions), from the same parameters: prefill caches, the last hidden
    state and greedy decode steps agree to bf16 rounding."""
    cfg = get_smoke_config(arch)
    cpu = M.Model(cfg, device="cpu", seed=0)
    card = M.Model(cfg, device="cpu", seed=0).to(device)
    batch = serve.prompt_batch(cpu, B, S, seed=1)
    on_card = batch.to(device) if isinstance(batch, torch.Tensor) else {
        k: v.to(device) for k, v in batch.items()}
    with torch.inference_mode():
        cc, hc = cpu.prefill_hidden(batch, impl="masked", cache=cpu.init_cache(
            B, S + GEN, enc_len=S if cfg.enc_layers else None))
        cg, hg = card.prefill_hidden(on_card, impl="flash", cache=card.init_cache(
            B, S + GEN, enc_len=S if cfg.enc_layers else None))
        torch.testing.assert_close(hg.float().cpu(), hc.float(), rtol=5e-2, atol=5e-2)
        want, got = flatten(cache_to_jax(cc)), flatten(cache_to_jax(cg))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-2, atol=5e-2, err_msg=k)
        tok = cpu.greedy(hc)
        for i in range(GEN - 1):
            hc = cpu.decode_hidden(cc, tok, S + i)
            hg = card.decode_hidden(cg, tok.to(device), S + i)
            torch.testing.assert_close(hg.float().cpu(), hc.float(), rtol=5e-2, atol=5e-2)
            tok = cpu.greedy(hc)


@pytest.mark.parametrize("impl", ["masked", "flash"])
@pytest.mark.parametrize("name,kv", VARIANTS)
def test_prefill_matches_jax(jax_out, name, kv, impl):
    model = _model(jax_out, name, kv)
    toks = torch.from_numpy(prompts(model.cfg.vocab))
    cache, nxt = steps.make_prefill_step(model, global_batch=B, seq=S, impl=impl)(toks)
    _close_cache(cache, jax_out, name, "prefill")
    with torch.inference_mode():
        _, h = model.prefill_hidden(toks, impl=impl)
        lg = model.logits(h)
    np.testing.assert_allclose(lg.numpy(), jax_out[f"{name}/logits0"], rtol=0, atol=LOGIT_TOL)
    _tokens_agree(nxt.numpy(), jax_out[f"{name}/tok0"], jax_out[f"{name}/logits0"])
    assert nxt.dtype == torch.int32


@pytest.mark.parametrize("impl", ["masked", "flash"])
@pytest.mark.parametrize("name,kv", VARIANTS)
def test_decode_steps_match_jax(jax_out, name, kv, impl):
    """Prefill into a cache of S + GEN slots, then three decode steps, each
    fed JAX's previous token: tokens, and the final cache, as JAX's."""
    model = _model(jax_out, name, kv)
    cache = model.init_cache(B, S + GEN)
    prefill = steps.make_prefill_step(model, global_batch=B, seq=S, impl=impl)
    cache, _ = prefill(torch.from_numpy(prompts(model.cfg.vocab)), cache)
    sstep = steps.make_serve_step(model, global_batch=B, seq_max=S + GEN)
    compared = 0
    for i in range(GEN - 1):
        fed = torch.from_numpy(jax_out[f"{name}/tok{i}"])
        nxt, cache = sstep(cache, fed, S + i)
        compared += _tokens_agree(nxt.numpy(), jax_out[f"{name}/tok{i + 1}"],
                                  jax_out[f"{name}/logits{i + 1}"])
    assert compared >= B  # the margins leave something to compare
    _close_cache(cache, jax_out, name, "final")


def test_decode_logits_match_jax(jax_out):
    """The logits of the first decode step, on the cache the port filled."""
    name, kv = VARIANTS[1]
    model = _model(jax_out, name, kv)
    cache = model.init_cache(B, S + GEN)
    with torch.inference_mode():
        cache, _ = M.prefill(model, torch.from_numpy(prompts(model.cfg.vocab)), cache=cache)
        fed = torch.from_numpy(jax_out[f"{name}/tok0"])
        x = model.backbone(M.embed_lookup(fed[:, None], model.embed_c),
                           {"rope": M.rope_for(model.cfg, torch.full((B, 1), S), model.cfg.hd),
                            "impl": "masked", "cache_len": S}, caches=cache)
        lg = model.logits(model.final_norm(x[:, 0]))
    np.testing.assert_allclose(lg.numpy(), jax_out[f"{name}/logits1"], rtol=0, atol=LOGIT_TOL)


def test_params_from_jax_checks_the_tree(jax_out):
    name, kv = VARIANTS[0]
    prefix = f"{name}/param/"
    tree = {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}
    model = params_from_jax(tree, smoke_cfg(kv), device="cpu")
    np.testing.assert_array_equal(model.blocks[1].attn.wk.numpy(),
                                  tree["blocks/0_attn_mlp/attn/wk"][1])
    assert model.blocks[0].attn.wq_c.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in tree.items() if k != "embed"}, smoke_cfg(kv),
                        device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, smoke_cfg(2 if kv == 4 else 4), device="cpu")
    nested = {}
    for k, v in tree.items():
        *path, leaf = k.split("/")
        d = nested
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    assert set(flatten(nested)) == set(tree)


def test_serve_run_on_the_cpu(capsys):
    args = serve.parser().parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2",
                                      "--prompt-len", "20", "--gen", "5", "--device", "cpu"])
    gen = serve.run(args)
    assert gen.shape == (2, 5) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < get_smoke_config("qwen1.5-0.5b").vocab)).all()
    assert "(masked)" in capsys.readouterr().out
    flash = serve.run(serve.parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2", "--prompt-len", "20", "--gen", "5",
         "--device", "cpu", "--impl", "flash"]))
    assert flash.shape == gen.shape


def test_generate_equals_the_steps():
    model = M.Model(get_smoke_config("qwen1.5-0.5b"), device="cpu", seed=3)
    toks = torch.from_numpy(prompts(model.cfg.vocab))
    res = serve.generate(model, toks, 3, impl="masked")
    prefill = steps.make_prefill_step(model, global_batch=B, seq=S)
    cache, t0 = prefill(toks, model.init_cache(B, S + 3))
    sstep = steps.make_serve_step(model, global_batch=B, seq_max=S + 3)
    t1, cache = sstep(cache, t0, S)
    t2, cache = sstep(cache, t1, S + 1)
    assert torch.equal(res["tokens"], torch.stack([t0, t1, t2], 1))
    got, want = flatten(res["cache"]), flatten(cache)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_unported_configs_and_impls_raise(monkeypatch):
    """(The name is historical: every arch is ported.) An unknown arch, a
    config whose block kind lacks its sub-config, ``impl="flash"`` on a
    decode step and a model on the card without CUDA raise."""
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("mamba3-9b")
    with pytest.raises(ValueError, match="cfg.moe"):
        M.Model(dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), family="moe"),
                device="cpu")
    model = M.Model(get_smoke_config("qwen1.5-0.5b"), device="cpu")
    cache = model.init_cache(1, 8)
    with pytest.raises(ValueError, match="flash"):
        # a decode step (cache offset, kv_len) is not the kernel's function
        model.blocks[0].attn(torch.zeros(1, 1, 32, dtype=torch.bfloat16),
                             rope=M.rope_for(model.cfg, torch.zeros(1, 1), model.cfg.hd),
                             cache={k: v[0] for k, v in
                                    cache["blocks"]["0_attn_mlp"]["attn"].items()},
                             cache_len=3,
                             impl="flash")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.Model(get_smoke_config("qwen1.5-0.5b"))


def test_full_config_shapes():
    cfg = get_config("qwen1.5-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab) == (24, 1024, 16, 16, 64, 2816, 151936)
    assert 460e6 < cfg.param_count() < 470e6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_prefill_launches_the_kernel_once_per_layer(cuda):
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), d_model=256, n_heads=4,
                              n_kv_heads=2, d_ff=512, vocab=1000)  # head_dim 64, 2 layers
    model = M.Model(cfg, device=cuda, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 200), device=cuda, dtype=torch.int32)
    ops.reset_launches()
    cache_f, h_f = model.prefill_hidden(toks, impl="flash")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    cache_m, h_m = model.prefill_hidden(toks, impl="masked")
    cache_f, cache_m = flatten(cache_f), flatten(cache_m)
    assert set(cache_f) == set(cache_m) == {"blocks/0_attn_mlp/attn/k", "blocks/0_attn_mlp/attn/v"}
    for key in cache_m:
        torch.testing.assert_close(cache_f[key].float(), cache_m[key].float(),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
    torch.testing.assert_close(h_f.float(), h_m.float(), rtol=5e-2, atol=5e-2)
