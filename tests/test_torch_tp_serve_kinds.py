"""Serving MLA, the RG-LRU hybrid, M-RoPE and enc-dec across a ("data",
"model") mesh: the port vs the JAX package, on the CPU.

One subprocess on 8 fake CPU devices (``jax_side``) runs the reference's
``prefill`` and ``decode_step`` under ``shard_map`` on each case's mesh
(``CASES``): minicpm3 (MLA) at (1, 4), tp 4; recurrentgemma (RG-LRU and
local attention, window 16, kv 1 duplicated over tp 2) at (2, 2), decoded
by the gather route and the compute-at-data route; qwen2-vl (M-RoPE over
patch embeddings and a (t, h, w) grid) at (1, 8), tp 4 with rep 2, the batch
split over the rep groups; seamless (a non-causal encoder over frame
embeddings, cross-attention) at (1, 4), tp 4. Parameters come from
``init_params(param_specs(cfg, env))``, perturbed as
``test_torch_tp_serve.perturb`` does. ``argmax_logits`` is replaced by the
logits it takes the argmax of (``sharded_logits``, every device's vocab
shard), so each step returns them; the next token is their first maximum
over the vocab, as the reference's pmax/pmin tie-break picks it. The prefill
of ``S`` positions gives the device-major cache, padded (``pad_cache``) to
``S + GEN`` positions (the encoder's length and the window unchanged), then
``GEN - 1`` self-fed decode steps.

The port loads the same parameters (``convert.params_from_jax(...,
env=)``), prefills the rows it holds once and serves the device-major
batches through its mesh steps. Tolerances: ``test_torch_tp_serve``'s, which
are ``test_torch_serve``'s tp = 1 ones (``CACHE_TOL`` for every cache leaf,
``LOGIT_TOL`` for the logits); greedy tokens equal at every step. In
process: the leaf specs of each kind at tp > 1 against ``param_specs``, the
dict inputs' specs against the reference's, the M-RoPE tables over a
device-major grid, ``launch.mesh.make_mesh`` with its model axis, and the
serve CLI on a (pod, data, model) mesh.
"""
import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_serve as TS  # noqa: E402
import test_torch_tp_serve as T20  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve, shapes, steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh, mesh_axis_sizes  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import specs  # noqa: E402
from repro_torch.models.convert import (cache_to_jax, flatten, leaf_paths,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.parallel import ShardEnv  # noqa: E402

B, S, GEN = T20.B, T20.S, T20.GEN  # global batch, prompt, tokens (prefill + 6 decode steps)
ENC = 16  # seamless: the encoder's frames (its decoder takes the S-token prompt)
CASES = {  # tag: (arch, mesh)
    "minicpm14": ("minicpm3-4b", (1, 4)),
    "rg22": ("recurrentgemma-2b", (2, 2)),
    "qwen2vl18": ("qwen2-vl-7b", (1, 8)),
    "seamless14": ("seamless-m4t-large-v2", (1, 4)),
}
CAD_CASES = ("rg22",)  # meshes with an fsdp world and an MLP: compute-at-data differs
CACHE_TOL = T20.CACHE_TOL
LOGIT_TOL = T20.LOGIT_TOL
# RoPE-rotated leaves (self-attention k, MLA's k_rope): both packages round
# k to bf16 before rotating it in fp32, so an ulp of a large component moves
# its small partner by that much: their elements are held at CACHE_TOL of
# their head vector's largest magnitude as well as of their own
ROTATED = ("attn/k", "k_rope")
GROWS = ("tokens", "embeds", "positions")  # the inputs that decoding lengthens


def _env(tag: str) -> ShardEnv:
    arch, dims = CASES[tag]
    return steps.make_env(get_smoke_config(arch), Mesh(("data", "model"), dims, device="cpu"))


def inputs(tag: str) -> dict:
    """The distinct rows of a case's prompt batch (numpy, from a seed): tokens;
    patch embeddings and their (t, h, w) grid for qwen2-vl; frame embeddings
    with their positions and a token prompt for seamless."""
    arch, _ = CASES[tag]
    cfg = get_smoke_config(arch)
    r = steps.held_rows(_env(tag), B)
    rs = np.random.RandomState(31)
    if cfg.enc_layers:
        return {"tokens": rs.randint(0, cfg.vocab, (r, S)).astype(np.int32),
                "enc_embeds": rs.randn(r, ENC, cfg.d_model).astype(np.float32),
                "enc_positions": np.broadcast_to(np.arange(ENC, dtype=np.int32),
                                                 (r, ENC)).copy()}
    if cfg.embed_input:
        return {"embeds": rs.randn(r, S, cfg.d_model).astype(np.float32),
                "positions": serve.grid_positions(r, S, "cpu").numpy().copy()}
    return {"tokens": rs.randint(0, cfg.vocab, (r, S)).astype(np.int32)}


def device_batch(tag: str) -> dict:
    env = _env(tag)
    return {k: steps.device_major(env, torch.from_numpy(v), B).numpy()
            for k, v in inputs(tag).items()}


def first_max(rows_logits: np.ndarray, vocab: int) -> np.ndarray:
    return np.argmax(rows_logits[:, :vocab], -1).astype(np.int32)


# ---------------------------------------------------------------------------
# the reference (runs in the JAX subprocess)
# ---------------------------------------------------------------------------
def jax_case(tag: str) -> dict:
    """The reference's prefill and decode of case ``tag`` (see the module doc)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config as ref_cfg
    from repro.launch import serve as jserve
    from repro.launch import shapes as jshapes
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh as ref_mesh
    from repro.models import model as JM
    from repro.models.common import init_params, tree_partition_specs

    arch, dims = CASES[tag]
    cfg = ref_cfg(arch)
    mesh = ref_mesh(dims, ("data", "model"))
    env = jsteps.make_env(cfg, mesh)
    pspecs = JM.param_specs(cfg, env)
    p_part = tree_partition_specs(pspecs, env.fsdp_axes)
    params = init_params(pspecs, 0, jnp.float32, env)
    keys = list(TS.flat_tree(params))
    flat = T20.perturb(TS.flat_tree(params), cfg, env)
    _, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])
    out = {f"{tag}/param/{k}": v for k, v in flat.items()}
    penv = _env(tag)
    _, spec, _ = jshapes.batch_layout(env, B)
    rows_p, dev = P(*spec), P("data", "model")
    batch = {k: jnp.asarray(v) for k, v in device_batch(tag).items()}

    def prefill_fn(p, bt):
        return jsteps._expand(JM.prefill(p, jsteps._strip(bt, 2), cfg, env), 2)

    prefill = jax.jit(jax.shard_map(prefill_fn, mesh=mesh,
                                    in_specs=(p_part, {k: rows_p for k in batch}),
                                    out_specs=dev, check_vma=False))
    cache, lg = prefill(params, batch)
    lg = T20.full_logits(np.asarray(lg), penv)
    out[f"{tag}/logits0"] = lg[:, :cfg.vocab]
    tok0 = first_max(lg, cfg.vocab)
    out.update({f"{tag}/prefill/{k}": v for k, v in TS.flat_tree(cache).items()})
    longer = {k: jax.ShapeDtypeStruct(v.shape[:3] + (S + GEN,) + v.shape[4:], v.dtype)
              if k in GROWS else v for k, v in batch.items()}
    tmpl, _ = jax.eval_shape(prefill, params, longer)
    padded = jserve.pad_cache(cache, jax.tree_util.tree_map(
        lambda t: jnp.zeros(t.shape, t.dtype), tmpl))
    for route in ("gather", "cad") if tag in CAD_CASES else ("gather",):
        e = dataclasses.replace(env, compute_at_data=route == "cad")

        def decode_fn(p, c, t, cl, e=e):
            return jsteps._expand(JM.decode_step(p, jsteps._strip(c, 2), jsteps._strip(t, 2),
                                                 cl, cfg, e), 2)

        decode = jax.jit(jax.shard_map(decode_fn, mesh=mesh,
                                       in_specs=(p_part, dev, rows_p, P()),
                                       out_specs=dev, check_vma=False))
        c, tok = padded, tok0
        for i in range(1, GEN):
            t = steps.device_major(penv, torch.from_numpy(tok), B).numpy()
            lg, c = decode(params, c, jnp.asarray(t), jnp.asarray(S + i - 1, jnp.int32))
            tok = first_max(T20.full_logits(np.asarray(lg), penv), cfg.vocab)
            out[f"{tag}/{route}/tok{i}"] = tok
        out.update({f"{tag}/{route}/final/{k}": v for k, v in TS.flat_tree(c).items()})
    out[f"{tag}/tok0"] = tok0
    return out


def jax_side() -> dict:
    from repro.models import model as JM
    from repro.models.parallel import sharded_logits

    JM.argmax_logits = lambda x, table, e, vocab: sharded_logits(x, table, e).astype("float32")
    out = {}
    for tag in CASES:
        out.update(jax_case(tag))
    return out


JAX_SCRIPT = r"""
import sys, numpy as np
sys.path.insert(0, {tests!r})
import test_torch_tp_serve_kinds as T
np.savez({path!r}, **T.jax_side())
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_tp_kinds") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path))
    with np.load(path) as f:
        return dict(f)


def load(jax_out, tag):
    arch, dims = CASES[tag]
    cfg = get_smoke_config(arch)
    mesh = Mesh(("data", "model"), dims, device="cpu")
    env = steps.make_env(cfg, mesh)
    prefix = f"{tag}/param/"
    tree = {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}
    return params_from_jax(tree, cfg, env=env, device="cpu"), mesh, env


def close_cache(got: dict, jax_out, prefix: str) -> None:
    """Every leaf of the port's device-major cache against the reference's
    under ``prefix``: the same tree and shapes, values within ``CACHE_TOL``
    (rtol = atol; ``ROTATED`` leaves also within it of their head vector's
    largest magnitude)."""
    want = {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}
    flat = flatten(got)
    assert set(flat) == set(want), (sorted(flat), sorted(want))
    for k, v in want.items():
        assert flat[k].shape == v.shape, (k, flat[k].shape, v.shape)
        atol = CACHE_TOL * (1 + np.abs(v).max(-1, keepdims=True) * k.endswith(ROTATED))
        np.testing.assert_array_less(np.abs(flat[k] - v), CACHE_TOL * np.abs(v) + atol + 1e-30,
                                     err_msg=k)


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# serving the four kinds over their meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", sorted(CASES))
def test_prefill_of_the_kind_over_mesh_matches_reference(jax_out, tag):
    """The prefill's cache (device-major, every leaf: MLA's latent cache,
    the RG-LRU state's channels by tp rank, the rolling window's and the
    cross cache's kv slots), the last position's logits over the vocab, and
    the mesh prefill step's greedy tokens."""
    model, mesh, env = load(jax_out, tag)
    vocab = model.cfg.vocab
    with torch.inference_mode():
        cache, h = model.prefill_hidden(_tensors(inputs(tag)))
        lg = model.logits(h).numpy()[:, :vocab]
    close_cache(cache_to_jax(cache, env=env), jax_out, f"{tag}/prefill/")
    np.testing.assert_allclose(lg, jax_out[f"{tag}/logits0"], rtol=0, atol=LOGIT_TOL)
    _, nxt = steps.make_prefill_step(model, global_batch=B, seq=S, mesh=mesh)(
        _tensors(device_batch(tag)))
    np.testing.assert_array_equal(steps.rows_of(env, nxt, B).numpy(), jax_out[f"{tag}/tok0"])


@pytest.mark.parametrize("route,tag", [("gather", t) for t in sorted(CASES)]
                         + [("cad", t) for t in CAD_CASES])
def test_decode_of_the_kind_over_mesh_matches_reference(jax_out, route, tag):
    """The mesh prefill step into a cache of S + GEN positions (the cross
    cache at the encoder's length, the rolling cache at the window), then 6
    self-fed greedy decode steps through the mesh serve step (``cad``: its
    compute-at-data route): every token, and the final cache."""
    model, mesh, env = load(jax_out, tag)
    cache = model.init_cache(steps.held_rows(env, B), S + GEN,
                             enc_len=ENC if model.cfg.enc_layers else None)
    cache, tok = steps.make_prefill_step(model, global_batch=B, seq=S, mesh=mesh)(
        _tensors(device_batch(tag)), cache)
    sstep = steps.make_serve_step(model, global_batch=B, seq_max=S + GEN, mesh=mesh,
                                  compute_at_data=route == "cad")
    for i in range(1, GEN):
        tok, cache = sstep(cache, tok, S + i - 1)
        np.testing.assert_array_equal(steps.rows_of(env, tok, B).numpy(),
                                      jax_out[f"{tag}/{route}/tok{i}"],
                                      err_msg=f"decode step {i}")
    close_cache(cache_to_jax(cache, env=env), jax_out, f"{tag}/{route}/final/")


# ---------------------------------------------------------------------------
# specs, layouts and the launchers, in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", sorted(CASES))
def test_leaf_specs_of_the_kind_match_reference(tag):
    """Every leaf of ``param_specs`` at the case's mesh and at a model axis
    of 16: the storage shape (kv slots laid out by ``dup_map``, the vocab
    padded to the model axis, layers stacked) from the port's parameters,
    and the TP dim, FSDP dim and duplicated entities from ``specs``."""
    import jax

    from repro.configs import get_smoke_config as ref_cfg
    from repro.models import model as ref_model
    from repro.models import parallel as ref
    from repro.models.common import LeafSpec

    arch, (data, model_size) = CASES[tag]
    cfg, rcfg = get_smoke_config(arch), ref_cfg(arch)
    for d, m in ((data, model_size), (1, 16)):
        tp = cfg.resolve_tp(m)
        assert tp == rcfg.resolve_tp(m)
        if m == 16 and tp == 1:
            continue  # the smoke widths do not split over 16
        env = ShardEnv(m, d, tp=tp)
        want, _ = jax.tree_util.tree_flatten_with_path(
            ref_model.param_specs(rcfg, ref.ShardEnv(m, d, tp=tp)),
            is_leaf=lambda v: isinstance(v, LeafSpec))
        want = {"/".join(k.key for k in path): ls for path, ls in want}
        model = M.Model(cfg, device="meta", env=env)
        params = dict(model.named_parameters())
        got: dict[str, list] = {}
        for name, (path, i) in leaf_paths(model).items():
            got.setdefault(path, []).append((i, tuple(params[name].shape)))
        assert set(got) == set(want), set(got) ^ set(want)
        for path, layers in got.items():
            ls, key = want[path], specs.layer_leaf(path)
            stacked = layers[0][0] is not None
            shape = list(layers[0][1])
            n = specs.dup_of(key, cfg)
            if n:
                shape[specs.TP_DIM[key]] = len(env.dup_map(n))
            assert tuple([len(layers)] * stacked + shape) == ls.shape, (path, m)
            tp_dim, fsdp_dim = specs.TP_DIM[key], specs.FSDP_DIM[key]
            assert (None if tp_dim is None else tp_dim + stacked) == ls.tp_dim, path
            assert (None if fsdp_dim is None else fsdp_dim + stacked) == ls.fsdp_dim, path
            assert n == ls.dup_of, path


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_dict_input_specs_match_reference(arch):
    """The prefill and decode input specs of the dict-input archs
    (embeddings and an M-RoPE grid; frames and tokens) over a ShardEnv's
    model axis, data 1 and 2, global batches 1..64: the reference's."""
    from repro.configs import get_smoke_config as ref_cfg
    from repro.launch import shapes as ref_shapes
    from repro.models import parallel as ref

    cfg, rcfg = get_smoke_config(arch), ref_cfg(arch)
    for model_size, tp in T20.GRID:
        for data in (1, 2):
            want, got = ref.ShardEnv(model_size, data, tp=tp), ShardEnv(model_size, data, tp=tp)
            for gb in (1, 2, 4, 8, 16, 32, 64):
                T20._same(lambda: {k: (v.shape, str(v.dtype)) for k, v in
                                   ref_shapes.prefill_input_specs(rcfg, want, 16, gb)[0].items()},
                          lambda: {k: (v[0], str(v[1]).removeprefix("torch.")) for k, v in
                                   shapes.prefill_input_specs(cfg, got, 16, gb).items()})
                T20._same(lambda: ref_shapes.decode_input_specs(rcfg, want, gb)[0]["tokens"].shape,
                          lambda: shapes.decode_input_specs(cfg, got, gb)["tokens"][0])


def test_mrope_tables_over_a_device_major_grid():
    """``rope_for`` of qwen2-vl's (t, h, w) grid laid out device-major at (1,
    8) (the batch split over the rep groups) is the rows' tables laid out
    alike: the tables broadcast over the world dims."""
    cfg = get_smoke_config("qwen2-vl-7b")
    env = _env("qwen2vl18")
    grid = torch.from_numpy(inputs("qwen2vl18")["positions"])
    dm = steps.device_major(env, grid, B)
    assert tuple(dm.shape[:3]) == (1, 8, 4)
    for got, want in zip(M.rope_for(cfg, dm, cfg.hd), M.rope_for(cfg, grid, cfg.hd)):
        torch.testing.assert_close(got, steps.device_major(env, want, B), rtol=0, atol=0)


def test_make_mesh_keeps_the_model_axis():
    """The reference's ``make_mesh`` shapes: (data, model) and (pod, data,
    model), the model axis kept and reported, and the serving env on each."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    for shape, axes in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        mesh = make_mesh(shape, device="cpu")
        assert (mesh.axis_names, mesh.shape) == (axes, shape)
        assert mesh_axis_sizes(mesh) == dict(zip(axes, shape))
        env = steps.make_env(cfg, mesh)
        assert (env.model_size, env.tp, env.fsdp_size, env.pod_axis) == (
            shape[-1], cfg.resolve_tp(shape[-1]), math.prod(shape[:-1]),
            "pod" if len(shape) == 3 else None)


@pytest.mark.parametrize("arch,mesh", [("qwen1.5-0.5b", "1,2,2"), ("recurrentgemma-2b", "2,1,2")])
def test_serve_cli_on_a_pod_mesh(capsys, arch, mesh):
    gen = serve.run(serve.parser().parse_args(
        ["--arch", arch, "--smoke", "--mesh", mesh, "--batch", "8", "--prompt-len", "16",
         "--gen", "4", "--device", "cpu"]))
    assert gen.shape == (8, 4) and ((gen >= 0) & (gen < 64)).all()
    dims = tuple(int(x) for x in mesh.split(","))
    assert f"mesh {dims} (tp 2, rep 1)" in capsys.readouterr().out
