"""Serving across a ("data", "model") mesh: the port vs the JAX package, on the CPU.

One subprocess on 8 fake CPU devices (``jax_side``) runs the reference:
  * the grouped collectives (``all_to_all``, ``all_gather``, ``pmax``,
    ``pmin``, ``psum_scatter`` with ``axis_index_groups``) under
    ``shard_map``, on integer-valued data, so the port's ``Mesh`` matches
    them bitwise;
  * ``make_prefill_step`` and ``make_serve_step`` (and at (2, 4) its
    ``compute_at_data`` route) of qwen1.5 at (2, 4) and (1, 8) (tp 4, rep 2,
    the batch split over rep), granite-moe at (1, 4) (kv 2 over tp 4: dup
    span 2; the prefill's MoE on ``moe_apply_a2a``) and mamba2 at (2, 2),
    from ``init_params(param_specs(cfg, env))`` with norms and biases
    perturbed (the kv biases one value per logical head, laid out in the
    slots as ``dup_map`` says): the greedy tokens of the prefill and 6
    self-fed decode steps, the prefill's last-position logits (every
    device's vocab shard), and the caches, device-major;
  * granite-moe's layer-0 MoE at (1, 4): ``_router``, ``moe_apply_a2a`` at
    the smoke config's capacity 4.0 and at 1.0 (with the rows each rank
    sends, read off its ``all_to_all``), ``moe_apply_replicated``; the a2a
    at capacity 1.0 in its other layouts (``A2A_LAYOUTS``: two expert slots
    a rank at (1, 2), rep 2 at (1, 8), two experts over tp 4); and at (2, 4)
    the compute-at-data ``_expert_ffn``.
The port loads the same parameters (``convert.params_from_jax(..., env=)``)
and serves the same device-major batches through its mesh steps. The
``ShardEnv`` grid, the leaf specs and the CLI run in process.

Tolerances. The JAX model runs in bf16 and XLA may keep a fusion's
intermediates in fp32 where PyTorch rounds each op, as at tp = 1
(``test_torch_serve``); over tp ranks both packages also sum bf16 partials
(``psum_tp``), in XLA's order in one and fp32-accumulated in the other, so
caches agree at ``CACHE_TOL`` and logits at ``LOGIT_TOL``, a few bf16 ulps.
The MoE sums its experts' gated rows in fp32 where the reference adds them
in bf16 (``MOE_TOL``, the reference's own a2a-vs-replicated tolerance,
``tests/test_train_e2e.py:63``); the compute-at-data column product sums
the fsdp d-slices' bf16 partials the same two ways (``CAD_TOL``). The MoE
modules replay the reference's route (router near-ties could pick another
expert), so the a2a's drops, and every row each rank sends, compare
bitwise. Greedy tokens are equal.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_serve as TS  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve, shapes, steps  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import specs  # noqa: E402
from repro_torch.models.convert import cache_to_jax, flatten, params_from_jax  # noqa: E402
from repro_torch.models.parallel import ShardEnv  # noqa: E402

B, S, GEN = 8, 24, 7  # global batch, prompt, tokens (prefill + 6 decode steps)
CASES = {  # tag: (arch, mesh)
    "qwen24": ("qwen1.5-0.5b", (2, 4)),
    "qwen18": ("qwen1.5-0.5b", (1, 8)),
    "granite14": ("granite-moe-1b-a400m", (1, 4)),
    "mamba22": ("mamba2-1.3b", (2, 2)),
}
CAD_CASES = ("qwen24",)  # meshes with an fsdp world, where compute-at-data differs
# test_torch_serve's tp = 1 tolerances: caches two bf16 ulps (2**-7 each, relative),
# logits (up to ~0.6 here) two ulps absolute at ~0.3
CACHE_TOL = TS.CACHE_TOL
LOGIT_TOL = TS.LOGIT_TOL
MOE_TOL = 2e-2
CAD_TOL = 2e-2
MOE_X = (2, 24)  # the MoE module's input rows and positions
A2A_LAYOUTS = {  # moe_apply_a2a's other layouts, at capacity 1.0: (mesh, variant)
    "e2": ((1, 2), "base"),  # tp 2: two expert slots a rank
    "rep2": ((1, 8), "base"),  # tp 4, rep 2: the batch split over the rep groups
    "parity": ((1, 4), "parity"),  # 2 experts over tp 4: replicas by token parity
}

# grouped collectives: integer data, so every sum is exact
X24 = np.random.RandomState(1).randint(-50, 50, (2, 4, 4, 6)).astype(np.float32)
X8 = np.random.RandomState(2).randint(-50, 50, (8, 4, 8)).astype(np.float32)
G24 = [[0, 2], [1, 3]]  # the tp groups of tp 2, rep 2
G8 = [[0, 2, 4, 6], [1, 3, 5, 7]]


def rows(tag: str) -> np.ndarray:
    """The distinct prompt rows of a case, (R, S) int32 from a seed."""
    arch, dims = CASES[tag]
    env = _env(arch, dims)
    r, b_loc = env.row_groups(B)
    return np.random.RandomState(5).randint(0, get_smoke_config(arch).vocab,
                                            (env.fsdp_size * r * b_loc, S)).astype(np.int32)


def _env(arch: str, dims) -> ShardEnv:
    return steps.make_env(get_smoke_config(arch), Mesh(("data", "model"), dims, device="cpu"))


def device_batch(tag: str) -> np.ndarray:
    arch, dims = CASES[tag]
    return steps.device_major(_env(arch, dims), torch.from_numpy(rows(tag)), B).numpy()


def perturb(flat: dict, cfg, env) -> dict:
    """``test_torch_serve.perturb``, with the kv biases drawn once a logical
    head and laid out in their slots (``dup_map``), so that duplicate
    copies stay equal."""
    out = TS.perturb(flat)
    rs = np.random.RandomState(8)
    dm = list(env.dup_map(cfg.n_kv_heads)) if cfg.n_kv_heads else []
    for k, a in sorted(out.items()):
        if k.rsplit("/", 1)[-1] in ("bk", "bv"):
            logical = rs.randn(a.shape[0], cfg.n_kv_heads, a.shape[-1]).astype(np.float32)
            out[k] = logical[:, dm] * 0.5
    return out


# ---------------------------------------------------------------------------
# the reference (runs in the JAX subprocess)
# ---------------------------------------------------------------------------
def jax_collectives() -> dict:
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    m24 = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    m8 = jax.make_mesh((8,), ("all",), axis_types=(jax.sharding.AxisType.Auto,))

    def on24(f):
        return jax.shard_map(lambda v: f(v[0, 0])[None, None], mesh=m24,
                             in_specs=P("data", "model"), out_specs=P("data", "model"),
                             check_vma=False)(X24)

    def on8(f):
        return jax.shard_map(lambda v: f(v[0])[None], mesh=m8, in_specs=P("all"),
                             out_specs=P("all"), check_vma=False)(X8)

    a2a, ag = lax.all_to_all, lax.all_gather
    cases = {
        "a2a_g": on24(lambda v: a2a(v.reshape(2, 2, 6), "model", 0, 0, axis_index_groups=G24)),
        "a2a_g_split1": on24(lambda v: a2a(v.reshape(2, 2, 6), "model", 1, 0,
                                           axis_index_groups=G24)),
        "a2a_g_tiled": on24(lambda v: a2a(v, "model", 1, 0, tiled=True, axis_index_groups=G24)),
        "a2a_g8_tiled": on8(lambda v: a2a(v, "all", 1, 0, tiled=True, axis_index_groups=G8)),
        "a2a_g8": on8(lambda v: a2a(v, "all", 0, 1, axis_index_groups=G8)),
        "gather_g": on24(lambda v: ag(v, "model", axis_index_groups=G24)),
        "gather_g_tiled": on24(lambda v: ag(v, "model", tiled=True, axis_index_groups=G24)),
        "gather_g8": on8(lambda v: ag(v, "all", axis_index_groups=G8)),
        "gather_tiled": on24(lambda v: ag(v, "model", tiled=True)),
        "pmax": on24(lambda v: lax.pmax(v, "model")),
        "pmax_g": on24(lambda v: lax.pmax(v, "model", axis_index_groups=G24)),
        "pmin_g8": on8(lambda v: lax.pmin(v, "all", axis_index_groups=G8)),
        "pmin_both": on24(lambda v: lax.pmin(v, ("data", "model"))),
        "psum_g": on24(lambda v: lax.psum(v, "model", axis_index_groups=G24)),
        "pss_tiled": on24(lambda v: lax.psum_scatter(v, "model", scatter_dimension=0,
                                                     tiled=True)),
        "pss_g_tiled": on24(lambda v: lax.psum_scatter(v, "model", scatter_dimension=1,
                                                       tiled=True, axis_index_groups=G24)),
        "pss_g8": on8(lambda v: lax.psum_scatter(v, "all", scatter_dimension=0,
                                                 axis_index_groups=G8)),
    }
    return {k: np.asarray(v) for k, v in cases.items()}


def port_collective(name: str) -> torch.Tensor:
    """``jax_collectives``' case ``name`` on the port's ``Mesh``."""
    m24 = Mesh(("data", "model"), (2, 4), device="cpu")
    m8 = Mesh(("all",), (8,), device="cpu")
    x24, x8 = m24.shard(X24), m8.shard(X8)
    x24r = x24.reshape(2, 4, 2, 2, 6)
    cases = {
        "a2a_g": lambda: m24.all_to_all(x24r, "model", 0, 0, axis_index_groups=G24),
        "a2a_g_split1": lambda: m24.all_to_all(x24r, "model", 1, 0, axis_index_groups=G24),
        "a2a_g_tiled": lambda: m24.all_to_all(x24, "model", 1, 0, tiled=True,
                                              axis_index_groups=G24),
        "a2a_g8_tiled": lambda: m8.all_to_all(x8, "all", 1, 0, tiled=True, axis_index_groups=G8),
        "a2a_g8": lambda: m8.all_to_all(x8, "all", 0, 1, axis_index_groups=G8),
        "gather_g": lambda: m24.all_gather(x24, "model", axis_index_groups=G24),
        "gather_g_tiled": lambda: m24.all_gather(x24, "model", tiled=True,
                                                 axis_index_groups=G24),
        "gather_g8": lambda: m8.all_gather(x8, "all", axis_index_groups=G8),
        "gather_tiled": lambda: m24.all_gather(x24, "model", tiled=True),
        "pmax": lambda: m24.pmax(x24, "model"),
        "pmax_g": lambda: m24.pmax(x24, "model", axis_index_groups=G24),
        "pmin_g8": lambda: m8.pmin(x8, "all", axis_index_groups=G8),
        "pmin_both": lambda: m24.pmin(x24, ("data", "model")),
        "psum_g": lambda: m24.psum(x24, "model", axis_index_groups=G24),
        "pss_tiled": lambda: m24.psum_scatter(x24, "model", 0, tiled=True),
        "pss_g_tiled": lambda: m24.psum_scatter(x24, "model", 1, tiled=True,
                                                axis_index_groups=G24),
        "pss_g8": lambda: m8.psum_scatter(x8, "all", 0, axis_index_groups=G8),
    }
    return cases[name]()


COLLECTIVES = ["a2a_g", "a2a_g_split1", "a2a_g_tiled", "a2a_g8_tiled", "a2a_g8", "gather_g",
               "gather_g_tiled", "gather_g8", "gather_tiled", "pmax", "pmax_g",
               "pmin_g8", "pmin_both", "psum_g", "pss_tiled", "pss_g_tiled", "pss_g8"]


def jax_serve_mesh(tag: str) -> dict:
    """The reference's serving steps for case ``tag`` (see the module doc)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config as ref_cfg
    from repro.launch import serve as jserve
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
    from repro.models import model as JM
    from repro.models import moe
    from repro.models.common import init_params
    from repro.models.parallel import embed_lookup, pad_vocab, sharded_logits

    arch, dims = CASES[tag]
    cfg = ref_cfg(arch)
    mesh = make_mesh(dims, ("data", "model"))
    pstep, env, pb = jsteps.make_prefill_step(cfg, mesh, global_batch=B, seq=S)
    params = init_params(pb["param_leafspecs"], 0, jnp.float32, env)
    paths, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = ["/".join(p.key for p in path) for path, _ in paths]
    flat = perturb({k: np.asarray(leaf) for k, (_, leaf) in zip(keys, paths)}, cfg, env)
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])
    out = {f"{tag}/param/{k}": v for k, v in flat.items()}
    batch = {"tokens": jnp.asarray(device_batch(tag))}
    vp = pad_vocab(cfg.vocab, env.model_size)

    routes = []  # each MoE layer's (gates, experts), in layer order
    router = moe._router

    def recording_router(*args):
        g, e, aux = router(*args)
        routes.append((g.astype(jnp.float32), e))
        return g, e, aux

    def prefill_logits(p, bt):
        x = embed_lookup(jsteps._strip(bt, 2)["tokens"], p["embed"], env, vp)
        b, s = x.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        ctx = {"rope": JM.rope_for(cfg, pos, JM._rope_dim(cfg)), "impl": "masked",
               "want_cache": True, "cache": None, "cache_len": None, "unroll": True}
        routes.clear()
        # unrolled, without remat: the same layers, with each router's output in reach
        x, _, _ = JM.backbone(p, x, dataclasses.replace(cfg, remat=False), env, ctx)
        x = JM._ln(p["final_norm"], x, cfg, env)
        head = p["embed"] if cfg.tie_embeddings else p["head"]  # JM.prefill's table
        lg = sharded_logits(x[:, -1], head, env).astype(jnp.float32)
        rt = [jnp.stack([r[i] for r in routes]) for i in (0, 1)] if routes else []
        return jsteps._expand((lg, *rt), 2)

    moe._router = recording_router
    plog = jax.jit(jax.shard_map(prefill_logits, mesh=mesh,
                                 in_specs=(pb["param_partition"], pb["batch_partition"]),
                                 out_specs=P("data", "model"), check_vma=False))
    lg, *rt = plog(params, batch)
    moe._router = router
    out[f"{tag}/logits_shards"] = np.asarray(lg)
    if rt:  # (D, M, layers, tokens a rank, k)
        out[f"{tag}/route_gates"], out[f"{tag}/route_experts"] = map(np.asarray, rt)
    cache, toks = pstep(params, batch)
    out[f"{tag}/tok0"] = np.asarray(toks)
    out.update({f"{tag}/prefill/{k}": v for k, v in TS.flat_tree(cache).items()})
    for route in ("gather", "cad") if tag in CAD_CASES else ("gather",):
        sstep, _, sb = jsteps.make_serve_step(cfg, mesh, global_batch=B, seq_max=S + GEN,
                                              compute_at_data=route == "cad")
        c = jserve.pad_cache(cache, jax.tree_util.tree_map(
            lambda t: jnp.zeros(t.shape, t.dtype), sb["cache_sds"]))
        c = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), c)  # the step donates it
        t = toks
        for i in range(1, GEN):
            t, c = sstep(params, c, t, jnp.asarray(S + i - 1, jnp.int32))
            out[f"{tag}/{route}/tok{i}"] = np.asarray(t)
        out.update({f"{tag}/{route}/final/{k}": v for k, v in TS.flat_tree(c).items()})
    return out


def moe_params(out: dict, variant: str = "base") -> dict:
    """granite14's layer-0 MoE parameters, logical (4 experts in 4 slots);
    the parity variant keeps the router's first two columns and experts."""
    pre = "granite14/param/blocks/0_attn_moe/moe/"
    p = {k[len(pre):]: v[0] for k, v in out.items() if k.startswith(pre)}
    if variant == "parity":
        p = {k: v[:, :2] if k == "router" else v[:2] for k, v in p.items()}
    return p


def moe_cfg(variant: str = "base", cf: float | None = None, get=get_smoke_config):
    """The smoke granite-moe (``get``: the port's or the reference's
    config); the parity variant has 2 experts, top-1, so that at tp 4 each
    expert has two replicas that split tokens by parity."""
    cfg = get("granite-moe-1b-a400m")
    m = cfg.moe
    if variant == "parity":
        m = dataclasses.replace(m, n_experts=2, top_k=1)
    if cf is not None:
        m = dataclasses.replace(m, capacity_factor=cf)
    return dataclasses.replace(cfg, moe=m)


def moe_a2a_rows(dims) -> np.ndarray:
    """(model_size, b_loc, s, d) bf16-valued: the rows of ``moe_x`` each model
    index holds, as the port lays them out (rep group r holds its own rows
    when the batch splits over rep, else every index holds all of them)."""
    x = moe_x()
    env = _env("granite-moe-1b-a400m", dims)
    rep, b_loc = env.row_groups(x.shape[0])
    groups = x.reshape((rep, b_loc) + x.shape[1:])
    return np.stack([groups[m % rep] for m in range(dims[1])]).astype(np.float32)


def moe_x() -> np.ndarray:
    cfg = get_smoke_config("granite-moe-1b-a400m")
    return np.random.RandomState(13).randn(*MOE_X, cfg.d_model).astype(np.float32)


def cad_x() -> np.ndarray:
    """(data ranks · 6 rows, d) for the compute-at-data expert at (2, 4)."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    return np.random.RandomState(17).randn(12, cfg.d_model).astype(np.float32)


def jax_moe(out: dict) -> dict:
    """granite-moe's layer-0 MoE on its own (see the module doc)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config as ref_cfg
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
    from repro.models import moe
    from repro.models.common import tree_partition_specs

    res = {}
    p = {k: jnp.asarray(v) for k, v in moe_params(out).items()}
    x = jnp.asarray(moe_x()).astype(jnp.bfloat16)

    class Recording:  # lax, with the rows each rank sends (the int32 all_to_all) kept
        sent: list = []

        def __getattr__(self, name):
            return getattr(lax, name)

        def all_to_all(self, v, *a, **kw):
            if v.dtype == jnp.int32:
                self.sent.append(v)
            return lax.all_to_all(v, *a, **kw)

    rec = Recording()
    moe.lax = rec

    def a2a_on(dims, cfg, p):  # moe_apply_a2a on each device's rows, as moe_a2a_rows lays them
        mesh = make_mesh(dims, ("data", "model"))
        env = jsteps.make_env(cfg, mesh)
        part = tree_partition_specs(moe.moe_specs(cfg, env), env.fsdp_axes)

        def a2a(p, x):
            y, _ = moe.moe_apply_a2a(p, x[0], cfg, env)
            return y[None], rec.sent[-1][None, None]

        y, meta = jax.jit(jax.shard_map(a2a, mesh=mesh, in_specs=(part, P("model")),
                                        out_specs=(P("model"), P("data", "model")),
                                        check_vma=False))(p, jnp.asarray(moe_a2a_rows(dims)).astype(jnp.bfloat16))
        return np.asarray(y, np.float32), np.asarray(meta)

    for cf in (4.0, 1.0):
        cfg = moe_cfg(cf=cf, get=ref_cfg)
        y, res[f"moe/meta{cf}"] = a2a_on((1, 4), cfg, p)
        res[f"moe/a2a{cf}"] = y[0]
        if cf == 4.0:
            mesh = make_mesh((1, 4), ("data", "model"))
            env = jsteps.make_env(cfg, mesh)
            part = tree_partition_specs(moe.moe_specs(cfg, env), env.fsdp_axes)

            def route(p, x, cfg=cfg, env=env):
                g, e, _ = moe._router(p, x.reshape(-1, x.shape[-1]), cfg, env)
                return g, e

            run = jax.jit(jax.shard_map(route, mesh=mesh, in_specs=(part, P()),
                                        out_specs=(P(), P()), check_vma=False))
            g, e = run(p, x)
            res["moe/gates"], res["moe/experts"] = np.asarray(g, np.float32), np.asarray(e)
            rep = jax.jit(jax.shard_map(
                lambda p, x: moe.moe_apply_replicated(p, x, cfg, env)[0], mesh=mesh,
                in_specs=(part, P()), out_specs=P(), check_vma=False))
            res["moe/replicated"] = np.asarray(rep(p, x), np.float32)
    for name, (dims, variant) in A2A_LAYOUTS.items():
        cfg = moe_cfg(variant, cf=1.0, get=ref_cfg)
        env = jsteps.make_env(cfg, make_mesh(dims, ("data", "model")))
        dm = np.asarray(env.dup_map(cfg.moe.n_experts))  # slot j holds logical expert dm[j]
        pv = {k: jnp.asarray(v if k == "router" else v[dm])
              for k, v in moe_params(out, variant).items()}
        if variant == "parity":
            def route(p, x, cfg=cfg, env=env):
                g, e, _ = moe._router(p, x.reshape(-1, x.shape[-1]), cfg, env)
                return g, e

            part = tree_partition_specs(moe.moe_specs(cfg, env), env.fsdp_axes)
            g, e = jax.jit(jax.shard_map(route, mesh=make_mesh(dims, ("data", "model")),
                                         in_specs=(part, P()), out_specs=(P(), P()),
                                         check_vma=False))(pv, x)
            res[f"moe/{name}/gates"] = np.asarray(g, np.float32)
            res[f"moe/{name}/experts"] = np.asarray(e)
        res[f"moe/{name}/a2a"], res[f"moe/{name}/meta"] = a2a_on(dims, cfg, pv)
    moe.lax = lax
    cfg = ref_cfg("granite-moe-1b-a400m")
    mesh = make_mesh((2, 4), ("data", "model"))
    env = dataclasses.replace(jsteps.make_env(cfg, mesh), compute_at_data=True)
    part = tree_partition_specs(moe.moe_specs(cfg, env), env.fsdp_axes)
    ffn = jax.jit(jax.shard_map(
        lambda p, x: moe._expert_ffn(p, x, 0, cfg, env)[None, None], mesh=mesh,
        in_specs=(part, P("data")), out_specs=P("data", "model"), check_vma=False))
    res["moe/cad_ffn"] = np.asarray(ffn(p, jnp.asarray(cad_x()).astype(jnp.bfloat16)), np.float32)
    return res


def jax_side() -> dict:
    out = {f"coll/{k}": v for k, v in jax_collectives().items()}
    for tag in CASES:
        out.update(jax_serve_mesh(tag))
    out.update(jax_moe(out))
    return out


JAX_SCRIPT = r"""
import sys, numpy as np
sys.path.insert(0, {tests!r})
import test_torch_tp_serve as T
np.savez({path!r}, **T.jax_side())
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_tp_serve") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path))
    with np.load(path) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# ShardEnv, layouts and specs against the reference, in process
# ---------------------------------------------------------------------------
GRID = [(m, tp) for m in (1, 2, 4, 8, 16) for tp in (1, 2, 4, 8, 16) if tp <= m and m % tp == 0]


def _same(f, g):
    """f() and g() return equal values, or both raise ValueError."""
    try:
        want = f()
    except ValueError:
        with pytest.raises(ValueError):
            g()
        return
    assert g() == want


@pytest.mark.parametrize("model_size,tp", GRID)
def test_shard_env_matches_reference(model_size, tp):
    """Groups, dup maps, the batch split, ``batch_layout`` and the serving
    steps' input specs over n_logical ∈ {1, 2, 4, 8, 32}, data ∈ {1, 2} and
    global batches 1..64."""
    from repro.configs import get_smoke_config as ref_cfg
    from repro.launch import shapes as ref_shapes
    from repro.models import parallel as ref

    cfg, rcfg = get_smoke_config("qwen1.5-0.5b"), ref_cfg("qwen1.5-0.5b")

    for data in (1, 2):
        want, got = ref.ShardEnv(model_size, data, tp=tp), ShardEnv(model_size, data, tp=tp)
        assert (got.rep, got.fsdp_size, got.dp_world) == (want.rep, want.fsdp_size, want.dp_world)
        assert got.tp_groups == want.tp_groups and got.rep_groups == want.rep_groups
        for n in (1, 2, 4, 8, 32):
            _same(lambda: want.dup_sync_groups(n), lambda: got.dup_sync_groups(n))
            assert got.dup_map(n) == want.dup_map(n)
        for gb in (1, 2, 3, 4, 8, 16, 32, 64):
            assert got.batch_split_rep(gb) == want.batch_split_rep(gb)
            _same(lambda: want.local_batch(gb), lambda: got.local_batch(gb))
            _same(lambda: (lambda d, _, b: (tuple(d), b))(*ref_shapes.batch_layout(want, gb)),
                  lambda: shapes.batch_layout(got, gb))
            _same(lambda: {k: v.shape for k, v in
                           ref_shapes.prefill_input_specs(rcfg, want, 16, gb)[0].items()},
                  lambda: {k: v[0] for k, v in
                           shapes.prefill_input_specs(cfg, got, 16, gb).items()})
            _same(lambda: ref_shapes.decode_input_specs(rcfg, want, gb)[0]["tokens"].shape,
                  lambda: shapes.decode_input_specs(cfg, got, gb)["tokens"][0])
        mesh = Mesh(("data", "model"), (data, model_size), device="cpu")
        idx = np.arange(model_size)
        np.testing.assert_array_equal(got.tp_rank(mesh).numpy(), np.tile(idx // got.rep, (data, 1)))
        np.testing.assert_array_equal(got.rep_rank(mesh).numpy(), np.tile(idx % got.rep, (data, 1)))


def test_leaf_specs_and_tp_match_reference():
    """``specs.TP_DIM``/``dup_of`` against ``param_specs``' LeafSpecs, and
    ``resolve_tp``, for all ten full configs at model axes 1..16."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import model as ref_model
    from repro.models import parallel as ref
    from repro.models.common import LeafSpec

    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch.replace("_", "-"))
        for m in (1, 2, 4, 8, 16):
            assert cfg.resolve_tp(m) == rcfg.resolve_tp(m), (arch, m)
        env = ref.ShardEnv(16, 1, tp=rcfg.resolve_tp(16))
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            ref_model.param_specs(rcfg, env), is_leaf=lambda v: isinstance(v, LeafSpec))
        for path, ls in leaves:
            p = "/".join(k.key for k in path)
            key = specs.layer_leaf(p)
            stacked = p.split("/")[0] in ("blocks", "enc_blocks")
            tp_dim = specs.TP_DIM[key]
            assert (None if tp_dim is None else tp_dim + stacked) == ls.tp_dim, p
            assert specs.dup_of(key, cfg) == ls.dup_of, p


# ---------------------------------------------------------------------------
# grouped collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", COLLECTIVES)
def test_grouped_collective_matches_lax(jax_out, name):
    got, want = port_collective(name).numpy(), jax_out[f"coll/{name}"]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# serving: the whole model over a mesh
# ---------------------------------------------------------------------------
def load(jax_out, tag):
    arch, dims = CASES[tag]
    cfg = get_smoke_config(arch)
    mesh = Mesh(("data", "model"), dims, device="cpu")
    env = steps.make_env(cfg, mesh)
    prefix = f"{tag}/param/"
    tree = {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}
    return params_from_jax(tree, cfg, env=env, device="cpu"), mesh, env


def replay_prefill_routes(model, jax_out, tag, env) -> None:
    """Make each MoE layer's prefill take the reference's route (router
    near-ties could pick another expert): the recorded (gates, experts) of
    every rank, laid back in the rows' order. Decode routes its own."""
    if f"{tag}/route_experts" not in jax_out:
        return
    rep, b_loc = env.row_groups(B)
    assert rep == 1 and env.rep == 1  # the a2a's rank layout is the mesh's own here
    tp = env.tp

    def rows_order(a):  # (D, M, n, k) per rank → (R·S, k)
        d, _, _, k = a.shape
        a = a.reshape(d, tp, b_loc, S // tp, k).transpose(0, 2, 1, 3, 4)
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1, k))

    gates, experts = jax_out[f"{tag}/route_gates"], jax_out[f"{tag}/route_experts"]
    for i, block in enumerate(model.blocks):
        own = block.moe.route
        g = rows_order(gates[:, :, i]).to(torch.bfloat16)
        e = rows_order(experts[:, :, i]).long()

        def route(x, router=None, own=own, g=g, e=e):
            return (g, e) if x.shape[0] == e.shape[0] else own(x, router=router)

        block.moe.route = route


def full_logits(shards: np.ndarray, env: ShardEnv) -> np.ndarray:
    """The device-major (D, M, b_loc, V_pad/tp) logits shards → (rows, V_pad):
    each row group's vocab shards in tp order."""
    rep, b_loc = env.row_groups(B)
    d, m = shards.shape[:2]
    out = []
    for di in range(d):
        for r in range(rep):
            out.append(np.concatenate([shards[di, t * env.rep + r] for t in range(env.tp)], -1))
    return np.concatenate(out, 0)


def close_tree(got: dict, jax_out, prefix: str, tol: float) -> None:
    want = {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}
    flat = flatten(got)
    assert set(flat) == set(want), (sorted(flat), sorted(want))
    for k, v in want.items():
        assert flat[k].shape == v.shape, (k, flat[k].shape, v.shape)
        np.testing.assert_allclose(flat[k], v, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_prefill_over_mesh_matches_reference(jax_out, tag):
    """The prefill's cache (device-major, every leaf), last-position logits
    over the vocab and greedy tokens, as the reference's on the same mesh."""
    model, mesh, env = load(jax_out, tag)
    replay_prefill_routes(model, jax_out, tag, env)
    cfg = model.cfg
    toks = torch.from_numpy(device_batch(tag))
    with torch.inference_mode():
        cache, h = model.prefill_hidden(steps.rows_of(env, toks, B))
        lg = model.logits(h).numpy()[:, :cfg.vocab]
    close_tree(cache_to_jax(cache, env=env), jax_out, f"{tag}/prefill/", CACHE_TOL)
    want = full_logits(jax_out[f"{tag}/logits_shards"], env)[:, :cfg.vocab]
    np.testing.assert_allclose(lg, want, rtol=0, atol=LOGIT_TOL)
    _, nxt = steps.make_prefill_step(model, global_batch=B, seq=S, mesh=mesh)(toks)
    np.testing.assert_array_equal(nxt.numpy(), jax_out[f"{tag}/tok0"])


@pytest.mark.parametrize("route,tag", [("gather", t) for t in sorted(CASES)]
                         + [("cad", t) for t in CAD_CASES])
def test_decode_over_mesh_matches_reference(jax_out, route, tag):
    """Prefill into a cache of S + GEN positions, then 6 self-fed greedy
    decode steps through the mesh serve step (``cad``: its compute-at-data
    route): every token, and the final cache, as the reference's."""
    model, mesh, env = load(jax_out, tag)
    replay_prefill_routes(model, jax_out, tag, env)
    r, b_loc = env.row_groups(B)
    cache = model.init_cache(env.fsdp_size * r * b_loc, S + GEN)
    cache, tok = steps.make_prefill_step(model, global_batch=B, seq=S, mesh=mesh)(
        torch.from_numpy(device_batch(tag)), cache)
    sstep = steps.make_serve_step(model, global_batch=B, seq_max=S + GEN, mesh=mesh,
                                  compute_at_data=route == "cad")
    for i in range(1, GEN):
        tok, cache = sstep(cache, tok, S + i - 1)
        np.testing.assert_array_equal(tok.numpy(), jax_out[f"{tag}/{route}/tok{i}"],
                                      err_msg=f"decode step {i}")
    close_tree(cache_to_jax(cache, env=env), jax_out, f"{tag}/{route}/final/", CACHE_TOL)


# ---------------------------------------------------------------------------
# the MoE routes at (1, 4) and the compute-at-data expert at (2, 4)
# ---------------------------------------------------------------------------
def _moe(jax_out, dims, cf=None, variant="base"):
    cfg = moe_cfg(variant, cf)
    env = steps.make_env(cfg, Mesh(("data", "model"), dims, device="cpu"))
    block = M.Block("attn_moe", cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for k, v in moe_params(jax_out, variant).items():
            getattr(block.moe, k).copy_(torch.from_numpy(v))
    block.moe.cast_weights()
    return block.moe, env


def _route(jax_out, pre="moe/"):
    g = torch.from_numpy(jax_out[f"{pre}gates"]).to(torch.bfloat16)
    return g, torch.from_numpy(jax_out[f"{pre}experts"]).long().reshape(g.shape)


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_moe_a2a_matches_reference(jax_out, cf):
    """``moe_apply_a2a`` at (1, 4) on the reference's route: every row each
    rank sends (its expert slot and token) bitwise, so the same assignments
    fall over capacity; the output within ``MOE_TOL``. At capacity 1.0
    some assignments drop."""
    moe, env = _moe(jax_out, (1, 4), cf)
    x = torch.from_numpy(moe_x()).to(torch.bfloat16)
    with torch.inference_mode():
        y, info = moe.a2a(x, env, route=_route(jax_out))
    want_meta = jax_out[f"moe/meta{cf}"]
    np.testing.assert_array_equal(info["send_meta"].reshape(want_meta.shape).numpy(), want_meta)
    dropped = 1 - info["keep"].float().mean().item()
    assert (dropped > 0) == (cf == 1.0), dropped
    np.testing.assert_allclose(y.float().numpy(), jax_out[f"moe/a2a{cf}"], rtol=MOE_TOL,
                               atol=MOE_TOL)


def test_moe_routes_match_reference_replicated(jax_out):
    """``moe_apply_replicated`` at (1, 4) on the reference's route, and the
    port's a2a without drops against it, as ``tests/test_train_e2e.py``
    holds the reference's two routes."""
    moe, env = _moe(jax_out, (1, 4))
    x = torch.from_numpy(moe_x()).to(torch.bfloat16)
    g, e = _route(jax_out)
    with torch.inference_mode():
        rep = moe.replicated(x.reshape(-1, x.shape[-1]), g, e, env).reshape(x.shape)
        y, info = moe.a2a(x, env, route=(g, e))
    assert bool(info["keep"].all())
    want = jax_out["moe/replicated"]
    np.testing.assert_allclose(rep.float().numpy(), want, rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(y.float().numpy(), want, rtol=MOE_TOL, atol=MOE_TOL)


@pytest.mark.parametrize("name", sorted(A2A_LAYOUTS))
def test_moe_a2a_layouts_match_reference(jax_out, name):
    """``moe_apply_a2a``'s other layouts at capacity 1.0, where assignments
    drop, on the reference's route: two expert slots a rank (e2), the rows
    split over rep groups (rep2), replicas that split tokens by parity
    (parity). Every row each rank sends bitwise; each rep group's output
    within ``MOE_TOL``."""
    dims, variant = A2A_LAYOUTS[name]
    moe, env = _moe(jax_out, dims, 1.0, variant)
    x = torch.from_numpy(moe_x()).to(torch.bfloat16)
    route = _route(jax_out, f"moe/{name}/" if variant == "parity" else "moe/")
    with torch.inference_mode():
        y, info = moe.a2a(x, env, route=route)
    want_meta = jax_out[f"moe/{name}/meta"]
    np.testing.assert_array_equal(info["send_meta"].reshape(want_meta.shape).numpy(), want_meta)
    assert not bool(info["keep"].all())
    rep, b_loc = env.row_groups(x.shape[0])
    want = jax_out[f"moe/{name}/a2a"]  # (model_size, b_loc, s, d); index r: rep group r's rows
    np.testing.assert_allclose(y.float().numpy().reshape((rep,) + want.shape[1:]), want[:rep],
                               rtol=MOE_TOL, atol=MOE_TOL)


def test_expert_ffn_compute_at_data_matches_reference(jax_out):
    """The compute-at-data ``_expert_ffn`` at (2, 4): rank (d, t) runs its
    expert t on data rank d's rows, the column products over the two
    d-slices."""
    moe, env = _moe(jax_out, (2, 4))
    env = dataclasses.replace(env, compute_at_data=True)
    x = torch.from_numpy(cad_x()).to(torch.bfloat16)
    want = jax_out["moe/cad_ffn"]  # (2, 4, 6, d)
    w = moe.weights()
    with torch.inference_mode():
        for t in range(4):
            got = moe.expert(x, w, t, env).float().numpy().reshape(2, 6, -1)
            np.testing.assert_allclose(got, want[:, t], rtol=CAD_TOL, atol=CAD_TOL)


# ---------------------------------------------------------------------------
# what waits, and the entry points
# ---------------------------------------------------------------------------
def test_training_under_tp_raises():
    """Training under TP no longer raises: ``train_loss`` under a tp group of
    4 and its gradient match tp = 1 on the same weights and rows, to the
    rounding of the row-parallel bf16 partials' sums."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    env = _env("qwen1.5-0.5b", (1, 4))
    model = M.Model(cfg, device="cpu", seed=3, env=env).requires_grad_(True)
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, cfg.vocab, (2, 16)))
    out = {}
    for tp_env in (env.tp_group(), None):
        loss, aux = model.train_loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, env=tp_env)
        out[tp_env is None] = (float(loss.detach()),
                               torch.autograd.grad(loss, list(model.parameters())))
    (loss4, g4), (loss1, g1) = out[False], out[True]
    assert env.tp == 4 and abs(loss4 - loss1) <= 1e-4 * loss1
    whole = [torch.cat([g.flatten() for g in gs]) for gs in (g4, g1)]
    assert float((whole[0] - whole[1]).norm() / whole[1].norm()) <= 1e-2


def test_params_from_jax_refuses_unequal_copies(jax_out):
    prefix = "granite14/param/"
    tree = {k[len(prefix):]: v.copy() for k, v in jax_out.items() if k.startswith(prefix)}
    env = _env("granite-moe-1b-a400m", (1, 4))
    tree["blocks/0_attn_moe/attn/wk"][0, 0, 1] += 1.0  # slot 1 is a copy of slot 0 (span 2)
    with pytest.raises(ValueError, match="duplicate copies"):
        params_from_jax(tree, get_smoke_config("granite-moe-1b-a400m"), env=env, device="cpu")


def test_rows_of_refuses_unequal_tp_rows():
    env = _env("qwen1.5-0.5b", (1, 8))
    toks = steps.device_major(env, torch.arange(B * S).reshape(B, S), B).clone()
    assert tuple(toks.shape[:3]) == (1, 8, 4)  # the batch splits over the two rep groups
    torch.testing.assert_close(steps.rows_of(env, toks, B), torch.arange(B * S).reshape(B, S))
    toks[0, 2, 0, 0] += 1  # tp rank 1 of rep group 0 holds another row
    with pytest.raises(ValueError, match="different rows"):
        steps.rows_of(env, toks, B)


def test_serve_cli_over_a_mesh(capsys, monkeypatch):
    gen = serve.run(serve.parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--mesh", "2,4", "--batch", "8",
         "--prompt-len", "16", "--gen", "4", "--device", "cpu"]))
    assert gen.shape == (8, 4)
    assert "mesh (2, 4) (tp 4, rep 1" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(serve.parser().parse_args(["--arch", "qwen1.5-0.5b", "--smoke",
                                             "--mesh", "2,4"]))
