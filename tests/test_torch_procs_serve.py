"""Serving on a process mesh: one ``torch.distributed`` process per mesh
device, each holding only its device's shard, against the JAX reference and
against the world-dim port, on the CPU.

Three ``multidevice`` subprocesses on 8 fake devices, side by side, run the
reference (``test_torch_tp_serve.jax_serve_mesh``: ``make_prefill_step`` and
``make_serve_step`` from ``init_params`` with norms and biases perturbed,
the device-major caches, last-position logits shards and greedy tokens of
the prefill and 6 decode steps) for every case below, each leaf's local
shape under its partition spec (``_local_shape``), and the a2a MoE of
granite-moe's layer 0 at (1, 8) at capacity 4.0 and 1.0 with the rows each
rank sends (its int32 ``all_to_all``) and each rank's route. They compile
at XLA's backend optimization level 0 (``JAX_XLA``): the same programs,
in about half the CPU time (their parameters come out a few fp32 ulps
from level 2's, and the port loads them as they come).

Eight gloo ranks on the CPU are spawned once for the file
(``launch.procs.spawn``), while the reference runs, and wait for its
outputs. Each loads its device's shard of the reference's
parameters (``convert.params_from_jax`` under its process mesh's env,
``convert.rank_shards``), serves its block of the device-major batch
through the mesh steps and hands back its tokens, caches (``cache_to_jax``
of its block), logits shard, ``count_collectives`` and parameter shapes;
the test process stacks the blocks device-major; then each runs the serve
CLI on their (2, 4) mesh. Cases, all on 8-device
meshes: qwen1.5 at (2, 4) (tp 4; also the compute-at-data decode) and at
(1, 8) (tp 4, rep 2: the rep-group gather, kv copies over rep, the batch
split over rep); granite-moe at (1, 8) (tp 4, rep 2, kv 2 over a span of
2, one expert a rank) with the a2a prefill at its config's capacity 4.0
and at 1.0 (where assignments drop), then the replicated decode, and its
layer-0 a2a at capacity 4.0 and 1.0, and at (2, 4) (its expert slots over an fsdp
world of 2; also the compute-at-data decode); mamba2 at (4, 2) (its
resolve_tp's 2). The other block kinds (``KINDS``, the reference from
``test_torch_tp_serve_kinds.jax_case`` in the same subprocesses): minicpm3
(MLA) at (1, 8) (tp 4, rep 2: the latent cache of each rank's rows, the
decode's fp32 ``wkv_b`` gather); recurrentgemma at (2, 4) (tp 4: the RG-LRU
state by tp rank, the rolling window over kv 1 duplicated over a span of 4;
also the compute-at-data decode); qwen2-vl at (1, 8) (tp 4, rep 2: patch
embeddings and their M-RoPE grid, the batch split over rep); seamless at
(2, 4) (tp 4: the encoder over ``ENC`` frames, the cross cache of each
rank's kv slots). phi3-medium-14b at (2, 2) (tp 2, GQA 2 kv heads; also the
compute-at-data decode), the first configuration of the repo that does not
fit one card, is held as the dense cases are; its four ranks are a world of
their own, spawned beside the eight.
The MoE prefill replays the reference's route on each rank (a router
near-tie could flip an expert), as ``test_torch_tp_serve`` does. Each rank
also makes every served arch from the seed under its process mesh's env:
its parameters are bitwise the world-dim model's shards, each leaf cut as it
is drawn.

Tolerances: against the reference, ``test_torch_tp_serve``'s (caches
``CACHE_TOL``, logits ``LOGIT_TOL``, the MoE layer ``MOE_TOL``; the kinds'
caches as ``test_torch_tp_serve_kinds.close_cache`` holds them, at the same
``CACHE_TOL``), tokens equal, the a2a's sent rows and kept assignments
bitwise. Against the
world-dim port on the same inputs, tokens equal, and the caches and logits
bitwise at tp 2 (mamba2: the same products, and psum_tp's fp32 sum of two
partials is exact in any order), except its SSM state after decoding, within
``DECODE_TOL`` (measured 1.2e-10 absolute: a process's decode products have
b/data_size rows where the world-dim ones have every row, and the bf16
matmul rounds one of them one ulp apart); at tp 4 within ``WORLD_TOL``,
where gloo adds the four fp32 partials in another order than the folded sum
(measured 0 on the CPU: every case bitwise).
"""
import contextlib
import dataclasses
import functools
import io
import os
import time
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_tp_serve as TT  # noqa: E402
import test_torch_tp_serve_kinds as TK  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import procs, serve, steps  # noqa: E402
from repro_torch.mesh import Mesh, ProcessMesh, count_collectives  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (cache_to_jax, flatten, params_from_jax,  # noqa: E402
                                        rank_shards, stack_leaves)

WORLD = 8
TIMEOUT_S = 240
JAX_WAIT_S = 200  # how long a rank waits for the reference's outputs
WORLDS = (WORLD, 4)  # the ranks' worlds: every case runs on the one of its mesh's size
# the CLI on the 8 ranks' (2, 4) mesh: qwen1.5, and seamless with an encoder of its own length
CLI = ["--arch", "qwen1.5-0.5b", "--smoke", "--mesh", "2,4", "--batch", "8", "--prompt-len", "16",
       "--gen", "3", "--device", "cpu"]
CLI_ENC = ["--arch", "seamless-m4t-large-v2", "--smoke", "--mesh", "2,4", "--batch", "8",
           "--prompt-len", "16", "--enc-len", "12", "--gen", "3", "--device", "cpu"]
B, S, GEN = TT.B, TT.S, TT.GEN
ENC = TK.ENC
CASES = {  # tag: (arch, mesh)
    "qwen24": ("qwen1.5-0.5b", (2, 4)),
    "qwen18": ("qwen1.5-0.5b", (1, 8)),
    "granite18": ("granite-moe-1b-a400m", (1, 8)),
    "granite18cf1": ("granite-moe-1b-a400m", (1, 8)),
    "granite24": ("granite-moe-1b-a400m", (2, 4)),
    "mamba42": ("mamba2-1.3b", (4, 2)),
    "minicpm18": ("minicpm3-4b", (1, 8)),
    "rg24": ("recurrentgemma-2b", (2, 4)),
    "qwen2vl18": ("qwen2-vl-7b", (1, 8)),
    "seamless24": ("seamless-m4t-large-v2", (2, 4)),
    "phi3_22": ("phi3-medium-14b", (2, 2)),  # on a world of 4 ranks of its own
}
# the other block kinds: references from test_torch_tp_serve_kinds.jax_case, dict inputs
KINDS = ("minicpm18", "rg24", "qwen2vl18", "seamless24")
CAD = ("qwen24", "granite24", "rg24", "phi3_22")  # the compute-at-data decode: an fsdp world
# every served arch, at one case's mesh: made from the seed on the ranks
SEEDED = {CASES[t][0]: t for t in ("qwen24", "granite24", "mamba42") + KINDS}
CF = {"granite18cf1": 1.0}  # a case's MoE capacity factor where not its config's
A2A_CF = (4.0, 1.0)
CACHE_TOL, LOGIT_TOL, MOE_TOL = TT.CACHE_TOL, TT.LOGIT_TOL, TT.MOE_TOL
# the process form against the world-dim form (rtol = atol; see the module
# doc). At tp 4 only gloo's order of the fp32 sums of four bf16-valued
# partials differs, and such a sum is exact unless their exponents spread
# over 16 bits: at most one bf16 ulp of the rounded sum (measured 0). At tp
# 2, the decoded SSM state, fp32, from products of another row count
WORLD_TOL = 2 ** -7
DECODE_TOL = 1e-6


def with_cf(cfg, cf: float):
    """``cfg`` with its MoE at capacity factor ``cf``."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def case_cfg(tag: str, get=get_smoke_config):
    cfg = get(CASES[tag][0])
    return with_cf(cfg, CF[tag]) if tag in CF else cfg


def routes(route):
    return ("gather", "cad") if route else ("gather",)


def world_env(tag: str):
    """The case's env on the world-dim mesh."""
    return steps.make_env(case_cfg(tag), Mesh(("data", "model"), CASES[tag][1], device="cpu"))


def rows(tag: str) -> np.ndarray:
    """The distinct prompt rows of a case, (R, S) int32: ``test_torch_tp_serve.rows``'s."""
    arch = CASES[tag][0]
    env = world_env(tag)
    r, b_loc = env.row_groups(B)
    return np.random.RandomState(5).randint(0, get_smoke_config(arch).vocab,
                                            (env.fsdp_size * r * b_loc, S)).astype(np.int32)


def batch_rows(tag: str):
    """A case's distinct prompt rows as the steps take them: ``rows`` as a
    tensor, or for ``KINDS`` the dict of ``test_torch_tp_serve_kinds.inputs``
    (tokens; patch embeddings and their grid; frames, their positions and a
    token prompt)."""
    if tag not in KINDS:
        return torch.from_numpy(rows(tag))
    with mock.patch.dict(TK.CASES, {tag: CASES[tag]}):
        return {k: torch.from_numpy(v) for k, v in TK.inputs(tag).items()}


def ref_tokens(jax_out: dict, tag: str, key: str) -> np.ndarray:
    """The reference's greedy tokens ``key`` of a case, device-major (the
    kinds' reference gives the rows held once)."""
    t = jax_out[f"{tag}/{key}"]
    if tag in KINDS:
        t = steps.device_major(world_env(tag), torch.from_numpy(t), B).numpy()
    return t


# ---------------------------------------------------------------------------
# the reference (runs in the JAX subprocess)
# ---------------------------------------------------------------------------
def jax_local_shapes(tag: str) -> dict:
    """Each leaf's local shape under its partition spec on the case's mesh."""
    import jax

    from repro.configs import get_smoke_config as ref_cfg
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
    from repro.models import model as JM
    from repro.models.common import LeafSpec

    dims = CASES[tag][1]
    cfg = case_cfg(tag, get=ref_cfg)
    env = jsteps.make_env(cfg, make_mesh(dims, ("data", "model")))
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JM.param_specs(cfg, env), is_leaf=lambda v: isinstance(v, LeafSpec))
    return {f"{tag}/local/" + "/".join(k.key for k in path):
            np.asarray(jsteps._local_shape(ls.shape, ls.partition_spec(env.fsdp_axes), env))
            for path, ls in leaves}


def jax_a2a(out: dict) -> dict:
    """granite18's layer-0 ``moe_apply_a2a`` at (1, 8) on ``moe_a2a_rows``:
    each device's output, the rows it sends (the int32 ``all_to_all``'s
    operand) and its route, at each of ``A2A_CF``."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config as ref_cfg
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
    from repro.models import moe
    from repro.models.common import tree_partition_specs

    pre = "granite18/param/blocks/0_attn_moe/moe/"
    p = {k[len(pre):]: jnp.asarray(v[0]) for k, v in out.items() if k.startswith(pre)}
    x = jnp.asarray(TT.moe_a2a_rows((1, 8))).astype(jnp.bfloat16)
    sent, routed, router = [], [], moe._router

    class Recording:  # lax, keeping the int32 all_to_all's operand: the rows each rank sends
        def __getattr__(self, name):
            return getattr(lax, name)

        def all_to_all(self, v, *a, **kw):
            if v.dtype == jnp.int32:
                sent.append(v)
            return lax.all_to_all(v, *a, **kw)

    def recording_router(*args):
        g, e, aux = router(*args)
        routed.append((g.astype(jnp.float32), e))
        return g, e, aux

    res = {}
    moe.lax, moe._router = Recording(), recording_router
    try:
        for cf in A2A_CF:
            cfg = with_cf(ref_cfg("granite-moe-1b-a400m"), cf)
            mesh = make_mesh((1, 8), ("data", "model"))
            env = jsteps.make_env(cfg, mesh)
            part = tree_partition_specs(moe.moe_specs(cfg, env), env.fsdp_axes)

            def a2a(p, x, cfg=cfg, env=env):
                y, _ = moe.moe_apply_a2a(p, x[0], cfg, env)
                g, e = routed[-1]
                return y[None], sent[-1][None, None], g[None, None], e[None, None]

            run = jax.jit(jax.shard_map(
                a2a, mesh=mesh, in_specs=(part, P("model")),
                out_specs=(P("model"), P("data", "model"), P("data", "model"),
                           P("data", "model")), check_vma=False))
            y, meta, g, e = run(p, x)
            res.update({f"a2a{cf}/y": np.asarray(y, np.float32), f"a2a{cf}/meta": np.asarray(meta),
                        f"a2a{cf}/gates": np.asarray(g), f"a2a{cf}/experts": np.asarray(e)})
    finally:
        moe.lax, moe._router = lax, router
    return res


def jax_kind(tag: str) -> dict:
    """``test_torch_tp_serve_kinds.jax_case`` of a ``KINDS`` case: its
    logits over the vocab and tokens of the rows held once."""
    from repro.models import model as JM
    from repro.models.parallel import sharded_logits

    TK.CASES[tag], TK.CAD_CASES = CASES[tag], CAD
    real = JM.argmax_logits
    JM.argmax_logits = lambda x, table, e, vocab: sharded_logits(x, table, e).astype("float32")
    try:
        return TK.jax_case(tag)
    finally:
        JM.argmax_logits = real


def jax_side(tags) -> dict:
    import repro.configs

    TT.CAD_CASES = CAD
    out = {}
    get = repro.configs.get_smoke_config
    for tag in tags:
        if tag in KINDS:
            out.update(jax_kind(tag))
            out.update(jax_local_shapes(tag))
            continue
        TT.CASES[tag] = CASES[tag]
        # jax_serve_mesh reads the config by this name when it runs
        repro.configs.get_smoke_config = functools.partial(
            lambda arch, tag: case_cfg(tag, get=get), tag=tag)
        try:
            out.update(TT.jax_serve_mesh(tag))
        finally:
            repro.configs.get_smoke_config = get
        out.update(jax_local_shapes(tag))
    if "granite18" in tags:
        out.update(jax_a2a(out))
    return out


# the reference's cases in parts that run side by side (their compiles take
# most of the time)
JAX_PARTS = (("qwen24", "qwen18", "minicpm18", "qwen2vl18"),
             ("mamba42", "granite24", "rg24", "phi3_22"),
             ("granite18", "granite18cf1", "seamless24"))
JAX_XLA = "--xla_backend_optimization_level=0"
JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] += " " + {xla!r}
import sys, numpy as np
sys.path.insert(0, {tests!r})
import test_torch_procs_serve as T
np.savez({path!r}, **T.jax_side({tags!r}))
print("OK")
"""


@pytest.fixture(scope="module")
def spawned(multidevice, tmp_path_factory):
    """(the reference's outputs, every rank's results). The ranks are spawned
    while the reference's parts run side by side, and wait for their npz
    (``_rank``), so that their start-up overlaps the reference's compiles."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tmp_path_factory.mktemp("jax_procs_serve")
    tests = os.path.dirname(os.path.abspath(__file__))
    path = tmp / "out.npz"

    def run(i):
        part = str(tmp / f"part{i}.npz")
        assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=part, tags=JAX_PARTS[i],
                                                     xla=JAX_XLA))
        with np.load(part) as f:
            return dict(f)

    with ThreadPoolExecutor(len(JAX_PARTS) + len(WORLDS)) as pool:
        worlds = [pool.submit(procs.spawn, functools.partial(_rank, str(path)), n,
                              backend="gloo", device="cpu", store_path=tmp / f"store{n}",
                              timeout_s=TIMEOUT_S) for n in WORLDS]
        out = {}
        try:
            for part in pool.map(run, range(len(JAX_PARTS))):
                out.update(part)
            np.savez(tmp / "out.partial.npz", **out)
            os.replace(tmp / "out.partial.npz", path)  # whole when the ranks see it
        except BaseException:
            (tmp / "out.failed").touch()  # the ranks stop waiting
            raise
        ranks = worlds[0].result()
        for other in worlds[1:]:  # a smaller world's ranks beside the first ranks
            for r, res in enumerate(other.result()):
                ranks[r].update(res)
        return out, ranks


@pytest.fixture(scope="module")
def jax_out(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[1]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def tree_of(jax_out: dict, tag: str) -> dict:
    pre = f"{tag}/param/"
    return {k[len(pre):]: v for k, v in jax_out.items() if k.startswith(pre)}


def replay(model, jax_out: dict, tag: str, block) -> None:
    """Each MoE layer's a2a prefill takes the reference's route of this
    device (``block``: its (data, model) index), recorded in layer order."""
    if f"{tag}/route_experts" not in jax_out:
        return
    g_all, e_all = jax_out[f"{tag}/route_gates"][block], jax_out[f"{tag}/route_experts"][block]
    for i, blk in enumerate(model.blocks):
        own = blk.moe.route
        g = torch.from_numpy(g_all[i]).to(torch.bfloat16)
        e = torch.from_numpy(e_all[i]).long()

        def route(x, router=None, own=own, g=g, e=e):
            return (g, e) if x.shape[0] == e.shape[0] else own(x, router=router)

        blk.moe.route = route


def serve_case(model, mesh, jax_out: dict, tag: str, held) -> dict:
    """One case on a mesh (world dims or this process's): the prefill's
    cache and last-position logits (a cache of S positions, as the
    reference's prefill step), then the prefill step and the decode steps
    into a cache of S + GEN on each route, counted. ``held``: the distinct
    rows held (all of them world-dim, the process's own on a process mesh),
    a tensor or a dict of the model's inputs."""
    env = steps.make_env(model.cfg, mesh)
    enc = ENC if model.cfg.enc_layers else None
    out = {}
    with torch.inference_mode():
        cache, h = model.prefill_hidden(held)
        out["prefill"] = cache_to_jax(cache, env=env) if env.mesh is None else cache_to_jax(
            cache, mesh.ndim)
        out["logits"] = model.logits(h).numpy()
    for route in routes(tag in CAD):
        with count_collectives() as counts:
            cache = model.init_cache(steps.batch_shape(held)[0], S + GEN, enc_len=enc)
            cache, tok = steps.make_prefill_step(model, global_batch=B, seq=S, mesh=mesh)(
                steps.map_batch(held, lambda v: steps.device_major(env, v, B)), cache)
            toks = [tok]
            sstep = steps.make_serve_step(model, global_batch=B, seq_max=S + GEN, mesh=mesh,
                                          compute_at_data=route == "cad")
            for i in range(1, GEN):
                tok, cache = sstep(cache, tok, S + i - 1)
                toks.append(tok)
        out[route] = {"toks": [t.numpy() for t in toks], "counts": dict(counts),
                      "final": cache_to_jax(cache, env=env) if env.mesh is None else
                      cache_to_jax(cache, mesh.ndim)}
    return out


def a2a_case(model, env, jax_out: dict, cf: float, block) -> dict:
    """Layer 0's a2a MoE of this rank at capacity ``cf`` on its rows of
    ``moe_a2a_rows`` and its recorded route."""
    moe = model.blocks[0].moe
    moe.cfg = with_cf(case_cfg("granite18"), cf)
    x = torch.from_numpy(TT.moe_a2a_rows((1, 8))[block[1]]).to(torch.bfloat16)
    g = torch.from_numpy(jax_out[f"a2a{cf}/gates"][block]).to(torch.bfloat16)
    e = torch.from_numpy(jax_out[f"a2a{cf}/experts"][block]).long()
    with torch.inference_mode():
        y, info = moe.a2a(x, env, route=(g, e))
    return {"y": y.float().numpy(), "meta": info["send_meta"].numpy(),
            "keep": info["keep"].numpy()}


def refusals(device) -> dict:
    """The messages of what a process mesh refuses (None where nothing raised)."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    pm18 = ProcessMesh(("data", "model"), (1, 8), device=device)
    pm24 = ProcessMesh(("data", "model"), (2, 4), device=device)
    env18 = steps.make_env(cfg, pm18)
    model = M.Model(cfg, device=device, seed=0, env=env18)
    mine = steps.rank_rows(env18, torch.from_numpy(rows("qwen18")), B)
    split = steps.device_major(env18, mine + pm18.rank // 2, B)  # tp ranks of a group differ
    cases = {
        "world_size": lambda: procs.init_process_mesh((2, 2), ("data", "model"), backend="gloo",
                                                      device=device),
        "rep_split": lambda: steps.make_prefill_step(model, global_batch=B, seq=S, mesh=pm18)(
            split),
        "other_mesh": lambda: steps.make_prefill_step(model, global_batch=B, seq=S, mesh=pm24),
        "world_model": lambda: steps.make_prefill_step(
            M.Model(cfg, device=device, seed=0, env=env18.world()), global_batch=B, seq=S,
            mesh=pm18),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def seeded(device) -> dict:
    """Every served arch made from the seed on this rank (its ``SEEDED``
    case's mesh): {arch: (its parameters as the JAX tree's stacked leaves,
    numpy; the order in which leaves were drawn whole and cut, (event,
    shape))}."""
    out = {}
    real_draw, real_cut = layers.init_tensor, layers.shard_leaf
    for arch, tag in SEEDED.items():
        events = []

        def draw(shape, *a, **kw):
            events.append(("draw", tuple(shape)))
            return real_draw(shape, *a, **kw)

        def cut(t, *a, **kw):
            events.append(("cut", tuple(t.shape)))
            return real_cut(t, *a, **kw)

        cfg = get_smoke_config(arch)
        pm = ProcessMesh(("data", "model"), CASES[tag][1], device=device)
        with mock.patch.object(layers, "init_tensor", draw), \
                mock.patch.object(layers, "shard_leaf", cut):
            model = M.Model(cfg, device=device, seed=0, env=steps.make_env(cfg, pm))
        out[arch] = ({k: v.numpy() for k, v in stack_leaves(
            model, dict(model.named_parameters())).items()}, events)
    return out


def _rank(path: str, device) -> dict:
    """What needs no reference first (the refusals, the seeded models, the
    CLI as ``torchrun`` would start it: on the world of ``WORLD`` ranks),
    then every case of this world's size on this rank, once the reference's
    npz at ``path`` is written (``spawned``)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    res = {}
    if dist.get_world_size() == WORLD:  # meanwhile: no reference
        res.update(refusals=refusals(device), seeded=seeded(device))
        for name, cli in (("cli", CLI), ("cli_enc", CLI_ENC)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res[name] = serve.run(serve.parser().parse_args(cli + ["--backend", "gloo"]))
            res[f"{name}_out"] = buf.getvalue()
    failed = os.path.join(os.path.dirname(path), "out.failed")
    deadline = time.monotonic() + JAX_WAIT_S
    while not os.path.exists(path):
        if os.path.exists(failed) or time.monotonic() > deadline:
            raise RuntimeError("the reference's outputs never came")
        time.sleep(0.1)
    with np.load(path) as f:
        jax_out = dict(f)
    meshes = {}
    for tag, (arch, dims) in CASES.items():
        if np.prod(dims) != dist.get_world_size():
            continue
        pm = meshes.setdefault(dims, ProcessMesh(("data", "model"), dims, device=device))
        cfg = case_cfg(tag)
        env = steps.make_env(cfg, pm)
        model = params_from_jax(tree_of(jax_out, tag), cfg, env=env, device=device)
        block = pm.coords
        replay(model, jax_out, tag, block)
        res[tag] = serve_case(model, pm, jax_out, tag, steps.map_batch(
            batch_rows(tag), lambda v: steps.rank_rows(env, v, B)))
        res[tag]["shapes"] = {k: tuple(v.shape) for k, v in stack_leaves(
            model, dict(model.named_parameters())).items()}
        res[tag]["bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        if tag == "granite18":
            res["a2a"] = {cf: a2a_case(model, env, jax_out, cf, block) for cf in A2A_CF}
    return res


@pytest.fixture(scope="module")
def world(jax_out):
    """Every case on the world-dim port, from the same parameters and rows."""
    out = {}
    for tag, (_, dims) in CASES.items():
        mesh = Mesh(("data", "model"), dims, device="cpu")
        model = params_from_jax(tree_of(jax_out, tag), case_cfg(tag), env=world_env(tag),
                                device="cpu")
        replay_world(model, jax_out, tag, model.env)
        out[tag] = serve_case(model, mesh, jax_out, tag, batch_rows(tag))
    return out


def replay_world(model, jax_out, tag, env) -> None:
    """``replay`` for the world-dim model (``test_torch_tp_serve.
    replay_prefill_routes``, with the rows split over rep groups too): each
    device's recorded route laid back in the order of the rows held once."""
    if f"{tag}/route_experts" not in jax_out:
        return
    rep, b_loc = env.row_groups(B)
    tp = env.tp
    s_loc = S // tp

    def rows_order(a):  # (D, M, n, k) per device → (R·S, k)
        d, _, n, k = a.shape
        a = a.reshape(d, tp, rep, b_loc, s_loc, k).transpose(0, 2, 3, 1, 4, 5)
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1, k))

    gates, experts = jax_out[f"{tag}/route_gates"], jax_out[f"{tag}/route_experts"]
    for i, blk in enumerate(model.blocks):
        own = blk.moe.route
        g = rows_order(gates[:, :, i]).to(torch.bfloat16)
        e = rows_order(experts[:, :, i]).long()

        def route(x, router=None, own=own, g=g, e=e):
            return (g, e) if x.shape[0] == e.shape[0] else own(x, router=router)

        blk.moe.route = route


def case_ranks(ranks, tag) -> list:
    """The ranks that ran ``tag``: the first ranks, as many as its mesh has devices."""
    return [r for r in ranks if tag in r]


def stacked(ranks, tag, pick, dims) -> np.ndarray:
    """The ranks' blocks (each behind two dims of 1) of one output, device-major."""
    blocks = [pick(r[tag]) for r in ranks]
    return np.stack([b.reshape(b.shape[2:]) for b in blocks]).reshape(dims + blocks[0].shape[2:])


def stacked_tree(ranks, tag, pick, dims) -> dict:
    keys = flatten(pick(ranks[0][tag])).keys()
    return {k: stacked(ranks, tag, lambda r: flatten(pick(r))[k], dims) for k in keys}


def held(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        assert got[k].shape == v.shape, (what, k, got[k].shape, v.shape)
        if tol == 0:
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol, err_msg=f"{what} {k}")


def world_tol(tag: str, decoded: bool = False) -> float:
    """Bitwise at tp 2 (``DECODE_TOL`` once decoded), else ``WORLD_TOL``."""
    arch, dims = CASES[tag]
    if get_smoke_config(arch).resolve_tp(dims[1]) == 2:
        return DECODE_TOL if decoded else 0
    return WORLD_TOL


def ref_tree(jax_out, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in jax_out.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", sorted(CASES))
def test_prefill_on_processes_matches_reference(ranks, world, jax_out, tag):
    """Every rank's prefill cache block and vocab shard of the last
    position's logits, stacked device-major, as the reference's and as the
    world-dim port's; the prefill step's tokens."""
    dims = CASES[tag][1]
    ranks = case_ranks(ranks, tag)
    got = stacked_tree(ranks, tag, lambda r: r["prefill"], dims)
    if tag in KINDS:
        TK.close_cache(got, jax_out, f"{tag}/prefill/")
    else:
        held(got, ref_tree(jax_out, f"{tag}/prefill/"), CACHE_TOL, "cache vs reference")
    held(got, flatten(world[tag]["prefill"]), world_tol(tag), "cache vs world-dim")
    shards = np.stack([r[tag]["logits"] for r in ranks])
    vocab = get_smoke_config(CASES[tag][0]).vocab
    full = TT.full_logits(shards.reshape(dims + shards.shape[1:]), world_env(tag))
    ref = jax_out[f"{tag}/logits0"] if tag in KINDS else TT.full_logits(
        jax_out[f"{tag}/logits_shards"], world_env(tag))
    np.testing.assert_allclose(full[:, :vocab], ref[:, :vocab], rtol=0, atol=LOGIT_TOL)
    wl = world[tag]["logits"][:, :vocab]
    if world_tol(tag):
        np.testing.assert_allclose(full[:, :vocab], wl, rtol=WORLD_TOL, atol=WORLD_TOL)
    else:
        np.testing.assert_array_equal(full[:, :vocab], wl)
    tok0 = np.stack([r[tag]["gather"]["toks"][0] for r in ranks]).reshape(dims + (-1,))
    want = ref_tokens(jax_out, tag, "tok0")
    np.testing.assert_array_equal(tok0[:, :want.shape[1]], want)


@pytest.mark.parametrize("route,tag", [("gather", t) for t in sorted(CASES)]
                         + [("cad", t) for t in CAD])
def test_decode_on_processes_matches_reference(ranks, world, jax_out, route, tag):
    """Prefill into a cache of S + GEN, then 6 greedy decode steps on every
    rank (``cad``: the compute-at-data route): each step's tokens as the
    reference's and the world-dim port's, and the final cache blocks."""
    dims = CASES[tag][1]
    ranks = case_ranks(ranks, tag)
    md = dims[1] if world_env(tag).batch_split_rep(B) else 1
    for i in range(GEN):
        got = np.stack([r[tag][route]["toks"][i] for r in ranks]).reshape(dims + (-1,))
        got = got[:, :md]
        want = ref_tokens(jax_out, tag, "tok0" if i == 0 else f"{route}/tok{i}")
        np.testing.assert_array_equal(got, want, err_msg=f"step {i}")
        np.testing.assert_array_equal(
            got, world[tag][route]["toks"][i], err_msg=f"step {i} vs world-dim")
    fin = stacked_tree(ranks, tag, lambda r: r[route]["final"], dims)
    if tag in KINDS:
        TK.close_cache(fin, jax_out, f"{tag}/{route}/final/")
    else:
        held(fin, ref_tree(jax_out, f"{tag}/{route}/final/"), CACHE_TOL,
             "final cache vs reference")
    held(fin, flatten(world[tag][route]["final"]), world_tol(tag, decoded=True),
         "final cache vs world-dim")


@pytest.mark.parametrize("route,tag", [("gather", t) for t in sorted(CASES)]
                         + [("cad", t) for t in CAD])
def test_collectives_are_process_group_calls(ranks, world, route, tag):
    """``count_collectives`` per rank, summed over the ranks, is the
    world-dim count of the same steps: the weight fetches' all-gathers, the
    psum_tp and embedding all-reduces, the vocab argmax's pmax/pmin, the
    compute-at-data all-to-alls and reduce-scatters, the MoE's
    all-to-alls and all-gather all ran as process-group calls."""
    want = world[tag][route]["counts"]
    got = {k: sum(r[tag][route]["counts"][k] for r in case_ranks(ranks, tag)) for k in want}
    assert got == want
    assert want["all-gather"] > 0 and want["all-reduce"] > 0
    if tag.startswith("granite"):
        assert want["all-to-all"] > 0
    if route == "cad":
        assert want["reduce-scatter"] > 0 and want["all-to-all"] > 0


@pytest.mark.parametrize("tag", sorted(CASES))
def test_rank_holds_its_device_shard(ranks, jax_out, tag):
    """Each rank's parameters, stacked as the JAX tree, have the local
    shapes of the reference's partition specs (``_local_shape``), and their
    bytes are the reference's per-device shard bytes; the port's held-once
    parameters cut by ``rank_shards`` give the same shards."""
    dims = CASES[tag][1]
    local = ref_tree(jax_out, f"{tag}/local/")
    cfg, env = case_cfg(tag), world_env(tag)
    per_device = sum(int(np.prod(s)) * 4 for s in local.values())  # fp32 storage
    for r in case_ranks(ranks, tag):
        assert r[tag]["shapes"] == {k: tuple(int(x) for x in v) for k, v in local.items()}
        assert r[tag]["bytes"] == per_device
    tree = tree_of(jax_out, tag)
    world_model = params_from_jax(tree, cfg, env=env, device="cpu")
    logical = stack_leaves(world_model, dict(world_model.named_parameters()))
    for at in ((0, 0), (dims[0] - 1, dims[1] - 1)):
        a = rank_shards(logical, cfg, env, slots=False, at=at)
        b = rank_shards(tree, cfg, env, slots=True, at=at)
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


@pytest.mark.parametrize("arch", sorted(SEEDED))
def test_seeded_rank_holds_world_model_shards(ranks, arch):
    """Every rank's model made from the seed under its process mesh's env:
    each parameter bitwise its device's shard (``rank_shards``,
    ``parallel.shard_leaf``) of the world-dim model made from the same seed,
    and each leaf cut to its shard right after it is drawn, before the next
    is drawn, so that a rank holds one whole leaf at a time."""
    tag = SEEDED[arch]
    cfg, env = get_smoke_config(arch), world_env(tag)
    world_model = M.Model(cfg, device="cpu", seed=0, env=env)
    logical = stack_leaves(world_model, dict(world_model.named_parameters()))
    for r, rank in enumerate(ranks):
        got, events = rank["seeded"][arch]
        want = rank_shards(logical, cfg, env, slots=False, at=divmod(r, env.model_size))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
        draws = events[0::2]
        assert len(events) == 2 * len(draws) == 2 * len(list(world_model.parameters()))
        assert [e for e, _ in draws] == ["draw"] * len(draws)
        assert events[1::2] == [("cut", shape) for _, shape in draws]


@pytest.mark.parametrize("cf", A2A_CF)
def test_a2a_on_processes_matches_reference(ranks, jax_out, cf):
    """granite-moe's layer-0 a2a at (1, 8) on every rank, at capacity 4.0
    and 1.0 (where assignments drop): the rows each rank sends (expert slot
    and token) bitwise, the kept assignments bitwise (read off the
    reference's sent rows), the output within ``MOE_TOL``."""
    meta = jax_out[f"a2a{cf}/meta"]  # (1, 8, tp, cap, 2)
    experts = jax_out[f"a2a{cf}/experts"]  # (1, 8, n, k)
    e_loc = max(1, case_cfg("granite18").moe.n_experts // world_env("granite18").tp)
    dropped = 0
    for m, r in enumerate(ranks):
        got = r["a2a"][cf]
        np.testing.assert_array_equal(got["meta"].reshape(meta[0, m].shape), meta[0, m])
        # an assignment is kept where its (slot + 1, token) is among the rows
        # sent to its destination rank (chunk e // e_loc of the sent rows)
        n, k = experts.shape[2:]
        want = np.zeros((n, k), bool)
        for tok in range(n):
            for j in range(k):
                e = int(experts[0, m, tok, j])
                sent = meta[0, m, e // e_loc]
                want[tok, j] = bool(((sent[:, 0] == e % e_loc + 1) & (sent[:, 1] == tok)).any())
        np.testing.assert_array_equal(got["keep"].reshape(n, k), want)
        dropped += int((~want).sum())
        np.testing.assert_allclose(got["y"], jax_out[f"a2a{cf}/y"][m], rtol=MOE_TOL, atol=MOE_TOL)
    assert (dropped > 0) == (cf == 1.0)


def test_whole_model_case_drops_assignments(jax_out):
    """The whole-model case at capacity 1.0 (granite18cf1) drops
    assignments in its a2a prefill: some device sends one of its layers more
    rows for a rank than the capacity, read off the reference's routes, so
    that the prefill, decode and cache tests above hold the dropping route.
    At the config's 4.0 (granite18) nothing drops."""
    tp = world_env("granite18").tp
    e_loc = max(1, case_cfg("granite18").moe.n_experts // tp)

    def drops(tag):
        experts = jax_out[f"{tag}/route_experts"]  # (D, M, layers, n, k)
        n, k = experts.shape[-2:]
        cap = int(-(-n * k * case_cfg(tag).moe.capacity_factor // tp))
        per_rank = (experts[..., None] // e_loc == np.arange(tp)).sum((-3, -2))
        return int(np.maximum(per_rank - cap, 0).sum())

    assert drops("granite18cf1") > 0 and drops("granite18") == 0


@pytest.mark.parametrize("name,match", [
    ("world_size", "needs 4 processes; WORLD_SIZE is 8"),
    ("rep_split", "different rows"),
    ("other_mesh", "model made for"),
    ("world_model", "model made for")])
def test_process_serving_refuses(ranks, name, match):
    for r in ranks:
        assert r["refusals"][name] is not None and match in r["refusals"][name], \
            r["refusals"][name]


def test_serve_cli_on_processes(ranks, capsys):
    """The CLI in the 8 ranks' process group (as torchrun starts it), for
    qwen1.5 and for seamless with ``--enc-len``: every rank gets the tokens
    of every rank's rows, the world-dim CLI's, and rank 0 alone prints
    them."""
    for name, cli in (("cli", CLI), ("cli_enc", CLI_ENC)):
        want = serve.run(serve.parser().parse_args(cli))
        capsys.readouterr()
        for r in ranks:
            np.testing.assert_array_equal(r[name], want)
        assert "on 8 processes (gloo)" in ranks[0][f"{name}_out"]
        assert all(r[f"{name}_out"] == "" for r in ranks[1:])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card_rank(device):
    cfg = get_smoke_config("qwen1.5-0.5b")
    pm = ProcessMesh(("data", "model"), (2, 4), device=device)
    env = steps.make_env(cfg, pm)
    model = M.Model(cfg, device=device, seed=0, env=env)
    mine = steps.rank_rows(env, torch.from_numpy(rows("qwen24")).to(device), B)
    res = serve.generate(model, mine, GEN, impl="flash", mesh=pm, global_batch=B)
    return {"tokens": res["tokens"].cpu().numpy()}


@pytest.mark.cuda
def test_processes_on_the_card_match_the_world_dim_port(tmp_path):
    """qwen1.5 at (2, 4) on 8 gloo ranks staged through host memory on one
    card (``impl="flash"``: the masked route at the smoke head dim): every
    rank's tokens as the world-dim port's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import _build

    _build.build_all()
    got = procs.spawn(_card_rank, WORLD, backend="gloo", store_path=tmp_path / "s",
                      timeout_s=TIMEOUT_S)
    cfg = get_smoke_config("qwen1.5-0.5b")
    mesh = Mesh(("data", "model"), (2, 4), device="cuda")
    model = M.Model(cfg, device="cuda", seed=0, env=steps.make_env(cfg, mesh))
    want = serve.generate(model, torch.from_numpy(rows("qwen24")).cuda(), GEN, impl="flash",
                          mesh=mesh, global_batch=B)["tokens"].cpu().numpy()
    blocks = np.stack([g["tokens"] for g in got]).reshape(2, 4, -1, GEN)[:, 0]
    np.testing.assert_array_equal(blocks.reshape(-1, GEN), want)
