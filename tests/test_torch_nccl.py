"""The process mesh under nccl, one card per rank, as far as the CPU can
show it: which card each process takes (``mesh.process_device``, the
launchers' ``--device``), that it sets the card before it joins the group
and binds an nccl group to it, a partial permutation as the first
collective of a fresh world, and a failed rank ending its world. Four
gloo ranks on the CPU stand in for the cards; the nccl runs themselves are
``chip_smoke.py`` phase 14 and the ``cuda``-marked tests (two cards or more).
Phase 14's block kinds (the MoE's all-to-all route, Mamba-2, MLA, the
RG-LRU hybrid, M-RoPE, enc-dec, 8-bit moments, phi3) run here at smoke size
on their phase 14 meshes, held to the world-dim port, with every
``torch.distributed`` call recorded and checked as NCCL needs it.
"""
import contextlib
import importlib.util
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import procs, serve, train  # noqa: E402
from repro_torch.mesh import Mesh, ProcessMesh, local_group, process_device  # noqa: E402

WORLD = 4
TIMEOUT_S = 120


def _cards(monkeypatch, n: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


# ------------------------------------------------------ which card a rank takes --
CASES = (
    # (device asked for, backend, LOCAL_RANK, cards) → the device, or the error's words
    [(dev, "nccl", r, 4, f"cuda:{r}") for dev in (None, "cuda") for r in range(4)]
    + [(dev, "nccl", r, 4, "one card per local rank") for dev in (None, "cuda") for r in (4, 5)]
    + [(dev, "gloo", r, 4, f"cuda:{r % 4}") for dev in (None, "cuda") for r in range(6)]
    + [("cuda:1", b, 3, 4, "cuda:1") for b in ("nccl", "gloo")]
    + [(None, "nccl", 2, 2, "one card per local rank"), (None, "gloo", 2, 2, "cuda:0"),
       (None, "gloo", 0, 0, "CUDA device"), ("cuda", "nccl", 0, 0, "CUDA device"),
       ("cpu", "gloo", 3, 4, "cpu"), ("cpu", "nccl", 0, 4, "CUDA tensors only")]
)


@pytest.mark.parametrize("device, backend, local, cards, want", CASES)
def test_process_device_takes_the_local_rank_card(monkeypatch, device, backend, local, cards,
                                                  want):
    _cards(monkeypatch, cards)
    monkeypatch.setenv("LOCAL_RANK", str(local))
    if not want.startswith(("cuda:", "cpu")):
        with pytest.raises((RuntimeError, ValueError), match=want):
            process_device(device, backend)
    else:
        assert process_device(device, backend) == torch.device(want)


def test_the_train_launcher_asks_for_no_card_by_default():
    assert train.parser().parse_args(["--arch", "qwen1.5-0.5b"]).device is None
    assert serve.parser().parse_args(["--arch", "qwen1.5-0.5b"]).device is None


class _Joined(Exception):
    """Raised where the patched ``init_process_group`` is reached."""


@pytest.mark.parametrize("launcher", ["train", "serve"])
@pytest.mark.parametrize("backend, local, cards", [("nccl", 2, 4), ("nccl", 0, 4),
                                                   ("gloo", 3, 4), ("gloo", 3, 2)])
def test_a_launcher_under_torchrun_joins_on_the_local_rank_card(monkeypatch, launcher, backend,
                                                                local, cards):
    """``run`` under ``torchrun``'s environment without ``--device``: the
    card it hands ``init_process_mesh`` resolves to the local rank's, which
    is set before the group is joined, and an nccl group is bound to it."""
    import torch.distributed as dist

    _cards(monkeypatch, cards)
    for k, v in {"WORLD_SIZE": "4", "RANK": str(local), "LOCAL_RANK": str(local),
                 "LOCAL_WORLD_SIZE": str(min(4, cards)), "MASTER_ADDR": "localhost",
                 "MASTER_PORT": "1", "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1"}.items():
        monkeypatch.setenv(k, v)
    seen = []
    real = procs.init_process_mesh

    def recording(shape, axes, *, backend, device=None):
        seen.append(("asked", device, process_device(device, backend)))
        return real(shape, axes, backend=backend, device=device)

    def join(b, **kw):
        seen.append(("join", b, kw.get("device_id"), kw["rank"], kw["world_size"]))
        raise _Joined

    monkeypatch.setattr(procs, "init_process_mesh", recording)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.append(("set", torch.device(d))))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", join)
    mod = {"train": train, "serve": serve}[launcher]
    args = mod.parser().parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--mesh", "2,2",
                                    "--backend", backend])
    with pytest.raises(_Joined):
        mod.run(args)
    card = torch.device("cuda", local % cards)
    assert seen == [("asked", None, card), ("set", card),
                    ("join", backend, card if backend == "nccl" else None, local, 4)]


# ----------------------------------- a fresh world's first collective, on the CPU --
PERMS = {  # the first is the world's first collective
    "one_pair": [(0, 1)],  # ranks 2 and 3 take no part
    "two_pairs": [(0, 2), (3, 1)],
    "three_cycle": [(1, 2), (2, 3), (3, 1)],  # rank 0 takes no part
    "self_and_pair": [(0, 0), (1, 3)],
}


def _data():
    return np.arange(WORLD * 6, dtype=np.float32).reshape(WORLD, 2, 3) + 1


def _first_rank(device):
    m = ProcessMesh(("all",), (WORLD,), device=device)
    x = m.shard(_data())
    out = {name: m.ppermute(x, "all", perm).numpy() for name, perm in PERMS.items()}
    gathered = m.gather(x)
    return {"perm": out, "gather": None if gathered is None else gathered.numpy()}


@pytest.fixture(scope="module")
def first_ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("nccl") / "store"
    return procs.spawn(_first_rank, WORLD, backend="gloo", device="cpu", store_path=store,
                       timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("name", list(PERMS))
def test_a_partial_permutation_first_matches_the_world_dim_mesh(first_ranks, name):
    w = Mesh(("all",), (WORLD,), device="cpu")
    want = w.ppermute(w.shard(_data()), "all", PERMS[name]).numpy()
    got = np.concatenate([r["perm"][name] for r in first_ranks])
    np.testing.assert_array_equal(got, want)


def test_gather_lands_every_block_on_rank_0(first_ranks):
    assert all(r["gather"] is None for r in first_ranks[1:])
    np.testing.assert_array_equal(first_ranks[0]["gather"].reshape(_data().shape), _data())


# ----------------------------------------------------- a rank that fails --
def _fail_rank(device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 gives up")
    dist.barrier()  # the others wait for rank 1 here
    return "unreachable"


def test_a_failed_rank_ends_its_world_before_the_deadline(tmp_path):
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        procs.spawn(_fail_rank, WORLD, backend="gloo", device="cpu", store_path=tmp_path / "s",
                    timeout_s=TIMEOUT_S)
    assert time.monotonic() - t < TIMEOUT_S / 2


# ------------------------- phase 14's cases at smoke size, every call recorded --
# ``chip_smoke.py`` phase 14 serves and trains these in one nccl world of four
# ranks, a card each; here four gloo ranks on the CPU run each at smoke size
# on its phase 14 mesh (the tables read off chip_smoke.py) at the full
# config's tp there, and a recorder around ``torch.distributed`` keeps every
# call, so that what NCCL would refuse or hang on shows without the cards.
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
CS = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(CS)
# arch → (mesh, global batch) served; (mesh, global batch, 8-bit moments) trained
SERVE14 = {CS.case_arch(c): CS.PROCS_SERVE[c][:2] for c in CS.NCCL_SERVE + (CS.NCCL_PHI3,)
           if c != CS.NCCL_CASE}
TRAIN14 = {CS.case_arch(a): (CS.procs_train_dims(a, what), CS.PROCS_TRAIN[a][1], what == "8bit")
           for a, what in CS.NCCL_TRAIN_WORLDS["first"] if a != CS.NCCL_CASE}
CASES14 = sorted(set(SERVE14) | set(TRAIN14))
S14, GEN14, ENC14, SEQ14, SEED14 = 16, 3, 12, 16, 1
# what NCCL reduces and moves (ProcessGroupNCCL's type table, bool left out)
NCCL_DTYPES = {str(d) for d in (torch.uint8, torch.int8, torch.int32, torch.int64, torch.float16,
                                torch.bfloat16, torch.float32, torch.float64)}
# the collectives ``ProcessMesh`` calls (``all_gather_single`` and
# ``reduce_scatter_single`` where this torch has them)
COLLECTIVES = ("all_reduce", "broadcast", "all_to_all_single", "all_gather_into_tensor",
               "all_gather_single", "reduce_scatter_tensor", "reduce_scatter_single", "gather")


def _cfg14(arch: str, dims) -> object:
    """``arch``'s smoke config at the full config's tp on ``dims``'s model axis."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), tp=get_config(arch).resolve_tp(dims[1]))


class _Recorder:
    """Every ``torch.distributed`` call of this process while ``installed``:
    ``calls``, each (op, the global ranks of its group, its tensors' (shape,
    dtype, contiguous, device), what else it names: a root or source, a
    point-to-point op's peer, and whether the group is the default one);
    ``groups``, the ranks of each ``new_group`` in the order they were made,
    ``local`` those made by their members alone
    (``use_local_synchronization``), and ``shrunk_at``, the number of calls
    made before the first of those (None: none was made); ``pgs``, beside
    ``calls``, the group object each named (None: the default group), for
    the rank's own use (it is not picklable)."""

    def __init__(self):
        self.calls, self.groups, self.local, self.shrunk_at = [], [], [], None
        self.pgs = []

    @staticmethod
    def _ranks(group):
        import torch.distributed as dist

        return tuple(dist.get_process_group_ranks(group if group is not None else
                                                  dist.group.WORLD))

    @staticmethod
    def _desc(t):
        return (tuple(t.shape), str(t.dtype), t.is_contiguous(), str(t.device))

    @contextlib.contextmanager
    def installed(self):
        import torch.distributed as dist

        def default(group):
            return group is None or group is dist.group.WORLD

        def wrap(name, real):
            def call(*args, **kw):
                group = kw.get("group")
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                tensors += [t for a in args if isinstance(a, list) for t in a]
                extra = {k: kw[k] for k in ("src", "dst", "group_src", "group_dst") if k in kw}
                extra["default"] = default(group)
                self.calls.append((name, self._ranks(group), [self._desc(t) for t in tensors],
                                   extra))
                self.pgs.append(group)
                return real(*args, **kw)
            return call

        def batch(ops):
            for op in ops:
                self.calls.append(("isend" if op.op is dist.isend else "irecv",
                                   self._ranks(op.group), [self._desc(op.tensor)],
                                   {"peer": op.peer, "default": default(op.group)}))
                self.pgs.append(op.group)
            return real_batch(ops)

        def new_group(ranks=None, *a, **kw):
            if kw.get("use_local_synchronization"):
                if self.shrunk_at is None:
                    self.shrunk_at = len(self.calls)
                self.local.append(tuple(ranks))
            else:
                self.groups.append(tuple(ranks))
            return real_new_group(ranks, *a, **kw)

        real_batch, real_new_group = dist.batch_isend_irecv, dist.new_group
        patches = [mock.patch.object(dist, n, wrap(n, getattr(dist, n)))
                   for n in COLLECTIVES + ("barrier",) if hasattr(dist, n)]
        patches += [mock.patch.object(dist, "batch_isend_irecv", batch),
                    mock.patch.object(dist, "new_group", new_group)]
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            yield self


def _serve14(model, batch, mesh, env, gb: int) -> dict:
    """Each route's tokens, every step's logits and the final cache (world
    dims: the rows held once; a process: its block)."""
    out = {}
    for route in ("gather", "cad") if env.fsdp_size > 1 else ("gather",):
        logs = []
        with CS.recording_logits(logs):
            res = serve.generate(model, batch, GEN14, impl="flash", mesh=mesh, global_batch=gb,
                                 compute_at_data=route == "cad")
        out[route] = {"tokens": res["tokens"], "logits": torch.stack(logs), "cache": res["cache"]}
    return out


def _train14(arch: str, dims, gb: int, eightbit: bool, mesh) -> tuple:
    """(model, step, state, metrics) of one S3 step of ``arch`` on ``mesh``
    from the seed (8-bit moments where asked)."""
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW

    cfg = _cfg14(arch, dims)
    model = Model(cfg, device=mesh.device, seed=SEED14, env=steps.make_env(cfg, mesh))
    args = train.parser().parse_args([
        "--arch", arch, "--smoke", "--scenario", "s3_in_net_map", "--mesh",
        ",".join(map(str, dims)), "--global-batch", str(gb), "--seq", str(SEQ14),
        "--seed", str(SEED14)])
    step, pipe = train.build(model, mesh, args,
                             optimizer=AdamW(eightbit=True) if eightbit else None)
    state, metrics = step(step.init_state(), pipe.batch_at(0))
    return model, step, state, {k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}


def _phase14_rank(device) -> dict:
    """Each case of ``CASES14`` in this rank on fresh process meshes (so that
    its groups are made within it), every call recorded: served on its
    ``SERVE14`` mesh, trained a step on its ``TRAIN14`` one (an 8-bit job
    also gathers its checkpoint's rows to rank 0)."""
    from repro_torch.launch import steps
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    out = {}
    for arch in CASES14:
        rec, res = _Recorder(), {}
        with rec.installed():
            if arch in SERVE14:
                dims, gb = SERVE14[arch]
                cfg = _cfg14(arch, dims)
                pm = ProcessMesh(("data", "model"), dims, device=device)
                env = steps.make_env(cfg, pm)
                model = Model(cfg, device=device, seed=SEED14, env=env)
                batch = serve.prompt_batch(model, steps.held_rows(env.world(), gb), S14,
                                           seed=SEED14, enc_len=ENC14)
                rows = steps.map_batch(batch, lambda v: steps.rank_rows(env, v, gb))
                res["serve"] = _serve14(model, rows, pm, env, gb)
                res["coords"] = pm.coords
            if arch in TRAIN14:
                dims, gb, eightbit = TRAIN14[arch]
                pm = ProcessMesh(("data", "model"), dims, device=device)
                _, step, state, res["metrics"] = _train14(arch, dims, gb, eightbit, pm)
                res["params"] = {k: p.detach().clone() for k, p in step.params.items()}
                res["train_coords"] = pm.coords
                if eightbit:
                    tree = train.checkpoint_tree(step, state)
                    res["rows"] = None if tree is None else tree["opt"][1:]
        res.update(calls=rec.calls, groups=rec.groups, local=rec.local, device=str(device))
        out[arch] = res
    return out


@pytest.fixture(scope="module")
def phase14_ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("phase14") / "store"
    return procs.spawn(_phase14_rank, WORLD, backend="gloo", device="cpu", store_path=store,
                       timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def phase14_world():
    """Each case on the world-dim mesh of its phase 14 shape on the CPU."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    out = {}
    for arch in CASES14:
        res = {}
        if arch in SERVE14:
            dims, gb = SERVE14[arch]
            cfg = _cfg14(arch, dims)
            mesh = make_mesh(dims, device="cpu")
            env = steps.make_env(cfg, mesh)
            model = Model(cfg, device="cpu", seed=SEED14, env=env)
            batch = serve.prompt_batch(model, steps.held_rows(env, gb), S14, seed=SEED14,
                                       enc_len=ENC14)
            res["serve"], res["env"] = _serve14(model, batch, mesh, env, gb), env
        if arch in TRAIN14:
            dims, gb, eightbit = TRAIN14[arch]
            model, step, state, res["metrics"] = _train14(arch, dims, gb, eightbit,
                                                          make_mesh(dims, device="cpu"))
            res["step"], res["state"], res["p0"] = step, state, Model(
                model.cfg, device="cpu", seed=SEED14, env=model.env)
        out[arch] = res
    return out


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    ok = torch.isfinite(want)
    den = float(torch.where(ok, want, 0.0).norm())
    return float(torch.where(ok, got - want, 0.0).norm()) / (den or 1.0)


@pytest.mark.parametrize("arch", CASES14)
def test_phase14_case_matches_world_dims(phase14_ranks, phase14_world, arch):
    """Every rank of the case against the world-dim port at phase 14's
    tolerances (phases 12 and 13's): served, its tokens on its rows equal,
    each step's logits (its rows, its vocab shard) and its final cache block
    within ``TP_TOL``; trained a step, the loss and gradient norm within
    ``PROCS_TRAIN_TOL``, its parameter shards within two steps of lr of the
    world-dim step's and the update within ``PROCS_UPDATE_TOL``; 8-bit
    moments gathered to rank 0 into the world-dim rows, each leaf within
    ``PROCS_EIGHTBIT_TOL`` (but rounding-noise leaves) and the tree within
    ``PROCS_MOMENT_TOL``."""
    from repro_torch.launch import steps
    from repro_torch.models.convert import cache_block, flatten
    from repro_torch.models.parallel import shard_leaf
    from repro_torch.optim.adamw import dequantize_block8

    world = phase14_world[arch]
    ranks = [r[arch] for r in phase14_ranks]
    if arch in SERVE14:
        env = world["env"]
        per = world["serve"]["gather"]["logits"].shape[-1] // env.tp
        rep, b_loc = env.row_groups(SERVE14[arch][1])
        for route, w in world["serve"].items():
            for r in ranks:
                f, m = r["coords"]
                got = r["serve"][route]
                start = (f * rep + (m % env.rep if rep > 1 else 0)) * b_loc
                t = m // env.rep
                np.testing.assert_array_equal(got["tokens"], w["tokens"][start:start + b_loc])
                want = w["logits"][:, start:start + b_loc, t * per:(t + 1) * per]
                assert _rel(got["logits"], want) <= CS.TP_TOL, (route, r["coords"])
                block, mine = flatten(cache_block(w["cache"], env, f, m)), flatten(got["cache"])
                assert set(block) == set(mine)
                for k, v in block.items():
                    assert _rel(mine[k], v) <= CS.TP_TOL, (route, k)
    if arch in TRAIN14:
        step, lr = world["step"], world["metrics"]["lr"]
        env = step.env
        for r in ranks:
            for k in CS.PROCS_TRAIN_TOL:
                assert abs(r["metrics"][k] / world["metrics"][k] - 1) <= CS.PROCS_TRAIN_TOL[k]
        num = den = 0.0
        p0 = dict(world["p0"].named_parameters())
        for r in ranks:
            f, m = divmod(int(np.ravel_multi_index(r["train_coords"], TRAIN14[arch][0])),
                          env.model_size)
            for k, p in r["params"].items():
                want = shard_leaf(step.params[k].detach(), step.places[k], env, f, m)
                start = shard_leaf(p0[k].detach(), step.places[k], env, f, m)
                assert float((p - want).abs().max()) <= 2 * lr * 1.01, k
                num += float(((p - want).double() ** 2).sum())
                den += float(((want - start).double() ** 2).sum())
        assert (num / den) ** 0.5 <= CS.PROCS_UPDATE_TOL
        if TRAIN14[arch][2]:  # 8-bit moments: rank 0 holds the world-dim rows
            assert all(r["rows"] is None for r in ranks[1:])
            sums = [0.0, 0.0]
            for i, what in enumerate(("m", "v")):
                want_rows = getattr(world["state"], what)
                got_rows = ranks[0]["rows"][i]
                assert set(got_rows) == set(want_rows)
                for path, (codes, scales) in want_rows.items():
                    n = codes.shape[-2] * codes.shape[-1]
                    a = dequantize_block8(*got_rows[path], n)
                    b = dequantize_block8(codes, scales, n)
                    assert a.shape == b.shape, path
                    if not any(path.endswith(x) for x in CS.PROCS_NOISE_LEAVES):
                        assert _rel(a, b) <= CS.PROCS_EIGHTBIT_TOL, (what, path)
                    sums[0] += float(((a - b).double() ** 2).sum())
                    sums[1] += float((b.double() ** 2).sum())
            assert (sums[0] / sums[1]) ** 0.5 <= CS.PROCS_MOMENT_TOL


@pytest.mark.parametrize("arch", CASES14)
def test_phase14_case_calls_fit_nccl(phase14_ranks, arch):
    """The recorded ``torch.distributed`` calls of the case, as NCCL needs
    them: every rank made the same groups in the same order; every member
    of a group issued the same collectives on it in the same order, with
    the same shapes, dtypes and roots; every send has its receive, in
    order, of the same shape and dtype; every dtype is one NCCL carries;
    every operand is contiguous and on the mesh's device."""
    ranks = [r[arch] for r in phase14_ranks]
    assert all(r["groups"] == ranks[0]["groups"] for r in ranks)
    assert all(not r["local"] for r in ranks)
    calls_fit_nccl(ranks, arch)


def calls_fit_nccl(ranks: list, what: str) -> None:
    """``test_phase14_case_calls_fit_nccl``'s checks of the calls of
    ``ranks``' records ({"calls", "device"}), a rank's place its global rank."""
    per_group, p2p = {}, {}
    for rank, r in enumerate(ranks):
        assert r["calls"], what
        for op, group, tensors, extra in r["calls"]:
            assert rank in group, (op, group)
            for shape, dtype, contiguous, device in tensors:
                assert dtype in NCCL_DTYPES, (what, op, dtype)
                assert contiguous and device == r["device"], (op, shape, device)
            if op in ("isend", "irecv"):
                pair = (rank, extra["peer"]) if op == "isend" else (extra["peer"], rank)
                p2p.setdefault((op,) + pair, []).append([t[:2] for t in tensors])
            else:
                per_group.setdefault(group, {}).setdefault(rank, []).append(
                    (op, [t[:2] for t in tensors[:1]], extra))
    for group, by_rank in per_group.items():
        assert set(by_rank) == set(group), (group, sorted(by_rank))
        first = by_rank[group[0]]
        for rank in group:
            assert by_rank[rank] == first, (group, rank)
    for (op, a, b), sent in p2p.items():
        if op == "isend":
            assert p2p.get(("irecv", a, b)) == sent, (a, b)
    assert {k[1:] for k in p2p if k[0] == "isend"} == {k[1:] for k in p2p if k[0] == "irecv"}


# ------------------ 14a staged on a gloo group inside the world, on the CPU --
# ``chip_smoke.py`` phase 14 runs 14a's data plane in its nccl world twice:
# on the world's group, then staged on a gloo group of the same four
# processes (``nccl_gloo_group``), in place of a gloo world of its own. Here
# four gloo ranks make that group as the smoke does and run 14a's meshes
# over it (``procs_meshes(..., group=)``) at a small size, then the same on
# the world's own group, as the nccl cases run there, every call recorded
STAGED_TOKENS, STAGED_GRAD = 4096, 1024


def _staged_cases(meshes) -> dict:
    """The collectives of 14a's meshes ("all" of 4, "pod_data" (2, 2); world
    dims or a process's) on seeded integer-valued blocks: sums agree
    whatever order gloo adds in."""
    data = np.random.RandomState(14).randint(-50, 50, (WORLD, 4, 3)).astype(np.float32)
    a, p = meshes["all"], meshes["pod_data"]
    x, y = a.shard(data), p.shard(data.reshape(2, 2, 4, 3))
    return {"psum": a.psum(x, "all"), "all_gather": a.all_gather(x, "all", tiled=True),
            "psum_scatter": a.psum_scatter(x, "all", 0, tiled=True),
            "all_to_all": a.all_to_all(x, "all", 0, 0, tiled=True),
            "ppermute": a.ppermute(x, "all", [(i, (i + 1) % WORLD) for i in range(WORLD)]),
            "broadcast": a.broadcast(x, "all", 2),
            "psum_pod": p.psum(y, "pod"), "psum_data": p.psum(y, "data"),
            "psum_pod_data": p.psum(y, ("pod", "data")),
            "all_gather_data": p.all_gather(y, "data", tiled=True)}


def _data_plane(meshes) -> dict:
    """14a's paths (``procs_paths``) on ``meshes`` at ``STAGED_TOKENS`` tokens
    and ``STAGED_GRAD`` gradients a device: each path's ``procs_record``."""
    words, grads, grads24, plan = CS.procs_inputs(meshes, STAGED_TOKENS, STAGED_GRAD)
    one = isinstance(meshes["all"], ProcessMesh)
    return {name: CS.procs_record(name, fn(), 1 if one else WORLD)
            for name, fn in CS.procs_paths(meshes, words, grads, grads24, plan).items()}


def _staged_rank(device) -> dict:
    """One rank: the gloo group of the world's ranks (``nccl_gloo_group``),
    14a's meshes over it, ``nccl_first`` on it, its collectives and data
    plane; then the same data plane on the world's own meshes. Returns
    their outputs, every call recorded, and for each call whether it named
    the gloo group or one made over its ranks."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rec = _Recorder()
    with rec.installed():
        pg = CS.nccl_gloo_group(device)
        meshes = CS.procs_meshes(WORLD, device, group=pg)
        out = {"first": CS.nccl_first(device, pg),
               "cases": {k: v.numpy() for k, v in _staged_cases(meshes).items()},
               "paths": _data_plane(meshes), "transport": meshes["all"].transport}
        staged_calls = len(rec.calls)
        made = [pg] + [g for m in meshes.values() for g in m._made]
        for m in meshes.values():
            m.close()
        dist.destroy_process_group(pg)
        out["world_paths"] = _data_plane(CS.procs_meshes(WORLD, device))
    on_staged = [any(g is m for m in made) for g in rec.pgs]
    return {**out, "calls": rec.calls, "staged_calls": staged_calls, "on_staged": on_staged,
            "local": rec.local, "groups": rec.groups, "device": str(device)}


@pytest.fixture(scope="module")
def staged_ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("staged") / "store"
    return procs.spawn(_staged_rank, WORLD, backend="gloo", device="cpu", store_path=store,
                       timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("name", sorted(_staged_cases(CS.procs_meshes(WORLD, "cpu",
                                                                      process=False))))
def test_gloo_group_collective_bitwise_to_world_dims(staged_ranks, name):
    """Each collective of 14a's meshes over the gloo group equals the
    world-dim ``Mesh``'s of the same shape, bitwise."""
    want = _staged_cases(CS.procs_meshes(WORLD, "cpu", process=False))[name].numpy()
    got = np.concatenate([r["cases"][name] for r in staged_ranks], axis=0)
    if name.startswith(("psum_", "all_gather_data")):  # the (2, 2) mesh's blocks
        got = got.reshape(want.shape)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("path", CS.PROCS_PATHS)
def test_gloo_group_data_plane_matches_world_dims(staged_ranks, path):
    """14a's paths on the gloo group's meshes, held as phase 14 holds its
    gloo comparison (``procs_hold``): each rank's outputs bitwise to the
    world-dim run's device, or for ``PROCS_CLOSE`` within ``PROCS_TOL``;
    the same on the world's own group; and the first permutations as the
    world-dim mesh's."""
    want = _data_plane(CS.procs_meshes(WORLD, "cpu", process=False))[path]
    for r, out in enumerate(staged_ranks):
        assert all(v["equal"] for v in out["first"].values()), out["first"]
        for got in (out["paths"][path], out["world_paths"][path]):
            if path.startswith("plan_"):
                assert got == want, r
            elif path in CS.PROCS_CLOSE:
                np.testing.assert_allclose(got[0], want[r], rtol=CS.PROCS_TOL,
                                           atol=CS.PROCS_TOL * float(np.abs(want[r]).max()))
            else:
                assert got[0] == want[r], (path, r)


def test_gloo_group_calls_name_only_it(staged_ranks):
    """Every call of 14a over the gloo group names that group or one made
    over its ranks by them alone, never the world's; no call on the world's
    own meshes afterwards names any of them; those calls fit NCCL
    (``calls_fit_nccl``), as every rank made the world's groups in one
    order."""
    for out in staged_ranks:
        n = out["staged_calls"]
        assert n and all(out["on_staged"][:n])
        assert not any(out["on_staged"][n:])
        assert all(not extra["default"] for _, _, _, extra in out["calls"][:n])
        assert out["local"] and all(len(g) in (2, WORLD) for g in out["local"])
        assert out["groups"] == staged_ranks[0]["groups"]
    calls_fit_nccl([{"calls": r["calls"][r["staged_calls"]:], "device": r["device"]}
                    for r in staged_ranks], "world after the gloo group")


# ----------------------------------- the smoke's spawns and its phase walls --
# ``chip_smoke.spawning`` starts the ranks while its block makes what they
# read (phases 12-14's references) and calls them once the block has ended;
# a failure in the block stops them. ``phase_walls`` prints each phase's wall
# in phase order
def _stamped_rank(device) -> dict:
    import torch.distributed as dist

    called = time.time()
    dist.barrier()  # no rank leaves while another still joins the group
    return {"rank": dist.get_rank(), "called": called}


def _gated_in_rank(fn, gate: str, device):
    """``chip_smoke._gated_call`` reached through this module, which a
    spawned rank imports by name (the smoke is loaded here by its path)."""
    return CS._gated_call(fn, gate, device)


@pytest.fixture
def gated(monkeypatch):
    monkeypatch.setattr(CS, "_gated_call", _gated_in_rank)


def test_spawning_calls_the_ranks_once_the_block_ends(gated, tmp_path):
    with CS.spawning(_stamped_rank, 2, backend="gloo", device="cpu",
                     store_path=tmp_path / "store", timeout_s=TIMEOUT_S) as got:
        time.sleep(0.5)
        ended = time.time()
    assert [r["rank"] for r in got["ranks"]] == [0, 1]
    assert all(r["called"] >= ended for r in got["ranks"])
    times = got["times"]
    assert set(times) == {"spawn_s", "start_s", "idle_s", "call_s", "teardown_s"}
    assert times["spawn_s"] >= times["start_s"] > 0 and times["idle_s"] >= 0


def test_spawning_stops_the_ranks_when_the_block_fails(gated, tmp_path, monkeypatch):
    """The block's failure is raised, and the ranks that waited for it end
    with theirs, before any timeout."""
    from repro_torch.launch import procs as procs_lib

    seen, real = {}, procs_lib.spawn

    def spawn(*args, **kw):
        try:
            return real(*args, **kw)
        except RuntimeError as e:
            seen["ranks"] = str(e)
            raise

    monkeypatch.setattr(procs_lib, "spawn", spawn)
    t = time.perf_counter()
    with pytest.raises(KeyError, match="the block failed"):
        with CS.spawning(_stamped_rank, 2, backend="gloo", device="cpu",
                         store_path=tmp_path / "store", timeout_s=TIMEOUT_S):
            time.sleep(0.5)
            raise KeyError("the block failed")
    assert "the parent failed before the ranks' call" in seen["ranks"]
    assert time.perf_counter() - t < TIMEOUT_S


def test_phase_walls_in_phase_order(monkeypatch):
    """Each phase's wall from its first stage to the next phase's, in phase
    order (3b after 3 where it ran after 4), and the script's wall."""
    start = CS.START
    monkeypatch.setattr(CS, "STAGES", {
        "1": (start + 1.0, "1 build"), "3": (start + 2.0, "3 main paths"),
        "4": (start + 4.0, "4 kernels"), "3b": (start + 5.0, "3b recurrences"),
        "12": (start + 9.0, "12 serving"), "11": (start + 7.0, "11 data plane"),
        "done": (start + 12.0, "done")})
    walls = CS.phase_walls()
    assert list(walls) == ["1 build", "3 main paths", "3b recurrences", "4 kernels",
                           "11 data plane", "12 serving", "script_s"]
    assert walls["1 build"] == 1.0 and walls["4 kernels"] == 1.0
    assert walls["3b recurrences"] == 2.0 and walls["11 data plane"] == 2.0
    assert walls["12 serving"] == 3.0 and walls["script_s"] > 0


# --------------------------- the survivors' mesh over a group of their own --
# the elastic restart inside the processes: of a (2, 2) world, ranks 2 and 3
# leave and ranks 0 and 1 form elastic_mesh_plan(2, model_size=2)'s (1, 2)
# over a group of their own (``procs.shrink_process_mesh``)
SHRINK_AXES, SHRINK_FROM, SHRINK_TO = ("data", "model"), (2, 2), 2
SHRINK_VOCAB, SHRINK_TOKENS = 64, 500
# qwen1.5 smoke trained at (2, 2) under S3, failing at RESTART_FAIL and
# restarting on (1, 2) in the same world, as ``launch/train.py`` runs it
RESTART_ARGS = ["--arch", "qwen1_5_0_5b", "--smoke", "--mesh", "2,2", "--scenario",
                "s3_in_net_map", "--steps", "4", "--global-batch", "4", "--seq", "16",
                "--ckpt-every", "2", "--fail-step", "2", "--shrink-to", str(SHRINK_TO),
                "--log-every", "100", "--device", "cpu"]
RESTART_FAIL, RESTART_STEPS = 2, 4
# a (1, 2) mesh over ranks whose positions in it are not their global ranks
OTHER_RANKS = (1, 3)
# the processes' losses against the world-dim run's: the same products on
# other shapes, gloo's order of fp32 sums (test_torch_procs_train's WORLD_LOSS_TOL)
RESTART_LOSS_TOL = 1e-4


def _shrink_inputs() -> dict:
    """Seeded integer-valued blocks of the (1, 2) mesh (the mesh dims lead):
    sums agree whatever order gloo adds in."""
    rs = np.random.RandomState(11)
    return {"x": rs.randint(-50, 50, (1, 2, 3, 4)).astype(np.float32),
            "y": rs.randint(-50, 50, (1, 2, 4, 3)).astype(np.float32)}


def _group_cases(m) -> dict:
    """The collectives on a (1, 2) mesh ``m`` (world dims or a process's)."""
    data = _shrink_inputs()
    x, y = m.shard(data["x"]), m.shard(data["y"])
    return {"ppermute": m.ppermute(x, "model", [(0, 1), (1, 0)]),
            "ppermute_partial": m.ppermute(x, "model", [(0, 1)]),
            "all_to_all": m.all_to_all(y, "model", 0, 1, tiled=True),
            "all_gather": m.all_gather(x, "model"),
            "all_gather_tiled": m.all_gather(x, "model", tiled=True),
            "psum": m.psum(x, "model"),
            "psum_mesh": m.psum(x, ("data", "model")),
            "psum_data": m.psum(x, "data"),
            "psum_scatter": m.psum_scatter(y, "model", 0, tiled=True),
            "broadcast": m.broadcast(x, "model", 1)}


def _shrink_words() -> list:
    rs = np.random.RandomState(12)
    return [np.minimum(rs.zipf(1.3, SHRINK_TOKENS) - 1, SHRINK_VOCAB - 1).astype(np.int32)
            for _ in range(2)]


def _shrink_rank(ckpt: str, device) -> dict:
    """One rank of a world of four: a (2, 2) mesh's collectives; the
    survivors' (1, 2) mesh, twice over the same ranks, each's collectives
    and ``gather``, the word-count plan on one axis over the survivors'
    group, every call recorded; both meshes released; the world going on
    (the first mesh's collectives again, and a new mesh of all four); then
    the restart of ``RESTART_ARGS`` through ``train.run``, every call
    recorded."""
    import torch.distributed as dist

    from repro_torch.core import wordcount as wc
    from repro_torch.runtime.fault_tolerance import elastic_mesh_plan

    torch.set_num_threads(1)
    m22 = ProcessMesh(SHRINK_AXES, SHRINK_FROM, device=device)
    x22 = m22.shard(np.arange(24, dtype=np.float32).reshape(2, 2, 6))
    out = {"before": m22.psum(x22, "data").numpy()}
    plan = elastic_mesh_plan(SHRINK_TO, model_size=SHRINK_FROM[1])
    rec = _Recorder()
    with rec.installed():
        meshes = [procs.shrink_process_mesh(m22, plan) for _ in range(2)]
        if meshes[0] is not None:
            a, b = meshes
            out["ranks"] = (a.ranks, b.ranks, a.rank)
            out["distinct_groups"] = a.group is not b.group
            out["cases"] = [{k: v.numpy() for k, v in _group_cases(m).items()} for m in (a, b)]
            g = a.gather(a.shard(_shrink_inputs()["x"]))
            out["gather"] = None if g is None else g.numpy()
            one = ProcessMesh(("all",), (SHRINK_TO,), device=device, group=b.group)
            out["wordcount"] = wc.wordcount_via_plan(_shrink_words(), SHRINK_VOCAB,
                                                     device=device, mesh=one)[0]
            one.close()
            for m in meshes:
                procs.release_process_mesh(m)
    out["shrink"] = {"calls": rec.calls, "local": rec.local, "groups": rec.groups,
                     "shrunk_at": rec.shrunk_at, "device": str(device)}
    if dist.get_rank() in OTHER_RANKS:
        other = ProcessMesh(SHRINK_AXES, (1, 2), device=device,
                            group=local_group(OTHER_RANKS, device))
        out["other"] = {k: v.numpy() for k, v in _group_cases(other).items()}
        x = other.shard(_shrink_inputs()["x"])
        for root in range(2):
            g = other.gather(x, root)
            out["other"][f"gather{root}"] = None if g is None else g.numpy()
        out["other_rank"] = (other.rank, other.ranks)
        procs.release_process_mesh(other)
    out["after"] = m22.psum(x22, "data").numpy()
    m4 = ProcessMesh(("all",), (WORLD,), device=device)
    x4 = m4.shard(np.arange(WORLD * 2, dtype=np.float32).reshape(WORLD, 2))
    out["after_new"] = m4.psum(x4, "all").numpy()
    out["pg_names"] = len(dist.distributed_c10d._world.pg_names)
    rec = _Recorder()
    with rec.installed():
        out["losses"] = train.run(train.parser().parse_args(RESTART_ARGS + ["--ckpt", ckpt]))
    out["restart"] = {"calls": rec.calls, "local": rec.local, "groups": rec.groups,
                      "shrunk_at": rec.shrunk_at, "device": str(device)}
    return out


@pytest.fixture(scope="module")
def shrink_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shrink")
    import functools

    return procs.spawn(functools.partial(_shrink_rank, str(tmp / "ckpt")), WORLD, backend="gloo",
                       device="cpu", store_path=tmp / "store", timeout_s=TIMEOUT_S)


def test_survivors_form_a_mesh_of_their_own(shrink_ranks):
    """Ranks 0 and 1, the first devices, get the (1, 2) mesh over a group of
    their own, its positions their global ranks; each shrink a group of its
    own over the same ranks; ranks 2 and 3 get None and make no call."""
    for r, out in enumerate(shrink_ranks):
        if r < SHRINK_TO:
            assert out["ranks"] == ([0, 1], [0, 1], r) and out["distinct_groups"]
        else:
            assert "ranks" not in out and out["shrink"]["calls"] == []
            assert out["shrink"]["local"] == [] and out["shrink"]["groups"] == []


@pytest.mark.parametrize("name", sorted(_group_cases(Mesh(SHRINK_AXES, (1, 2), device="cpu"))))
def test_group_mesh_collective_bitwise_to_world_dims(shrink_ranks, name):
    """Each collective on both survivors' meshes (two groups over the same
    ranks) equals the world-dim ``Mesh``'s of the same shape, bitwise."""
    m = Mesh(SHRINK_AXES, (1, 2), device="cpu")
    want = _group_cases(m)[name].numpy()
    for which in range(2):
        got = np.concatenate([shrink_ranks[r]["cases"][which][name] for r in range(SHRINK_TO)],
                             axis=1)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=f"{name} on mesh {which}")


def test_group_mesh_gathers_to_its_root(shrink_ranks):
    assert shrink_ranks[1]["gather"] is None
    got = shrink_ranks[0]["gather"]
    np.testing.assert_array_equal(got.reshape(_shrink_inputs()["x"].shape),
                                  _shrink_inputs()["x"])


def test_wordcount_plan_on_the_survivors_mesh_matches_world_dims(shrink_ranks):
    """The word-count plan on one axis over the survivors' group (the
    shards each rank counts picked by its rank there) against the
    world-dim plan on the same shards, bitwise."""
    from repro_torch.core import wordcount as wc

    want = wc.wordcount_via_plan(_shrink_words(), SHRINK_VOCAB, device="cpu")[0]
    np.testing.assert_array_equal(want, wc.wordcount_reference(_shrink_words(), SHRINK_VOCAB))
    for r in range(SHRINK_TO):
        got = shrink_ranks[r]["wordcount"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_mesh_over_other_ranks_takes_its_positions(shrink_ranks):
    """A mesh over global ranks ``OTHER_RANKS``: its positions are their
    places in that group, not their global ranks."""
    for pos, r in enumerate(OTHER_RANKS):
        assert shrink_ranks[r]["other_rank"] == (pos, list(OTHER_RANKS))
    assert all("other" not in shrink_ranks[r] for r in set(range(WORLD)) - set(OTHER_RANKS))


@pytest.mark.parametrize("name", sorted(_group_cases(Mesh(SHRINK_AXES, (1, 2), device="cpu")))
                         + ["gather0", "gather1"])
def test_mesh_over_other_ranks_bitwise_to_world_dims(shrink_ranks, name):
    """Each collective, and ``gather`` to either position, on a (1, 2) mesh
    over ``OTHER_RANKS`` equals the world-dim ``Mesh``'s, bitwise: peers,
    sources and roots are taken as positions in the mesh's group."""
    x = _shrink_inputs()["x"]
    got = [shrink_ranks[r]["other"][name] for r in OTHER_RANKS]
    if name.startswith("gather"):
        root = int(name[-1])
        assert got[1 - root] is None
        np.testing.assert_array_equal(got[root].reshape(x.shape), x)
        return
    want = _group_cases(Mesh(SHRINK_AXES, (1, 2), device="cpu"))[name].numpy()
    got = np.concatenate(got, axis=1)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


def _after_shrink(out: dict) -> list:
    """A survivor's recorded calls from its first group of its own on."""
    assert out["shrunk_at"] is not None
    return out["calls"][out["shrunk_at"]:]


@pytest.mark.parametrize("what", ["shrink", "restart"])
def test_survivors_call_neither_the_default_group_nor_a_departed_rank(shrink_ranks, what):
    """After the shrink every call of a survivor names a group of its own
    (the survivors' group or one made over its ranks), whose ranks, and
    every peer and root, are survivors; the leavers made no call after the
    barrier that the whole world passed."""
    gone = set(range(SHRINK_TO, WORLD))
    for r in range(SHRINK_TO):
        calls = _after_shrink(shrink_ranks[r][what])
        assert calls, what
        for op, group, _, extra in calls:
            assert not extra["default"], (what, op, group)
            assert not set(group) & gone, (what, op, group)
            for k in ("peer", "src", "dst"):
                assert extra.get(k) not in gone, (what, op, extra)
            assert set(shrink_ranks[r][what]["local"]) <= {(0,), (1,), (0, 1)}
    for r in sorted(gone):
        rec = shrink_ranks[r][what]
        assert rec["shrunk_at"] is None and rec["local"] == []
        if what == "restart":
            assert rec["calls"][-1][0] == "barrier" and rec["calls"][-1][3]["default"]


@pytest.mark.parametrize("what", ["shrink", "restart"])
def test_the_shrink_calls_fit_nccl(shrink_ranks, what):
    """The calls of the shrink and of the restart as NCCL needs them
    (``calls_fit_nccl``): every rank made the world's groups in one order,
    any two survivors the groups of their own that hold both in one order,
    and every group's members the same calls on it."""
    recs = [r[what] for r in shrink_ranks]
    assert all(r["groups"] == recs[0]["groups"] for r in recs)
    for a in range(SHRINK_TO):
        for b in range(SHRINK_TO):
            assert ([g for g in recs[a]["local"] if b in g]
                    == [g for g in recs[b]["local"] if a in g]), (a, b)
    calls_fit_nccl([r for r in recs if r["calls"]], what)


def test_the_world_goes_on_after_the_shrink(shrink_ranks):
    """The leavers and the survivors (their groups released) go on in the
    same world: the first mesh's collectives as before the shrink, a new
    mesh of all four, and as many groups on every rank."""
    w = Mesh(("all",), (WORLD,), device="cpu")
    want = w.psum(w.shard(np.arange(WORLD * 2, dtype=np.float32).reshape(WORLD, 2)), "all").numpy()
    for out in shrink_ranks:
        np.testing.assert_array_equal(out["after"], out["before"])
        np.testing.assert_array_equal(out["after_new"], want[:1])
        assert out["pg_names"] == shrink_ranks[0]["pg_names"]


def test_restart_inside_the_processes_matches_world_dims(shrink_ranks, tmp_path):
    """qwen1.5 trained at (2, 2), failing at ``RESTART_FAIL``: the survivors
    restore the checkpoint on (1, 2) and train on to ``RESTART_STEPS``, as
    the world-dim run of the same arguments does (the same losses within
    ``RESTART_LOSS_TOL``); the leavers return the losses they took."""
    want = train.run(train.parser().parse_args(RESTART_ARGS + ["--ckpt", str(tmp_path / "ckpt")]))
    assert len(want) == RESTART_STEPS
    for r, out in enumerate(shrink_ranks):
        got = out["losses"]
        assert len(got) == (RESTART_STEPS if r < SHRINK_TO else RESTART_FAIL)
        assert got == shrink_ranks[0]["losses"][:len(got)]
        for g, w in zip(got, want):
            assert abs(g - w) <= RESTART_LOSS_TOL * w, (r, got, want)


# ------------------------------------------------------------ on the cards --
@pytest.mark.cuda
def test_kernels_launch_on_the_card_of_their_tensors():
    """Each kernel on the last card while the current card is the first:
    the wrappers launch where their tensors are (``chip_smoke.nccl_other_card``)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from repro_torch.kernels import _build

    _build.build_all()
    torch.cuda.set_device(0)
    out = CS.nccl_other_card(torch.cuda.device_count() - 1)
    assert out["current"] == 0 and out["on_card"]
