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
from repro_torch.mesh import Mesh, ProcessMesh, process_device  # noqa: E402

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
    point-to-point op's peer); ``groups``, the ranks of each ``new_group``
    in the order they were made."""

    def __init__(self):
        self.calls, self.groups = [], []

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

        def wrap(name, real):
            def call(*args, **kw):
                group = kw.get("group")
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                tensors += [t for a in args if isinstance(a, list) for t in a]
                extra = {k: kw[k] for k in ("src", "dst") if k in kw}
                self.calls.append((name, self._ranks(group), [self._desc(t) for t in tensors],
                                   extra))
                return real(*args, **kw)
            return call

        def batch(ops):
            for op in ops:
                self.calls.append(("isend" if op.op is dist.isend else "irecv",
                                   self._ranks(op.group), [self._desc(op.tensor)],
                                   {"peer": op.peer}))
            return real_batch(ops)

        def new_group(ranks=None, *a, **kw):
            self.groups.append(tuple(ranks))
            return real_new_group(ranks, *a, **kw)

        real_batch, real_new_group = dist.batch_isend_irecv, dist.new_group
        patches = [mock.patch.object(dist, n, wrap(n, getattr(dist, n)))
                   for n in COLLECTIVES if hasattr(dist, n)]
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
        res.update(calls=rec.calls, groups=rec.groups, device=str(device))
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
    per_group, p2p = {}, {}
    for rank, r in enumerate(ranks):
        assert r["calls"], arch
        for op, group, tensors, extra in r["calls"]:
            assert rank in group, (op, group)
            for shape, dtype, contiguous, device in tensors:
                assert dtype in NCCL_DTYPES, (op, dtype)
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
