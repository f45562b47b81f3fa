"""The process mesh under nccl, one card per rank, as far as the CPU can
show it: which card each process takes (``mesh.process_device``, the
launchers' ``--device``), that it sets the card before it joins the group
and binds an nccl group to it, a partial permutation as the first
collective of a fresh world, and a failed rank ending its world. Four
gloo ranks on the CPU stand in for the cards; the nccl runs themselves are
``chip_smoke.py`` phase 14 and the ``cuda``-marked tests (two cards or more).
"""
import importlib.util
import time
from pathlib import Path

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


# ------------------------------------------------------------ on the cards --
@pytest.mark.cuda
def test_kernels_launch_on_the_card_of_their_tensors():
    """Each kernel on the last card while the current card is the first:
    the wrappers launch where their tensors are (``chip_smoke.nccl_other_card``)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from repro_torch.kernels import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build_all()
    torch.cuda.set_device(0)
    out = smoke.nccl_other_card(torch.cuda.device_count() - 1)
    assert out["current"] == 0 and out["on_card"]
