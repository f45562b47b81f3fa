"""One process per mesh device: the launchers of ``repro_torch.mesh.ProcessMesh``.

``init_process_mesh`` joins the process group that ``torchrun`` describes
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and the
rendezvous address) and returns this process's ``ProcessMesh``:

    torchrun --nproc-per-node 8 examples/torch_procs_wordcount.py --backend gloo

``spawn`` starts the ranks itself, with the ``spawn`` start method (a
process forked after CUDA is initialized cannot use the card) and a
``file://`` store (no TCP port to agree on): for tests and for
``chip_smoke.py``. Build the kernels (``kernels._build.build_all``) before
spawning, so that the ranks only load them.

Neither switches backend by itself: gloo carries CPU tensors and, staged
through host memory, the tensors of ranks that share a card; nccl needs one
card per local rank and raises with fewer. Under nccl a process sets its
card before it joins and binds the group to it (``device_id``), so the
world's communicator exists before any collective: a ``ppermute`` that
leaves some ranks out may then be the first call. NCCL's watchdog aborts a
collective that waits past the timeout, and a rank that fails leaves its
group without waiting for the others.

``shrink_process_mesh`` is the elastic restart's mesh inside the running
world: the first ranks of a mesh form a process group of their own, made
by them alone under either backend (``mesh.local_group``; not a split of
the world's communicator, which every rank would have to join), and a
``ProcessMesh`` of the smaller shape over it; the other ranks leave.
``release_process_mesh`` destroys its groups when the survivors are done.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.mesh import ProcessMesh, local_group, process_device

TIMEOUT_S = 300


def _check_cards(backend: str, local_ranks: int) -> None:
    if backend == "nccl" and torch.cuda.device_count() < local_ranks:
        raise RuntimeError(f"nccl needs one card per local rank: {local_ranks} local ranks, "
                           f"{torch.cuda.device_count()} cards")


def _join(backend: str, device: torch.device, timeout_s: float, **kw) -> None:
    """Join the default process group from ``device``, the current card
    where it is one; under nccl bound to it, which forms the world's
    communicator at once, and with NCCL's errors aborting the process."""
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        kw["device_id"] = device
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def init_process_mesh(shape: Sequence[int], axes: Sequence[str], *, backend: str,
                      device=None) -> ProcessMesh:
    """Join the process group of ``torchrun``'s environment (unless this
    process has joined one) and return the ``ProcessMesh`` of ``shape`` and
    ``axes`` on ``device`` (``None`` or ``"cuda"``: this local rank's card,
    ``mesh.process_device``). Raises when the world size is not
    ``prod(shape)``, and under nccl when this host has fewer cards than
    local ranks."""
    shape = tuple(int(s) for s in shape)
    world = int(os.environ["WORLD_SIZE"])
    if world != math.prod(shape):
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} processes; "
                         f"WORLD_SIZE is {world}")
    _check_cards(backend, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    device = process_device(device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # before the group, which binds to it
    if not dist.is_initialized():
        _join(backend, device, TIMEOUT_S, rank=int(os.environ["RANK"]), world_size=world)
    return ProcessMesh(axes, shape, device=device)


def shrink_process_mesh(mesh: ProcessMesh, plan) -> ProcessMesh | None:
    """The survivors' mesh of an elastic shrink to ``plan``
    (``runtime.fault_tolerance.elastic_mesh_plan``: its ``shape`` and
    ``axes``): the processes at ``mesh``'s positions ``0 … prod(plan.shape)
    − 1``, the first devices as the reference's ``make_mesh`` takes them,
    form a process group of their own (``local_group``, made by them alone)
    and get a ``ProcessMesh`` of ``plan.shape`` over it on the same device;
    the other processes get None and make no call. Every process of
    ``mesh`` calls it; the default group is not touched, and the survivors'
    calls on the new mesh name only its group and the groups made over its
    ranks."""
    n = math.prod(plan.shape)
    if n > mesh.size:
        raise ValueError(f"a mesh of {tuple(plan.shape)} needs {n} processes; "
                         f"the mesh {mesh.shape} has {mesh.size}")
    if mesh.rank >= n:
        return None
    group = local_group(mesh.ranks[:n], mesh.device)
    return ProcessMesh(plan.axes, plan.shape, device=mesh.device, group=group)


def release_process_mesh(mesh: ProcessMesh) -> None:
    """Destroy a survivors' mesh's groups (``shrink_process_mesh``): the
    ones it made over its ranks, then the group it spans. Its processes
    call it together; the default group is left as it is."""
    mesh.close()
    dist.destroy_process_group(mesh.group)


def _rank_main(rank: int, world: int, backend: str, device, store: str, timeout_s: float,
               fn: Callable, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    failed_at = None  # when fn raised: before the group's teardown fails the others
    try:
        device = process_device(device, backend)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        _join(backend, device, timeout_s, init_method=f"file://{store}", rank=rank,
              world_size=world)
        try:
            result = fn(device)
        except BaseException:
            failed_at = time.time()
            raise
        finally:
            if failed_at is None or backend != "nccl":
                dist.destroy_process_group()
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("error", (failed_at or time.time(), traceback.format_exc())), f)
        if backend == "nccl":  # the others may wait in a collective: leave without them
            os._exit(1)
        raise


def spawn(fn: Callable, world: int, *, backend: str, store_path, device=None,
          timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(device)`` in ``world`` new processes, rank ``r`` of a
    process group over a ``file://`` store at ``store_path`` (made anew;
    the results are written beside it), ``device`` being the rank's own
    (``mesh.process_device``; ``None``: the card). ``fn`` must be importable
    (a module-level function) and return picklable host values. Returns
    every rank's result, in rank order.

    Raises if any rank fails, with that rank's traceback, and ends the
    others; a collective that waits past ``timeout_s`` fails its rank. The
    whole run is given ``timeout_s`` plus a minute to start and finish."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("spawn() runs the ranks on the CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; one of 'gloo', 'nccl'")
    _check_cards(backend, world)
    store = Path(store_path).resolve()
    out = f"{store}.result"
    for p in [store] + [Path(f"{out}.{r}") for r in range(world)]:
        p.unlink(missing_ok=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, device, str(store), timeout_s, fn, out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s + 60
    late = False
    try:
        while any(p.is_alive() for p in procs):
            late = time.monotonic() > deadline
            if late or any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    results, errors = [], []
    for r, p in enumerate(procs):
        path = Path(f"{out}.{r}")
        if path.exists():
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            path.unlink()
        else:
            status, value = "error", (math.inf, f"exit code {p.exitcode}, no result")
        (results if status == "ok" else errors).append((r, value))
    store.unlink(missing_ok=True)
    if errors:
        r, (_, why) = min(errors, key=lambda e: e[1][0])  # the first to fail
        raise RuntimeError(f"{len(errors)} of {world} ranks failed ({backend}"
                           f"{', past the deadline' if late else ''}); rank {r}:\n{why}")
    return [v for _, v in sorted(results)]
