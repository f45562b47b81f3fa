"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launcher and compiles on its own
into ``build/lib<name>.so`` at the repository root, for ``sm_90a`` (Hopper).
The first call builds every source that is missing or older than its
``.cu``, one ``nvcc`` process per source, all started together. Nothing is
built when this module is imported, so the CPU-only tests can import the
whole package. Every source also links ``libcuda`` (``-lcuda``, through
the toolkit's stub library where the system's own is not on the linker's
path): ``flash_attention`` calls ``cuTensorMapEncodeTiled`` for its TMA
descriptors.

Processes that build at once (the ranks of a process mesh) take turns on a
file lock under ``build/``: the first compiles, the others find nothing
stale and only load. Build in the parent before spawning the ranks.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NAMES = ("hash_partition", "segment_reduce", "ring_fused_step", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _libcuda_link_flags(nvcc: str) -> list[str]:
    """Flags that link libcuda: the toolkit's stub library resolves the
    symbols at build time, and the system's ``libcuda.so.1`` at load."""
    stubs = Path(nvcc).resolve().parent.parent / "lib64" / "stubs"
    return ([f"-L{stubs}"] if stubs.is_dir() else []) + ["-lcuda"]


@contextlib.contextmanager
def _build_lock():
    """This process's turn to build: a thread lock, then an exclusive lock
    on ``build/.lock`` that other processes wait on."""
    with _lock:
        BUILD.mkdir(parents=True, exist_ok=True)
        with open(BUILD / ".lock", "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def _stale(name: str) -> bool:
    lib = BUILD / f"lib{name}.so"
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build_all() -> float:
    """Compile every stale kernel source in parallel; return the seconds it
    took. The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept in ``build/<name>.log``. Raises, with every failing log,
    if any source does not compile."""
    with _build_lock():
        todo = [n for n in NAMES if _stale(n)]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            tmp = BUILD / f"lib{name}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
                   *_libcuda_link_flags(nvcc)]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            (BUILD / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, BUILD / f"lib{name}.so")
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
