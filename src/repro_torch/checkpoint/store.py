"""Checkpoints on disk, in the JAX package's layout (``repro/checkpoint/
store.py``), so that either package restores the other's.

Layout::

    <dir>/step_<k:08d>/
        manifest.json        # {"step", "meta", "leaves": {path: {"file", "shape", "dtype"}}}
        <path with / → __>.npy   # one whole (global) array per leaf

A tree is a nested dict (or list, tuple, NamedTuple) of leaves: tensors on
any device, numpy arrays or numpy scalars; a leaf's path is its keys joined
by "/" (a tuple's fields by index, as the reference flattens
``OptState(count, m, v)``). ``save`` publishes a step by an atomic rename of
a temporary directory, then keeps the newest ``keep`` steps. Leaves are
written whole, so a job restarts on a smaller data world: restore puts
every leaf on one device and the caller cuts what it needs.

bf16 leaves without ``ml_dtypes``: numpy has no bf16 of its own. The
reference's ``np.save`` of an ``ml_dtypes.bfloat16`` array writes the
2-byte words under the descriptor ``'<V2'`` with ``"dtype": "bfloat16"`` in
the manifest; the port writes the same header and words from the tensor's
bits, and reads such a file back as those words viewed as bf16. Either
package's bf16 file loads bitwise in the other (the reference's own
``np.load`` returns the words as a ``V2`` array).

Async save: ``save(..., blocking=False)`` takes a snapshot into host memory
before it returns (a copy: the caller may update its tensors in place at
once; a copy from the card goes to pinned memory without blocking, and one
synchronise ends it) and writes the files on a background thread;
``wait()`` joins the writes and raises the first error a write met.
``stats`` keeps each save's step, bytes, snapshot ms and write ms.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.mesh import resolve_device

BF16_DESCR = "<V2"  # np.save's descriptor of an ml_dtypes.bfloat16 array


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(template, flat: dict):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], {kk[len(k) + 1:]: v for kk, v in flat.items()
                                                 if kk == k or kk.startswith(k + "/")})
                for k in template}
    if isinstance(template, (list, tuple)) and not hasattr(template, "shape"):
        vals = [_unflatten_into(v, {kk[len(str(i)) + 1:]: vv for kk, vv in flat.items()
                                    if kk == str(i) or kk.startswith(f"{i}/")})
                for i, v in enumerate(template)]
        return type(template)(*vals) if hasattr(template, "_fields") else type(template)(vals)
    if "" not in flat:
        raise KeyError("the checkpoint has no leaf for a leaf of the template")
    leaf = flat[""]
    if hasattr(template, "shape") and tuple(template.shape) != tuple(leaf.shape):
        raise ValueError(f"checkpoint leaf {tuple(leaf.shape)}, the template wants "
                         f"{tuple(template.shape)}")
    return leaf


def _snapshot(v):
    """A leaf → a host copy that no later in-place update reaches: a
    tensor on the card into pinned memory without blocking (the caller
    synchronises), any other tensor or array cloned."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.device.type == "cuda":
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            return host.copy_(v, non_blocking=True)
        return v.to("cpu", copy=True).contiguous()
    return np.array(v, copy=True)


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return "bfloat16" if v.dtype == torch.bfloat16 else str(v.numpy().dtype)
    return str(v.dtype)


def _write_leaf(path: str, v) -> None:
    """One leaf as ``.npy``: ``np.save`` of its numpy form, or for bf16 the
    reference's header (``'<V2'``) and the tensor's 2-byte words."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
        words = v.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False, "shape": tuple(words.shape)})
            f.write(memoryview(words).cast("B"))
        return
    np.save(path, v.numpy() if isinstance(v, torch.Tensor) else v)


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class CheckpointStore:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pending: list[threading.Thread] = []
        self._errors: list[Exception] = []
        self.stats: list[dict] = []

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, *, meta: dict | None = None,
             blocking: bool = True) -> str:
        """Write ``tree`` as step ``step``; returns the step's directory.
        With ``blocking=False`` it returns once the snapshot is taken."""
        t0 = time.perf_counter()
        flat = _flatten(tree)
        host = {k: _snapshot(v) for k, v in flat.items()}
        if any(isinstance(v, torch.Tensor) and v.is_pinned() for v in host.values()):
            torch.cuda.synchronize()
        stat = {"step": step, "snapshot_ms": (time.perf_counter() - t0) * 1e3,
                "bytes": sum(v.element_size() * v.numel() if isinstance(v, torch.Tensor)
                             else v.nbytes for v in host.values())}
        self.stats.append(stat)
        path = os.path.join(self.directory, f"step_{step:08d}")

        def write():
            t = time.perf_counter()
            tmp = f"{path}.tmp{os.getpid()}_{threading.get_ident()}"
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "meta": meta or {}, "leaves": {}}
            for k, v in host.items():
                fn = k.replace("/", "__") + ".npy"
                _write_leaf(os.path.join(tmp, fn), v)
                manifest["leaves"][k] = {"file": fn, "shape": list(v.shape),
                                         "dtype": _dtype_name(v)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)  # atomic publish
            self._gc()
            stat["write_ms"] = (time.perf_counter() - t) * 1e3

        def write_async():
            try:
                write()
            except Exception as e:  # raised again by wait()
                self._errors.append(e)

        if blocking:
            write()
        else:
            th = threading.Thread(target=write_async, daemon=True)
            th.start()
            self._pending.append(th)
        return path

    def wait(self) -> None:
        """Join every pending write; raise the first error one met."""
        for th in self._pending:
            th.join()
        self._pending.clear()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise RuntimeError("an asynchronous checkpoint write failed") from err

    def _gc(self) -> None:
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def list_steps(self) -> list[int]:
        """The published steps, ascending (unfinished ``.tmp`` directories
        are not steps)."""
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int | None = None) -> dict:
        """The manifest of ``step`` (the latest by default)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self.directory, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f)

    def restore(self, template: Any = None, *, step: int | None = None,
                device=None) -> tuple[Any, dict]:
        """(tree, manifest) of ``step`` (the latest by default), every leaf a
        tensor on ``device`` (``None``: the card) in its saved dtype. With a
        ``template`` the leaves are put into its structure (a template leaf
        with a shape must match); without, the tree is flat ({path: leaf})."""
        manifest = self.manifest(step)
        dev = resolve_device(device, "CheckpointStore.restore()")
        path = os.path.join(self.directory, f"step_{manifest['step']:08d}")
        flat = {k: _read_leaf(os.path.join(path, info["file"]), info["dtype"]).to(dev)
                for k, info in manifest["leaves"].items()}
        return (flat if template is None else _unflatten_into(template, flat)), manifest
