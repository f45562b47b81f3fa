#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main paths (one GPU).

    PYTHONPATH=src python3 benchmarks/torch_path_profile.py

Runs each main path of ``chip_smoke.py`` (its ``inputs`` and ``main_paths``,
the same full size; then ``recurrence_inputs`` and ``recurrence_paths``, the
sharded scan and the pipeline), then the serving prefill (``serve_inputs`` and
``prefill_paths``: Qwen1.5-0.5B at full width, 8 × 4096 tokens, attention
through ``flash_attention``), each once to warm up, then twice under ``torch.profiler``
(CPU + CUDA activity), each call inside a ``record_function`` window that
ends after ``torch.cuda.synchronize()``. From the second window of that one
trace it prints, per path: the window (call to synchronized end), the
device span (first to last device timestamp), the device busy time (the
union of all kernel, copy and set intervals), the idle share
1 - busy / window, the device time by kind of kernel (the port's, cuBLAS
matmuls, other), and the top kernels by device time. A trace whose busy
time exceeds its window raises. Ends with the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOP = 12  # kernels listed per path
WINDOW = "path_window"
# device time by kind of kernel, from the kernel's name: the port's own
# kernels, cuBLAS matrix products, and everything else (elementwise passes,
# reductions, copies, sorts)
KINDS = (("port kernels", ("flash_", "segment_", "hash_partition",
                           "ring_fused_step")),
         ("matmuls (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "cublas")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("torch_path_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke

    def paths():
        _, words, _, grads = chip_smoke.inputs()
        yield from chip_smoke.main_paths(words, grads).items()
        yield from chip_smoke.recurrence_paths(*chip_smoke.recurrence_inputs()).items()
        yield from chip_smoke.prefill_paths(*chip_smoke.serve_inputs()).items()

    cuda = torch.autograd.DeviceType.CUDA
    for name, fn in paths():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the first traced call pays the tracer's own start-up on the host
            # (milliseconds before its first launch): trace two, read the second
            for _ in range(2):
                with record_function(WINDOW):
                    fn()
                    torch.cuda.synchronize()
        events = prof.events()
        windows = sorted((e.time_range.start, e.time_range.end) for e in events
                         if e.name == WINDOW and e.device_type != cuda)
        if len(windows) != 2:
            raise RuntimeError(f"{name}: {len(windows)} host windows in the trace, not 2")
        w0, w1 = windows[1]
        # device activity of the second call: kernels, copies and sets; not
        # the windows' own device-side annotations
        device = [e for e in events if e.device_type == cuda and e.name != WINDOW
                  and not getattr(e, "is_user_annotation", False)
                  and e.time_range.start >= w0]
        if not device:
            print(f"== {name}: window {(w1 - w0) / 1e3:.3f} ms; the profiler saw no device activity")
            continue
        spans = [(e.time_range.start, e.time_range.end) for e in device]
        busy = busy_us(spans)
        d0, d1 = min(s for s, _ in spans), max(e for _, e in spans)
        if busy > w1 - w0:
            raise RuntimeError(f"{name}: device busy {busy:.1f} us exceeds the window "
                               f"{w1 - w0:.1f} us: the trace's clocks disagree")
        print(f"== {name}: window {(w1 - w0) / 1e3:.3f} ms, device span {(d1 - d0) / 1e3:.3f} ms, "
              f"device busy {busy / 1e3:.3f} ms, idle share {1 - busy / (w1 - w0):.3f}; "
              f"first device event {(d0 - w0) / 1e3:.3f} ms into the window, "
              f"last ends {(w1 - d1) / 1e3:.3f} ms before its end")
        per_kernel: dict[str, list] = {}
        for e in device:
            k = per_kernel.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.end - e.time_range.start
            k[1] += 1
        by_kind: dict[str, float] = {}
        for kname, (us, _) in per_kernel.items():
            by_kind[kind_of(kname)] = by_kind.get(kind_of(kname), 0.0) + us
        print("   by kind: " + ", ".join(f"{k} {us / 1e3:.3f} ms" for k, us in
                                        sorted(by_kind.items(), key=lambda kv: -kv[1])))
        for kname, (us, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
            print(f"   {us / 1e3:9.3f} ms  x{count:<4d} {kname[:90]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
