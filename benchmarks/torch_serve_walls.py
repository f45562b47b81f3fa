"""Warm serving walls of ``chip_smoke.py``'s world-dim serving paths on the
card: phase 5's ``serve_flash`` (Qwen1.5-0.5B, 8 x 4,096, 32 tokens) and
phase 9's mesh paths of qwen1.5-0.5b (gather and compute-at-data decode),
granite-moe-1b-a400m and mamba2-1.3b, each as that phase defines it
(``serve_inputs``/``serve_paths``, ``mesh_inputs``/``mesh_paths``).

    python benchmarks/torch_serve_walls.py [--tree DIR] [--repeat N]

``--tree`` takes the paths, the model code and the kernels from another
checkout's root (a parent commit unpacked with ``git archive`` into a
git-ignored directory), so that two versions are compared in one call on
one card: run parent, change, change, parent. Each path is called once cold,
then ``--repeat`` times; prints one JSON line with the card's name and power
limit and, per path, the median prefill ms and decode ms a step of the warm
calls and every call's readings. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

MESH_ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "mamba2-1.3b")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose chip_smoke.py and src/ run the paths")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_walls: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    def timed(fn) -> dict:
        calls = []
        for _ in range(1 + args.repeat):
            torch.cuda.synchronize()
            res = fn()
            torch.cuda.synchronize()
            calls.append({"prefill_ms": res["prefill_s"] * 1e3, "decode_s": res["decode_s"]})
            del res
        return calls

    out = {}
    model, prompts = cs.serve_inputs()
    (name, fn), = cs.serve_paths(model, prompts).items()
    out[name] = (timed(fn), cs.SERVE_GEN)
    del model, prompts, fn
    for arch in MESH_ARCHS:
        torch.cuda.empty_cache()
        model, mesh, batch = cs.mesh_inputs(arch)
        gen = cs.MESH_SERVE[arch][3]
        for cad in (False, True) if arch == "qwen1.5-0.5b" else (False,):
            (name, fn), = cs.mesh_paths(arch, model, mesh, batch, compute_at_data=cad).items()
            out[name] = (timed(fn), gen)
            del fn
        del model, mesh, batch
    paths = {}
    for name, (calls, gen) in out.items():
        warm = calls[1:]
        paths[name] = {
            "prefill_ms": statistics.median(c["prefill_ms"] for c in warm),
            "decode_ms_per_step": statistics.median(c["decode_s"] * 1e3 / (gen - 1) for c in warm),
            "calls_decode_ms_per_step": [c["decode_s"] * 1e3 / (gen - 1) for c in calls],
            "calls_prefill_ms": [c["prefill_ms"] for c in calls]}
    print(json.dumps({"tree": str(tree), "device": smi, "repeat": args.repeat, "paths": paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
