#!/usr/bin/env python3
"""Which part of the bf16 ``flash_attention`` kernel holds its time (one GPU).

    PYTHONPATH=src python3 benchmarks/flash_ablation.py

Builds variants of ``src/repro_torch/csrc/flash_attention.cu``, each with a
part of the work taken out, and times each at the serve prefill's shape (q,
k, v (8, 16, 4096, 64) bf16 views of (b, s, h, d), causal) with CUDA events,
20 launches after 3 warm-ups. A variant's output is wrong by design; only
``full`` is held to the plain version (worst output row, normwise). The
variants:

    full           the kernel as it is
    no_softmax     no mask, max, exponentials or row sums (P = S as it came)
    no_exp         the softmax without its exponentials
    no_fma_exp     every exponential on the multi-function unit (none on ex2_fma)
    no_products    neither wgmma product (S stays zero); loads and softmax run
    no_loads       K/V loaded for the first ring of stages only
    products_only  no softmax and no loads after the first ring

The variants are made by exact-text edits of a copy of the source, each
asserted, so an edit that no longer applies fails loudly. Builds go to
``build/ablation/``. Ends with the card's name and power limit. Needs a
CUDA device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "ablation"
SHAPE = (8, 4096, 16, 64)  # (b, s, h, d): the serve prefill's

# flag -> (text in the source, text that replaces it)
EDITS = {
    "NO_SOFTMAX": ("  auto softmax = [&](int j) {  // s: raw scores of tile j -> unnormalised p\n",
                   "  auto softmax = [&](int j) {  // s: raw scores of tile j -> unnormalised p\n"
                   "#ifdef NO_SOFTMAX\n    alpha[0] = alpha[1] = 1.f;\n    return;\n#endif\n"),
    "NO_EXP": ("        s[4 * c + e] = (c % kPolyEvery == kPolyEvery - 1) ? ex2_fma(x) : ex2(x);",
               "#if defined(NO_EXP)\n        s[4 * c + e] = x;\n#elif defined(NO_FMA_EXP)\n"
               "        s[4 * c + e] = ex2(x);\n#else\n"
               "        s[4 * c + e] = (c % kPolyEvery == kPolyEvery - 1) ? ex2_fma(x) : ex2(x);\n"
               "#endif"),
    "NO_PRODUCTS": ("  auto issue_qk = [&](int st) {\n",
                    "  auto issue_qk = [&](int st) {\n#ifdef NO_PRODUCTS\n    wgmma_commit();\n"
                    "    return;\n#endif\n"),
    "NO_PRODUCTS_PV": ("  auto issue_pv = [&](int st) {\n",
                       "  auto issue_pv = [&](int st) {\n#ifdef NO_PRODUCTS\n    wgmma_commit();\n"
                       "    return;\n#endif\n"),
    "NO_LOADS": ("        if (j >= S) mbar_wait(empty(st), ((j / S) - 1) & 1);  // both warpgroups are done with it\n",
                 "        if (j >= S) mbar_wait(empty(st), ((j / S) - 1) & 1);  // both warpgroups are done with it\n"
                 "#ifdef NO_LOADS\n        if (j >= S) {\n          mbar_arrive(k_full(st));\n"
                 "          mbar_arrive(v_full(st));\n          continue;\n        }\n#endif\n"),
}
VARIANTS = {
    "full": [], "no_softmax": ["NO_SOFTMAX"], "no_exp": ["NO_EXP"], "no_fma_exp": ["NO_FMA_EXP"],
    "no_products": ["NO_PRODUCTS"], "no_loads": ["NO_LOADS"],
    "products_only": ["NO_SOFTMAX", "NO_LOADS"],
}


def variant_source() -> Path:
    text = SRC.read_text()
    for flag, (old, new) in EDITS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"edit {flag} no longer applies to {SRC.name}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "flash_attention_ablation.cu"
    path.write_text(text)
    return path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref

    nvcc = _build._nvcc()
    src = variant_source()
    procs = {}
    for name, flags in VARIANTS.items():
        lib = OUT / f"lib{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *(f"-D{f}" for f in flags), "-o", str(lib), str(src),
               *_build._libcuda_link_flags(nvcc)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    g = torch.Generator().manual_seed(1)
    b, s, h, d = SHAPE
    q, k, v = (torch.randn(SHAPE, generator=g).to("cuda", torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    out = torch.empty_like(q)
    want = ref.flash_attention(q, k, v, causal=True).double()
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int

        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, h, h, s, s,
                     d, *strides, 1, d ** -0.5, stream)
            if err != 0:
                raise RuntimeError(f"variant {name}: launch error {err}")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        line = f"{name:14s} {start.elapsed_time(end) / 20:.4f} ms"
        if name == "full":
            got = out.double()
            line += f"  (worst row vs plain {float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max()):.3e})"
        regs = [x.split(":")[-1].strip() for x in log.splitlines() if "Used" in x]
        print(f"{line}  ptxas: {regs[-2:]}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
