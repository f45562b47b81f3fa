"""MoE token dispatch is the paper's Word-Count (map → shuffle → reduce),
on the port.

Runs the granite-moe smoke model's MoE layer two ways on one device:
dispatched (dropless: the router maps each token to its top-k experts, a
sort by expert shuffles the rows together, each expert runs on its own
rows, and ``segment_reduce`` reduces the gate-weighted rows into their
tokens: the reducer kernel on the card) and replicated (every expert on
every token, masked by its gate: the endpoint baseline). The two compute
the same function, within the reference example's 2e-2; the example
prints the bytes of token rows that each moves to its experts and back
(bf16 rows of d_model), and the FLOPs each computes
(``analysis.roofline.cost_vector``).
The port of ``examples/moe_dispatch.py``, whose ``a2a`` shuffle across 4
devices is the dispatched form here on one.

    PYTHONPATH=src python examples/torch_moe_dispatch.py                # on the card
    PYTHONPATH=src python examples/torch_moe_dispatch.py --device cpu   # on the host
"""
import argparse
import dataclasses

import torch

from repro_torch.analysis.roofline import cost_vector
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.mesh import resolve_device
from repro_torch.models.moe import MoE


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the layer (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    dev = resolve_device(parse_args(argv).device, "torch_moe_dispatch")
    cfg0 = get_smoke_config("granite_moe_1b_a400m")
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, capacity_factor=8.0, router_aux_weight=0.0))
    g = torch.Generator(device=dev).manual_seed(0)
    layer = MoE(cfg, g, dev)
    layer.cast_weights()
    x = torch.randn((2, 16, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)

    with torch.no_grad():
        ops.reset_launches()
        yd = layer(x)  # dispatched
        launches = ops.LAUNCHES["segment_reduce"]
        yr = layer(x, decode=True)  # replicated
        flops = {"dispatched": cost_vector(lambda: layer(x))[0],
                 "replicated": cost_vector(lambda: layer(x, decode=True))[0]}
    err = float((yd.float() - yr.float()).abs().max() / (yr.float().abs().max() + 1e-9))
    print(f"dispatched (word-count shuffle, combine on segment_reduce) vs replicated "
          f"(endpoint): rel err {err:.2e}")
    if not err < 2e-2:
        raise SystemExit(f"the two forms differ: {err}")
    n_tok, m = x.shape[0] * x.shape[1], cfg.moe
    rows = {"dispatched": n_tok * m.top_k, "replicated": n_tok * m.n_experts}
    print(f"{n_tok} tokens x top-{m.top_k} of {m.n_experts} experts")
    for name, n in rows.items():  # each row to its expert and its output back, bf16
        print(f"  {name:10s}: {n:4d} rows, {2 * n * cfg.d_model * 2 / 1e3:7.1f} kB moved, "
              f"{flops[name] / 1e6:6.2f} MFLOP")
    print(f"segment_reduce kernel launches: {launches} (0 on the host: its plain version runs)")
    print("OK: expert dispatch ran as a map → shuffle → reduce.")


if __name__ == "__main__":
    main()
