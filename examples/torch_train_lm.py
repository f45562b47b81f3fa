"""End-to-end LM training with in-network gradient aggregation, on the port.

Trains qwen1.5's reduced smoke config on a data world of 8 ranks held on
one device, with the paper's Scenario-2 aggregation (ring reduce-scatter,
reduce in transit) of every leaf's gradient along its FSDP dim, and AdamW;
the loss drops as the model learns the synthetic Markov structure of
``TrainPipeline``'s tokens. ``--scenario s3_in_net_map`` puts bf16 on the
wire (each hop one ``ring_fused_step`` launch on the card). Checkpoints and
the elastic restart of the reference's example wait for the port of
``checkpoint/`` (ROADMAP 5(c)).

    PYTHONPATH=src python examples/torch_train_lm.py                # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu   # on the host
"""
import argparse
import math

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import parser, run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--scenario", default="s2_in_net")
    ap.add_argument("--device", default=None,
                    help="torch device for the model and its data world (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args_in = parse_args(argv)
    args = parser().parse_args([
        "--arch", "qwen1.5-0.5b", "--smoke", "--steps", str(args_in.steps),
        "--mesh", "8,1", "--scenario", args_in.scenario,
        "--global-batch", "16", "--seq", "64", "--microbatches", "2", "--log-every", "10",
    ] + (["--device", args_in.device] if args_in.device else []))
    losses = run(args)
    print(f"\nfirst-5 loss {np.mean(losses[:5]):.4f} -> last-5 {np.mean(losses[-5:]):.4f} "
          f"(ln V = {math.log(get_smoke_config('qwen1.5-0.5b').vocab):.3f})")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise SystemExit("did not learn")
    print(f"OK: gradients were aggregated in transit ({args_in.scenario}) throughout.")


if __name__ == "__main__":
    main()
