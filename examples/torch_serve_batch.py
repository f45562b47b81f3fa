"""Batched serving on the port: prefill + greedy decode of a small hybrid
model (RG-LRU recurrences + local attention) for a batch of requests.

The port of ``examples/serve_batch.py``: recurrentgemma's reduced smoke
config, 8 prompts of 32 tokens, 12 generated tokens each, through
``python -m repro_torch.launch.serve``'s ``run``. The local-attention layers
keep a rolling window cache and the recurrent layers their state.

    PYTHONPATH=src python examples/torch_serve_batch.py                # on the card
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu   # on the host
"""
import argparse

from repro_torch.launch.serve import parser, run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the model and its cache (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args_in = parse_args(argv)
    args = parser().parse_args([
        "--arch", "recurrentgemma-2b", "--smoke",
        "--batch", "8", "--prompt-len", "32", "--gen", "12",
    ] + (["--device", args_in.device] if args_in.device else []))
    gen = run(args)
    if gen.shape != (8, 12):
        raise SystemExit(f"generated {gen.shape}, not (8, 12)")
    print("OK: hybrid (RG-LRU + local attention) model served with a rolling window cache "
          "and recurrent state.")


if __name__ == "__main__":
    main()
