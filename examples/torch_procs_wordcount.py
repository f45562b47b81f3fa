"""The paper's Map-Reduce and the §4 aggregation on a process mesh: one
``torch.distributed`` process per mesh device, each holding only its own
shard (``repro_torch.mesh.ProcessMesh``), under ``torchrun``:

    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch_procs_wordcount.py --backend gloo
    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch_procs_wordcount.py --backend gloo --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_procs_wordcount.py --backend nccl

Under gloo the ranks may share one card: every collective then copies its
operands through pinned host memory. Under nccl (``--backend nccl``) each
rank needs a card of its own, and the launch raises with fewer.

Every rank makes the same word lists and gradients from ``--seed`` and
keeps its own shard. The word count runs in both forms (each mapper's
``segment_reduce`` histogram shuffled to its reducer; raw words routed by
``hash_partition`` and counted where they land), and ``aggregate`` under
every scenario (HIERARCHICAL on a (2, world / 2) view of the same ranks).
Each rank checks its share against the host's counts and float64 mean;
rank 0 prints the results.
"""
import argparse
import os
import warnings

import numpy as np
import torch

from repro_torch.core import scenarios
from repro_torch.core import wordcount as wc
from repro_torch.data.pipeline import wordcount_shards
from repro_torch.launch.procs import init_process_mesh
from repro_torch.mesh import ProcessMesh

AGG_TOL = {"s3_in_net_map": 3e-2}  # bf16 on the wire; the others 1e-5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="gloo (CPU tensors, or ranks sharing a card through host copies) "
                         "or nccl (one card per rank)")
    ap.add_argument("--device", default=None,
                    help="torch device of the shards (default: the CUDA card)")
    ap.add_argument("--tokens", type=int, default=2**16, help="words per mapper")
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--grad", type=int, default=100_000, help="gradient elements per rank")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    world = int(os.environ["WORLD_SIZE"])
    mesh = init_process_mesh((world,), ("all",), backend=args.backend, device=args.device)
    data = ProcessMesh(("data",), (world,), device=mesh.device)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"{world} ranks over {mesh.transport}, each on {mesh.device}")

    shards = wordcount_shards(world * args.tokens, world, args.vocab, seed=args.seed)
    want = wc.wordcount_reference(shards, args.vocab)
    mine = want.reshape(world, -1)[mesh.rank]  # the words this rank reduces
    words = mesh.shard(shards)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        hist = wc.wordcount_step(words, args.vocab, mesh, "all", histogram_fn=wc.kernel_histogram)
    counts, _ = wc.wordcount_token_shuffle(words, args.vocab, mesh, "all")
    # the token path: each rank counts the words of its hash bucket
    total = mesh.psum(counts.to(torch.int64), "all").reshape(-1).cpu().numpy()
    flags = torch.tensor([[np.array_equal(hist.reshape(-1).cpu().numpy(), mine),
                           np.array_equal(total, want)]], dtype=torch.int32, device=mesh.device)
    ok = mesh.pmin(flags, "all").reshape(-1).tolist()  # every rank's checks
    say(f"word count, {world} x {args.tokens} words of {args.vocab}: histogram shuffle "
        f"{'==' if ok[0] else 'DIFFERS from'} the host's counts, token shuffle "
        f"{'==' if ok[1] else 'DIFFERS from'} the host's counts; top words "
        f"{want.argsort()[::-1][:5].tolist()}")

    g = np.random.default_rng(args.seed).standard_normal((world, args.grad), dtype=np.float32)
    mean = torch.from_numpy(g.mean(0, dtype=np.float64)).to(mesh.device)
    grads = data.shard(g)
    runs = {sc: (grads, data, {}) for sc in ("s1_host", "s2_in_net", "s3_in_net_map", "native")}
    if world % 2 == 0:
        pods = ProcessMesh(("pod", "data"), (2, world // 2), device=mesh.device)
        runs["hierarchical"] = (pods.shard(g.reshape(2, world // 2, -1)), pods, {"pod_axis": "pod"})
    beyond = []
    for sc, (x, m, kw) in runs.items():
        out = scenarios.aggregate(x, m, sc, data_axis="data", **kw)
        err = (out.reshape(-1).double() - mean).abs().max().view(m.block)
        err = float(m.pmax(err, m.axis_names).reshape(-1)[0])  # the worst rank's
        tol = AGG_TOL.get(sc, 1e-5)
        if err > tol + tol * float(mean.abs().max()):
            beyond.append(sc)
        say(f"aggregate {sc}: {world} x {args.grad} fp32, max abs err vs the float64 mean "
            f"{err:.3g} ({'BEYOND' if sc in beyond else 'within'} {tol})")
    torch.distributed.destroy_process_group()
    if not all(ok) or beyond:
        raise SystemExit(f"the process mesh differs from the host: word counts {ok}, "
                         f"aggregation beyond its tolerance {beyond}")


if __name__ == "__main__":
    main()
