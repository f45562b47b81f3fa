"""Quickstart on the PyTorch port: Word-Count offloaded to the 'data plane'
(§2, Fig 1), written against the framework API the paper names —
``repro_torch.p4mr``.

A fluent ``Job`` declares the Map-Reduce dataflow (stores → KEYBY hash
routing → one SUM the compiler splits into per-bucket in-network
reducers), a ``Session`` owns the fabric + cost model and compiles it,
and ``plan.run(inputs)`` executes the plan on the card: the mapper
histograms come from the ``segment_reduce`` kernel (``kernel_histogram``)
and the plan's hops are ``ppermute``s over the world-dim mesh. The same
plan on the host backends (the streaming packet simulator and the
reference oracle) and the mesh word count (``wordcount_step``) give the
same counts, bit for bit.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # on the host
"""
import argparse
import warnings

import numpy as np

from repro_torch import p4mr
from repro_torch.core import wordcount as wc
from repro_torch.core.scenarios import Scenario, wire_bytes_per_device
from repro_torch.core.topology import TorusTopology
from repro_torch.data.pipeline import wordcount_shards
from repro_torch.mesh import Mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the plan's run (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    n_servers, vocab = 8, 64
    shards = wordcount_shards(total_items=8 * 1000, n_shards=n_servers, vocab=vocab)

    # 1. declare the dataflow: no DSL text, no label bookkeeping
    job = p4mr.job("wordcount")
    mapped = [
        job.store(f"s{i}", host=f"d{i}", items=vocab).key_by(n_servers)
        for i in range(n_servers)
    ]
    mapped[0].reduce("SUM", *mapped[1:], label="COUNTS").collect("d0", label="OUT")
    # the fluent form and the paper's surface syntax are interchangeable:
    assert p4mr.from_source(job.to_source()).program() == job.program()

    # 2. compile on a fabric: Session owns topology + CostModel + options
    sess = p4mr.Session(TorusTopology(dims=(n_servers,)))
    plan = sess.compile(job)
    print(f"compiled: {len(plan.program)} nodes, {plan.routes.total_hops} wire hops")

    # 3. the mapper histograms on the device, one segment_reduce launch
    mesh = Mesh(("net",), (n_servers,), device=args.device)
    words = mesh.shard(shards)
    hist = wc.kernel_histogram(words, vocab)
    counts = plan.run({f"s{i}": hist[i] for i in range(n_servers)}, device=args.device)["OUT"]
    oracle = wc.wordcount_reference(shards, vocab)
    assert np.array_equal(counts.astype(np.int64), oracle), "plan.run != oracle"

    # the same plan on the host backends, from numpy histograms
    host = {f"s{i}": wc.wordcount_reference([ws], vocab).astype(np.float64)
            for i, ws in enumerate(shards)}
    for backend in ("simulate", "reference"):
        assert np.array_equal(plan.run(host, backend=backend)["OUT"], counts), backend
    print(f"word-count via p4mr.job → Session → plan.run on {mesh.device}: OK "
          "(== simulate == reference == oracle)")
    top = np.argsort(-oracle)[:5]
    print("top words:", [(int(w), int(oracle[w])) for w in top])

    # the mesh word count (deprecated shim over shuffle.spmd) gives the
    # same counts
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mesh_counts = wc.wordcount_step(words, vocab, mesh, "net",
                                        histogram_fn=wc.kernel_histogram)
    assert np.array_equal(mesh_counts.reshape(-1).cpu().numpy().astype(np.int64), oracle)
    print("mesh wordcount_step matches the compiled plan bit for bit")

    # cost of the endpoint alternative (Scenario 1): every device receives
    # every histogram — p× the wire bytes of the in-transit version.
    nbytes = vocab * 4
    print(f"wire bytes/device  S1(endpoint)={wire_bytes_per_device(nbytes, 8, Scenario.S1_HOST):.0f}"
          f"  S2(in-transit)={wire_bytes_per_device(nbytes, 8, Scenario.S2_IN_NET):.0f}")


if __name__ == "__main__":
    main()
