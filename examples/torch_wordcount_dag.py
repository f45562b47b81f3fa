"""The paper's §5.2 example on the PyTorch port, through the framework API:
``p4mr.from_source`` → ``Session.compile`` (passes: DCE, reduce-tree
rebalance, combiners; and the ``unoptimized`` preset beside it) →
``plan.run`` on the card (the world-dim ``ppermute`` step on the Fig-10
topology) and the packet simulator, plus the word-count DAG end to end
and a two-job shared-fabric simulation.

    PYTHONPATH=src python examples/torch_wordcount_dag.py                # on the card
    PYTHONPATH=src python examples/torch_wordcount_dag.py --device cpu   # on the host
"""
import argparse

import numpy as np

from repro_torch import p4mr, shuffle
from repro_torch.core import dsl, topology, wordcount


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the plans' runs (default: the CUDA card)")
    return ap.parse_args(argv)


def paper_example(device):
    print("p4mr source (§5.2):")
    src = dsl.PAPER_SOURCE + 'OUT := COLLECT(E, "h6");\n'
    print(src)

    # the 6-switch Fig-10 graph, embedded in an 8-device world dim
    sess = p4mr.Session(topology.paper_topology().as_indexed(num_devices=8))
    plan = sess.compile(p4mr.from_source(src, name="paper_5_2"))
    unopt = sess.compile(src, name="paper_flat", options="unoptimized")
    print(plan.describe(), "\n")

    ins = {"A": np.array([3.0]), "B": np.array([4.0]), "C": np.array([5.0])}

    # the packet-level simulator (host, no devices)
    sim = plan.simulate(ins)
    sim_u = unopt.simulate(ins)
    print(f"simulator: OUT={sim.outputs['OUT'][0]} "
          f"hops={sim.report.edge_hops} recirc={sim.report.recirculations} "
          f"time={sim.report.time_s * 1e6:.2f}us "
          f"(unoptimized {sim_u.report.time_s * 1e6:.2f}us)")
    assert sim.outputs["OUT"][0] == 12.0
    assert sim.report.time_s <= sim_u.report.time_s

    # the same plan on the world-dim mesh, one call
    out = plan.run(ins, device=device)
    print(f"torch backend: E = SUM(C, SUM(A, B)) in transit = {out['OUT'][0]} "
          "(expected 12.0)")
    assert out["OUT"][0] == 12.0


def wordcount_example(device):
    vocab, shards = 32, 6
    rs = np.random.RandomState(0)
    word_shards = [rs.randint(0, vocab, size=(40,)).astype(np.int32) for _ in range(shards)]
    counts, sim = wordcount.wordcount_via_plan(word_shards, vocab, device=device)
    ref = wordcount.wordcount_reference(word_shards, vocab)
    np.testing.assert_array_equal(counts, ref)
    print(f"\nword-count via CompiledPlan: {shards} shards, vocab={vocab}: "
          f"counts match oracle; makespan={sim.report.makespan_ticks} ticks, "
          f"recirc={sim.report.recirculations}")

    # the compiled in-network shuffle (lower-shuffle pass) via the fluent
    # builder: per-bucket routed edges, skew visible as wire bytes + queueing
    job = p4mr.job("wordcount-skewed")
    keyed = [
        job.store(f"s{i}", host=f"d{i}", items=vocab).key_by(4, weights=(4, 2, 1, 1))
        for i in range(shards)
    ]
    keyed[0].reduce("SUM", *keyed[1:], label="COUNTS").collect(f"d{shards - 1}", label="OUT")
    sess = p4mr.Session(topology.TorusTopology(dims=(shards,)))
    plan = sess.compile(job)
    stats = shuffle.plan_shuffle(plan)
    hists = {f"s{i}": wordcount.wordcount_reference([ws], vocab).astype(np.float64)
             for i, ws in enumerate(word_shards)}
    sim2 = plan.simulate(hists)
    np.testing.assert_array_equal(sim2.outputs["OUT"].astype(np.int64), ref)
    np.testing.assert_array_equal(plan.run(hists, device=device)["OUT"], sim2.outputs["OUT"])
    print(f"compiled shuffle: {stats.num_buckets} buckets on switches "
          f"{stats.bucket_switch}; hot bucket {stats.hot_bucket} carries "
          f"{stats.bucket_wire_bytes[stats.hot_bucket]:.0f}B of "
          f"{stats.total_wire_bytes:.0f}B; queue delay "
          f"{sim2.report.queue_delay_ticks} ticks; the same counts on the mesh")


def multi_job_example():
    # two tenants on one fat-tree: Session.simulate streams both jobs'
    # packet trains through the shared switch queues at once
    ft = topology.fat_tree_topology(4)
    sess = p4mr.Session(ft)
    for name, hosts, sink in (("tenant_a", range(4), "h15"), ("tenant_b", range(4, 8), "h12")):
        job = p4mr.job(name)
        keyed = [job.store(f"s{i}", host=f"h{h}", items=64).key_by(4)
                 for i, h in enumerate(hosts)]
        keyed[0].reduce("SUM", *keyed[1:], label="R").collect(sink, label="OUT")
        sess.compile(job)
    rep = sess.simulate()
    print(f"\nshared fabric: {rep.summary()}")
    assert rep.combined.makespan_ticks >= max(rep.solo_makespan_ticks.values())


def main(argv=None):
    args = parse_args(argv)
    paper_example(args.device)
    wordcount_example(args.device)
    multi_job_example()


if __name__ == "__main__":
    main()
