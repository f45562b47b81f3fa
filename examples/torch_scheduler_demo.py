"""Online multi-tenant scheduling on one fat-tree fabric, on the PyTorch port.

Two word-count tenants share the k=4 fat-tree. Run back-to-back at
tick 0 they contend for core links: the naive merge (compile each job
alone, then stream both) pays a contention premium over the solo
makespans. ``p4mr.Scheduler`` treats the fabric as an online resource —
jobs *arrive*, admission is checked against the switch-memory budget,
later jobs are compiled with penalty seeds from earlier jobs' measured
pressure, routes get a fleet-wide reroute round over merged traffic,
and plans whose measured pressure drifts from their compile-time profile
are hot-swapped through the autotuner. The demo prints the before/after,
then runs each admitted tenant's plan over its mappers' histograms on the
card (``kernel_histogram``, then ``plan.indexed().run``) and checks the
counts.

    PYTHONPATH=src python examples/torch_scheduler_demo.py                # on the card
    PYTHONPATH=src python examples/torch_scheduler_demo.py --device cpu   # on the host
"""
import argparse

import numpy as np

from repro_torch import p4mr
from repro_torch.core import topology
from repro_torch.core import wordcount as wc
from repro_torch.data.pipeline import wordcount_shards
from repro_torch.mesh import Mesh

VOCAB = 64


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the tenants' runs (default: the CUDA card)")
    return ap.parse_args(argv)


def wordcount_tenant(name: str, hosts, sink: str) -> p4mr.Job:
    job = p4mr.job(name)
    keyed = [job.store(f"s{i}", host=f"h{h}", items=VOCAB).key_by(4)
             for i, h in enumerate(hosts)]
    keyed[0].reduce("SUM", *keyed[1:], label="R").collect(sink, label="OUT")
    return job


def main(argv=None):
    args = parse_args(argv)
    sess = p4mr.Session(topology.fat_tree_topology(4))
    sched = p4mr.Scheduler(sess, objective="weighted-makespan", reroute_rounds=3)

    # tenant_a is already running; tenant_b arrives 20 ticks later with a
    # deadline and a higher weight — the SLO steers admission order and
    # reroute tie-breaks
    sched.submit(wordcount_tenant("tenant_a", range(4), "h15"), at=0)
    sched.submit(wordcount_tenant("tenant_b", range(4, 8), "h12"),
                 at=20, deadline=200, weight=2.0)

    rep = sched.run()
    print(rep.summary())
    print()

    print("before (unscheduled merge of solo-compiled plans):",
          f"{rep.unscheduled_makespan_ticks} ticks")
    print("after  (admission + seeded compile + reroute + hot-swap):",
          f"{rep.makespan_ticks} ticks "
          f"(recovered {rep.recovered_ticks}, residual contention "
          f"+{rep.contention_ticks})")
    for name in sorted(rep.arrivals):
        print(f"  {name}: arrived @{rep.arrivals[name]:g}, "
              f"finished @{rep.finish_ticks[name]} "
              f"(solo {rep.solo_makespan_ticks[name]} ticks)")
    for adm in rep.admissions:
        tag = "seeded compile" if adm.seeded else "cold compile"
        print(f"  admission[{adm.name}]: "
              f"{'admitted' if adm.admitted else 'REJECTED'} ({tag})")
    for swap in rep.hot_swaps:
        print(f"  hot-swap[{swap.name}]: drift {swap.drift:.2f}, "
              f"{'accepted' if swap.accepted else 'kept old plan'} "
              f"({swap.makespan_before} -> {swap.makespan_after} ticks)")

    # the scheduler's contract: never worse than the unscheduled merge
    assert rep.makespan_ticks <= rep.unscheduled_makespan_ticks
    # and the schedule it reports is reproducible through the session
    replay = sess.simulate(arrivals=rep.arrivals)
    assert replay.combined.makespan_ticks == rep.makespan_ticks
    print("\nreplay via sess.simulate(arrivals=...) reproduces the "
          f"scheduled makespan: {replay.combined.makespan_ticks} ticks")

    # each admitted tenant's plan, run over its own mappers' histograms; the
    # torch backend addresses switches by index, so the fat-tree plan runs
    # on its integer view (``plan.indexed()``)
    shards = wordcount_shards(total_items=8 * 1000, n_shards=8, vocab=VOCAB, seed=1)
    mesh = Mesh(("all",), (8,), device=args.device)
    hist = wc.kernel_histogram(mesh.shard(shards), VOCAB)
    for t, name in enumerate(("tenant_a", "tenant_b")):
        mine = range(4 * t, 4 * t + 4)
        inputs = {f"s{i}": hist[m] for i, m in enumerate(mine)}
        counts = sess.plans[name].indexed().run(inputs, device=args.device)["OUT"]
        want = wc.wordcount_reference([shards[m] for m in mine], VOCAB)
        assert np.array_equal(counts.astype(np.int64), want), name
        print(f"  {name}: counts on {mesh.device} == wordcount_reference "
              f"({int(want.sum())} words)")


if __name__ == "__main__":
    main()
