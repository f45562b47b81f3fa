"""repro_torch.p4mr — the framework API the paper names (§5: "a parallel
programming framework to help users efficiently program multiple
switches"), as far as the port carries it.

* **Build** — ``p4mr.job()`` starts a fluent dataflow builder
  (``Dataset.map(...).key_by(...).reduce("SUM").collect(...)``) that
  constructs ``dag.Program``s directly; ``from_source`` /
  ``Job.to_source()`` round-trip with the paper's surface syntax.
* **Compile** — ``Session`` owns topology + ``CostModel`` + typed
  ``CompileOptions`` (presets ``unoptimized`` / ``static_ecmp`` /
  ``default`` / ``autotuned`` over the registered pass pipelines) and
  compiles many jobs against one fabric.
* **Execute** — every backend behind one call:
  ``plan.run(inputs)`` on the card (``backend="torch"``, the default), or
  on the host by name (``backend="simulate" | "reference"``); and
  ``session.simulate()`` streams *all* registered jobs' packet trains
  through the shared switches at once (multi-tenant contention).
* **Serve** — ``Scheduler`` runs the session online: jobs arrive at
  submit ticks, pass ``FabricBudget`` admission control, are compiled
  against the measured pressure of resident traffic, ordered by an SLO
  objective, and hot-swapped when queue pressure drifts. The resulting
  schedule is never worse than the unscheduled merge.

    from repro_torch import p4mr
    from repro_torch.core.topology import TorusTopology

    job = p4mr.job("wordcount")
    mapped = [job.store(f"s{i}", host=f"d{i}", items=64).key_by(8)
              for i in range(8)]
    mapped[0].reduce("SUM", *mapped[1:], label="COUNTS").collect("d0")

    sess = p4mr.Session(TorusTopology(dims=(8,)))
    plan = sess.compile(job)
    counts = plan.run(histograms)   # on the card; == backend="simulate" on the host
"""
from repro_torch.p4mr.builder import Dataset, Job, from_program, from_source, job
from repro_torch.p4mr.scheduler import (
    Admission,
    FabricBudget,
    HotSwap,
    JobRequest,
    ScheduleReport,
    Scheduler,
)
from repro_torch.p4mr.session import CompileOptions, Session, SessionReport, merge_plans

__all__ = [
    "Admission",
    "CompileOptions",
    "Dataset",
    "FabricBudget",
    "HotSwap",
    "Job",
    "JobRequest",
    "ScheduleReport",
    "Scheduler",
    "Session",
    "SessionReport",
    "from_program",
    "from_source",
    "job",
    "merge_plans",
]
