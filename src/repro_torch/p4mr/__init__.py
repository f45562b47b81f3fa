"""repro_torch.p4mr — the framework API the paper names (§5: "a parallel
programming framework to help users efficiently program multiple
switches"), as far as the port carries it.

* **Build** — ``p4mr.job()`` starts a fluent dataflow builder
  (``Dataset.map(...).key_by(...).reduce("SUM").collect(...)``) that
  constructs ``dag.Program``s directly; ``from_source`` /
  ``Job.to_source()`` round-trip with the paper's surface syntax.
* **Compile and run** — ``repro_torch.compiler.compile(job.program(),
  topology, passes=...)`` and ``plan.run(inputs, backend="torch")``.

    from repro_torch import compiler, p4mr
    from repro_torch.core.topology import TorusTopology

    job = p4mr.job("wordcount")
    s = [job.store(f"s{i}", host=f"d{i}", items=64) for i in range(8)]
    s[0].reduce("SUM", *s[1:], label="COUNTS").collect("d0")

    plan = compiler.compile(job.program(), TorusTopology(dims=(8,)),
                            passes=compiler.UNOPTIMIZED_PASSES)
    counts = plan.run(histograms, backend="torch")   # == "reference"

``Session`` and ``Scheduler`` come with later slices of the port
(ROADMAP.md, queue 1 item 5 onward).
"""
from repro_torch.p4mr.builder import Dataset, Job, from_program, from_source, job

__all__ = [
    "Dataset",
    "Job",
    "from_program",
    "from_source",
    "job",
]
