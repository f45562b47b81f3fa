"""Fluent dataflow builder — p4mr programs without DSL text or JSON AST.

The paper's surface syntax (§5.2) is one frontend; this is the other:
a ``Job`` accumulates IR nodes directly into a ``dag.Program`` while the
user chains transformations off ``Dataset`` handles, so a Map-Reduce
pipeline reads as dataflow instead of label bookkeeping:

    job = p4mr.job("wordcount")
    mapped = [
        job.store(f"s{i}", host=f"d{i}", items=vocab).key_by(buckets)
        for i in range(n)
    ]
    mapped[0].reduce("SUM", *mapped[1:], label="COUNTS").collect("d0")

Both frontends meet in the same IR: ``Job.to_source()`` prints the
program as DSL text and ``from_source`` parses DSL text into a ``Job``,
so builder-constructed jobs round-trip through the surface syntax (and
vice versa) to equal ``dag.Program``s. The one asymmetry is declared
``KeyBy.weights`` skew: floats have no surface spelling, so weights are
API-only and drop out of ``to_source`` (documented in ``core.dsl``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import dag, dsl, primitives as prim

_REDUCE_KINDS = {k.value: k for k in prim.ReduceKind}


def _as_kind(kind: "str | prim.ReduceKind") -> prim.ReduceKind:
    if isinstance(kind, prim.ReduceKind):
        return kind
    try:
        return _REDUCE_KINDS[str(kind).lower()]
    except KeyError:
        raise ValueError(
            f"unknown reduce kind {kind!r}; one of {sorted(_REDUCE_KINDS)} "
            "(case-insensitive) or a primitives.ReduceKind"
        ) from None


class Job:
    """A p4mr program under construction (the fluent-builder frontend).

    Node-creating methods return ``Dataset`` handles to chain from;
    ``program()`` yields the validated ``dag.Program`` the compiler (and
    ``Session.compile``) consumes. Labels are optional everywhere — the
    job generates deterministic fresh ones (``s0``, ``m0``, ``k0``, …)
    when none is given — and explicit labels are preserved through
    ``to_source()``/``from_source`` round trips.
    """

    def __init__(self, name: str = "job"):
        self.name = name
        self._program = dag.Program()

    # -------------------------------------------------------- construction --
    def _fresh(self, prefix: str) -> str:
        n = 0
        while f"{prefix}{n}" in self._program.nodes:
            n += 1
        return f"{prefix}{n}"

    def store(
        self,
        label: str | None = None,
        *,
        host: str,
        path: str = "",
        dtype: str = "uint64",
        items: int = 0,
    ) -> "Dataset":
        """Bind a data source (paper: ``A := store<uint_64>("host:path")``)."""
        label = label if label is not None else self._fresh("s")
        self._program.store(label, host=host, path=path, dtype=dtype, items=items)
        return Dataset(self, label)

    def reduce(
        self,
        kind: "str | prim.ReduceKind",
        *datasets: "Dataset",
        state_width: int | None = None,
        label: str | None = None,
    ) -> "Dataset":
        """Reduce ≥1 datasets (``Dataset.reduce`` is the chained spelling)."""
        if not datasets:
            raise dag.ProgramError("reduce needs at least one dataset")
        return datasets[0].reduce(
            kind, *datasets[1:], state_width=state_width, label=label
        )

    def dataset(self, label: str) -> "Dataset":
        """Handle to an already-defined label (e.g. after ``from_source``)."""
        if label not in self._program.nodes:
            raise KeyError(
                f"no node {label!r} in job {self.name!r}; "
                f"defined: {sorted(self._program.nodes)}"
            )
        return Dataset(self, label)

    # ------------------------------------------------------------- outputs --
    def program(self) -> dag.Program:
        """The validated ``dag.Program`` (a copy — the job stays buildable)."""
        p = self._program.copy()
        p.validate()
        return p

    def to_source(self) -> str:
        """Print the job as p4mr surface syntax (``from_source`` inverts)."""
        return dsl.program_to_source(self.program())

    # ------------------------------------------------------------ plumbing --
    def _items_of(self, label: str) -> int:
        """Semantic cardinality of a label's output — mirrors
        ``CostModel.traffic`` so inferred reduce widths match what the
        ``lower-shuffle`` pass requires of a KEYBY-fed reduce."""
        node = self._program.nodes[label]
        if isinstance(node, prim.Store):
            return max(1, node.items)
        if isinstance(node, prim.Reduce):
            return max(1, node.state_width)
        if isinstance(node, prim.ShuffleBucket):
            return max(1, node.width)
        if isinstance(node, prim.Concat):
            return sum(self._items_of(s) for s in node.srcs)
        return self._items_of(node.deps[0])  # MapFn / KeyBy / Collect

    def __len__(self) -> int:
        return len(self._program)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Job({self.name!r}, {len(self._program)} nodes)"


@dataclasses.dataclass(frozen=True)
class Dataset:
    """A named intermediate inside a ``Job`` — what the fluent methods
    chain from. Cheap and immutable: it is just (job, label)."""

    job: Job
    label: str

    def _sibling(self, other: "Dataset") -> str:
        if not isinstance(other, Dataset):
            raise TypeError(f"expected a Dataset, got {type(other).__name__}")
        if other.job is not self.job:
            raise ValueError(
                f"dataset {other.label!r} belongs to job {other.job.name!r}, "
                f"not {self.job.name!r} — cross-job dataflow is a Session concern"
            )
        return other.label

    # --------------------------------------------------------------- verbs --
    def map(self, fn_name: str, *, label: str | None = None) -> "Dataset":
        """Per-item transform in transit (S3: ``to_bf16`` wire narrowing)."""
        label = label if label is not None else self.job._fresh("m")
        self.job._program.map(label, self.label, fn_name=fn_name)
        return Dataset(self.job, label)

    def key_by(
        self,
        num_buckets: int,
        *,
        weights=None,
        label: str | None = None,
    ) -> "Dataset":
        """Hash-route items into ``num_buckets`` (the mapper→reducer
        shuffle the ``lower-shuffle`` pass expands; ``weights`` declares
        per-bucket skew)."""
        label = label if label is not None else self.job._fresh("k")
        self.job._program.key_by(label, self.label, num_buckets=num_buckets, weights=weights)
        return Dataset(self.job, label)

    def reduce(
        self,
        kind: "str | prim.ReduceKind" = "SUM",
        *others: "Dataset",
        state_width: int | None = None,
        label: str | None = None,
    ) -> "Dataset":
        """Stateful in-transit reduction of this dataset (+ ``others``).

        ``state_width`` defaults to the widest source's cardinality, so a
        KEYBY-fed reduce is lowerable without restating the key-space
        size the upstream stores already declare.
        """
        srcs = (self.label, *(self._sibling(o) for o in others))
        if state_width is None:
            state_width = max(self.job._items_of(s) for s in srcs)
        label = label if label is not None else self.job._fresh("r")
        self.job._program.reduce(label, *srcs, kind=_as_kind(kind), state_width=state_width)
        return Dataset(self.job, label)

    def concat(self, *others: "Dataset", label: str | None = None) -> "Dataset":
        """Reassemble datasets in order (shuffle collection phase)."""
        srcs = (self.label, *(self._sibling(o) for o in others))
        label = label if label is not None else self.job._fresh("cat")
        self.job._program.concat(label, *srcs)
        return Dataset(self.job, label)

    def collect(self, sink_host: str, *, label: str | None = None) -> "Dataset":
        """Collection signal: flush this dataset to ``sink_host``."""
        label = label if label is not None else self.job._fresh("out")
        self.job._program.collect(label, self.label, sink_host=sink_host)
        return Dataset(self.job, label)

    @property
    def node(self) -> prim.Node:
        return self.job._program.nodes[self.label]


def job(name: str = "job") -> Job:
    """Start a fluent p4mr job (``p4mr.job("wordcount")``)."""
    return Job(name)


def from_source(src: str, *, name: str = "job") -> Job:
    """Parse p4mr surface syntax into a ``Job`` (inverse of
    ``Job.to_source``). ``DSLSyntaxError`` — now carrying line/column and
    the offending token — surfaces unchanged."""
    return from_program(dsl.ast_to_program(dsl.parse_ast(src)), name=name)


def from_program(program: dag.Program, *, name: str = "job") -> Job:
    """Wrap an existing ``dag.Program`` in a ``Job`` (copied, validated)."""
    program.validate()
    j = Job(name)
    j._program = program.copy()
    return j
