"""Structured, coded diagnostics — the verifier's output vocabulary.

Every checker in ``repro_torch.verify.checks`` emits ``Diagnostic`` values
instead of raising ad-hoc ``ValueError``s: one stable code per invariant
(``V1xx`` IR/dataflow, ``V2xx`` placement/routing, ``V3xx`` target
feasibility, ``V4xx`` multi-tenant), a severity, the offending
node/edge/switch, and a human message carrying a concrete counterexample
(the uncovered key range, the cyclic route, the overfull switch). The
catalog lives in ``docs/verify.md``.

``VerificationError`` is the one exception type the verify layer raises:
a ``ValueError`` (so existing ``except ValueError`` call sites — the
autotune action builders, test harnesses — keep working) that carries
the full diagnostic list, not just the first failure.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Hashable, Sequence

NodeId = Hashable


class Severity(enum.Enum):
    """``ERROR`` fails compiles / CI; ``WARNING`` is advisory only."""

    ERROR = "error"
    WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding.

    ``code`` is the stable checker id (``V104``); ``subject`` names the
    offending node label (or plan/job name), ``switch`` the offending
    switch, ``edge`` the offending ``(src_label, dst_label)`` route —
    whichever apply. ``message`` is the human line with counterexample.
    """

    code: str
    severity: Severity
    message: str
    subject: str | None = None
    switch: NodeId | None = None
    edge: tuple[str, str] | None = None

    def format(self) -> str:
        """One pretty-printed line: ``V104 error [K__b2]: ...``."""
        where = []
        if self.subject is not None:
            where.append(str(self.subject))
        if self.switch is not None:
            where.append(f"switch {self.switch}")
        if self.edge is not None:
            where.append(f"{self.edge[0]}->{self.edge[1]}")
        loc = f" [{', '.join(where)}]" if where else ""
        return f"{self.code} {self.severity.value}{loc}: {self.message}"


class VerificationError(ValueError):
    """A verify run found error-severity diagnostics.

    ``diagnostics`` carries the full list (warnings included) so callers
    — the CLI, ``validate``'s multi-error regression tests, telemetry —
    see everything found in one run, not just the first failure.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        errors = [d for d in self.diagnostics if d.severity is Severity.ERROR]
        shown = errors if errors else list(self.diagnostics)
        head = f"verify: {len(errors)} error(s)"
        if len(self.diagnostics) != len(errors):
            head += f", {len(self.diagnostics) - len(errors)} warning(s)"
        super().__init__(head + "\n" + "\n".join(f"  {d.format()}" for d in shown))


def errors_of(diagnostics: Sequence[Diagnostic]) -> list[Diagnostic]:
    """The error-severity subset (what fails a compile or a CI lint)."""
    return [d for d in diagnostics if d.severity is Severity.ERROR]


def format_diagnostics(diagnostics: Sequence[Diagnostic]) -> str:
    """Multi-line pretty print (the CLI's output body)."""
    return "\n".join(d.format() for d in diagnostics)
