"""repro_torch.verify — static plan verifier + target-feasibility linter.

The single static-analysis layer that proves every ``CompiledPlan`` —
freshly emitted or mutated by the autotuner / scheduler — still
satisfies the invariants the backends assume. See ``docs/verify.md``
for the checker catalog (V1xx IR/dataflow, V2xx placement/routing,
V3xx target feasibility, V4xx multi-tenant).

Four integration surfaces:

* the ``verify`` compiler pass (``repro_torch.verify.pass_hook``), always-on
  in the shipped pipelines after ``emit``;
* ``check_plan`` — the post-mutation hook ``autotune.tune`` and the
  ``Scheduler`` call on every accepted candidate;
* ``python -m repro_torch.verify`` — the standalone CLI / CI lint;
* Tracer spans (``verify.plan``) + the ``verify.diagnostics`` counter
  fed by ``Telemetry.record_compile``.

Importing this package registers the ``verify`` pass (the driver's
``_ensure_builtin_passes`` imports it lazily, like the other pass
modules).
"""
from __future__ import annotations

from repro_torch.verify import pass_hook as _pass_hook  # noqa: F401  (registers "verify")
from repro_torch.verify.checks import (
    switch_state_bytes,
    verify_merged,
    verify_plan,
    verify_program,
)
from repro_torch.verify.diagnostics import (
    Diagnostic,
    Severity,
    VerificationError,
    errors_of,
    format_diagnostics,
)
from repro_torch.verify.profiles import (
    PROFILES,
    TargetProfile,
    resolve_profile,
    tofino_like,
    unconstrained,
)


def check_plan(plan, *, profile=None):
    """Verify ``plan`` and *raise* ``VerificationError`` on any
    error-severity diagnostic; returns the full diagnostic list when the
    plan is clean (warnings allowed). The post-mutation hook: one call,
    pass/fail semantics."""
    diags = verify_plan(plan, profile=resolve_profile(profile))
    if errors_of(diags):
        raise VerificationError(diags)
    return diags


__all__ = [
    "Diagnostic",
    "PROFILES",
    "Severity",
    "TargetProfile",
    "VerificationError",
    "check_plan",
    "errors_of",
    "format_diagnostics",
    "resolve_profile",
    "switch_state_bytes",
    "tofino_like",
    "unconstrained",
    "verify_merged",
    "verify_plan",
    "verify_program",
]
