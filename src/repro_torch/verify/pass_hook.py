"""The ``verify`` compiler pass — always-on static backstop after emit.

Registered into every shipped pipeline (``DEFAULT_PASSES``,
``UNOPTIMIZED_PASSES``, and everything derived from them): once ``emit``
has produced a ``CompiledPlan``, the cheap V1xx/V2xx subset runs
unconditionally; passing ``verify_profile=`` (a ``TargetProfile``, a
preset name, or via ``CompileOptions.verify_profile``) adds the V3xx
target-feasibility checks. Error-severity findings abort the compile
with a ``VerificationError`` carrying the full diagnostic list; the
(possibly empty) list is stored on ``plan.diagnostics`` either way so
telemetry and the CLI can report warnings from clean compiles too.
"""
from __future__ import annotations

from repro_torch.compiler.driver import CompileCtx, register_pass
from repro_torch.verify.checks import verify_plan
from repro_torch.verify.diagnostics import Severity, VerificationError
from repro_torch.verify.profiles import resolve_profile


@register_pass("verify")
def verify_pass(ctx: CompileCtx) -> str:
    if ctx.plan is None:
        raise ValueError("verify pass requires an emitted plan (run 'emit' first)")
    profile = resolve_profile(ctx.options.get("verify_profile"))
    diags = verify_plan(ctx.plan, profile=profile)
    ctx.plan.diagnostics = tuple(diags)
    errors = sum(1 for d in diags if d.severity is Severity.ERROR)
    if errors:
        raise VerificationError(diags)
    scope = f"profile={profile.name}" if profile is not None else "V1xx/V2xx"
    if diags:
        return f"{scope}: clean, {len(diags)} warning(s)"
    return f"{scope}: clean"
