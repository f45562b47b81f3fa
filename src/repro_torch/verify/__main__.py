"""``python -m repro_torch.verify`` — the standalone plan linter.

Compiles each positional ``.p4mr`` DSL file through the full optimizing
pipeline on the chosen topology and verifies the emitted plan;
``--scenarios`` additionally compiles and lints the paper's S1/S2/S3
gradient-aggregation plans. Diagnostics pretty-print one per line; the
exit code is CI's contract: 0 when every plan is clean of error-severity
diagnostics, 1 otherwise (warnings alone do not fail the lint).

    python -m repro_torch.verify examples/paper_fig2.p4mr
    python -m repro_torch.verify examples/*.p4mr --profile tofino_like
    python -m repro_torch.verify --scenarios --world 6
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.verify.checks import verify_plan
from repro_torch.verify.diagnostics import (
    Severity,
    VerificationError,
    format_diagnostics,
)
from repro_torch.verify.profiles import PROFILES, resolve_profile


def _topology(name: str):
    from repro_torch.core import topology as topo

    if name == "paper":
        return topo.paper_topology()
    if name.startswith("fat_tree"):
        k = int(name.partition(":")[2] or 4)
        return topo.fat_tree_topology(k)
    raise SystemExit(f"unknown topology {name!r} (paper, fat_tree[:k])")


def _report(name: str, diags, *, failed: bool) -> bool:
    """Print one plan's verdict; returns True when it has errors."""
    errors = [d for d in diags if d.severity is Severity.ERROR]
    if not diags:
        print(f"{name}: clean")
    else:
        verdict = "FAIL" if errors else f"clean, {len(diags)} warning(s)"
        print(f"{name}: {verdict}")
        print("  " + format_diagnostics(diags).replace("\n", "\n  "))
    return bool(errors) or failed


def _lint_file(path: Path, topo, profile) -> bool:
    """Compile + verify one DSL file; returns True on error diagnostics."""
    from repro_torch.compiler import driver
    from repro_torch.core.dsl import DSLSyntaxError

    try:
        plan = driver.compile(path.read_text(), topo)
    except VerificationError as e:
        return _report(str(path), e.diagnostics, failed=True)
    except (DSLSyntaxError, ValueError) as e:
        print(f"{path}: FAIL\n  compile error: {e}")
        return True
    # the always-on pass covered V1xx/V2xx; rerun only to add V3xx
    diags = plan.diagnostics if profile is None else verify_plan(plan, profile=profile)
    return _report(str(path), list(diags or ()), failed=False)


def _lint_scenarios(world: int, profile) -> bool:
    from repro_torch.core.scenarios import Scenario, compile_scenario

    failed = False
    for sc in (Scenario.S1_HOST, Scenario.S2_IN_NET, Scenario.S3_IN_NET_MAP):
        name = f"scenario:{sc.value}(world={world})"
        try:
            plan = compile_scenario(world, sc, state_width=world)
        except VerificationError as e:
            failed = _report(name, e.diagnostics, failed=True) or failed
            continue
        except ValueError as e:
            print(f"{name}: FAIL\n  compile error: {e}")
            failed = True
            continue
        failed = _report(name, verify_plan(plan, profile=profile), failed=False) or failed
    return failed


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="Lint compiled p4mr plans: static invariants + target feasibility.",
    )
    ap.add_argument("paths", nargs="*", type=Path, help=".p4mr DSL files to lint")
    ap.add_argument(
        "--profile",
        default=None,
        choices=sorted(PROFILES),
        help="TargetProfile preset for the V3xx feasibility checks "
        "(default: V1xx/V2xx only)",
    )
    ap.add_argument(
        "--topology",
        default="paper",
        help="fabric to compile DSL files on: paper (default) or fat_tree[:k]",
    )
    ap.add_argument(
        "--scenarios",
        action="store_true",
        help="also lint the compiled S1/S2/S3 gradient-aggregation scenarios",
    )
    ap.add_argument(
        "--world", type=int, default=6, help="scenario world size (default 6)"
    )
    args = ap.parse_args(argv)
    if not args.paths and not args.scenarios:
        ap.error("nothing to lint: give .p4mr files and/or --scenarios")
    profile = resolve_profile(args.profile)
    topo = _topology(args.topology)
    failed = False
    for path in args.paths:
        if not path.exists():
            print(f"{path}: FAIL\n  no such file")
            failed = True
            continue
        failed = _lint_file(path, topo, profile) or failed
    if args.scenarios:
        failed = _lint_scenarios(args.world, profile) or failed
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
