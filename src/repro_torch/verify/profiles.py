"""``TargetProfile`` — PSA/Tofino-style hardware envelopes (V3xx checks).

The §3 cost model prices wire bytes, hops and one per-switch memory pool;
real targets are harsher (the P4 survey's per-target tables): a fixed
number of pipeline stages, SRAM banked *per stage*, and a recirculation
budget (a stateful merge beyond what one pass through the pipeline can
absorb re-enters at the parser and eats ingress bandwidth). A
``TargetProfile`` captures those three limits; ``None`` means the target
does not constrain that axis.

Presets:

* ``tofino_like()`` — a Tofino-1-shaped envelope (12 stages, 128 KiB of
  stateful SRAM per stage, 64 recirculations per switch per collection
  window). Not vendor data — the order of magnitude the public P4
  literature reports, enough to make infeasibility *visible*.
* ``unconstrained()`` — no V3xx limits at all; what the always-on verify
  pass uses implicitly, and what the zero-false-positive sweep asserts
  every shipped scenario passes under.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TargetProfile:
    """Per-switch hardware limits for the V3xx feasibility checks.

    ``pipeline_stages`` bounds how many stateful tables (Reduce state)
    one switch can host (each table claims at least one stage);
    ``stage_memory_bytes`` bounds a *single* table (a register array
    cannot span stages) and, times ``pipeline_stages``, the switch's
    total stateful memory; ``recirculation_budget`` bounds the summed
    extra passes stateful multi-way merges need (fan-in − 1 per reduce).
    """

    name: str = "unconstrained"
    pipeline_stages: int | None = None
    stage_memory_bytes: int | None = None
    recirculation_budget: int | None = None

    def __post_init__(self):
        for field in ("pipeline_stages", "stage_memory_bytes", "recirculation_budget"):
            v = getattr(self, field)
            if v is not None and v < 1:
                raise ValueError(f"TargetProfile.{field} must be >= 1 or None, got {v!r}")

    @property
    def total_memory_bytes(self) -> int | None:
        """Whole-switch stateful memory: stages × per-stage SRAM (None
        when either axis is unconstrained)."""
        if self.pipeline_stages is None or self.stage_memory_bytes is None:
            return None
        return self.pipeline_stages * self.stage_memory_bytes


def tofino_like() -> TargetProfile:
    """A Tofino-1-shaped envelope (public-literature orders of magnitude)."""
    return TargetProfile(
        name="tofino_like",
        pipeline_stages=12,
        stage_memory_bytes=128 * 1024,
        recirculation_budget=64,
    )


def unconstrained() -> TargetProfile:
    """No V3xx limits — the §3 cost model's single memory pool only."""
    return TargetProfile(name="unconstrained")


PROFILES = {"tofino_like": tofino_like, "unconstrained": unconstrained}


def resolve_profile(value: "TargetProfile | str | None") -> TargetProfile | None:
    """Coerce a ``CompileOptions.verify_profile`` value: ``None`` stays
    None (V3xx skipped), a preset name resolves via ``PROFILES``, an
    instance passes through."""
    if value is None or isinstance(value, TargetProfile):
        return value
    if isinstance(value, str):
        try:
            return PROFILES[value]()
        except KeyError:
            raise ValueError(
                f"unknown target profile {value!r}; one of {sorted(PROFILES)}"
            ) from None
    raise TypeError(
        f"expected TargetProfile, a preset name or None, got {type(value).__name__}"
    )
