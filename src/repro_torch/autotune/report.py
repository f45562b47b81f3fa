"""Structured record of one autotune run — who proposed what, what won.

``TuningReport`` is attached to the tuned plan (``plan.tuning``) and
serialized into ``BENCH_autotune.json``: per-action attribution is the
acceptance criterion's audit trail (which action family bought which
ticks), not an afterthought.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TunedAction:
    """One evaluated plan mutation (accepted, rejected or skipped)."""

    round: int
    kind: str  # "reroute" | "move-reducer" | "rebucket" | "reweight"
    detail: str
    accepted: bool
    time_s_before: float  # incumbent streamed time when evaluated
    time_s_after: float | None  # candidate streamed time; None when skipped
    makespan_ticks_after: int | None
    note: str = ""
    cached: bool = False  # score served from the candidate cache (no rebuild)

    @property
    def gain_s(self) -> float:
        """Streamed-time improvement this candidate offered (<=0: none)."""
        if self.time_s_after is None:
            return 0.0
        return self.time_s_before - self.time_s_after


@dataclasses.dataclass
class TuningReport:
    initial_time_s: float
    initial_makespan_ticks: int
    final_time_s: float
    final_makespan_ticks: int
    rounds_run: int
    actions: list[TunedAction] = dataclasses.field(default_factory=list)
    # candidate cache: (action, mutation-params) → simulated makespan.
    # hits are re-proposed mutations whose recompile+simulate was skipped
    cache_hits: int = 0
    cache_misses: int = 0
    # candidates whose mutation broke a static invariant (repro_torch.verify
    # found error-severity diagnostics) and were rejected unevaluated
    verify_rejections: int = 0

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of cacheable evaluations served from the cache."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def improvement_pct(self) -> float:
        """Streamed-time win over the input plan, in percent (>= 0: the
        search never accepts a worse plan)."""
        if self.initial_time_s <= 0:
            return 0.0
        return 100.0 * (self.initial_time_s - self.final_time_s) / self.initial_time_s

    @property
    def accepted(self) -> list[TunedAction]:
        return [a for a in self.actions if a.accepted]

    def accepted_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for a in self.accepted:
            out[a.kind] = out.get(a.kind, 0) + 1
        return out

    def to_dict(self) -> dict:
        """JSON-able form (the BENCH_autotune.json payload)."""
        return {
            "initial_time_s": self.initial_time_s,
            "initial_makespan_ticks": self.initial_makespan_ticks,
            "final_time_s": self.final_time_s,
            "final_makespan_ticks": self.final_makespan_ticks,
            "improvement_pct": round(self.improvement_pct, 3),
            "rounds_run": self.rounds_run,
            "accepted_by_kind": self.accepted_by_kind(),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": round(self.cache_hit_rate, 3),
            "verify_rejections": self.verify_rejections,
            "actions": [
                {
                    "round": a.round,
                    "kind": a.kind,
                    "detail": a.detail,
                    "accepted": a.accepted,
                    "time_s_before": a.time_s_before,
                    "time_s_after": a.time_s_after,
                    "makespan_ticks_after": a.makespan_ticks_after,
                    **({"note": a.note} if a.note else {}),
                    **({"cached": True} if a.cached else {}),
                }
                for a in self.actions
            ],
        }

    def summary(self) -> str:
        """One line for pass traces and CI logs."""
        by_kind = self.accepted_by_kind()
        kinds = (
            ", ".join(f"{k}×{n}" for k, n in sorted(by_kind.items())) if by_kind else "none"
        )
        cache = (
            f", cache {self.cache_hits}/{self.cache_hits + self.cache_misses} hit"
            if self.cache_hits
            else ""
        )
        vetoed = (
            f", {self.verify_rejections} verify-rejected"
            if self.verify_rejections
            else ""
        )
        return (
            f"{len(self.accepted)}/{len(self.actions)} action(s) accepted [{kinds}], "
            f"makespan {self.initial_makespan_ticks}→{self.final_makespan_ticks} ticks "
            f"({self.improvement_pct:+.1f}%){cache}{vetoed}"
        )
