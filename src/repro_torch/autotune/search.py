"""Greedy hill-climb search driver — the repo's one hill-climb loop.

``hill_climb`` is deliberately domain-free: a state, an objective to
minimize, and a proposer that emits lazily-built candidate mutations per
round. ``repro_torch.autotune.tune`` drives it with ``CompiledPlan`` states and
the streamed makespan; ``benchmarks/hillclimb.py`` drives it with
roofline dry-run cells and the modelled step-time bound. Both get the
same guarantees:

* **never worse than the input** — a candidate is accepted only when its
  objective is strictly below the incumbent's, so the returned state is
  the input state whenever nothing improves;
* **budgeted** — at most ``rounds`` accept rounds, each evaluating every
  proposed candidate (steepest-descent: the best improving candidate of
  the round wins, not the first);
* **auditable** — every evaluation is recorded (kind, detail, scores,
  accepted/skipped), which is what ``TuningReport`` is built from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable


class SkipCandidate(Exception):
    """Raised by a candidate's ``build`` when the mutation is infeasible
    (e.g. a moved reducer overflows the target switch's memory budget);
    recorded as skipped, never fatal."""


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One proposed mutation: ``build()`` materializes the mutated state
    (lazily — proposal must stay cheap, evaluation pays the cost).

    ``cache_key`` optionally names the mutation itself — ``("reroute",
    flow, path)``, not a fingerprint of the incumbent being mutated.
    ``hill_climb`` then skips re-building and re-scoring a key it already
    measured this climb (identical re-proposed mutations were previously
    re-simulated every round — the candidate cache)."""

    kind: str  # action family, e.g. "reroute" / "move-reducer"
    detail: str  # human-readable description of the mutation
    build: Callable[[], Any]
    cache_key: "tuple | None" = None


@dataclasses.dataclass
class EvalRecord:
    """One candidate evaluation inside ``hill_climb``."""

    round: int
    kind: str
    detail: str
    score_before: float  # incumbent objective when evaluated
    score: float | None  # candidate objective; None when build() skipped
    accepted: bool = False
    note: str = ""
    cached: bool = False  # score served from the candidate cache
    cache_key: "tuple | None" = None  # the candidate's key, cached or not


def hill_climb(
    state: Any,
    *,
    objective: Callable[[Any], float],
    propose: Callable[[Any, int], Iterable[Candidate]],
    rounds: int,
    min_gain: float = 0.0,
    on_eval: Callable[[EvalRecord, Any], None] | None = None,
    stop_when_stuck: bool = True,
    cache: dict | None = None,
) -> tuple[Any, float, list[EvalRecord]]:
    """Steepest-descent hill-climb; returns (best state, score, records).

    Each round evaluates every candidate from ``propose(best, round)`` and
    accepts the lowest-objective one that beats the incumbent by more than
    ``min_gain`` (a relative fraction); the search stops early when a
    round proposes nothing or — unless ``stop_when_stuck=False``, for
    fixed ladders whose every rung must be measured (the roofline
    hillclimb bench) — improves nothing. ``on_eval`` observes each
    successfully built candidate with its record (benchmarks log here).

    ``cache`` (optional, caller-owned) memoizes candidate objectives by
    ``Candidate.cache_key``: a re-proposed key is recorded as a cache hit
    and neither rebuilt nor re-scored. Keys name the mutation alone, so
    after an accepted action the same key may denote a build against a
    *different* incumbent — the cached score is then an estimate, which
    is why a hit is never considered for acceptance (the ``continue``
    below runs before the acceptance check): accepts only ever come from
    fresh evaluations, preserving the never-worse guarantee. The cost is
    search quality, not correctness — a mutation whose value improved
    under the new incumbent won't be re-measured this climb — and in
    exchange re-proposed mutations (the common case: the top-k hot flows
    are re-ranked every round) stop paying a full simulate each round.
    The cache's lifetime is ONE climb: pass a fresh dict per call, as
    ``autotune.tune`` does, since across climbs the estimate would go
    stale with no bound at all.
    """
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    from repro_torch.telemetry.trace import current_tracer, maybe_span

    tracer = current_tracer()  # spans when a telemetry Tracer is active
    best = state
    best_score = float(objective(state))
    records: list[EvalRecord] = []
    for rnd in range(1, rounds + 1):
        with maybe_span(tracer, f"tune:round-{rnd}") as round_attrs:
            candidates = list(propose(best, rnd))
            round_attrs["candidates"] = len(candidates)
            if not candidates:
                break
            bar = best_score - abs(best_score) * min_gain
            round_best: tuple[float, EvalRecord, Any] | None = None
            for cand in candidates:
                rec = EvalRecord(
                    round=rnd,
                    kind=cand.kind,
                    detail=cand.detail,
                    score_before=best_score,
                    score=None,
                    cache_key=cand.cache_key,
                )
                records.append(rec)
                with maybe_span(
                    tracer, f"eval:{cand.kind}", detail=cand.detail
                ) as eval_attrs:
                    if (
                        cache is not None
                        and cand.cache_key is not None
                        and cand.cache_key in cache
                    ):
                        rec.score = cache[cand.cache_key]
                        rec.cached = True
                        rec.note = "cache hit"
                        eval_attrs["cached"] = True
                        eval_attrs["score"] = rec.score
                        continue
                    eval_attrs["cached"] = False
                    try:
                        nxt = cand.build()
                    except SkipCandidate as e:
                        rec.note = str(e) or "infeasible"
                        eval_attrs["skipped"] = rec.note
                        continue
                    rec.score = float(objective(nxt))
                    eval_attrs["score"] = rec.score
                    if cache is not None and cand.cache_key is not None:
                        cache[cand.cache_key] = rec.score
                    if on_eval is not None:
                        on_eval(rec, nxt)
                    if rec.score < bar and (
                        round_best is None or rec.score < round_best[0]
                    ):
                        round_best = (rec.score, rec, nxt)
            if round_best is None:
                round_attrs["accepted"] = None
                if stop_when_stuck:
                    break
                continue
            best_score, rec, best = round_best
            rec.accepted = True
            round_attrs["accepted"] = rec.detail
            round_attrs["score"] = best_score
    return best, best_score, records
