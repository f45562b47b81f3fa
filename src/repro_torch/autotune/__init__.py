"""repro_torch.autotune — profile-guided plan optimization against the
streaming simulator.

The ``reroute-feedback`` pass proved the loop: simulate, feed the
measured queueing back, keep the best plan. This subsystem generalizes
that loop from one knob (ECMP tie-breaks) to the whole plan: a
``CompiledPlan`` is a search state, the streamed makespan is the
objective, and a greedy hill-climb (``search.hill_climb``) applies the
best measured-improving mutation per round from four action families
(``actions``): ``reroute`` k-shortest-path detours, ``move-reducer``
relocation off queued switches, ``rebucket`` fan-out changes pruned
analytically, and ``reweight`` skew learned from measured per-bucket
packets. Accept-if-better means the tuned plan is **never worse than its
input** — the same guarantee ``reroute-feedback`` gives, one level up.

Two entry points:

    tuned = autotune.tune(plan, rounds=6)     # standalone; tuned.tuning
    plan = compiler.compile(src, topo, passes=compiler.AUTOTUNE_PASSES)

``tuned.tuning`` is a ``TuningReport``: every accepted/rejected action
with before/after streamed times (per-action attribution).
"""
from __future__ import annotations

import dataclasses

from repro_torch.autotune.actions import (
    DEFAULT_ACTIONS,
    move_reducer_candidates,
    propose,
    rebucket_candidates,
    reroute_candidates,
    reweight_candidates,
)
from repro_torch.autotune.report import TunedAction, TuningReport
from repro_torch.autotune.search import Candidate, EvalRecord, SkipCandidate, hill_climb
from repro_torch.compiler.driver import CompileCtx, register_pass
from repro_torch.compiler.plan import CompiledPlan


def tune(
    plan: CompiledPlan,
    *,
    rounds: int = 6,
    actions: tuple[str, ...] = DEFAULT_ACTIONS,
    min_gain: float = 0.0,
) -> CompiledPlan:
    """Hill-climb ``plan`` against the streaming simulator.

    Each round proposes mutations from every enabled action family,
    simulates each candidate, and accepts the best strictly-improving one;
    the search stops when a round improves nothing or after ``rounds``
    accepts. The returned plan carries a ``TuningReport`` in ``.tuning``
    and is never worse than ``plan`` on ``simulate_timing().time_s`` — if
    nothing improves, it *is* the input plan (modulo the report field).

    ``min_gain`` (relative) raises the acceptance bar, trading tuning
    rounds for convergence speed; ``actions`` restricts the families
    (e.g. ``("reroute",)`` for a routes-only search).
    """
    from repro_torch import verify as _verify  # lazy: verify registers a pass too

    initial = plan.simulate_timing()
    makespans: dict[int, int] = {}
    # cached records never rebuild the plan, so their makespan comes from
    # the first (non-cached) evaluation of the same key
    key_makespans: dict[tuple, int] = {}
    # candidate cache: (action, mutation-params) → streamed time, so a
    # mutation re-proposed in a later round (e.g. the same rebucket after a
    # reroute accept) is not recompiled and re-simulated (ROADMAP item)
    cache: dict[tuple, float] = {}

    def objective(pl: CompiledPlan) -> float:
        return pl.simulate_timing().time_s

    def _verified(c: Candidate) -> Candidate:
        """Post-mutation hook: a candidate that breaks a static invariant
        (error-severity diagnostics) is skipped, never simulated or
        accepted — the search cannot trade correctness for makespan."""
        build = c.build

        def checked() -> CompiledPlan:
            pl = build()
            diags = _verify.verify_plan(pl)
            errs = _verify.errors_of(diags)
            if errs:
                more = f" (+{len(errs) - 1} more)" if len(errs) > 1 else ""
                raise SkipCandidate(f"verify: {errs[0].format()}{more}")
            pl.diagnostics = tuple(diags)
            return pl

        return dataclasses.replace(c, build=checked)

    def observe(rec: EvalRecord, pl: CompiledPlan) -> None:
        ticks = pl.simulate_timing().makespan_ticks
        makespans[id(rec)] = ticks
        if rec.cache_key is not None:
            key_makespans[rec.cache_key] = ticks

    best, _, records = hill_climb(
        plan,
        objective=objective,
        propose=lambda pl, _round: [_verified(c) for c in propose(pl, actions)],
        rounds=rounds,
        min_gain=min_gain,
        on_eval=observe,
        cache=cache,
    )
    final = best.simulate_timing()
    report = TuningReport(
        initial_time_s=initial.time_s,
        initial_makespan_ticks=initial.makespan_ticks,
        final_time_s=final.time_s,
        final_makespan_ticks=final.makespan_ticks,
        rounds_run=max((r.round for r in records), default=0),
        cache_hits=sum(1 for r in records if r.cached),
        # misses are *cacheable* evaluations only (key-less candidates
        # were never cacheable and must not dilute the hit-rate)
        cache_misses=sum(
            1
            for r in records
            if r.score is not None and not r.cached and r.cache_key is not None
        ),
        verify_rejections=sum(1 for r in records if r.note.startswith("verify:")),
        actions=[
            TunedAction(
                round=r.round,
                kind=r.kind,
                detail=r.detail,
                accepted=r.accepted,
                time_s_before=r.score_before,
                time_s_after=r.score,
                makespan_ticks_after=makespans.get(id(r), key_makespans.get(r.cache_key)),
                note=r.note,
                cached=r.cached,
            )
            for r in records
        ],
    )
    return dataclasses.replace(best, tuning=report)


@register_pass("autotune")
def autotune_pass(ctx: CompileCtx) -> str:
    """Opt-in pipeline tail (``compiler.AUTOTUNE_PASSES``): hill-climb the
    emitted plan. ``options["autotune_rounds"]`` budgets the search
    (default 4; 0 disables), ``options["autotune_actions"]`` restricts
    the action families."""
    if ctx.plan is None:
        raise ValueError("autotune pass requires an emitted plan (run 'emit' first)")
    rounds = int(ctx.options.get("autotune_rounds", 4))
    if rounds <= 0:
        return "disabled (autotune_rounds=0)"
    actions = tuple(ctx.options.get("autotune_actions", DEFAULT_ACTIONS))
    ctx.plan = tune(ctx.plan, rounds=rounds, actions=actions)
    return ctx.plan.tuning.summary()


__all__ = [
    "Candidate",
    "DEFAULT_ACTIONS",
    "EvalRecord",
    "SkipCandidate",
    "TunedAction",
    "TuningReport",
    "autotune_pass",
    "hill_climb",
    "move_reducer_candidates",
    "propose",
    "rebucket_candidates",
    "reroute_candidates",
    "reweight_candidates",
    "tune",
]
