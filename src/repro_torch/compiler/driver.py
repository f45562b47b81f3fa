"""Pass-based compiler driver (§5 Fig 9, as a real compiler).

``compile(src_or_program, topology, *, passes=...)`` runs a pipeline of
registered passes over one shared ``CompileCtx`` and returns the emitted
``CompiledPlan``. Parse, validation, optimization, placement, routing and
codelet emission are all passes: callers pick a pipeline instead of
hand-wiring ``dsl.parse_ast → place → build_routes → compile_program``.

    plan = compile(dsl.PAPER_SOURCE, paper_topology())          # optimized
    plan = compile(prog, topo, passes=UNOPTIMIZED_PASSES)       # baseline
    out = plan.run(inputs, backend="torch"); sim = plan.simulate(inputs)

Custom passes register with ``@register_pass("name")`` and slot into any
pipeline tuple.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Hashable, Sequence

from repro_torch.compiler.cost import CostModel
from repro_torch.compiler.plan import CompiledPlan
from repro_torch.core import dag
from repro_torch.core.placement import Placement
from repro_torch.core.routing import RoutingTable

NodeId = Hashable

PassFn = Callable[["CompileCtx"], "str | None"]

_PASS_REGISTRY: dict[str, PassFn] = {}


def register_pass(name: str) -> Callable[[PassFn], PassFn]:
    """Register ``fn`` as a named compiler pass (import-time decorator)."""

    def deco(fn: PassFn) -> PassFn:
        if name in _PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        fn.pass_name = name
        _PASS_REGISTRY[name] = fn
        return fn

    return deco


def get_pass(name: str) -> PassFn:
    _ensure_builtin_passes()
    try:
        return _PASS_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown pass {name!r}; registered: {sorted(_PASS_REGISTRY)}"
        ) from None


def registered_passes() -> list[str]:
    _ensure_builtin_passes()
    return sorted(_PASS_REGISTRY)


def _ensure_builtin_passes() -> None:
    # pass modules import this module for register_pass, so load them lazily
    if "parse" not in _PASS_REGISTRY:
        import repro_torch.compiler.passes  # noqa: F401
    if "lower-shuffle" not in _PASS_REGISTRY:
        import repro_torch.shuffle.lower  # noqa: F401
    if "autotune" not in _PASS_REGISTRY:
        import repro_torch.autotune  # noqa: F401
    if "verify" not in _PASS_REGISTRY:
        import repro_torch.verify  # noqa: F401


# The full optimizing pipeline and the paper-faithful flat baseline.
DEFAULT_PASSES: tuple[str, ...] = (
    "parse",
    "validate",
    "dead-node-elim",
    "lower-shuffle",
    "rebalance-reduce-tree",
    "insert-combiners",
    "place",
    "route",
    "reroute-feedback",
    "emit",
    "verify",
)
# DEFAULT_PASSES without the measured-queueing reroute loop: routes stay
# on the static route-count ECMP tie-break. The benchmarks compile under
# both to price what feedback routing buys.
STATIC_ECMP_PASSES: tuple[str, ...] = tuple(
    p for p in DEFAULT_PASSES if p != "reroute-feedback"
)
UNOPTIMIZED_PASSES: tuple[str, ...] = (
    "parse",
    "validate",
    "place",
    "route",
    "emit",
    "verify",
)
# DEFAULT_PASSES plus the profile-guided autotune search (repro_torch.autotune):
# the emitted plan is hill-climbed against the streaming simulator —
# reroute (k-shortest-path detours), move-reducer, rebucket, reweight.
# Opt-in: each candidate action costs a simulate round, so this pipeline
# is for plans that will run long enough to amortize the search.
AUTOTUNE_PASSES: tuple[str, ...] = DEFAULT_PASSES + ("autotune",)


@dataclasses.dataclass(frozen=True)
class PassRecord:
    name: str
    wall_us: float
    summary: str


@dataclasses.dataclass
class CompileCtx:
    """Shared state the pass pipeline threads through.

    Frontend passes populate ``ast``/``program``; optimization passes
    rewrite ``program`` and accumulate ``pins`` (label → switch placement
    constraints); backend passes fill ``placement``/``routes``/``plan``.
    """

    topology: Any
    cost_model: CostModel
    source: str | None = None
    ast: list | None = None
    program: dag.Program | None = None
    # snapshot of ``program`` as parsed, before any optimization pass
    # rewrote it (the 'parse' pass fills this; emit hands it to the plan)
    source_program: dag.Program | None = None
    pins: dict[str, NodeId] = dataclasses.field(default_factory=dict)
    # the caller's pins only — ``pins`` accumulates pass-created ones
    user_pins: dict[str, NodeId] = dataclasses.field(default_factory=dict)
    placement: Placement | None = None
    routes: RoutingTable | None = None
    plan: CompiledPlan | None = None
    options: dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: list[PassRecord] = dataclasses.field(default_factory=list)

    def require_program(self) -> dag.Program:
        if self.program is None:
            raise ValueError("no program in context (did the 'parse' pass run?)")
        return self.program


class PassManager:
    """Resolves a pipeline spec (names and/or callables) and runs it."""

    def __init__(self, passes: Sequence[str | PassFn] = DEFAULT_PASSES):
        self.pipeline: list[PassFn] = []
        for p in passes:
            self.pipeline.append(get_pass(p) if isinstance(p, str) else p)

    @property
    def names(self) -> list[str]:
        return [getattr(p, "pass_name", p.__name__) for p in self.pipeline]

    def run(self, ctx: CompileCtx) -> CompileCtx:
        # one ambient-tracer read per compile: when a telemetry Tracer is
        # active (Session / activate()), every pass gets a span carrying
        # the same wall time the PassRecord records; when none is, the
        # only cost is this lookup
        from repro_torch.telemetry.trace import current_tracer, maybe_span

        tracer = current_tracer()
        for p in self.pipeline:
            name = getattr(p, "pass_name", p.__name__)
            with maybe_span(tracer, f"pass:{name}") as span_attrs:
                t0 = time.perf_counter()
                summary = p(ctx) or ""
                wall_us = (time.perf_counter() - t0) * 1e6
                span_attrs["summary"] = summary
                span_attrs["wall_us"] = round(wall_us, 1)
            ctx.trace.append(PassRecord(name=name, wall_us=wall_us, summary=summary))
        return ctx


def compile(
    src_or_program: "str | list | dag.Program",
    topology,
    *,
    passes: Sequence[str | PassFn] | None = None,
    cost_model: CostModel | None = None,
    pins: dict[str, NodeId] | None = None,
    options: dict[str, Any] | None = None,
) -> CompiledPlan:
    """DSL text / JSON AST / ``Program`` → ``CompiledPlan`` on ``topology``.

    ``passes`` defaults to the optimizing ``DEFAULT_PASSES``; pass
    ``UNOPTIMIZED_PASSES`` for the paper's flat pipeline. ``pins`` seed
    placement constraints (label → switch id). The returned plan executes
    via ``plan.run(inputs, backend="torch")`` (world-dim mesh) or
    ``backend="reference"`` (numpy oracle).

    ``options`` is a free-form dict every pass can read. Keys understood
    by the built-in pipeline:

    * ``reroute_rounds`` — iteration cap for ``reroute-feedback``.
    * ``switch_penalty_seed`` / ``link_penalty_seed`` — external
      contention maps (switch → pressure, (switch, switch) → pressure)
      that bias ``route`` and ``reroute-feedback`` tie-breaks away from
      fabric other tenants already load. This is the hook the p4mr
      scheduler uses for contention-aware compilation: it seeds job B's
      compile with job A's measured ``telemetry.fabric`` pressure.
    * ``autotune_rounds`` / ``autotune_actions`` — autotune pass knobs.
    """
    ctx = CompileCtx(
        topology=topology,
        cost_model=cost_model or CostModel(),
        pins=dict(pins or {}),
        user_pins=dict(pins or {}),
        options=dict(options or {}),
    )
    if isinstance(src_or_program, dag.Program):
        ctx.program = src_or_program.copy()
    elif isinstance(src_or_program, str):
        ctx.source = src_or_program
    elif isinstance(src_or_program, list):
        ctx.ast = src_or_program
    else:
        raise TypeError(
            f"expected DSL text, JSON AST or Program, got {type(src_or_program).__name__}"
        )
    PassManager(passes if passes is not None else DEFAULT_PASSES).run(ctx)
    if ctx.plan is None:
        raise ValueError(
            "pipeline finished without emitting a plan (missing 'emit' pass?); "
            f"ran: {[r.name for r in ctx.trace]}"
        )
    # emit ran mid-pipeline; refresh the trace to cover the whole run
    ctx.plan.trace = tuple(ctx.trace)
    return ctx.plan


def compile_best(
    src_or_program: "str | list | dag.Program",
    topology,
    *,
    pipelines: Sequence[Sequence[str | PassFn]] = (DEFAULT_PASSES, UNOPTIMIZED_PASSES),
    cost_model: CostModel | None = None,
    pins: dict[str, NodeId] | None = None,
    autotune: bool = False,
    objective: str | None = None,
    options: dict[str, Any] | None = None,
) -> CompiledPlan:
    """Compile under each candidate pipeline, keep the cheapest plan.

    Tree rebalancing trades total wire traffic for latency: on a ring a
    sequential chain is bandwidth-optimal while a balanced tree minimizes
    depth, and which wins depends on payload width and topology. Rather
    than guess, let the §3 cost model arbitrate — the same move as
    profile-guided pass selection in a conventional compiler.

    ``autotune=True`` adds ``AUTOTUNE_PASSES`` to the candidate set (the
    full pipeline plus the profile-guided hill-climb) and, unless
    ``objective`` says otherwise, switches the arbitration to the
    ``"streamed"`` makespan — the quantity autotuning optimizes; the
    static ``cost.scalar`` cannot see what a deliberate detour buys.
    """
    if not pipelines:
        raise ValueError("need at least one candidate pipeline")
    if autotune and AUTOTUNE_PASSES not in tuple(tuple(p) for p in pipelines):
        pipelines = (*pipelines, AUTOTUNE_PASSES)
    objective = objective or ("streamed" if autotune else "static")
    if objective not in ("static", "streamed"):
        raise ValueError(f"unknown objective {objective!r} (static or streamed)")
    plans = [
        compile(
            src_or_program, topology,
            passes=p, cost_model=cost_model, pins=pins, options=options,
        )
        for p in pipelines
    ]
    if objective == "streamed":
        return min(plans, key=lambda pl: (pl.simulate_timing().time_s, pl.cost.scalar))
    return min(plans, key=lambda pl: pl.cost.scalar)
