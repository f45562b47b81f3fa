"""``Session`` — one fabric, typed compile options, many jobs.

A ``Session`` owns what the module-level driver calls kept re-threading
by hand: the target topology, the §3 ``CostModel``, and a typed
``CompileOptions`` (named presets over the registered pass pipelines
instead of stringly-typed ``passes=``/kwarg plumbing). Every compile is
registered under a job name, which is what makes the multi-tenant story
expressible: ``session.simulate()`` merges every registered plan's
packet trains into one streamed simulation over the *shared* switches,
so cross-job queueing — the contention a per-plan ``simulate_timing()``
cannot see — shows up as ``combined`` vs ``solo`` makespans.

    sess = p4mr.Session(fat_tree_topology(4), options="autotuned")
    plan_a = sess.compile(job_a)
    plan_b = sess.compile(job_b, options="static_ecmp")
    rep = sess.simulate()          # both jobs on the fabric at once
    rep.combined.makespan_ticks    # >= every rep.solo[...] makespan
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Hashable, Iterator, Mapping, Sequence

from repro_torch.core import dag

NodeId = Hashable


def _preset_passes() -> dict[str, tuple[str, ...]]:
    from repro_torch import compiler

    return {
        "unoptimized": compiler.UNOPTIMIZED_PASSES,
        "static_ecmp": compiler.STATIC_ECMP_PASSES,
        "default": compiler.DEFAULT_PASSES,
        "autotuned": compiler.AUTOTUNE_PASSES,
    }


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Typed compile configuration (replaces ad-hoc ``passes=`` tuples and
    ``reroute_rounds=``/``autotune_rounds=`` kwarg plumbing).

    ``preset`` names a registered pipeline: ``unoptimized`` (the paper's
    flat parse→place→route), ``static_ecmp`` (optimizing, route-count
    ECMP only), ``default`` (adds the measured-queueing reroute-feedback
    loop) or ``autotuned`` (adds the profile-guided hill-climb).
    ``passes`` overrides the preset with an explicit pipeline; the knob
    fields map onto the driver's ``options`` dict, and ``extra`` is the
    escape hatch for pass-specific options not modeled here.
    """

    preset: str = "default"
    passes: tuple | None = None
    reroute_rounds: int | None = None
    autotune_rounds: int | None = None
    autotune_actions: tuple[str, ...] | None = None
    # TargetProfile (or preset name, e.g. "tofino_like") for the verify
    # pass's V3xx feasibility checks; None = V1xx/V2xx subset only
    verify_profile: Any = None
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.passes is None and self.preset not in _preset_passes():
            raise ValueError(
                f"unknown preset {self.preset!r}; one of {sorted(_preset_passes())}"
            )
        if self.passes is not None:
            object.__setattr__(self, "passes", tuple(self.passes))

    @classmethod
    def of(cls, value: "CompileOptions | str | None") -> "CompileOptions":
        """Coerce ``None`` / a preset name / an instance to options."""
        if value is None:
            return cls()
        if isinstance(value, CompileOptions):
            return value
        if isinstance(value, str):
            return cls(preset=value)
        raise TypeError(
            f"expected CompileOptions, a preset name or None, got {type(value).__name__}"
        )

    def pass_list(self) -> tuple:
        """The compiler pass tuple these options select: explicit
        ``passes`` verbatim, otherwise the ``preset``'s pipeline."""
        return self.passes if self.passes is not None else _preset_passes()[self.preset]

    def driver_options(self) -> dict[str, Any]:
        """Flatten the typed knobs (+``extra``) into the plain options
        dict ``compiler.compile`` passes to its passes."""
        out = dict(self.extra)
        if self.reroute_rounds is not None:
            out["reroute_rounds"] = self.reroute_rounds
        if self.autotune_rounds is not None:
            out["autotune_rounds"] = self.autotune_rounds
        if self.autotune_actions is not None:
            out["autotune_actions"] = tuple(self.autotune_actions)
        if self.verify_profile is not None:
            out["verify_profile"] = self.verify_profile
        return out


@dataclasses.dataclass(frozen=True)
class SessionReport:
    """``Session.simulate()`` result: the shared-fabric streamed timing
    (``combined``) next to each job's solo timing (``solo``) — the gap is
    multi-tenant contention. ``outputs`` carries per-job functional
    results when inputs were supplied. Under staggered submission
    (``simulate(arrivals=...)``), ``arrivals`` records each job's submit
    tick and ``finish_ticks`` its absolute completion tick on the shared
    clock (from the merged run's per-sink finish times)."""

    combined: Any  # compiler.SimReport over the merged traffic
    solo: dict[str, Any]  # job name -> its plan's own SimReport
    outputs: dict[str, dict] | None = None
    arrivals: dict[str, float] = dataclasses.field(default_factory=dict)
    finish_ticks: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def solo_makespan_ticks(self) -> dict[str, int]:
        """Each job's makespan running alone on an idle fabric."""
        return {name: rep.makespan_ticks for name, rep in self.solo.items()}

    @property
    def contention_ticks(self) -> int:
        """Combined makespan beyond the ideal no-contention schedule
        (each job finishing ``arrival + solo makespan``): what sharing
        the fabric cost the last finisher. >= 0 when every job keeps its
        solo routes; a scheduler that re-routes jobs *for* coexistence
        can drive it down but never below 0."""
        ideal = max(
            (
                self.arrivals.get(name, 0.0) + rep.makespan_ticks
                for name, rep in self.solo.items()
            ),
            default=0.0,
        )
        return self.combined.makespan_ticks - int(round(ideal))

    def summary(self) -> str:
        """One line: combined vs per-job solo makespans + contention."""
        solo = ", ".join(
            f"{name}={rep.makespan_ticks}t" for name, rep in self.solo.items()
        )
        when = ""
        if any(self.arrivals.values()):
            when = " arrivals " + ", ".join(
                f"{name}@{int(t)}" for name, t in sorted(self.arrivals.items())
            ) + ";"
        return (
            f"{len(self.solo)} job(s): combined {self.combined.makespan_ticks}t "
            f"(solo {solo};{when} contention +{self.contention_ticks}t)"
        )


def _prefix_node(node, prefix: str):
    """Rename ``node`` (and its dep references) into ``prefix/``-space."""
    from repro_torch.core import primitives as prim

    name = f"{prefix}/{node.name}"
    if isinstance(node, (prim.Concat, prim.Reduce)):
        return dataclasses.replace(
            node, name=name, srcs=tuple(f"{prefix}/{s}" for s in node.srcs)
        )
    if isinstance(node, prim.Store):
        return dataclasses.replace(node, name=name)
    # MapFn / KeyBy / ShuffleBucket / Collect: single ``src`` field
    return dataclasses.replace(node, name=name, src=f"{prefix}/{node.src}")


def merge_plans(plans: Mapping[str, Any]) -> tuple[dag.Program, Any]:
    """One program + routing table over every plan's traffic, labels
    prefixed ``jobname/`` so the merged DAG stays label-unique. Programs
    and routes are structurally untouched — only renamed — so per-flow
    trains, paths and hop counts are exactly each plan's own; the merge
    changes nothing but which switch queues the trains now share."""
    from repro_torch.core.routing import RoutingTable

    nodes, routes = [], []
    seen: dict[str, str] = {}  # merged label -> owning job
    for name, plan in plans.items():
        for n in plan.program:
            pn = _prefix_node(n, name)
            other = seen.get(pn.name)
            if other is not None:
                # "/" nests: job 'a' with node 'b/c' and job 'a/b' with
                # node 'c' both map to 'a/b/c' — catch it here with the
                # job names, not deep inside Program validation
                raise ValueError(
                    f"merged label {pn.name!r} is claimed by both job "
                    f"{other!r} and job {name!r}; rename one job so the "
                    "prefixed label spaces stay disjoint"
                )
            seen[pn.name] = name
            nodes.append(pn)
        for r in plan.routes.routes:
            routes.append(
                dataclasses.replace(
                    r,
                    src_label=f"{name}/{r.src_label}",
                    dst_label=f"{name}/{r.dst_label}",
                )
            )
    return dag.Program.from_nodes(nodes), RoutingTable(routes=routes)


class Session:
    """Compile and execute p4mr jobs against one shared fabric."""

    def __init__(
        self,
        topology,
        *,
        cost_model=None,
        options: "CompileOptions | str | None" = None,
        telemetry: "Any | bool | None" = None,
    ):
        from repro_torch import compiler
        from repro_torch.telemetry import Telemetry

        self.topology = topology
        self.cost_model = cost_model if cost_model is not None else compiler.CostModel()
        self.options = CompileOptions.of(options)
        self.plans: dict[str, Any] = {}
        # ``telemetry=True`` builds a fresh Tracer + MetricsRegistry that
        # every compile/tune/simulate on this session writes into
        # (repro_torch.telemetry); pass an existing Telemetry to share one
        # across sessions. None/False disables — zero overhead.
        self.telemetry = Telemetry.of(telemetry)

    @contextlib.contextmanager
    def _scope(self, name: str, **attrs: Any) -> Iterator[dict]:
        """A traced span with the session tracer installed ambiently, so
        pass / autotune / plan spans nest under the session call — or a
        no-op when telemetry is off."""
        if self.telemetry is None:
            yield {}
            return
        with self.telemetry.activate():
            with self.telemetry.tracer.span(name, **attrs) as span_attrs:
                yield span_attrs

    # ------------------------------------------------------------ compile --
    def _resolve(self, job) -> tuple[Any, str | None]:
        from repro_torch.p4mr.builder import Job

        if isinstance(job, Job):
            return job.program(), job.name
        if isinstance(job, (dag.Program, str, list)):
            # DSL text parses inside the driver's parse pass; a
            # DSLSyntaxError (with line/column/token) surfaces unchanged
            return job, None
        raise TypeError(
            f"expected a p4mr Job, Program, DSL text or JSON AST, got {type(job).__name__}"
        )

    def _register(self, name: str | None, plan, *, derived: str | None = None) -> str:
        """Record a plan. An explicit ``name`` is a caller-owned key:
        recompiling under it *replaces* the old plan (no stale twin left
        for ``simulate`` to double-count). Names derived from the job (or
        defaulted) are suffixed ``#n`` to stay unique — two default-named
        jobs are distinct tenants, not a replacement."""
        if name is not None:
            self.plans[name] = plan
            return name
        base = derived if derived is not None else "job"
        key, i = base, 0
        while key in self.plans:
            i += 1
            key = f"{base}#{i}"
        self.plans[key] = plan
        return key

    def compile(
        self,
        job,
        *,
        name: str | None = None,
        pins: dict[str, NodeId] | None = None,
        options: "CompileOptions | str | None" = None,
    ):
        """Compile one job on the session fabric and register its plan.

        ``job`` is a fluent ``Job``, a ``dag.Program``, DSL text or a
        JSON AST; ``options`` overrides the session-level options for
        this compile only. An explicit ``name`` is a caller-owned
        registry key — recompiling under it replaces the previous plan;
        without one the job's own name is suffixed to stay unique.
        Returns the ``CompiledPlan``.
        """
        from repro_torch import compiler

        opts = CompileOptions.of(options) if options is not None else self.options
        src, jobname = self._resolve(job)
        with self._scope(
            "session.compile", job=name or jobname or "job", preset=opts.preset
        ):
            plan = compiler.compile(
                src,
                self.topology,
                passes=opts.pass_list(),
                cost_model=self.cost_model,
                pins=pins,
                options=opts.driver_options(),
            )
        key = self._register(name, plan, derived=jobname)
        if self.telemetry is not None:
            self.telemetry.record_compile(plan, name=key)
        return plan

    def compile_best(
        self,
        job,
        *,
        name: str | None = None,
        pins: dict[str, NodeId] | None = None,
        pipelines: Sequence | None = None,
        autotune: bool = False,
        objective: str | None = None,
        options: "CompileOptions | str | None" = None,
    ):
        """``compiler.compile_best`` on the session fabric (cost-model
        arbitration across candidate pipelines), plan registered.

        The session/``options`` preset names the optimizing candidate:
        unless ``pipelines`` overrides them, the candidates are that pass
        list against the flat ``unoptimized`` baseline, and the typed
        knobs (``reroute_rounds``, …) apply to every candidate compile.
        """
        from repro_torch import compiler

        opts = CompileOptions.of(options) if options is not None else self.options
        if pipelines is None:
            optimizing = opts.pass_list()
            baseline = _preset_passes()["unoptimized"]
            pipelines = (
                (optimizing,) if optimizing == baseline else (optimizing, baseline)
            )
        src, jobname = self._resolve(job)
        with self._scope(
            "session.compile_best",
            job=name or jobname or "job",
            pipelines=len(tuple(pipelines)),
        ):
            plan = compiler.compile_best(
                src,
                self.topology,
                pipelines=pipelines,
                cost_model=self.cost_model,
                pins=pins,
                autotune=autotune,
                objective=objective,
                options=opts.driver_options(),
            )
        key = self._register(name, plan, derived=jobname)
        if self.telemetry is not None:
            self.telemetry.record_compile(plan, name=key)
        return plan

    def arbitrate_buckets(
        self,
        program_or_factory,
        candidates: Sequence[int],
        *,
        name: str | None = None,
        pins: dict[str, NodeId] | None = None,
        options: "CompileOptions | str | None" = None,
        objective: str = "streamed",
    ):
        """``shuffle.arbitrate_buckets`` under the session's fabric, cost
        model and options; the winning plan is registered."""
        from repro_torch import shuffle

        opts = CompileOptions.of(options) if options is not None else self.options
        with self._scope(
            "session.arbitrate_buckets", candidates=len(tuple(candidates))
        ):
            plan = shuffle.arbitrate_buckets(
                program_or_factory,
                self.topology,
                candidates,
                cost_model=self.cost_model,
                pins=pins,
                passes=opts.pass_list(),
                options=opts.driver_options(),
                objective=objective,
            )
        key = self._register(name, plan)
        if self.telemetry is not None:
            self.telemetry.record_compile(plan, name=key)
        return plan

    # ------------------------------------------------------------- verify --
    def verify(
        self, *, profile=None, memory_headroom: float = 1.0
    ) -> dict[str, list]:
        """Re-verify every registered plan plus the cross-job fabric
        booking, returning ``{job name: [Diagnostic, ...]}`` with the
        multi-tenant V401 findings under ``"<merged>"``. Purely
        diagnostic — nothing raises; feed ``repro_torch.verify.errors_of`` to
        gate. ``profile`` (a ``TargetProfile`` or preset name) adds the
        V3xx feasibility checks per plan."""
        from repro_torch import verify as v

        prof = v.resolve_profile(profile)
        with self._scope("session.verify", jobs=len(self.plans)):
            out = {
                name: v.verify_plan(pl, profile=prof)
                for name, pl in self.plans.items()
            }
            out["<merged>"] = v.verify_merged(
                self.plans,
                cost_model=self.cost_model,
                memory_headroom=memory_headroom,
            )
        return out

    # ----------------------------------------------------------- simulate --
    def simulate(
        self,
        inputs: Mapping[str, Mapping] | None = None,
        *,
        names: Sequence[str] | None = None,
        engine: str | None = None,
        arrivals: Mapping[str, float] | None = None,
        observers: Sequence | None = None,
    ) -> SessionReport:
        """Stream every registered job's packet trains through the shared
        fabric at once (the multi-tenant switch story).

        By default all jobs inject at tick 0; their trains contend in
        the same switch queues, so the ``combined`` makespan is never
        below any job's ``solo`` makespan — queues only add delay.
        ``arrivals`` maps job name → submit tick: that job's sources
        release at the given tick instead of 0 (unknown names raise;
        unlisted jobs arrive at 0), which is how staggered multi-tenant
        load is expressed — the p4mr scheduler drives this. ``inputs``
        optionally maps job name → per-Store input arrays for functional
        outputs; ``names`` restricts which jobs share the run. ``engine``
        picks the simulator core ("event" | "vectorized") for both the
        combined and the solo runs; default is ``CostModel.sim_engine``.
        ``observers`` are streaming telemetry sinks (detector suites,
        ``SloMonitor``s, ``WindowRecorder``s — ``repro_torch.telemetry.stream``)
        fed windowed fabric aggregates from the *combined* run while it
        executes; passing any forces fabric collection on for that run.
        """
        from repro_torch.compiler.simulator import simulate_timing

        if names is None:
            picked = dict(self.plans)
        else:
            missing = [n for n in names if n not in self.plans]
            if missing:
                raise KeyError(
                    f"no compiled job(s) {missing} in session; have {sorted(self.plans)}"
                )
            picked = {n: self.plans[n] for n in names}
        if not picked:
            raise ValueError("session has no compiled jobs to simulate")
        arr = {n: 0.0 for n in picked}
        if arrivals:
            unknown = [n for n in arrivals if n not in picked]
            if unknown:
                raise KeyError(
                    f"arrivals for unknown job(s) {unknown}; have {sorted(picked)}"
                )
            for n, tick in arrivals.items():
                if tick < 0:
                    raise ValueError(f"arrival tick for job {n!r} is negative: {tick}")
                arr[n] = float(tick)
        with self._scope("session.simulate", jobs=len(picked)) as scope_attrs:
            program, routes = merge_plans(picked)
            release = {
                f"{name}/{node}": tick
                for name, tick in arr.items()
                if tick > 0
                for node in picked[name].program.nodes
            }
            combined = simulate_timing(
                program, routes, self.cost_model, engine=engine,
                release=release or None, observers=observers,
            )
            solo = {n: pl.simulate_timing(engine=engine) for n, pl in picked.items()}
            finish = {
                name: max(
                    (
                        combined.sink_finish_ticks.get(f"{name}/{s}", 0)
                        for s in pl.flow_spec().sinks
                    ),
                    default=combined.makespan_ticks,
                )
                for name, pl in picked.items()
            }
            outputs = None
            if inputs is not None:
                unknown = [n for n in inputs if n not in picked]
                if unknown:
                    raise KeyError(
                        f"inputs for unknown job(s) {unknown}; have {sorted(picked)}"
                    )
                outputs = {n: picked[n].execute_reference(inputs[n]) for n in inputs}
            scope_attrs["makespan_ticks"] = combined.makespan_ticks
        if self.telemetry is not None:
            self.telemetry.record_simulation(combined, label="combined")
        return SessionReport(
            combined=combined, solo=solo, outputs=outputs,
            arrivals=arr, finish_ticks=finish,
        )
