"""``CompiledPlan`` — the artifact the pass pipeline produces.

One object bundling everything downstream consumers need: the (possibly
optimizer-rewritten) program, its placement and routing on the target
topology, the §3 cost estimate, and the execution backends:

* ``torch_step()`` — the ``ppermute`` step over a world-dim ``Mesh``;
* ``execute_reference()`` — the oracle;
* ``simulate()`` — the packet-level dataplane simulator (no devices).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Mapping

import numpy as np

from repro_torch.compiler.cost import CostModel, PlanCost
from repro_torch.core import dag
from repro_torch.core.placement import Placement
from repro_torch.core.routing import RoutingTable

NodeId = Hashable


@dataclasses.dataclass
class CompiledPlan:
    program: dag.Program
    topology: Any
    placement: Placement
    routes: RoutingTable
    cost_model: CostModel
    cost: PlanCost
    pins: dict[str, NodeId] = dataclasses.field(default_factory=dict)
    trace: tuple = ()  # PassRecords from the driver, for diagnostics
    # reroute-feedback stats (rounds, converged, static vs feedback
    # makespan) when that pass ran; None otherwise
    feedback: dict | None = None
    # lower-shuffle metadata: reduce label -> {num_buckets, widths,
    # keybys, bucket_reducers, bucket_switch}; None when nothing lowered
    shuffle_meta: dict | None = None
    # the program as handed to the compiler, before any optimization pass
    # rewrote it — what the autotune rebucket/reweight actions recompile
    # from (a lowered program cannot be re-lowered at a new bucket count)
    source_program: dag.Program | None = None
    # caller-supplied placement constraints only (pass-accumulated pins
    # live in ``pins``); recompiles must not bake lowering pins back in
    user_pins: dict[str, NodeId] = dataclasses.field(default_factory=dict)
    # TuningReport when repro_torch.autotune produced this plan; None otherwise
    tuning: Any = None
    # verifier output (repro_torch.verify Diagnostic tuple) when the 'verify'
    # pass (or check_plan) ran over this plan; None = never verified.
    # An empty tuple means verified clean.
    diagnostics: "tuple | None" = None

    @property
    def pass_records(self) -> tuple:
        """Per-pass wall times + summaries from the driver (the
        ``PassRecord`` tuple) — the compile-time breakdown
        ``bench_compile.py --timings`` and the telemetry registry print."""
        return self.trace

    def pass_timings_us(self) -> dict[str, float]:
        """Pass name → total wall µs (a pass may run more than once)."""
        out: dict[str, float] = {}
        for rec in self.trace:
            out[rec.name] = out.get(rec.name, 0.0) + rec.wall_us
        return out

    # ------------------------------------------------------------ backends --
    def torch_step(self, mesh, *, axis_name: str = "all", item_dtype=None):
        """Step function over ``mesh`` (a ``repro_torch.mesh.Mesh`` whose
        ``axis_name`` indices are the topology's switch ids)."""
        import torch

        from repro_torch.compiler.torch_backend import emit_step

        return emit_step(
            self.program,
            self.placement,
            self.routes,
            mesh,
            axis_name=axis_name,
            item_dtype=item_dtype if item_dtype is not None else torch.float32,
        )

    def simulate(self, inputs: Mapping[str, np.ndarray], *, engine: str | None = None):
        """Run the streaming packet simulator; returns a ``SimResult``.
        ``engine`` selects ``"vectorized"`` (batched-step VOQ core, the
        default via ``CostModel.sim_engine``) or ``"event"`` (per-packet
        reference heap)."""
        from repro_torch.compiler.simulator import SimulatorBackend

        return SimulatorBackend(self).run(inputs, engine=engine)

    def flow_spec(self):
        """Packet trains + flow graph derived from program/routes/cost
        model — memoized on the plan. Autotune evaluates the same plan's
        timing repeatedly (and both engines consume the same spec), so
        re-deriving trains per call is pure waste. ``dataclasses.replace``
        (how every autotune action derives a mutated plan) copies fields
        only, not this cache, so mutated plans rebuild naturally."""
        if getattr(self, "_flow_spec", None) is None:
            from repro_torch.compiler.simulator import build_flow_spec

            self._flow_spec = build_flow_spec(self.program, self.routes, self.cost_model)
        return self._flow_spec

    def simulate_timing(self, *, engine: str | None = None, observers=None):
        """Timing half of the simulator alone (no input arrays needed);
        returns a ``SimReport``. Streamed makespan depends on traffic
        shapes, not payload values — this is what bucket-count
        arbitration and the reroute-feedback loop consume. Memoized per
        engine: program/routes are fixed once emitted, and arbitration +
        stats + benchmarks would otherwise re-run the same simulation.

        ``observers`` (streaming telemetry sinks — see
        ``repro_torch.telemetry.stream``) bypass the memo both ways: the run
        always executes (observers see live windows) and its report is
        not cached (it carries a timeline the default path didn't ask
        for)."""
        from repro_torch.compiler.simulator import ENGINES, simulate_timing

        eng = engine if engine is not None else getattr(self.cost_model, "sim_engine", "vectorized")
        if eng not in ENGINES:
            raise ValueError(f"unknown simulator engine {eng!r}; one of {ENGINES}")
        if observers:
            return simulate_timing(
                self.program, self.routes, self.cost_model,
                engine=eng, spec=self.flow_spec(), observers=observers,
            )
        reports = getattr(self, "_timing_reports", None)
        if reports is None:
            reports = self._timing_reports = {}
        if eng not in reports:
            from repro_torch.telemetry.trace import current_tracer, maybe_span

            # span only the real simulation — memo hits are free and
            # would drown the trace in zero-width spans
            with maybe_span(
                current_tracer(), "plan.simulate_timing", engine=eng
            ) as attrs:
                reports[eng] = simulate_timing(
                    self.program, self.routes, self.cost_model,
                    engine=eng, spec=self.flow_spec(),
                )
                attrs["makespan_ticks"] = reports[eng].makespan_ticks
        return reports[eng]

    def execute_reference(self, inputs: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Reference oracle on this plan's (rewritten) program."""
        from repro_torch.core.codelet import execute_reference

        return execute_reference(self.program, inputs)

    def run(
        self,
        inputs: Mapping[str, Any],
        *,
        backend: str = "torch",
        axis_name: str = "all",
        item_dtype=None,
        device=None,
    ) -> dict[str, np.ndarray]:
        """One execution surface over every backend.

        ``inputs`` maps each Store label to its array; the result maps each
        program sink to its output array:

        * ``"torch"`` (the default) — the step of ``torch_backend`` over a
          world-dim ``Mesh`` with one row per topology switch, on the card
          unless ``device`` says otherwise (``device="cpu"``); inputs are
          numpy arrays or tensors, which may already lie on the card;
          float64 outputs;
        * ``"reference"`` — the oracle (``core.codelet.execute_reference``),
          on the host: it takes numpy arrays or CPU tensors and refuses a
          tensor on the card;
        * ``"simulate"``  — the streaming packet simulator, on the host; its
          outputs are the oracle's (so the same inputs as ``"reference"``);
          use ``simulate()`` directly when the timing report is wanted too.

        The reference package's default is ``"simulate"``; the port's is
        the card, and the host backends are asked for by name.
        """
        from repro_torch.telemetry.trace import current_tracer, maybe_span

        with maybe_span(current_tracer(), "plan.run", backend=backend):
            if backend == "reference":
                return self.execute_reference(inputs)
            if backend == "simulate":
                return self.simulate(inputs).outputs
            if backend != "torch":
                raise ValueError(
                    f"unknown backend {backend!r}; one of 'simulate', 'torch', 'reference'"
                )
            return self._run_torch(inputs, axis_name=axis_name, item_dtype=item_dtype, device=device)

    def _run_torch(self, inputs, *, axis_name: str, item_dtype, device):
        import torch

        from repro_torch.mesh import Mesh

        n = self._mesh_devices()
        mesh = Mesh((axis_name,), (n,), device=device)
        step = self.torch_step(mesh, axis_name=axis_name, item_dtype=item_dtype)

        def on_mesh(v):
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            t = torch.atleast_1d(t.to(mesh.device))
            # every row sees the Store's array; the step keeps the owner's
            return t.unsqueeze(0).expand((n,) + tuple(t.shape))

        out = step({k: on_mesh(v) for k, v in inputs.items()})
        # the "@all" copy is replicated: row 0 is the collected value
        return {
            s: out[s + "@all"][0].to(torch.float64).cpu().numpy() for s in self.sinks
        }

    def indexed(self) -> "CompiledPlan":
        """This plan on ``topology.as_indexed()``: placement,
        routes and pins relabeled to the view's integer switch ids, the
        program and everything else as they are. A plan compiled on a
        named-switch fabric (a fat-tree) runs on the torch backend this
        way; its simulated timing is unchanged."""
        from repro_torch.core.routing import RoutingTable

        view = self.topology.as_indexed()
        ids = view.name_to_id
        pl = self.placement
        placement = dataclasses.replace(
            pl,
            assignment={label: ids[s] for label, s in pl.assignment.items()},
            burden={ids[s]: v for s, v in pl.burden.items()},
            state_used={ids[s]: v for s, v in pl.state_used.items()},
        )
        routes = RoutingTable([
            dataclasses.replace(r, path=tuple(ids[s] for s in r.path))
            for r in self.routes.routes
        ])
        return dataclasses.replace(
            self, topology=view, placement=placement, routes=routes,
            pins={label: ids[s] for label, s in self.pins.items()},
            user_pins={label: ids[s] for label, s in self.user_pins.items()},
        )

    def _mesh_devices(self) -> int:
        """World-dim length the torch backend needs: switch ids must be
        mesh indices (``TorusTopology`` / ``as_indexed`` views)."""
        n = getattr(self.topology, "num_devices", None)
        if n is not None:
            return int(n)
        switches = list(self.topology.switches)
        if not all(isinstance(s, int) for s in switches):
            raise TypeError(
                "backend='torch' needs integer switch ids; compile on a "
                "TorusTopology or a SwitchTopology.as_indexed() view"
            )
        return max(switches) + 1

    # ---------------------------------------------------------- inspection --
    @property
    def sinks(self) -> list[str]:
        return self.program.sinks()

    def describe(self) -> str:
        """Human-readable plan dump: optimized surface syntax, placement,
        routing totals and the cost estimate."""
        from repro_torch.core import dsl

        lines = ["# optimized program", dsl.program_to_source(self.program).rstrip()]
        lines.append("# placement")
        for label, sw in self.placement.assignment.items():
            pin = "  [pinned]" if label in self.pins else ""
            lines.append(f"  {label} -> {sw}{pin}")
        lines.append(
            f"# routing: total_hops={self.routes.total_hops} max_hops={self.routes.max_hops}"
        )
        lines.append(
            f"# cost: wire={self.cost.wire_bytes:.0f}B packet_hops={self.cost.packet_hops} "
            f"time={self.cost.serial_time_s * 1e6:.2f}us "
            f"state_max={self.cost.state_bytes_max}B"
        )
        if self.trace:
            lines.append("# passes")
            for rec in self.trace:
                lines.append(f"  {rec.name}: {rec.summary} ({rec.wall_us:.0f}us)")
        return "\n".join(lines)
