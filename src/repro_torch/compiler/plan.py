"""``CompiledPlan`` — the artifact the pass pipeline produces.

One object bundling everything downstream consumers need: the (possibly
optimizer-rewritten) program, its placement and routing on the target
topology, the §3 cost estimate, and the execution backends:

* ``torch_step()`` — the ``ppermute`` step over a world-dim ``Mesh``;
* ``execute_reference()`` — the oracle;
* ``simulate()`` — the packet-level dataplane simulator, which raises
  ``NotImplementedError`` until the simulator slice of the port.
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

_NO_SIMULATOR = (
    "the packet simulator (compiler/simulator.py, compiler/vectorized.py) is "
    "not ported to repro_torch yet (ROADMAP.md, queue 1 item 5); use "
    "backend='torch' or backend='reference'"
)


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
        """The streaming packet simulator (not ported yet)."""
        raise NotImplementedError(_NO_SIMULATOR)

    def flow_spec(self):
        """Packet trains + flow graph of the simulator (not ported yet)."""
        raise NotImplementedError(_NO_SIMULATOR)

    def simulate_timing(self, *, engine: str | None = None, observers=None):
        """Timing half of the simulator (not ported yet)."""
        raise NotImplementedError(_NO_SIMULATOR)

    def execute_reference(self, inputs: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Reference oracle on this plan's (rewritten) program."""
        from repro_torch.core.codelet import execute_reference

        return execute_reference(self.program, inputs)

    def run(
        self,
        inputs: Mapping[str, Any],
        *,
        backend: str = "simulate",
        axis_name: str = "all",
        item_dtype=None,
        device=None,
    ) -> dict[str, np.ndarray]:
        """One execution surface over every backend.

        ``inputs`` maps each Store label to its array (numpy, or a tensor,
        which may already lie on the card); the result maps each program
        sink to its output array:

        * ``"torch"``     — the step of ``torch_backend`` over a world-dim
          ``Mesh`` with one row per topology switch, on the card unless
          ``device`` says otherwise (``device="cpu"``); float64 outputs;
        * ``"reference"`` — the oracle (``core.codelet.execute_reference``);
        * ``"simulate"``  — the streaming packet simulator, which raises
          ``NotImplementedError`` until it is ported.
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
