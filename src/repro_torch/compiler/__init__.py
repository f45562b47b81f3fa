"""repro_torch.compiler — pass-based p4mr compiler driver (§5 Fig 9).

    from repro_torch import compiler
    plan = compiler.compile(dsl.PAPER_SOURCE, topology.paper_topology().as_indexed())
    plan.simulate(inputs)                  # packet-level dataplane simulator
    plan.run(inputs, backend="torch")      # world-dim mesh on the card
    plan.run(inputs, backend="reference")  # numpy oracle

Pipeline: parse → validate → dead-node-elim → lower-shuffle (KeyBy →
per-bucket routed edges, see ``repro_torch.shuffle``) →
rebalance-reduce-tree → insert-combiners → place (§3 cost model) → route
→ reroute-feedback (streaming-simulate, then re-route on *measured*
per-switch queueing and per-bucket traffic, to a fixed point) → emit →
verify. Every stage is a registered pass over a shared ``CompileCtx``;
see ``driver.py``. ``AUTOTUNE_PASSES`` adds the profile-guided
``autotune`` hill-climb (``repro_torch.autotune``).
"""
from repro_torch.compiler.cost import CostModel, PlanCost, Traffic
from repro_torch.compiler.driver import (
    AUTOTUNE_PASSES,
    DEFAULT_PASSES,
    STATIC_ECMP_PASSES,
    UNOPTIMIZED_PASSES,
    CompileCtx,
    PassManager,
    PassRecord,
    compile,
    compile_best,
    get_pass,
    register_pass,
    registered_passes,
)
from repro_torch.compiler.plan import CompiledPlan
from repro_torch.compiler.simulator import SimReport, SimResult, SimulatorBackend, simulate_timing
from repro_torch.compiler.torch_backend import emit_step

# importing the pass module registers the built-in passes
from repro_torch.compiler import passes as _passes  # noqa: F401

__all__ = [
    "CostModel",
    "PlanCost",
    "Traffic",
    "compile_best",
    "AUTOTUNE_PASSES",
    "DEFAULT_PASSES",
    "STATIC_ECMP_PASSES",
    "UNOPTIMIZED_PASSES",
    "CompileCtx",
    "PassManager",
    "PassRecord",
    "compile",
    "get_pass",
    "register_pass",
    "registered_passes",
    "emit_step",
    "CompiledPlan",
    "SimReport",
    "SimResult",
    "SimulatorBackend",
    "simulate_timing",
]
