"""Word count, in-transit collectives, the §4 scenarios, the sharded linear
scan (``ring_scan``) and the stage pipeline (``pipeline``) on the world-dim
mesh, and the p4mr IR (``primitives``, ``dag``), DSL, topologies, placement,
routing and reference interpreter (``codelet``) the compiler works on."""
from repro_torch.core import collectives, scenarios, wordcount
from repro_torch.core.scenarios import Scenario, aggregate

__all__ = ["collectives", "scenarios", "wordcount", "Scenario", "aggregate"]
