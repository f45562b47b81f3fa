"""Word count, in-transit collectives and the §4 scenarios on the world-dim mesh."""
from repro_torch.core import collectives, scenarios, wordcount
from repro_torch.core.scenarios import Scenario, aggregate

__all__ = ["collectives", "scenarios", "wordcount", "Scenario", "aggregate"]
