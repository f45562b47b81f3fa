"""Fault tolerance and elasticity: the port's copy of
``repro/runtime/fault_tolerance.py``, with the same behaviour.

* ``HeartbeatMonitor``: hosts report heartbeats; a host silent for
  ``timeout_s`` is declared dead, and a host that beats again is
  re-admitted.
* ``StragglerPolicy``: a host whose step time exceeds ``factor`` × the
  fleet's median for ``patience`` steps in a row is flagged for eviction.
* ``elastic_mesh_plan``: given the surviving device count, the largest
  valid mesh: the data axis shrinks to a power of two and the model (TP)
  axis is kept, since TP is part of the checkpointed layout. On one card the
  mesh is the world dims of a ``Mesh``, its model axis included.
* ``FleetSimulator``: scripted failures and recoveries for tests.

The restart itself is ``launch/train.py``'s: on a failure it restores the
latest checkpoint on the smaller world and carries on at that step (the
batch at a step is a function of (seed, step), whatever the world).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 30.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._last: dict[str, float] = {}
        self._dead: set[str] = set()

    def register(self, host: str):
        self._last[host] = self.clock()

    def beat(self, host: str):
        if host in self._dead:
            self._dead.discard(host)  # a recovered host is re-admitted
        self._last[host] = self.clock()

    def dead_hosts(self) -> set[str]:
        now = self.clock()
        for h, t in self._last.items():
            if now - t > self.timeout_s:
                self._dead.add(h)
        return set(self._dead)

    @property
    def alive(self) -> list[str]:
        dead = self.dead_hosts()
        return [h for h in self._last if h not in dead]


@dataclasses.dataclass
class StragglerPolicy:
    factor: float = 2.0
    patience: int = 3

    def __post_init__(self):
        self._strikes: dict[str, int] = {}

    def observe(self, step_times: dict[str, float]) -> set[str]:
        """Feed per-host step durations; returns the hosts to evict."""
        if not step_times:
            return set()
        med = sorted(step_times.values())[len(step_times) // 2]
        evict = set()
        for h, t in step_times.items():
            if t > self.factor * max(med, 1e-9):
                self._strikes[h] = self._strikes.get(h, 0) + 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.patience:
                evict.add(h)
        return evict


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def elastic_mesh_plan(n_devices: int, *, model_size: int, pod_size: int = 1) -> MeshPlan:
    """The largest mesh of at most ``n_devices`` that keeps the model (TP)
    axis: the data axis absorbs every shrink and growth, as the largest
    power of two that fits (ring collectives and even shards)."""
    if n_devices < model_size:
        raise ValueError(f"cannot keep tp={model_size} with only {n_devices} devices")
    data = n_devices // (model_size * pod_size)
    d = 1
    while d * 2 <= data:
        d *= 2
    if pod_size > 1:
        return MeshPlan((pod_size, d, model_size), ("pod", "data", "model"))
    return MeshPlan((d, model_size), ("data", "model"))


@dataclasses.dataclass
class FleetSimulator:
    """Deterministic failure injection for tests and benchmarks."""

    n_hosts: int
    fail_at: dict[int, list[str]] = dataclasses.field(default_factory=dict)
    recover_at: dict[int, list[str]] = dataclasses.field(default_factory=dict)

    def hosts_at(self, step: int) -> list[str]:
        alive = {f"host{i}" for i in range(self.n_hosts)}
        for s in sorted(self.fail_at):
            if s <= step:
                alive -= set(self.fail_at[s])
        for s in sorted(self.recover_at):
            if s <= step:
                alive |= set(self.recover_at[s])
        return sorted(alive)
