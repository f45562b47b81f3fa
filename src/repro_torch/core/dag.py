"""p4mr program → dependency DAG (§5 Fig 9: parse → DAG → place → route).

``Program`` is an ordered collection of IR nodes with label uniqueness and
dependency validation; ``toposort`` yields a deterministic schedulable
order. The compiler downstream (placement/routing/codelet) consumes only
this structure.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

from repro_torch.core import primitives as prim


class ProgramError(ValueError):
    pass


@dataclasses.dataclass
class Program:
    nodes: dict[str, prim.Node] = dataclasses.field(default_factory=dict)

    # ---------------------------------------------------------- builders --
    def add(self, node: prim.Node) -> prim.Node:
        if node.name in self.nodes:
            raise ProgramError(f"duplicate label {node.name!r}")
        for d in node.deps:
            if d not in self.nodes:
                raise ProgramError(f"{node.name!r} depends on undefined label {d!r}")
        self.nodes[node.name] = node
        return node

    def store(self, name: str, host: str, path: str = "", dtype: str = "uint64", items: int = 0):
        return self.add(prim.Store(name=name, host=host, path=path, dtype=dtype, items=items))

    def map(self, name: str, src: str, fn_name: str = "identity"):
        if fn_name not in prim.MAP_FNS:
            raise ProgramError(f"unknown map fn {fn_name!r}")
        return self.add(prim.MapFn(name=name, src=src, fn_name=fn_name))

    def key_by(self, name: str, src: str, num_buckets: int, weights=None):
        if num_buckets < 1:
            raise ProgramError("num_buckets must be >= 1")
        return self.add(
            prim.KeyBy(
                name=name, src=src, num_buckets=num_buckets,
                weights=tuple(weights) if weights is not None else None,
            )
        )

    def bucket(self, name: str, src: str, bucket: int, num_buckets: int, offset: int, width: int):
        if not 0 <= bucket < num_buckets:
            raise ProgramError(f"bucket {bucket} out of range [0, {num_buckets})")
        return self.add(
            prim.ShuffleBucket(
                name=name, src=src, bucket=bucket, num_buckets=num_buckets,
                offset=offset, width=width,
            )
        )

    def concat(self, name: str, *srcs: str):
        if not srcs:
            raise ProgramError(f"concat {name!r} needs at least one source")
        return self.add(prim.Concat(name=name, srcs=tuple(srcs)))

    def sum(self, name: str, *srcs: str, state_width: int = 1):
        return self.add(
            prim.Reduce(name=name, srcs=tuple(srcs), kind=prim.ReduceKind.SUM, state_width=state_width)
        )

    def reduce(self, name: str, *srcs: str, kind: prim.ReduceKind, state_width: int = 1):
        return self.add(prim.Reduce(name=name, srcs=tuple(srcs), kind=kind, state_width=state_width))

    def collect(self, name: str, src: str, sink_host: str):
        return self.add(prim.Collect(name=name, src=src, sink_host=sink_host))

    # -------------------------------------------------------- rewriting --
    @classmethod
    def from_nodes(cls, nodes: Iterable[prim.Node]) -> "Program":
        """Rebuild a program from an arbitrary node iterable (compiler
        passes emit nodes in rewrite order, not necessarily dep order).
        Validates label uniqueness, dep closure and acyclicity."""
        p = cls()
        for n in nodes:
            if n.name in p.nodes:
                raise ProgramError(f"duplicate label {n.name!r}")
            p.nodes[n.name] = n
        for n in p.nodes.values():
            for d in n.deps:
                if d not in p.nodes:
                    raise ProgramError(f"{n.name!r} depends on undefined label {d!r}")
        p.validate()
        return p

    def copy(self) -> "Program":
        return Program(nodes=dict(self.nodes))

    # -------------------------------------------------------- structure --
    def consumers(self, label: str) -> list[str]:
        return [n.name for n in self.nodes.values() if label in n.deps]

    def sinks(self) -> list[str]:
        # one pass over all deps instead of consumers() per node (which
        # would rescan every node per call — quadratic on shuffle-sized
        # programs, and sinks() sits on the simulators' report path)
        consumed = {d for n in self.nodes.values() for d in n.deps}
        return [name for name in self.nodes if name not in consumed]

    def sources(self) -> list[str]:
        return [n.name for n in self.nodes.values() if isinstance(n, prim.Store)]

    def validate(self) -> None:
        """Well-formedness: acyclic (by construction), every non-Store has
        deps, every Reduce has >=1 src, sinks should be Collect or Reduce."""
        if not self.nodes:
            raise ProgramError("empty program")
        for n in self.nodes.values():
            if isinstance(n, prim.Reduce) and not n.srcs:
                raise ProgramError(f"reduce {n.name!r} has no sources")
            if not isinstance(n, prim.Store) and not n.deps:
                raise ProgramError(f"{n.name!r} has no dependencies")
        # acyclicity is guaranteed by add() (deps must pre-exist), but a
        # program assembled directly via .nodes bypasses that — check.
        list(self.toposort())

    def toposort(self) -> Iterator[prim.Node]:
        """Deterministic topological order (Kahn, insertion-order ties)."""
        # reverse index built once: consumers() per emitted node would
        # rescan all nodes each time, and toposort runs on every program
        # iteration (cost model, passes, simulators)
        cons: dict[str, list[str]] = {}
        indeg: dict[str, int] = {}
        for name, node in self.nodes.items():
            uniq = set(node.deps)
            indeg[name] = len(uniq)
            for d in uniq:
                cons.setdefault(d, []).append(name)
        # insertion-order ties: consumers were appended in node order, and
        # the ready list is FIFO, matching the original scan order
        ready = [name for name, d in indeg.items() if d == 0]
        emitted = 0
        while ready:
            name = ready.pop(0)
            emitted += 1
            yield self.nodes[name]
            for c in cons.get(name, ()):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if emitted != len(self.nodes):
            raise ProgramError("cycle detected in program DAG")

    def depth(self) -> int:
        """Longest dependency chain — lower-bounds in-transit latency hops."""
        level: dict[str, int] = {}
        for n in self.toposort():
            level[n.name] = 1 + max((level[d] for d in n.deps), default=0)
        return max(level.values(), default=0)

    def total_state_bytes(self, item_bytes: int = 8) -> int:
        return sum(n.state_bytes(item_bytes) for n in self.nodes.values())

    def __iter__(self) -> Iterator[prim.Node]:
        return iter(self.nodes.values())

    def __len__(self) -> int:
        return len(self.nodes)


def paper_example() -> Program:
    """The exact program of §5.2 (Figure 10)."""
    p = Program()
    p.store("A", host="h1", path="path_A", dtype="uint64")
    p.store("B", host="h2", path="path_B", dtype="uint64")
    p.store("C", host="h3", path="path_C", dtype="uint64")
    p.sum("D", "A", "B")
    p.sum("E", "C", "D")
    p.collect("OUT", "E", sink_host="h6")
    return p
