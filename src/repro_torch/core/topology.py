"""Network topologies the p4mr compiler places programs onto.

Two concrete families:

* ``SwitchTopology`` — an arbitrary host/switch graph, used for the
  paper-faithful §5.2 example (6 hosts + 6 switches, Fig 10).
* ``TorusTopology`` — an N-dimensional wrap-around torus of accelerator
  chips. Every vertex is simultaneously a "switch" (it can compute
  in transit) and a "host" (it holds a data shard). Mesh axes map 1:1 to
  torus dimensions, so a placement on this topology is directly realizable
  as one program over the world-dim mesh with ``ppermute`` routing.

Both expose the same interface: ``switches``, ``hosts``, ``neighbors``,
``hop_distance``, ``shortest_path`` — all the compiler needs.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Hashable, Sequence

NodeId = Hashable


@dataclasses.dataclass
class SwitchTopology:
    """Arbitrary undirected graph. ``host_uplink[h]`` = the switch h attaches to."""

    adjacency: dict[NodeId, tuple[NodeId, ...]]
    host_uplink: dict[str, NodeId]

    def __post_init__(self):
        for u, nbrs in self.adjacency.items():
            for v in nbrs:
                if u not in self.adjacency.get(v, ()):  # undirected check
                    raise ValueError(f"asymmetric edge {u}->{v}")

    @property
    def switches(self) -> list[NodeId]:
        return list(self.adjacency)

    @property
    def hosts(self) -> list[str]:
        return list(self.host_uplink)

    def attach_switch(self, host: str) -> NodeId:
        # the paper's DSL writes hosts as "ip_h1"; accept both spellings
        tried = [host]
        if host.startswith("ip_"):
            tried.append(host[3:])
        for form in tried:
            if form in self.host_uplink:
                return self.host_uplink[form]
        raise KeyError(
            f"host {host!r} not attached to any switch "
            f"(tried {' and '.join(repr(t) for t in tried)})"
        )

    def neighbors(self, u: NodeId) -> tuple[NodeId, ...]:
        return self.adjacency[u]

    def shortest_path(self, src: NodeId, dst: NodeId) -> list[NodeId]:
        """BFS shortest path (switch vertices), inclusive of endpoints."""
        if src == dst:
            return [src]
        prev: dict[NodeId, NodeId] = {src: src}
        q = deque([src])
        while q:
            u = q.popleft()
            for v in self.neighbors(u):
                if v not in prev:
                    prev[v] = u
                    if v == dst:
                        path = [v]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return path[::-1]
                    q.append(v)
        raise ValueError(f"no path {src} -> {dst}")

    def hop_distance(self, src: NodeId, dst: NodeId) -> int:
        return len(self.shortest_path(src, dst)) - 1

    def as_indexed(self, num_devices: int | None = None) -> "IndexedSwitchTopology":
        """Embed the named-switch graph into a 0..n-1 integer device axis.

        The torch backend addresses devices by their index on the mesh's
        world dim, so switch ids must be mesh indices. Extra device slots (``num_devices`` larger
        than the switch count) are pads that only size the mesh: they are
        not placement candidates (``switches`` excludes them) and have no
        modeled links.
        """
        return IndexedSwitchTopology(base=self, num_devices=num_devices or len(self.adjacency))


@dataclasses.dataclass
class IndexedSwitchTopology:
    """Integer-indexed view of a ``SwitchTopology`` (see ``as_indexed``).

    Switch k is ``base.switches[k]`` (insertion order); hosts keep their
    names. Exposes the full compiler interface: ``switches``, ``hosts``,
    ``attach_switch``, ``neighbors``, ``shortest_path``, ``hop_distance``.
    Device ids ≥ the switch count are mesh pads: excluded from
    ``switches`` so the placer never routes through a vertex with no
    modeled links.
    """

    base: SwitchTopology
    num_devices: int

    def __post_init__(self):
        names = list(self.base.adjacency)
        if self.num_devices < len(names):
            raise ValueError(
                f"num_devices {self.num_devices} < switch count {len(names)}"
            )
        self.name_to_id = {s: i for i, s in enumerate(names)}
        self.id_to_name = {i: s for s, i in self.name_to_id.items()}

    @property
    def switches(self) -> list[int]:
        return list(range(len(self.base.adjacency)))

    @property
    def hosts(self) -> list[str]:
        return self.base.hosts

    def attach_switch(self, host: str) -> int:
        return self.name_to_id[self.base.attach_switch(host)]

    def neighbors(self, u: int) -> tuple[int, ...]:
        if u not in self.id_to_name:
            return ()
        return tuple(self.name_to_id[v] for v in self.base.neighbors(self.id_to_name[u]))

    def shortest_path(self, src: int, dst: int) -> list[int]:
        if src == dst:
            return [src]
        if src not in self.id_to_name or dst not in self.id_to_name:
            raise ValueError(
                f"no modeled path {src} -> {dst}: pad devices "
                f"(ids >= {len(self.id_to_name)}) have no links"
            )
        return [
            self.name_to_id[s]
            for s in self.base.shortest_path(self.id_to_name[src], self.id_to_name[dst])
        ]

    def hop_distance(self, src: int, dst: int) -> int:
        return len(self.shortest_path(src, dst)) - 1


def paper_topology() -> SwitchTopology:
    """Fig 10: six switches in a ring-ish fabric, six hosts.

    The figure shows h1..h3 as sources (attached to S1..S3) and h6 as the
    collection endpoint (attached to S6); switches form a 2x3 grid.
    """
    adj = {
        "S1": ("S2", "S4"),
        "S2": ("S1", "S3", "S5"),
        "S3": ("S2", "S6"),
        "S4": ("S1", "S5"),
        "S5": ("S2", "S4", "S6"),
        "S6": ("S3", "S5"),
    }
    hosts = {"h1": "S1", "h2": "S2", "h3": "S3", "h4": "S4", "h5": "S5", "h6": "S6"}
    return SwitchTopology(adjacency=adj, host_uplink=hosts)


def fat_tree_topology(k: int = 4) -> SwitchTopology:
    """k-ary fat-tree (Al-Fares et al.): k pods of k/2 edge + k/2 aggregation
    switches, (k/2)² core switches, (k/2)² hosts per pod.

    The canonical datacenter shuffle fabric: many equal-cost paths between
    pods, so this is where queue-aware ECMP tie-breaking and bucket→switch
    assignment actually have room to spread load. Hosts are ``h<i>``,
    attached (k/2 each) to the edge switches. ``k`` must be even.
    """
    if k < 2 or k % 2:
        raise ValueError(f"fat-tree arity must be even and >= 2, got {k}")
    half = k // 2
    adj: dict[NodeId, set[NodeId]] = {}

    def link(a: NodeId, b: NodeId) -> None:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)

    for pod in range(k):
        for e in range(half):
            for a in range(half):
                link(f"E{pod}_{e}", f"A{pod}_{a}")
    # core switch C<a>_<c> connects to aggregation switch a of every pod
    for a in range(half):
        for c in range(half):
            for pod in range(k):
                link(f"C{a}_{c}", f"A{pod}_{a}")

    hosts: dict[str, NodeId] = {}
    h = 0
    for pod in range(k):
        for e in range(half):
            for _ in range(half):
                hosts[f"h{h}"] = f"E{pod}_{e}"
                h += 1
    return SwitchTopology(
        adjacency={sw: tuple(sorted(nbrs)) for sw, nbrs in sorted(adj.items())},
        host_uplink=hosts,
    )


@dataclasses.dataclass
class TorusTopology:
    """N-D wrap-around torus of devices; vertex ids are flat ints.

    ``dims`` follows the mesh shape, e.g. (16, 16) for one v5e pod slice or
    (2, 16, 16) for the 2-pod production mesh (the leading "pod" dim has no
    wrap ICI in reality — cross-pod hops go over DCN — so ``wrap_dims``
    lets us mark it linear and give it a distance penalty).
    """

    dims: tuple[int, ...]
    wrap_dims: tuple[bool, ...] | None = None
    # relative cost of one hop along each dim (DCN hop >> ICI hop)
    hop_cost: tuple[float, ...] | None = None

    def __post_init__(self):
        if self.wrap_dims is None:
            self.wrap_dims = tuple(True for _ in self.dims)
        if self.hop_cost is None:
            self.hop_cost = tuple(1.0 for _ in self.dims)
        if not (len(self.dims) == len(self.wrap_dims) == len(self.hop_cost)):
            raise ValueError("dims/wrap_dims/hop_cost length mismatch")

    @property
    def num_devices(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def switches(self) -> list[int]:
        return list(range(self.num_devices))

    @property
    def hosts(self) -> list[str]:
        # every device doubles as a host (holds a data shard)
        return [f"d{i}" for i in range(self.num_devices)]

    def attach_switch(self, host: str) -> int:
        if not host.startswith("d"):
            raise ValueError(f"torus hosts are 'd<idx>', got {host!r}")
        return int(host[1:])

    def coords(self, flat: int) -> tuple[int, ...]:
        c = []
        for d in reversed(self.dims):
            c.append(flat % d)
            flat //= d
        return tuple(reversed(c))

    def flat(self, coords: Sequence[int]) -> int:
        f = 0
        for c, d in zip(coords, self.dims):
            f = f * d + (c % d)
        return f

    def neighbors(self, u: int) -> tuple[int, ...]:
        cu = list(self.coords(u))
        out = []
        for ax, d in enumerate(self.dims):
            if d == 1:
                continue
            for step in (-1, 1):
                c = list(cu)
                nxt = c[ax] + step
                if self.wrap_dims[ax]:
                    c[ax] = nxt % d
                elif 0 <= nxt < d:
                    c[ax] = nxt
                else:
                    continue
                v = self.flat(c)
                if v != u:
                    out.append(v)
        return tuple(dict.fromkeys(out))

    def _axis_dist(self, a: int, b: int, ax: int) -> int:
        d = self.dims[ax]
        lin = abs(a - b)
        return min(lin, d - lin) if self.wrap_dims[ax] else lin

    def hop_distance(self, src: int, dst: int) -> int:
        ca, cb = self.coords(src), self.coords(dst)
        return sum(self._axis_dist(a, b, ax) for ax, (a, b) in enumerate(zip(ca, cb)))

    def weighted_distance(self, src: int, dst: int) -> float:
        ca, cb = self.coords(src), self.coords(dst)
        return sum(
            self._axis_dist(a, b, ax) * self.hop_cost[ax]
            for ax, (a, b) in enumerate(zip(ca, cb))
        )

    def shortest_path(self, src: int, dst: int) -> list[int]:
        """Dimension-ordered routing (deterministic, torus-minimal)."""
        path = [src]
        cur = list(self.coords(src))
        tgt = self.coords(dst)
        for ax, d in enumerate(self.dims):
            while cur[ax] != tgt[ax]:
                fwd = (tgt[ax] - cur[ax]) % d
                bwd = (cur[ax] - tgt[ax]) % d
                if self.wrap_dims[ax] and bwd < fwd:
                    cur[ax] = (cur[ax] - 1) % d
                else:
                    cur[ax] = (cur[ax] + 1) % d if self.wrap_dims[ax] else cur[ax] + (1 if tgt[ax] > cur[ax] else -1)
                path.append(self.flat(cur))
        return path

    def ring_order(self, axis: int) -> list[list[int]]:
        """Groups of device ids forming rings along ``axis`` (for ppermute)."""
        groups = []
        other = [range(d) for i, d in enumerate(self.dims) if i != axis]
        for rest in itertools.product(*other):
            ring = []
            for k in range(self.dims[axis]):
                coords = list(rest)
                coords.insert(axis, k)
                ring.append(self.flat(coords))
            groups.append(ring)
        return groups


def production_torus(multi_pod: bool = False) -> TorusTopology:
    """Matches launch.mesh.make_production_mesh: (pod, data, model)."""
    if multi_pod:
        # pod axis is DCN (no wrap, expensive); data/model are ICI torus dims
        return TorusTopology(dims=(2, 16, 16), wrap_dims=(False, True, True), hop_cost=(16.0, 1.0, 1.0))
    return TorusTopology(dims=(16, 16))
