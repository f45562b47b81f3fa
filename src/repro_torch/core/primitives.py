"""p4mr primitive IR.

The paper (§5) exposes a small set of primitives users compose into a
program: ``store``/``load`` (bind a data source), ``map`` (per-item
transform), ``SUM`` (stateful reduce on a switch), plus hash-routing and a
collection signal. We reproduce that IR faithfully and extend it with the
reductions an accelerator hop can perform at line rate (a "switch" with
vector units is not limited to 64-bit register adds).

Every node is a frozen dataclass; a program is a DAG of nodes (see
``dag.py``). Placement assigns nodes to mesh devices ("switches"),
routing generates ``ppermute`` schedules, and
``compiler/torch_backend.py`` runs them over the world-dim mesh. The
reductions and map functions act on ``torch`` tensors.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Mapping

import numpy as np


class ReduceKind(enum.Enum):
    """Reductions a hop can apply in transit (paper supports SUM only)."""

    SUM = "sum"
    MAX = "max"
    MIN = "min"
    COUNT = "count"

    @property
    def identity(self) -> float:
        return {"sum": 0.0, "count": 0.0, "max": -np.inf, "min": np.inf}[self.value]

    def combine(self, a, b):
        import torch

        if self in (ReduceKind.SUM, ReduceKind.COUNT):
            return a + b
        if self is ReduceKind.MAX:
            return torch.maximum(a, b)
        return torch.minimum(a, b)


# Supported element dtypes — the paper's packet format carries a 64-bit
# data field; we allow the narrower on-the-wire types used by compression.
WIRE_DTYPES = ("uint64", "uint32", "int32", "float32", "bfloat16", "float64")


@dataclasses.dataclass(frozen=True)
class PacketFormat:
    """§5 Fig 11: the fixed p4mr packet header format.

    preamble(64b) | app_id(8b) | routing_id(8b) | collection_id(8b) | data(64b)

    On an accelerator the "packet" is a fixed-shape chunk of a collective message; the
    header overhead is the per-chunk fixed cost (dispatch latency). We keep
    the byte accounting so the serialization model (§3) can price both.
    """

    preamble_bits: int = 64
    app_id_bits: int = 8
    routing_id_bits: int = 8
    collection_id_bits: int = 8
    data_bits: int = 64

    @property
    def header_bits(self) -> int:
        return self.preamble_bits + self.app_id_bits + self.routing_id_bits + self.collection_id_bits

    @property
    def total_bits(self) -> int:
        return self.header_bits + self.data_bits

    @property
    def goodput_fraction(self) -> float:
        """Fraction of wire bytes that are payload (1 item per packet)."""
        return self.data_bits / self.total_bits

    def packets_per_mtu(self, mtu_bytes: int = 1500) -> int:
        """How many data items fit in one MTU-packed packet (§3)."""
        usable = mtu_bytes * 8 - self.header_bits
        return max(1, usable // self.data_bits)


DEFAULT_PACKET = PacketFormat()


@dataclasses.dataclass(frozen=True)
class Node:
    """Base IR node. ``name`` is the program-unique label (paper: A..E)."""

    name: str

    @property
    def deps(self) -> tuple[str, ...]:
        return ()

    # Per-node stateful-memory requirement (bytes) for placement budgeting.
    def state_bytes(self, item_bytes: int = 8) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class Store(Node):
    """``A := store<uint_64>("ip_h1:path_A")`` — bind a data source.

    ``host`` is the source endpoint (a host id in the paper topology, a data
    shard index on a device mesh); ``path`` is opaque to the compiler.
    """

    host: str = ""
    path: str = ""
    dtype: str = "uint64"
    items: int = 0  # declared cardinality (0 = unknown)

    def __post_init__(self):
        if self.dtype not in WIRE_DTYPES:
            raise ValueError(f"unsupported wire dtype {self.dtype!r}; one of {WIRE_DTYPES}")


@dataclasses.dataclass(frozen=True)
class MapFn(Node):
    """Per-item transform applied in transit (serialization, cast, scale).

    ``fn_name`` selects a registered pure function; switches apply it on the
    wire (S3 fused map). ``src`` is the upstream label.
    """

    src: str = ""
    fn_name: str = "identity"

    @property
    def deps(self) -> tuple[str, ...]:
        return (self.src,)


@dataclasses.dataclass(frozen=True)
class KeyBy(Node):
    """Hash-route items to one of ``num_buckets`` reducers (mapper→reducer).

    This is the paper's hash-based forwarding from mappers to reducers and,
    on a device mesh, the ``all_to_all`` shuffle key. The compiler's ``lower-shuffle``
    pass expands a KeyBy-fed reduce into per-bucket ``ShuffleBucket`` edges
    and per-bucket reducers, so the fan-out becomes compiler-visible routed
    traffic instead of a pass-through annotation.

    ``weights`` optionally declares the expected per-bucket traffic shares
    (a skew histogram, relative — need not sum to 1). The lowering sizes
    each bucket's slice of the key space proportionally, so a hot bucket
    carries more wire items and larger reducer state.
    """

    src: str = ""
    num_buckets: int = 1
    weights: tuple[float, ...] | None = None

    def __post_init__(self):
        if self.weights is not None:
            if len(self.weights) != self.num_buckets:
                raise ValueError(
                    f"keyby {self.name!r}: {len(self.weights)} weights for "
                    f"{self.num_buckets} buckets"
                )
            if any(w < 0 for w in self.weights) or sum(self.weights) <= 0:
                raise ValueError(f"keyby {self.name!r}: weights must be >=0 with a positive sum")

    @property
    def deps(self) -> tuple[str, ...]:
        return (self.src,)


@dataclasses.dataclass(frozen=True)
class ShuffleBucket(Node):
    """One bucket of a lowered KeyBy: the slice of ``src``'s key space that
    hash-routes to bucket ``bucket`` (``lower-shuffle`` pass output).

    The bucketing "hash" is the order-preserving range partition the word
    count shuffle uses (bucket = key // bucket_width): the node carries
    ``src[offset : offset + width]``, so concatenating a KeyBy's buckets
    reconstructs the upstream exactly. Stateless per-packet filter — it
    rides on the upstream's switch; the per-bucket routed edge is the edge
    from this node to its (per-bucket) reducer.
    """

    src: str = ""
    bucket: int = 0
    num_buckets: int = 1
    offset: int = 0
    width: int = 1

    @property
    def deps(self) -> tuple[str, ...]:
        return (self.src,)


@dataclasses.dataclass(frozen=True)
class Concat(Node):
    """Reassemble per-bucket reducer outputs in bucket order (shuffle
    collection phase). Stateless; output = concatenation of ``srcs``."""

    srcs: tuple[str, ...] = ()

    @property
    def deps(self) -> tuple[str, ...]:
        return tuple(self.srcs)


@dataclasses.dataclass(frozen=True)
class Reduce(Node):
    """``D := SUM(A, B)`` — stateful in-transit reduction of ≥1 upstreams."""

    srcs: tuple[str, ...] = ()
    kind: ReduceKind = ReduceKind.SUM
    # width of the reducer state table (1 for scalar SUM; vocab-size for
    # word-count; gradient-bucket length for DP aggregation)
    state_width: int = 1

    @property
    def deps(self) -> tuple[str, ...]:
        return tuple(self.srcs)

    def state_bytes(self, item_bytes: int = 8) -> int:
        return self.state_width * item_bytes


@dataclasses.dataclass(frozen=True)
class Collect(Node):
    """Collection signal (§2/§5): flush reducer state to the sink host."""

    src: str = ""
    sink_host: str = ""

    @property
    def deps(self) -> tuple[str, ...]:
        return (self.src,)


# Registered map functions (S3 "map in transit" transforms). All pure.
def _identity(x):
    return x


def _to_bf16(x):
    import torch

    return x.to(torch.bfloat16)


def _from_bf16(x):
    import torch

    return x.to(torch.float32)


def _square(x):
    return x * x


def _negate(x):
    return -x


MAP_FNS: Mapping[str, Callable[[Any], Any]] = {
    "identity": _identity,
    "to_bf16": _to_bf16,
    "from_bf16": _from_bf16,
    "square": _square,
    "negate": _negate,
}


def register_map_fn(name: str, fn: Callable[[Any], Any]) -> None:
    if name in MAP_FNS:
        raise ValueError(f"map fn {name!r} already registered")
    dict.__setitem__(MAP_FNS, name, fn)  # type: ignore[attr-defined]


NODE_TYPES = (Store, MapFn, KeyBy, ShuffleBucket, Concat, Reduce, Collect)
