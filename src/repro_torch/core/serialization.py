"""§3 — the cost model of data-plane serialization.

The paper's setting: a data set must be framed as fixed-format packets,
one data item each, before switches can reduce it. Either the **server
CPU** serializes (sends one small packet per item), or the **switch**
does: the server sends MTU-packed packets and the switch *recirculates*
each packet k times to split out the k items. Recirculated packets share
the pipeline with fresh arrivals, so ingest must be throttled.

Paper model (Eq. 1): divide time into N slices; each slice the in-flight
rate compounds by (1 + 1/N); at equilibrium

    lim_{N->inf} r * (1 + 1/N)^N = C      =>      r = C / e

so a port of capacity C sustains ingest C/e ≈ 0.3679·C and the throughput
penalty is C·(1 − 1/e). For GbE, r = 1000/e = 367.88 Mbps — the paper
rate-limits Scenario-3 servers to exactly this.

We implement the model exactly, a discrete-time simulator that reproduces
the compounding construction (validating the limit), and — for the device
adaptation — the α–β chunking model that plays the same role for
collective buckets: a fixed per-chunk cost (the "header"/launch latency)
against pipelining gain, yielding the optimal gradient-bucket size (the
reference's ``optim.distributed`` reads it).
"""
from __future__ import annotations

import dataclasses
import math

E = math.e


# --------------------------------------------------------------------------
# Paper model, Eq. (1)
# --------------------------------------------------------------------------
def equilibrium_ingest_rate(capacity: float) -> float:
    """r = C/e: max sustainable ingest when the switch serializes (§3)."""
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    return capacity / E


def throughput_penalty(capacity: float) -> float:
    """C(1 − 1/e): port throughput lost to recirculation (§3)."""
    return capacity * (1.0 - 1.0 / E)


def compounding_equilibrium(capacity: float, n_slices: int) -> float:
    """The finite-N version of Eq. (1): r s.t. r·(1+1/N)^N = C.

    Converges to C/e from below as N→∞ — the simulator checks this.
    """
    if n_slices < 1:
        raise ValueError("n_slices must be >= 1")
    return capacity / (1.0 + 1.0 / n_slices) ** n_slices


def simulate_recirculation(capacity: float, n_slices: int, ingest: float) -> tuple[float, bool]:
    """Discrete-time simulation of the paper's compounding process.

    Start with in-flight load = ``ingest``; each of ``n_slices`` steps the
    recirculating fraction re-enters, compounding load by (1 + 1/N).
    Returns (final_load, sustainable) where sustainable := final ≤ C.
    """
    load = ingest
    for _ in range(n_slices):
        load *= 1.0 + 1.0 / n_slices
    return load, load <= capacity + 1e-9


def max_sustainable_ingest(capacity: float, n_slices: int, tol: float = 1e-9) -> float:
    """Bisection on the simulator — must agree with compounding_equilibrium."""
    lo, hi = 0.0, capacity
    while hi - lo > tol * capacity:
        mid = 0.5 * (lo + hi)
        _, ok = simulate_recirculation(capacity, n_slices, mid)
        lo, hi = (mid, hi) if ok else (lo, mid)
    return lo


# --------------------------------------------------------------------------
# Item-level refinement (beyond paper; documented in EXPERIMENTS.md).
# The paper's model is item-count agnostic; a pass-level queue sim shows the
# penalty actually depends on items-per-packet k (each pass emits one item
# and recirculates the remainder => k pipeline passes per ingested packet).
# --------------------------------------------------------------------------
def item_level_sustainable_ingest(capacity_pps: float, items_per_packet: int) -> float:
    """Packets/s sustainable when each packet needs k pipeline passes."""
    if items_per_packet < 1:
        raise ValueError("items_per_packet >= 1")
    return capacity_pps / items_per_packet


# --------------------------------------------------------------------------
# Where should serialization run? (§3 closing question, §4 scenarios)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SerializationDecision:
    on_switch: bool
    server_time_s: float
    switch_time_s: float

    @property
    def chosen_time_s(self) -> float:
        return self.switch_time_s if self.on_switch else self.server_time_s


def choose_serialization(
    data_bytes: float,
    cpu_serialize_bps: float,
    link_bps: float,
    *,
    header_overhead: float = 1.0,
) -> SerializationDecision:
    """Pick server-CPU vs in-network serialization by completion time.

    Server path (S2): CPU packetizes at ``cpu_serialize_bps`` then sends
    one-item packets (wire inflated by ``header_overhead`` ≥ 1) at link
    rate; CPU and NIC pipeline, so time = max of the two stages.
    Switch path (S3): send MTU-packed at the throttled rate C/e.
    """
    server = max(data_bytes / cpu_serialize_bps, data_bytes * header_overhead / link_bps)
    switch = data_bytes / equilibrium_ingest_rate(link_bps)
    return SerializationDecision(on_switch=switch < server, server_time_s=server, switch_time_s=switch)


# --------------------------------------------------------------------------
# α–β chunk model → gradient bucket sizing (device adaptation)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-hop cost model: time(bytes) = alpha + bytes * beta."""

    alpha_s: float = 1e-6  # per-message fixed cost (the "packet header")
    beta_s_per_byte: float = 1.0 / 50e9  # the reference's default: a TPU ICI link, ~50 GB/s

    def time(self, nbytes: float) -> float:
        return self.alpha_s + nbytes * self.beta_s_per_byte


def ring_all_reduce_time(nbytes: float, world: int, link: LinkModel, chunks: int = 1) -> float:
    """Time of a chunked ring all-reduce of ``nbytes`` over ``world`` hops.

    Classic 2(p−1) step ring; with c chunks the steps pipeline, so
    T = (2(p−1) + c − 1) · (α + (S/(p·c))·β).
    """
    if world <= 1:
        return 0.0
    per_msg = nbytes / (world * chunks)
    steps = 2 * (world - 1) + (chunks - 1)
    return steps * link.time(per_msg)


def optimal_chunks(nbytes: float, world: int, link: LinkModel, max_chunks: int = 4096) -> int:
    """argmin over chunk count of ``ring_all_reduce_time`` (integer scan).

    The continuous optimum is c* ≈ sqrt(S·β·(2p−3)/(p·α)); we scan the
    neighbourhood to stay exact for small sizes.
    """
    if world <= 1 or nbytes <= 0:
        return 1
    best_c, best_t = 1, ring_all_reduce_time(nbytes, world, link, 1)
    c = 1
    while c <= max_chunks:
        t = ring_all_reduce_time(nbytes, world, link, c)
        if t < best_t:
            best_c, best_t = c, t
        c *= 2
    return best_c


def optimal_bucket_bytes(
    total_bytes: float,
    world: int,
    link: LinkModel,
    overlap_window_s: float = 0.0,
) -> float:
    """Bucket size for overlap-with-backward gradient aggregation.

    With B buckets the exposed time is roughly the last bucket's ring time
    plus per-bucket launch overhead; balancing B·2(p−1)·α against the
    (S/B)·β tail gives  b* = sqrt(S · β_eff · α_eff)-shaped optimum:

        B* = sqrt( S · β · / (p · α) ),   b* = S / B*

    clipped to [1 MiB, S]. ``overlap_window_s`` > 0 (backward-pass time
    available for hiding) only shrinks the exposed tail, never changes b*'s
    order of magnitude, so we keep the closed form and let the simulator in
    benchmarks/bench_collectives.py confirm.
    """
    if total_bytes <= 0 or world <= 1:
        return max(total_bytes, 1.0)
    beta_eff = link.beta_s_per_byte * 2.0 * (world - 1) / world
    alpha_eff = link.alpha_s * 2.0 * (world - 1)
    b_star = math.sqrt(total_bytes * alpha_eff / max(beta_eff, 1e-30))
    return float(min(max(b_star, 1 << 20), total_bytes))
