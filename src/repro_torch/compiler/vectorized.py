"""Vectorized tick-synchronous simulator core with per-port VOQs.

The event-ordered engine in ``compiler.simulator`` pays one Python heap
event per super-packet per hop — faithful, but the cost of *simulating*
traffic scales with the traffic. This module rebuilds the inner loop as
a batched array engine over dense per-entry state, where an **entry** is
one flow's queue at one switch, keyed to its output port (the directed
link to the next hop) — a virtual output queue. Each iteration:

1. computes every switch's service allocation in one shot (numpy over
   all entries; optionally torch ops on a device, ``VoqParams.use_torch``),
2. solves for the time ``dt`` until the next state change (a queue
   drains, a link-latency gate opens, a finite buffer fills),
3. advances all queues by ``dt`` in closed form.

Step count therefore scales with *contention changes*, not packets: a
million-packet train crossing an idle fabric is a handful of steps. That
is the ~100× cheaper evaluation autotune's candidate search needs.

Service discipline (``fidelity="voq"``, the default): each switch is
still the §3 single server (1 pkt/tick aggregate, ``CostModel.tick_s``),
allocated to the VOQ whose current backlog formed **earliest** (FIFO by
busy-period start, ties by entry order) — the fluid analogue of the
event engine's arrival-order interleaving. Streams passing through
without waiting are served from the leftover budget in hop order. This
reproduces the event engine's pipelining arithmetic exactly on
uncontended paths (``h + P − 1`` ticks for P packets over h hops, pinned
by tests) and tracks its makespan closely under contention (the
differential suite bounds the gap at 5%); completion *order* of flows
that interleave packet-by-packet inside one busy period is where the
fluid approximation lives.

The port model (firesim's ``switch.cc`` knobs, via ``CostModel``):

* ``sim_link_latency_ticks`` — hop i+1 may start serving this many
  ticks after hop i starts (LINKLATENCY);
* ``sim_port_bw``            — per-output-port packets/tick cap
  (throttle_numer/denom);
* ``sim_buffer_packets``     — finite per-switch transit buffer
  (LIMITED_BUFSIZE); with ``sim_buffer_policy="drop"`` overflow
  arrivals vanish into ``port_drops``, with ``"backpressure"`` the
  upstream VOQ stalls (``port_blocked_ticks``) while sibling VOQs at
  the same switch keep flowing — head-of-line blocking is per *port*,
  not per switch, which is the point of VOQs.

``fidelity="fifo"`` is the compatibility mode: infinite buffers, single
FIFO per switch, scheduled on the tick-bucket calendar — bit-exact with
the event engine (same arithmetic, same order), for when a consumer
needs the reference numbers at lower constant cost.

Reports extend ``SimReport`` with per-port signals (peak VOQ depth,
drops, blocked ticks) that ``reroute-feedback`` turns into link
penalties and ``autotune`` folds into hotspot selection.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Hashable, Mapping

import numpy as np

from repro_torch.core import dag  # noqa: F401  (type context)

NodeId = Hashable

_EPS = 1e-9
# retirement tolerance: fractional tie-split rates (1/3, 1/7, …) leave
# float drift in q/fut that never reaches exact zero. The same tolerance
# is the "has backlog" threshold throughout the step loop — a mid-flow
# entry can hold a sub-_RETIRE crumb (big ``fut`` keeps it alive), and if
# the drain horizon could see it, two tied crumb-holders ping-pong the
# allocation at dt≈crumb/rate per step: a livelock. Crumbs stay parked
# until the flow ends, then vanish inside the retirement tolerance.
_RETIRE = 1e-6
_INF = float("inf")

# steps taken by ``_make_torch_step``'s step (each one a round trip to its
# device), so a caller can show that the torch step, not numpy, ran
STEPS = {"torch": 0}


@dataclasses.dataclass(frozen=True)
class VoqParams:
    """Vectorized-engine knobs, normally read off the ``CostModel``."""

    fidelity: str = "voq"  # "voq" (fluid VOQ core) | "fifo" (bit-exact compat)
    link_latency_ticks: float = 1.0
    port_bw: float | None = None  # packets/tick per output port
    buffer_packets: float | None = None  # per-switch transit buffer
    buffer_policy: str = "backpressure"  # or "drop"
    # the dense per-step math as torch ops (``_make_torch_step``) on
    # ``device``; None = the card. Only with fidelity "voq" and neither a
    # port cap nor a finite buffer, else ``simulate_vectorized`` raises
    use_torch: bool = False
    device: str | None = None

    @classmethod
    def from_cost_model(cls, cm) -> "VoqParams":
        return cls(
            fidelity=getattr(cm, "sim_fidelity", "voq"),
            link_latency_ticks=float(getattr(cm, "sim_link_latency_ticks", 1)),
            port_bw=getattr(cm, "sim_port_bw", None),
            buffer_packets=getattr(cm, "sim_buffer_packets", None),
            buffer_policy=getattr(cm, "sim_buffer_policy", "backpressure"),
            use_torch=bool(getattr(cm, "sim_use_torch", False)),
        )


def simulate_vectorized(
    program,
    spec,
    cost_model,
    *,
    params: VoqParams | None = None,
    release: Mapping[str, float] | None = None,
    observers=None,
):
    """Run the vectorized engine over a prebuilt ``FlowSpec``.

    ``release`` staggers source readiness (see
    ``simulator.simulate_timing``): a flow whose source releases in the
    future is parked on an arrival heap and injected when the fluid
    clock reaches its release tick, so late-arriving jobs never occupy
    queue or buffer state early. ``observers`` subscribes streaming
    sinks (see ``repro_torch.telemetry.stream``) — windows and node events are
    pushed mid-run, forcing sample collection on for this run.
    """
    p = params if params is not None else VoqParams.from_cost_model(cost_model)
    if p.use_torch and (p.fidelity != "voq" or p.port_bw is not None
                        or p.buffer_packets is not None):
        raise ValueError(
            "the torch step (VoqParams.use_torch, CostModel.sim_use_torch) runs "
            "fidelity 'voq' with no sim_port_bw and no sim_buffer_packets only; "
            f"got fidelity={p.fidelity!r}, port_bw={p.port_bw!r}, "
            f"buffer_packets={p.buffer_packets!r}"
        )
    if p.fidelity == "fifo":
        from repro_torch.compiler.simulator import _simulate_event

        return _simulate_event(
            program, spec, cost_model, scheduler="calendar", release=release,
            observers=observers,
        )
    if p.fidelity != "voq":
        raise ValueError(
            f"unknown vectorized fidelity {p.fidelity!r}; one of 'voq', 'fifo'"
        )
    if p.buffer_policy not in ("backpressure", "drop"):
        raise ValueError(
            f"unknown sim_buffer_policy {p.buffer_policy!r}; "
            "one of 'backpressure', 'drop'"
        )
    return _simulate_voq(program, spec, cost_model, p, release=release,
                         observers=observers)


def _simulate_voq(program, spec, cm, p: VoqParams, release=None, observers=None):
    flows = spec.flows
    # ---------------------------------------------------------- indexing --
    switches: list[NodeId] = []
    sw_id: dict[NodeId, int] = {}

    def sid(sw: NodeId) -> int:
        i = sw_id.get(sw)
        if i is None:
            i = sw_id[sw] = len(switches)
            switches.append(sw)
        return i

    esw_l: list[int] = []  # service switch per entry
    enx_l: list[int] = []  # next-hop switch (the output port's far end)
    up_l: list[int] = []  # upstream entry (-1 at the injection hop)
    lvl_l: list[int] = []  # hop index within the flow (0-based)
    last_l: list[bool] = []
    eflow_l: list[int] = []
    flow_base: list[int] = []
    for fid, f in enumerate(flows):
        h = f.hops
        if h == 0:
            flow_base.append(-1)
            continue
        flow_base.append(len(esw_l))
        for j in range(h):
            esw_l.append(sid(f.path[j]))
            enx_l.append(sid(f.path[j + 1]))
            up_l.append(len(esw_l) - 2 if j > 0 else -1)
            lvl_l.append(j)
            last_l.append(j == h - 1)
            eflow_l.append(fid)
    recirc_entry: dict[str, int] = {}
    recirc_label: dict[int, str] = {}
    for name in sorted(spec.merges, key=str):
        if spec.merges[name] > 0 and name in spec.dst_switch:
            e = len(esw_l)
            recirc_entry[name] = e
            recirc_label[e] = name
            s = sid(spec.dst_switch[name])
            esw_l.append(s)
            enx_l.append(s)  # loopback port
            up_l.append(-1)
            lvl_l.append(0)
            last_l.append(False)
            eflow_l.append(-1)

    n = len(esw_l)
    ns = max(1, len(switches))
    esw = np.asarray(esw_l, dtype=np.int64)
    enx = np.asarray(enx_l, dtype=np.int64)
    up = np.asarray(up_l, dtype=np.int64)
    lvl = np.asarray(lvl_l, dtype=np.int64)
    is_last = np.asarray(last_l, dtype=bool)
    eflow = np.asarray(eflow_l, dtype=np.int64)
    dn = np.full(n, -1, dtype=np.int64)
    has_up = up >= 0
    dn[up[has_up]] = np.where(has_up)[0]
    # output ports: unique (switch, next) pairs
    if n:
        port_key = esw * ns + enx
        uniq, pid = np.unique(port_key, return_inverse=True)
        ports = [(int(k // ns), int(k % ns)) for k in uniq]
    else:
        pid = np.zeros(0, dtype=np.int64)
        ports = []
    nport = max(1, len(ports))
    maxlvl = int(lvl.max()) if n else 0

    # ---- opt-in INT telemetry (CostModel.sim_telemetry): sampled series
    # via the collector + per-entry arrival/departure/max-depth arrays.
    # Streaming observers force collection on for this run (they consume
    # the same samples, windowed, mid-flight)
    stream = None
    if observers:
        from repro_torch.telemetry.stream import WindowedStream

        stream = WindowedStream(
            observers,
            window_ticks=getattr(cm, "sim_telemetry_window", 64.0),
            engine="vectorized",
        )
    tel = None
    if getattr(cm, "sim_telemetry", False) or stream is not None:
        from repro_torch.telemetry.fabric import VoqCollector

        tel = VoqCollector(
            getattr(cm, "sim_telemetry_interval", 16.0), esw, pid, ns, nport,
            switches=switches, ports=ports, stream=stream,
        )
        tl_first = np.full(n, _INF)  # first fluid arrival per entry
        tl_done = np.zeros(n)  # retirement tick per entry
        tl_maxq = np.zeros(n)  # deepest effective backlog per entry

    # ------------------------------------------------------- dense state --
    q = np.zeros(n)
    fut = np.zeros(n)
    gate = np.full(n, _INF)
    prio = np.full(n, _INF)
    started = np.zeros(n, dtype=bool)
    active = np.zeros(n, dtype=bool)
    # scalar bookkeeping kept out of numpy: the step loop runs on ~100-entry
    # arrays where every array op is ~1µs of dispatch overhead, so loop
    # guards use plain ints maintained at inject/retire time
    n_active = 0
    lvl_count = [0] * (maxlvl + 1)
    prev_rate = np.zeros(n)  # last step's service rates (inject busy check)

    queued_s = np.zeros(ns)  # direct burst/recirc increments (inject)
    served_tot = np.zeros(n)  # per-entry service, folded into busy_s once
    queued_e = np.zeros(n)  # per-entry queue-arrival accrual, same idea
    maxdepth_s = np.zeros(ns)
    voq_peak = np.zeros(nport)
    blocked_p = np.zeros(nport)
    drops_p = np.zeros(nport)
    qdelay = 0.0
    dropped = 0.0
    recirc_count = 0

    latency = float(p.link_latency_ticks)
    pbw = _INF if p.port_bw is None else float(p.port_bw)
    buffer = None if p.buffer_packets is None else float(p.buffer_packets)
    backpressure = buffer is not None and p.buffer_policy == "backpressure"
    droppy = buffer is not None and p.buffer_policy == "drop"
    switch_rate = 1.0

    pending = dict(spec.in_degree)
    arrived: dict[str, float] = {}
    ready: dict[str, float] = {}

    # staggered releases: flows whose source isn't ready yet wait here as
    # (release tick, seq, flow id) and are injected when the clock arrives
    t = 0.0
    arrivals: list[tuple[float, int, int]] = []
    arr_seq = 0

    # ------------------------------------------------- node-level events --
    def node_ready(name: str, tt: float) -> None:
        if name in ready:  # fire-once (see the event engine's guard)
            return
        ready[name] = tt
        if stream is not None:
            stream.on_node(name, tt)
        for fid in spec.out_flows.get(name, ()):
            inject(fid, tt)

    def inject(fid: int, tt: float) -> None:
        nonlocal n_active, arr_seq
        f = flows[fid]
        if f.hops == 0:
            complete(fid, tt)
            return
        if tt > t + _EPS:
            # future release: the train must not occupy queue/buffer
            # state yet — park it until the clock reaches the tick
            arr_seq += 1
            heapq.heappush(arrivals, (tt, arr_seq, fid))
            return
        base = flow_base[fid]
        end = base + f.hops
        active[base:end] = True
        n_active += f.hops
        for j in range(f.hops):
            lvl_count[j] += 1
        q[base] = float(f.packets)
        fut[base] = 0.0
        if f.hops > 1:
            fut[base + 1 : end] = float(f.packets)
            gate[base + 1 : end] = _INF
        gate[base] = tt
        prio[base] = tt
        started[base:end] = False
        s = int(esw[base])
        # burst queue accounting: the whole train lands at once; all but
        # the immediately-served packet wait when the switch is idle, all
        # of them when it is already occupied (q is zeroed on retirement,
        # so the masked sum sees only live backlogs; prev_rate likewise)
        msw = esw == s
        occ_now = float(q[msw].sum()) - float(f.packets)
        busy_now = occ_now > _EPS or float(prev_rate[msw].sum()) > _EPS
        w = f.packets if busy_now else f.packets - 1
        if w > 0:
            queued_s[s] += w
        if tel is not None:
            tl_first[base] = tt

    def complete(fid: int, tt: float) -> None:
        d = flows[fid].dst
        arrived[d] = max(arrived.get(d, 0.0), tt)
        pending[d] -= 1
        if pending[d] == 0:
            finalize(d, arrived[d])

    def finalize(name: str, tt: float) -> None:
        nonlocal recirc_count, n_active
        m = spec.merges.get(name, 0)
        if m > 0:
            recirc_count += m
            e = recirc_entry.get(name)
            if e is not None:
                # the stored partial re-enters its own switch's pipeline
                # through the loopback port, and always counts as queued
                # (stateful hotspots must stay visible to feedback routing)
                active[e] = True
                n_active += 1
                lvl_count[0] += 1
                q[e] = float(m)
                fut[e] = 0.0
                gate[e] = tt
                prio[e] = tt
                started[e] = False
                queued_s[esw[e]] += m
                if tel is not None:
                    tl_first[e] = tt
                return
            tt += m  # pragma: no cover - reduce with no routed in-edges
        node_ready(name, tt)

    # seed at the propagated release floor: a merge-fed node with no
    # in-flows must still wait for its (transitive) sources' release
    from repro_torch.compiler.simulator import _release_floors

    rel = _release_floors(program, release)
    for name in program.nodes:
        if pending.get(name, 0) == 0:
            node_ready(name, rel.get(name, 0.0))

    torch_step = _make_torch_step(esw, up, lvl, ns, maxlvl, p.device) if (
        p.use_torch and n
    ) else None

    # --------------------------------------------------------- main loop --
    # per-step cost is dominated by numpy dispatch overhead on ~100-entry
    # arrays, so invariants are hoisted, segment mins use one reduceat
    # over a precomputed switch-sorted order (instead of ufunc.at), and
    # every buffer/port-cap feature is gated behind a scalar flag
    steps = 0
    max_steps = 200 * (n + 1) + 10_000
    idx = np.arange(n)
    has_dn = dn >= 0
    hd_idx = idx[has_dn]  # entries feeding a downstream entry …
    dn_idx = dn[hd_idx]  # … and the (unique) entries they feed
    up_safe = np.maximum(up, 0)
    has_up_f = has_up.astype(np.float64)
    lvl_masks = [lvl == L for L in range(maxlvl + 1)]
    order = np.argsort(esw, kind="stable")  # reduceat segments by switch
    esw_sorted = esw[order]
    if n:
        seg_starts = np.flatnonzero(
            np.r_[True, esw_sorted[1:] != esw_sorted[:-1]]
        )
        seg_sw = esw_sorted[seg_starts]
    else:
        seg_starts = np.zeros(0, dtype=np.int64)
        seg_sw = np.zeros(0, dtype=np.int64)
    simple = p.port_bw is None and buffer is None
    ones_s = np.full(ns, switch_rate)

    def segment_min(key: np.ndarray) -> np.ndarray:
        """Per-switch min of ``key`` (+INF where a switch has no entry)."""
        out = np.full(ns, _INF)
        out[seg_sw] = np.minimum.reduceat(key[order], seg_starts)
        return out

    while n_active or arrivals:
        while arrivals and arrivals[0][0] <= t + _EPS:
            tt, _, fid = heapq.heappop(arrivals)
            inject(fid, tt)
        if not n_active:
            if not arrivals:  # due pops were all zero-hop completions
                break
            # idle fabric before the next release — jump the clock
            t = arrivals[0][0]
            continue
        steps += 1
        if steps > max_steps:
            raise ValueError(
                "vectorized simulator exceeded its step budget — possible "
                "buffer deadlock or inconsistent routing table"
            )
        if buffer is not None:
            occ = np.bincount(
                esw, weights=np.where(active, q, 0.0), minlength=ns
            )
        gated = gate <= t + _EPS
        elig = active & (q > _RETIRE) & gated
        if backpressure:
            dn_occ = np.zeros(n)
            dn_occ[has_dn] = occ[enx[has_dn]]
            blocked = has_dn & (dn_occ >= buffer - _EPS)
            elig &= ~blocked

        if torch_step is not None:
            rate, _dt_kernel = torch_step(q, fut, gate, prio, active, t)
            sw_budget = None
        elif simple:
            # fast path: no port caps, no finite buffers. Phase 1 — the
            # tied earliest-busy-period group splits each switch equally
            # (the fluid limit of the event engine's arrival-order
            # interleaving — and what keeps simultaneous bursts symmetric)
            if np.count_nonzero(elig):
                minp = segment_min(np.where(elig, prio, _INF))
                tied = elig & (prio <= minp[esw] + 1e-9)
                cnt = np.bincount(esw, weights=tied, minlength=ns)
                rate = tied / np.maximum(cnt, 1.0)[esw]
            else:
                tied = elig
                rate = np.zeros(n)
            # phase 2: pass-through service from leftover budget, by hop
            # level so a chain of switches streams in one step (steady
            # pipelining; this is what keeps step count independent of P).
            # Demand is the upstream service rate; a switch whose combined
            # demand exceeds its leftover budget throttles proportionally
            pass2 = active & gated & (q <= _RETIRE) & (fut > _EPS)
            if maxlvl and np.count_nonzero(pass2):
                free = ones_s - np.bincount(esw, weights=rate, minlength=ns)
                for level in range(1, maxlvl + 1):
                    if not lvl_count[level]:
                        continue
                    ml = pass2 & lvl_masks[level]
                    if not np.count_nonzero(ml):
                        continue
                    r = rate[up_safe] * ml  # inflow demand; 0 off-mask
                    dem = np.bincount(esw, weights=r, minlength=ns)
                    scale_s = np.where(
                        dem > free,
                        np.maximum(free, 0.0) / np.maximum(dem, _EPS),
                        1.0,
                    )
                    r *= scale_s[esw]
                    rate += r  # levels are disjoint: plain accumulate
                    free -= np.bincount(esw, weights=r, minlength=ns)
        else:
            rate = np.zeros(n)
            sw_budget = np.full(ns, switch_rate)
            port_used = np.zeros(nport)
            # phase 1 under port caps: a capped tied group can leave
            # switch budget for the next priority group, hence 3 rounds
            for _ in range(3):
                m = elig & (rate <= _EPS) & (sw_budget[esw] > _EPS)
                if not m.any():
                    break
                minp = segment_min(np.where(m, prio, _INF))
                tied = m & (prio <= minp[esw] + 1e-9)
                cnt = np.bincount(esw, weights=tied, minlength=ns)
                r = np.where(tied, sw_budget[esw] / np.maximum(cnt, 1.0)[esw], 0.0)
                if p.port_bw is not None:
                    ptot = np.bincount(pid, weights=r, minlength=nport)
                    avail = np.maximum(pbw - port_used, 0.0)
                    scale = np.where(
                        ptot > avail, avail / np.maximum(ptot, _EPS), 1.0
                    )
                    r *= scale[pid]
                got = r > _EPS
                if not got.any():
                    break
                rate[got] = r[got]
                sw_budget -= np.bincount(esw, weights=r, minlength=ns)
                port_used += np.bincount(pid, weights=r, minlength=nport)
            for level in range(1, maxlvl + 1):
                if not lvl_count[level]:
                    continue
                ml = active & lvl_masks[level] & (rate <= _EPS)
                if not ml.any():
                    continue
                infl = np.zeros(n)
                mu = ml & has_up
                infl[mu] = rate[up[mu]]
                m2 = ml & gated & (q <= _RETIRE) & (fut > _EPS) & (infl > _EPS)
                if backpressure:
                    m2 &= ~blocked
                if not m2.any():
                    continue
                r = np.where(m2, infl, 0.0)
                dem = np.bincount(esw, weights=r, minlength=ns)
                scale_s = np.where(
                    dem > sw_budget,
                    np.maximum(sw_budget, 0.0) / np.maximum(dem, _EPS),
                    1.0,
                )
                r *= scale_s[esw]
                if p.port_bw is not None:
                    ptot = np.bincount(pid, weights=r, minlength=nport)
                    avail = np.maximum(pbw - port_used, 0.0)
                    scale_p = np.where(
                        ptot > avail, avail / np.maximum(ptot, _EPS), 1.0
                    )
                    r *= scale_p[pid]
                got = r > _EPS
                if not got.any():
                    continue
                rate[got] = r[got]
                sw_budget -= np.bincount(esw, weights=r, minlength=ns)
                port_used += np.bincount(pid, weights=r, minlength=nport)

        # link-latency gates open one hop downstream of a starting server
        newly = (rate > _EPS) & ~started
        if np.count_nonzero(newly):
            started |= newly
            d_idx = dn[newly]
            d_idx = d_idx[d_idx >= 0]
            gate[d_idx] = np.minimum(gate[d_idx], t + latency)

        inflow = rate[up_safe] * has_up_f
        if droppy:
            full_sw = occ >= buffer - _EPS
            drop_in = has_up & full_sw[esw] & (inflow > _EPS)
            eff_in = np.where(drop_in, 0.0, inflow)
        else:
            eff_in = inflow

        # ------------------------------------------------- time horizon --
        dt = _INF
        net = rate - eff_in
        drain = (q > _RETIRE) & (net > _EPS)  # q>0 implies active
        if np.count_nonzero(drain):
            dt = float((q[drain] / net[drain]).min())
        # every active entry holds q or fut > _RETIRE (retirement clears
        # the rest), so no content guard is needed on the gate wait
        wait_gate = active & (gate > t + _EPS) & (gate < _INF)
        if np.count_nonzero(wait_gate):
            dt = min(dt, float((gate[wait_gate] - t).min()))
        if buffer is not None:
            net_sw = np.bincount(esw, weights=eff_in, minlength=ns) - np.bincount(
                esw, weights=rate, minlength=ns
            )
            filling = (net_sw > _EPS) & (occ < buffer - _EPS)
            if filling.any():
                dt = min(
                    dt, float(((buffer - occ)[filling] / net_sw[filling]).min())
                )
        if arrivals:
            # never step past a pending release (it re-sorts priorities)
            dt = min(dt, max(arrivals[0][0] - t, _EPS))
        if dt == _INF:
            stuck = idx[active]
            raise ValueError(
                "vectorized simulator stalled: no serviceable queue "
                "(buffer deadlock under backpressure?) — "
                f"t={t:.3f}, {len(stuck)} active entries, "
                f"q={q[stuck][:8].tolist()}, fut={fut[stuck][:8].tolist()}, "
                f"gate={gate[stuck][:8].tolist()}, rate={rate[stuck][:8].tolist()}"
            )
        dt = max(dt, _EPS)

        # ----------------------------------------------- accounting (dt) --
        # effective waiting depth excludes the ~latency packets of
        # pipeline fill a saturated wait-free stream keeps in flight
        # (q is zero on inactive entries, so qeff needs no active mask)
        fill = np.minimum(q, np.maximum(eff_in, rate) * latency)
        qeff = q - fill
        if tel is not None:
            np.maximum(tl_maxq, qeff, out=tl_maxq)
            tel_q0 = q.copy() if tel.pending(t, dt) else None
        dep_total = float(qeff.sum())
        if dep_total > _EPS:
            dep_sw = np.bincount(esw, weights=qeff, minlength=ns)
            np.maximum(maxdepth_s, dep_sw, out=maxdepth_s)
            qdelay += dep_total * dt
            voq_now = np.bincount(pid, weights=qeff, minlength=nport)
            np.maximum(voq_peak, voq_now, out=voq_peak)
            # arrivals join the queued count when they land behind a real
            # backlog, or when the entry can't keep up; arrivals during
            # the closed link-latency window are in-flight, not queued
            add_q = np.where(qeff > _EPS, eff_in, np.maximum(eff_in - rate, 0.0))
            queued_e += np.where(gated, add_q, 0.0) * dt
        else:
            # no standing backlog, but a throttled entry may still be
            # falling behind its inflow — that excess queues up too
            exc = eff_in - rate
            if float(exc.max(initial=0.0)) > _EPS:
                queued_e += np.where(gated, np.maximum(exc, 0.0), 0.0) * dt
        if backpressure:
            blk = blocked & active & (q > _RETIRE) & gated
            if blk.any():
                np.add.at(blocked_p, pid[blk], dt)

        # ------------------------------------------------------ advance --
        served = rate * dt
        q -= served
        served_tot += served  # busy_s = one bincount at end of run
        # each entry has at most one upstream, so dn_idx is duplicate-free
        # and plain fancy assignment replaces np.add.at
        amt = served[hd_idx]
        keep_amt = amt
        if droppy:
            dfull = full_sw[enx[hd_idx]]
            if dfull.any():
                drop_amt = np.where(dfull, amt, 0.0)
                keep_amt = amt - drop_amt
                np.add.at(drops_p, pid[hd_idx], drop_amt)
                dropped += float(drop_amt.sum())
                # the dropped packets will never reach anything further
                # down the flow either
                for i_src, a in zip(hd_idx[dfull], drop_amt[dfull]):
                    j = dn[dn[i_src]]
                    while j >= 0:
                        fut[j] -= a
                        j = dn[j]
        fut[dn_idx] -= amt
        q[dn_idx] += keep_amt
        np.maximum(q, 0.0, out=q)
        np.maximum(fut, 0.0, out=fut)
        t += dt
        prev_rate = rate
        if tel is not None:
            # fluid arrival time of each entry's first packets: the step
            # in which its queue first became non-empty
            np.copyto(tl_first, t, where=np.isinf(tl_first) & (q > _EPS))
            if tel_q0 is not None:
                # queues move linearly inside the step — interpolate the
                # sample ticks that landed in (t-dt, t]
                tel.sample(t - dt, dt, tel_q0, q,
                           qeff, np.maximum(q - fill, 0.0),
                           drops_p, blocked_p,
                           served_s=(
                               np.bincount(esw, weights=served_tot,
                                           minlength=ns)
                               if stream is not None else None
                           ))

        # busy-period priorities: reset on drain, stamp on backlog formation
        has_backlog = active & (q > _RETIRE)
        prio = np.where(
            has_backlog, np.where(np.isinf(prio), t, prio), _INF
        )

        # retirement cascades within the step: a finished entry's
        # downstream will see no more arrivals, so its residual ``fut``
        # is float drift from fractional tie-split rates — clear it, which
        # may retire the downstream too (a drifted fut that never reaches
        # exactly zero would otherwise stall the whole simulation)
        while True:
            fin = active & (q <= _RETIRE) & (fut <= _RETIRE)
            if not np.count_nonzero(fin):
                break
            fin_idx = idx[fin]
            active[fin_idx] = False
            if tel is not None:
                tl_done[fin_idx] = t
            q[fin_idx] = 0.0
            fut[fin_idx] = 0.0
            d_idx = dn[fin_idx]
            fut[d_idx[d_idx >= 0]] = 0.0
            n_active -= len(fin_idx)
            for i in fin_idx:
                i = int(i)
                lvl_count[int(lvl[i])] -= 1
                if is_last[i]:
                    complete(int(eflow[i]), t)
                elif i in recirc_label:
                    node_ready(recirc_label[i], t)

    busy_s = np.bincount(esw, weights=served_tot, minlength=ns)
    queued_s += np.bincount(esw, weights=queued_e, minlength=ns)

    undelivered = sorted(name for name, k in pending.items() if k > 0)
    if undelivered:
        raise ValueError(
            f"simulation did not deliver all traffic: {len(undelivered)} node(s) "
            f"never completed ({', '.join(undelivered[:5])}{'…' if len(undelivered) > 5 else ''}) "
            "— is the routing table missing edges for this program?"
        )

    from repro_torch.compiler.simulator import SimReport

    edge_hops = sum(f.hops for f in flows)
    packet_hops = sum(f.hops * f.packets for f in flows)
    sinks = spec.sinks if spec.sinks else tuple(program.sinks())
    makespan = max((ready.get(s, 0.0) for s in sinks), default=0.0)
    time_s = makespan * cm.tick_s + recirc_count * cm.recirculation_s
    total = makespan if makespan > 0 else 1.0

    timeline = None
    if tel is not None:
        hop_meta = []
        for i in range(n):
            fid = int(eflow[i])
            if fid >= 0:
                f = flows[fid]
                hop_meta.append(
                    (i, f.src, f.dst, int(lvl[i]), int(esw[i]), int(pid[i]))
                )
            else:  # loopback recirculation entry
                name = recirc_label[i]
                hop_meta.append((i, name, name, 0, int(esw[i]), int(pid[i])))
        timeline = tel.finish(
            engine="vectorized", makespan=makespan,
            switches=switches, ports=ports,
            served_tot=served_tot, pid_full=pid, hop_meta=hop_meta,
            first_t=tl_first, done_t=tl_done, maxq=tl_maxq,
        )
    if stream is not None:
        stream.finish(makespan)

    def port_dict(vals: np.ndarray) -> dict:
        return {
            (switches[a], switches[b]): float(v)
            for (a, b), v in zip(ports, vals)
            if v > _EPS
        }

    return SimReport(
        edge_hops=edge_hops,
        packet_hops=packet_hops,
        recirculations=recirc_count,
        makespan_ticks=int(round(makespan)),
        queue_delay_ticks=int(round(qdelay)),
        queued_batches={
            switches[i]: int(round(v)) for i, v in enumerate(queued_s) if v > _EPS
        },
        wire_bytes=cm.wire_bytes(packet_hops),
        time_s=time_s,
        switch_busy_ticks={
            switches[i]: int(round(v)) for i, v in enumerate(busy_s) if v > _EPS
        },
        switch_utilization={
            switches[i]: float(v) / total for i, v in enumerate(busy_s) if v > _EPS
        },
        max_queue_depth={
            switches[i]: int(round(v)) for i, v in enumerate(maxdepth_s) if v > 0.5
        },
        engine="vectorized",
        voq_depth=port_dict(voq_peak),
        port_drops=port_dict(drops_p),
        port_blocked_ticks=port_dict(blocked_p),
        dropped_packets=float(dropped),
        timeline=timeline,
        sink_finish_ticks={s: int(round(ready.get(s, 0.0))) for s in sinks},
    )


def _make_torch_step(esw, up, lvl, ns, maxlvl, device=None):
    """The per-step dense math (service allocation + time horizon) in the
    default-knob case — no port caps, no finite buffers — as torch ops on
    ``device`` (None = the card, and without CUDA this raises). The
    reference runs the same step under ``jax.jit``
    (``_make_jax_step``); its segment min/sums become ``scatter_reduce``
    / ``index_add_`` over ``esw``. Everything is float64, as the numpy
    path, so the two agree. Returns ``run(q, fut, gate, prio, active, t)
    -> (rate as numpy, dt)``, which syncs with the device once a step."""
    import torch

    from repro_torch.mesh import resolve_device

    dev = resolve_device(device, "the simulator's torch step (VoqParams.use_torch)")
    f64 = torch.float64
    esw_t = torch.as_tensor(np.asarray(esw), dtype=torch.int64, device=dev)
    up_safe = torch.as_tensor(np.maximum(up, 0), dtype=torch.int64, device=dev)
    has_up_t = torch.as_tensor(np.asarray(up) >= 0, device=dev)
    lvl_t = torch.as_tensor(np.asarray(lvl), device=dev)
    level_masks = [lvl_t == level for level in range(1, maxlvl + 1)]
    inf = torch.tensor(_INF, dtype=f64, device=dev)
    zero = torch.zeros((), dtype=f64, device=dev)

    def seg_sum(x):
        return torch.zeros(ns, dtype=f64, device=dev).index_add_(0, esw_t, x)

    def step(q, fut, gate, prio, active, t):
        gated = gate <= t + _EPS
        elig = active & (q > _RETIRE) & gated
        # backlogged VOQs: the tied earliest-busy-period group splits the
        # switch equally (same discipline as the numpy path)
        key = torch.where(elig, prio, inf)
        best = torch.full((ns,), _INF, dtype=f64, device=dev).scatter_reduce_(
            0, esw_t, key, reduce="amin")
        tied = elig & (key <= best[esw_t] + 1e-9)
        cnt = seg_sum(tied.to(f64))
        rate = torch.where(tied, 1.0 / torch.clamp(cnt[esw_t], min=1.0), zero)
        free = 1.0 - seg_sum(rate)
        for lvl_mask in level_masks:
            infl = torch.where(has_up_t, rate[up_safe], zero)
            m2 = (
                active
                & lvl_mask
                & gated
                & (q <= _RETIRE)
                & (fut > _EPS)
                & (infl > _EPS)
                & (rate <= _EPS)
            )
            r = torch.where(m2, infl, zero)
            dem = seg_sum(r)
            scale = torch.where(
                dem > free, torch.clamp(free, min=0.0) / torch.clamp(dem, min=_EPS), 1.0
            )
            r = r * scale[esw_t]
            rate = rate + r
            free = free - seg_sum(r)
        inflow = torch.where(has_up_t, rate[up_safe], zero)
        net = rate - inflow
        drain = torch.where(active & (q > _RETIRE) & (net > _EPS),
                            q / torch.where(net > _EPS, net, 1.0), inf)
        gwait = torch.where(
            active & (gate > t + _EPS) & torch.isfinite(gate) & ((q > _EPS) | (fut > _EPS)),
            gate - t,
            inf,
        )
        dt = torch.minimum(drain.min(), gwait.min())
        return rate, dt

    def run(q, fut, gate, prio, active, t):
        def on_dev(a):
            return torch.from_numpy(np.asarray(a)).to(dev)

        STEPS["torch"] += 1
        rate, dt = step(on_dev(q), on_dev(fut), on_dev(gate), on_dev(prio), on_dev(active),
                        float(t))
        # one sync a step: the rates and the horizon come back together
        out = torch.cat([rate, dt.reshape(1)]).cpu().numpy()
        dt = float(out[-1])
        if not np.isfinite(dt):
            raise ValueError(
                "vectorized simulator stalled: no serviceable queue"
            )
        return out[:-1], max(dt, _EPS)

    return run
