"""Live SLO tracking over the streaming window feed.

An ``SloMonitor`` subscribes to the same ``repro_torch.telemetry.stream``
feed the anomaly detectors do and answers, *while the run is still
going*: which jobs have finished, which are on track, and which are
projected to blow their deadline — and when a projection goes red, which
switches to blame (ranked through the same ``fabric.rank_hot`` order
every other telemetry-driven selector uses, fed by the windowed
per-switch pressure integral, the streaming twin of
``fabric.timeline_pressure``).

Job completion is observed through ``on_node``: a job finishes when the
last of its registered sink labels completes. Projection is a fluid
argument on fabric aggregates: the backlog standing at a window close
drains at the recent measured service rate, so

    projected_finish ≈ window.end + total_backlog / drain_rate

— coarse (fabric-wide, not per-flow) but *live*, monotone in backlog,
and exact in the limit of an empty fabric. A job is flagged ``at_risk``
the first window its projection crosses the deadline; the flag clears
only by finishing, the violation record keeps the earliest onset.

    mon = SloMonitor([SloTarget("etl", deadline_ticks=400.0,
                                sinks=("etl/out",))])
    session.simulate(arrivals=..., observers=[mon])
    mon.status("etl").projected_finish_tick, mon.violations()
"""
from __future__ import annotations

import dataclasses
from typing import Hashable, Iterable, Mapping, Sequence

from repro_torch.telemetry.fabric import rank_hot
from repro_torch.telemetry.stream import Window

NodeId = Hashable

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class SloTarget:
    """One job's service-level objective.

    ``sinks`` are the labels (as they appear in the simulated program —
    prefixed ``job/sink`` in a merged run) whose completion finishes the
    job; ``deadline_ticks`` is absolute on the shared clock, None =
    track progress only."""

    job: str
    deadline_ticks: float | None = None
    weight: float = 1.0
    sinks: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SloStatus:
    """One job's live (or final) SLO standing."""

    job: str
    deadline_ticks: float | None
    weight: float
    finished: bool
    finish_tick: float | None
    projected_finish_tick: float | None
    at_risk: bool  # projection crossed the deadline at some window
    risk_onset_tick: float | None  # end of the first red window
    hot_switches: tuple[NodeId, ...]  # ranked blame at first red window

    @property
    def violated(self) -> bool:
        """Deadline actually (finished late) or projectedly missed."""
        if self.deadline_ticks is None:
            return False
        if self.finished and self.finish_tick is not None:
            return self.finish_tick > self.deadline_ticks + _EPS
        return self.at_risk

    @property
    def margin_ticks(self) -> float | None:
        """Deadline minus (actual or projected) finish — negative is a
        miss; None without a deadline or any estimate."""
        if self.deadline_ticks is None:
            return None
        f = self.finish_tick if self.finished else self.projected_finish_tick
        if f is None:
            return None
        return self.deadline_ticks - f


class SloMonitor:
    """Stream observer tracking per-job deadlines live (see module doc).

    ``rate_alpha`` smooths the measured drain rate (EWMA over windows);
    ``top_k`` bounds the ranked blame list attached to a violation.
    """

    def __init__(
        self,
        targets: Iterable[SloTarget],
        *,
        rate_alpha: float = 0.5,
        top_k: int = 3,
    ):
        self.targets: dict[str, SloTarget] = {}
        for t in targets:
            if t.job in self.targets:
                raise ValueError(f"duplicate SLO target for job {t.job!r}")
            self.targets[t.job] = t
        self.rate_alpha = float(rate_alpha)
        self.top_k = int(top_k)
        self._sink_job: dict[str, str] = {
            s: t.job for t in self.targets.values() for s in t.sinks
        }
        self._remaining: dict[str, set[str]] = {
            t.job: set(t.sinks) for t in self.targets.values()
        }
        self._finish: dict[str, float] = {}
        self._projected: dict[str, float] = {}
        self._risk_onset: dict[str, float] = {}
        self._blame: dict[str, tuple[NodeId, ...]] = {}
        self._pressure: dict[NodeId, float] = {}  # windowed depth integral
        self._rate: float | None = None  # EWMA fabric service rate
        self.makespan: float | None = None
        self.windows_seen = 0

    # ------------------------------------------------------- stream hooks --
    def on_node(self, label: str, tick: float) -> None:
        job = self._sink_job.get(label)
        if job is None or job in self._finish:
            return
        rem = self._remaining[job]
        rem.discard(label)
        if not rem:
            self._finish[job] = tick

    def on_window(self, window: Window) -> None:
        self.windows_seen += 1
        for sw, v in window.pressure().items():
            self._pressure[sw] = self._pressure.get(sw, 0.0) + v
        dur = max(window.duration_ticks, _EPS)
        rate = window.total_served / dur
        if self._rate is None:
            self._rate = rate
        else:
            self._rate += self.rate_alpha * (rate - self._rate)
        backlog = window.total_depth_mean
        # live projection: standing backlog drains at the measured rate.
        # An idle-but-backlogged fabric (rate ~ 0) projects to infinity,
        # which correctly reads as "red" against any finite deadline.
        drain = max(self._rate, _EPS)
        projected = window.end_tick + backlog / drain
        for job, target in self.targets.items():
            if job in self._finish:
                continue
            self._projected[job] = projected
            dl = target.deadline_ticks
            if dl is not None and projected > dl + _EPS and job not in self._risk_onset:
                self._risk_onset[job] = window.end_tick
                self._blame[job] = tuple(rank_hot(self._pressure)[: self.top_k])

    def on_finish(self, makespan: float) -> None:
        self.makespan = makespan
        # a target whose sinks never completed ends with the run
        for job, rem in self._remaining.items():
            if rem and job not in self._finish:
                self._finish[job] = makespan

    # ------------------------------------------------------------ queries --
    def status(self, job: str) -> SloStatus:
        target = self.targets[job]
        finished = job in self._finish and (
            not self._remaining[job] or self.makespan is not None
        )
        return SloStatus(
            job=job,
            deadline_ticks=target.deadline_ticks,
            weight=target.weight,
            finished=finished,
            finish_tick=self._finish.get(job),
            projected_finish_tick=self._projected.get(job),
            at_risk=job in self._risk_onset,
            risk_onset_tick=self._risk_onset.get(job),
            hot_switches=self._blame.get(job, ()),
        )

    def statuses(self) -> dict[str, SloStatus]:
        return {job: self.status(job) for job in self.targets}

    def violations(self) -> list[SloStatus]:
        """Jobs that missed (or are projected to miss) their deadline,
        worst weighted margin first."""
        out = [st for st in self.statuses().values() if st.violated]
        out.sort(key=lambda st: ((st.margin_ticks or 0.0) * st.weight, st.job))
        return out

    def pressure(self) -> dict[NodeId, float]:
        """Accumulated per-switch windowed depth integral (packet-ticks)
        — the monitor's view of ``fabric.timeline_pressure``."""
        return dict(self._pressure)


def targets_from_requests(
    requests: Sequence, plans: Mapping[str, object]
) -> list[SloTarget]:
    """Build SLO targets for the scheduler's monitored run: one per
    admitted ``JobRequest``, sinks prefixed the way ``merge_plans``
    labels them (``job/sink``)."""
    out = []
    for req in requests:
        pl = plans.get(req.name)
        if pl is None:
            continue
        out.append(
            SloTarget(
                job=req.name,
                deadline_ticks=req.deadline_ticks,
                weight=req.weight,
                sinks=tuple(f"{req.name}/{s}" for s in pl.flow_spec().sinks),
            )
        )
    return out
