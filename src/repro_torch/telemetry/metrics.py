"""Session-scoped metrics registry.

Four instrument shapes, all get-or-create by name so call sites never
pre-register:

* ``counter(name)``   — monotonically increasing totals (compiles run,
  cache hits, packets dropped);
* ``gauge(name)``     — last-written point values (makespan of the most
  recent simulate);
* ``histogram(name)`` — distributions (per-pass wall time across a
  session's compiles);
* ``series(name)``    — (t, value) time series (fabric queue depth over
  simulated ticks, straight off ``SimReport.timeline``);
* ``table(name)``     — keyed accumulators (packets per port), what the
  report CLI ranks for its top-N views.

``to_dict``/``write`` give the JSON export; ``load`` reads it back —
``python -m repro_torch.telemetry.report`` renders that file as the text
dashboard. Everything is plain Python (no numpy), so a registry is
importable anywhere without dragging the simulator in.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

# histograms keep raw observations up to this many samples (enough for
# percentiles over any realistic session; beyond it only the moments
# keep updating)
_HIST_CAP = 4096


@dataclasses.dataclass
class Counter:
    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {n})")
        self.value += n


@dataclasses.dataclass
class Gauge:
    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


@dataclasses.dataclass
class Histogram:
    name: str
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    samples: list[float] = dataclasses.field(default_factory=list)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.samples) < _HIST_CAP:
            self.samples.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained samples."""
        if not self.samples:
            return 0.0
        ordered = sorted(self.samples)
        k = min(len(ordered) - 1, max(0, int(round(p / 100.0 * (len(ordered) - 1)))))
        return ordered[k]


@dataclasses.dataclass
class Series:
    name: str
    points: list[tuple[float, float]] = dataclasses.field(default_factory=list)

    def append(self, t: float, v: float) -> None:
        self.points.append((float(t), float(v)))

    def extend(self, ts, vs) -> None:
        self.points.extend((float(t), float(v)) for t, v in zip(ts, vs))


@dataclasses.dataclass
class Table:
    name: str
    data: dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, key: Any, v: float) -> None:
        k = key if isinstance(key, str) else str(key)
        self.data[k] = self.data.get(k, 0.0) + float(v)

    def set(self, key: Any, v: float) -> None:
        k = key if isinstance(key, str) else str(key)
        self.data[k] = float(v)

    def top(self, n: int) -> list[tuple[str, float]]:
        return sorted(self.data.items(), key=lambda kv: (-kv[1], kv[0]))[:n]


class MetricsRegistry:
    """Named instruments, get-or-create; one per ``Session``."""

    def __init__(self) -> None:
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.series_: dict[str, Series] = {}
        self.tables: dict[str, Table] = {}

    def counter(self, name: str) -> Counter:
        """Get-or-create the named monotonically increasing counter."""
        return self.counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        """Get-or-create the named last-value gauge."""
        return self.gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str) -> Histogram:
        """Get-or-create the named histogram (count/total/min/max/mean)."""
        return self.histograms.setdefault(name, Histogram(name))

    def series(self, name: str) -> Series:
        """Get-or-create the named (x, y) sample series."""
        return self.series_.setdefault(name, Series(name))

    def table(self, name: str) -> Table:
        """Get-or-create the named row table (list-of-dicts)."""
        return self.tables.setdefault(name, Table(name))

    # ------------------------------------------------------------- export --
    def to_dict(self) -> dict:
        """JSON-able dump of every instrument, keys sorted — the shape
        the report CLI dashboard consumes."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {
                k: {
                    "count": h.count,
                    "total": h.total,
                    "min": h.min if h.count else 0.0,
                    "max": h.max if h.count else 0.0,
                    "mean": h.mean,
                    "p50": h.percentile(50),
                    "p95": h.percentile(95),
                }
                for k, h in sorted(self.histograms.items())
            },
            "series": {k: s.points for k, s in sorted(self.series_.items())},
            "tables": {k: t.data for k, t in sorted(self.tables.items())},
        }

    def write(self, path: str) -> None:
        """Write ``to_dict()`` as JSON for ``python -m repro_torch.telemetry.report``."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @staticmethod
    def load(path: str) -> dict:
        """Read an exported registry back as the plain dict shape (the
        report CLI consumes this; round-tripping into live instruments is
        deliberately not supported — exports are artifacts, not state)."""
        with open(path) as f:
            return json.load(f)
