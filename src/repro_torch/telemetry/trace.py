"""Trace spans — the compile/tune/simulate timing surface.

A ``Span`` is name + start + duration + attrs; a ``Tracer`` collects
them and exports Chrome trace-event JSON (the ``{"traceEvents": [...]}``
shape Perfetto and ``chrome://tracing`` load directly). Spans nest by
wall time alone — no parent ids — which is exactly what the trace-event
"complete" (``ph="X"``) encoding wants, and what lets ``PassManager``
adopt its existing ``PassRecord`` timings without restructuring.

Threading: rather than plumb a tracer argument through every driver /
search / plan signature, the active tracer is ambient state in a
``contextvars.ContextVar``.  ``Session`` (or any caller) does::

    tracer = Tracer()
    with activate(tracer):
        compiler.compile(...)        # pass spans land on ``tracer``
    tracer.write("trace.json")

and instrumented call sites do ``maybe_span(current_tracer(), ...)`` —
a ``nullcontext`` when no tracer is active, so the un-traced fast path
pays one contextvar read per instrumented call and nothing else.

``validate_chrome_trace`` is the schema check CI's trace-smoke step (and
``tests/test_telemetry.py``) runs over the artifact: valid structure,
monotonic timestamps, matched span nesting (every pair of spans on a
track is disjoint or properly contained).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import time
from typing import Any, Iterator, Mapping


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span: ``ts_us``/``dur_us`` are relative to the
    tracer's birth, in microseconds (the trace-event unit)."""

    name: str
    ts_us: float
    dur_us: float
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)


class Tracer:
    """Collects spans; exports Chrome trace-event JSON.

    ``span(name, **attrs)`` is a context manager that yields the span's
    mutable attrs dict (so results computed inside the span — a score, a
    cache verdict — can be attached before it closes). ``add`` adopts an
    externally-measured duration (how ``PassManager`` folds its
    ``PassRecord`` wall times in without timing anything twice).
    """

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.spans: list[Span] = []
        # instant ("i") and counter ("C") marks, kept as raw trace-event
        # dicts; anomaly/SLO exports land here (repro_torch.telemetry.anomaly)
        self.marks: list[dict] = []

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[dict[str, Any]]:
        """Time the ``with`` block as one span. Yields the span's mutable
        attrs dict; mutations made inside the block are recorded."""
        start = self._now_us()
        frame = dict(attrs)
        try:
            yield frame
        finally:
            end = self._now_us()
            self.spans.append(
                Span(name=name, ts_us=start, dur_us=max(end - start, 0.0), attrs=frame)
            )

    def add(self, name: str, *, start_us: float | None = None,
            dur_us: float = 0.0, **attrs: Any) -> Span:
        """Record a span from an externally-measured duration. With no
        ``start_us`` the span is placed so it *ends* now — the natural
        anchoring for "this work just finished and took ``dur_us``"."""
        if start_us is None:
            start_us = max(self._now_us() - dur_us, 0.0)
        sp = Span(name=name, ts_us=start_us, dur_us=max(dur_us, 0.0), attrs=dict(attrs))
        self.spans.append(sp)
        return sp

    def instant(self, name: str, *, ts_us: float | None = None,
                tid: int = 0, scope: str = "t", **attrs: Any) -> dict:
        """Record an instant event (``ph:"i"``) — a zero-duration marker
        (Perfetto draws a flag). ``scope`` is the trace-event instant
        scope: "t" (thread), "p" (process) or "g" (global). Put events
        whose timestamps are *not* wall microseconds (e.g. simulated
        ticks) on their own ``tid`` so per-track monotonicity holds."""
        if scope not in ("t", "p", "g"):
            raise ValueError(f"instant scope must be 't', 'p' or 'g', got {scope!r}")
        ev = {
            "name": name,
            "ph": "i",
            "ts": round(self._now_us() if ts_us is None else float(ts_us), 3),
            "pid": 0,
            "tid": tid,
            "s": scope,
            "args": {k: _jsonable(v) for k, v in attrs.items()},
        }
        self.marks.append(ev)
        return ev

    def counter(self, name: str, *, ts_us: float | None = None,
                values: Mapping[str, float], tid: int = 0) -> dict:
        """Record a counter sample (``ph:"C"``) — Perfetto renders each
        args key as one series on a counter track named ``name``."""
        if not values:
            raise ValueError("counter event needs at least one value series")
        bad = {k: v for k, v in values.items()
               if not isinstance(v, (int, float)) or isinstance(v, bool)}
        if bad:
            raise ValueError(f"counter values must be numeric, got {bad!r}")
        ev = {
            "name": name,
            "ph": "C",
            "ts": round(self._now_us() if ts_us is None else float(ts_us), 3),
            "pid": 0,
            "tid": tid,
            "args": {k: float(v) for k, v in values.items()},
        }
        self.marks.append(ev)
        return ev

    # ------------------------------------------------------------- export --
    def to_chrome_trace(self) -> dict:
        """The ``{"traceEvents": [...]}`` dict Perfetto loads; events are
        "complete" (``ph="X"``) spans sorted by timestamp, followed by
        instant/counter marks sorted by (track, timestamp) — each track
        stays monotonic in file order, which the validator checks."""
        events = [
            {
                "name": sp.name,
                "ph": "X",
                "ts": round(sp.ts_us, 3),
                "dur": round(sp.dur_us, 3),
                "pid": 0,
                "tid": 0,
                "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
            }
            # ties: longer span first so a parent precedes the children
            # it shares a start timestamp with
            for sp in sorted(self.spans, key=lambda s: (s.ts_us, -s.dur_us))
        ]
        events.extend(
            sorted(self.marks, key=lambda ev: (ev.get("tid", 0), ev["ts"]))
        )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        """Write ``to_chrome_trace()`` as JSON at ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# ------------------------------------------------------- ambient tracer --
_ACTIVE: contextvars.ContextVar[Tracer | None] = contextvars.ContextVar(
    "repro_active_tracer", default=None
)


def current_tracer() -> Tracer | None:
    """The tracer installed by the innermost ``activate()``, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(tracer: Tracer) -> Iterator[Tracer]:
    """Make ``tracer`` ambient for the dynamic extent of the block."""
    token = _ACTIVE.set(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.reset(token)


def maybe_span(tracer: Tracer | None, name: str, **attrs: Any):
    """``tracer.span(...)`` or a no-op context yielding a throwaway dict."""
    if tracer is None:
        return contextlib.nullcontext({})
    return tracer.span(name, **attrs)


# ----------------------------------------------------------- validation --
def validate_chrome_trace(data: Any) -> list[str]:
    """Schema-check a parsed Chrome trace; returns problems (empty = ok).

    Checks the three properties the trace-smoke CI step gates on:
    structural validity (a ``traceEvents`` list of well-formed events),
    monotonic non-negative timestamps per track, and matched span
    nesting — any two spans on a track are disjoint or one contains the
    other (a span that straddles another's boundary renders as garbage
    in Perfetto and means a start/stop was dropped).

    Beyond ``ph:"X"`` spans, instant events (``ph:"i"``, the anomaly
    markers) must carry a valid scope (``s`` in ``t``/``p``/``g`` when
    present) and counter samples (``ph:"C"``) a non-empty all-numeric
    ``args`` mapping — Perfetto silently drops malformed ones, which
    would make a missing anomaly marker look like a clean run. Both
    participate in the per-track timestamp monotonicity check (they are
    timestamped points on their track) but not in the nesting sweep
    (they have no extent).
    """
    errors: list[str] = []
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level 'traceEvents' is missing or not a list"]
    elif isinstance(data, list):  # the bare-array legacy form is also valid
        events = data
    else:
        return [f"trace must be a dict or list, got {type(data).__name__}"]

    # (ts, dur, name, ph) per track; ph "i"/"C" are zero-extent points
    tracks: dict[tuple, list[tuple[float, float, str, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event #{i} is not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ev.get("name"), str):
            errors.append(f"event #{i}: missing/non-string 'name'")
        if ph not in ("X", "M", "i", "C"):
            errors.append(f"event #{i} ({ev.get('name')!r}): unsupported ph {ph!r}")
            continue
        if ph == "M":  # metadata events carry no timeline position
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event #{i} ({ev.get('name')!r}): bad ts {ts!r}")
            continue
        if ph == "i":
            scope = ev.get("s", "t")
            if scope not in ("t", "p", "g"):
                errors.append(
                    f"event #{i} ({ev.get('name')!r}): instant scope 's' "
                    f"must be 't', 'p' or 'g', got {scope!r}"
                )
                continue
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errors.append(
                    f"event #{i} ({ev.get('name')!r}): counter event needs a "
                    f"non-empty 'args' mapping, got {args!r}"
                )
                continue
            bad = {
                k: v for k, v in args.items()
                if not isinstance(v, (int, float)) or isinstance(v, bool)
            }
            if bad:
                errors.append(
                    f"event #{i} ({ev.get('name')!r}): counter values must "
                    f"be numeric, got {bad!r}"
                )
                continue
        dur = ev.get("dur", 0) if ph == "X" else 0
        if not isinstance(dur, (int, float)) or dur < 0:
            errors.append(f"event #{i} ({ev.get('name')!r}): bad dur {dur!r}")
            continue
        tracks.setdefault((ev.get("pid", 0), ev.get("tid", 0)), []).append(
            (float(ts), float(dur), str(ev.get("name")), str(ph))
        )

    eps = 1e-3  # µs; round-off slack from export rounding
    for (pid, tid), marks in tracks.items():
        last_ts = -1.0
        for ts, _dur, name, _ph in marks:
            if ts + eps < last_ts:
                errors.append(
                    f"track pid={pid} tid={tid}: non-monotonic ts at event "
                    f"{name!r} ({ts} after {last_ts})"
                )
            last_ts = max(last_ts, ts)
        # nesting sweep: sorted by (start, -dur), an open span's end must
        # contain every span that starts before it ends; instant/counter
        # points have no extent and stay out of the sweep
        spans = [(ts, dur, name) for ts, dur, name, ph in marks if ph == "X"]
        stack: list[tuple[float, str]] = []  # (end, name)
        for ts, dur, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][0] <= ts + eps:
                stack.pop()
            if stack and ts + dur > stack[-1][0] + eps:
                errors.append(
                    f"track pid={pid} tid={tid}: span {name!r} "
                    f"[{ts}, {ts + dur}) crosses the boundary of enclosing "
                    f"span {stack[-1][1]!r} (ends {stack[-1][0]})"
                )
                continue
            stack.append((ts + dur, name))
    return errors
