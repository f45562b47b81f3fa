"""Telemetry for the port: the ambient ``Tracer`` and its spans.

``trace`` is the port of ``repro/telemetry/trace.py``: compile passes
(``pass:<name>``), the verifier (``verify.plan``) and ``plan.run`` open
spans on the tracer ``activate()`` installs, and ``Tracer`` writes them as
Chrome-trace JSON. The fabric/stream telemetry, metrics and SLO modules
come with the simulators (ROADMAP.md, queue 1 item 5).
"""
from repro_torch.telemetry.trace import (
    Span,
    Tracer,
    activate,
    current_tracer,
    maybe_span,
    validate_chrome_trace,
)

__all__ = [
    "Span",
    "Tracer",
    "activate",
    "current_tracer",
    "maybe_span",
    "validate_chrome_trace",
]
