"""Observability (counterpart of ``repro.obs``): telemetry for the VP.

Module map:
  trace.py   — fixed-capacity trace event rings carried inside the state
               tree (and so inside the fused dispatch's captured loop),
               appended by the segment step, drained at dispatch boundaries
               in the dispatch's one host fetch; sticky overflow is
               termination flag 6, informational only
  metrics.py — typed metrics registry over the simulation state, the
               source of ``Controller.stats()`` and ``Controller.metrics()``
  export.py  — Chrome-trace/Perfetto JSON timelines and the NDJSON stream
               behind ``Controller.run(..., on_telemetry=...)``

``Controller(obs=None)`` (the default) leaves every emission out of the
step; ``obs=TraceConfig(...)`` turns tracing on with results equal to the
untraced run's, the ring aside.  See docs/observability.md.
"""
from repro_torch.obs.trace import EVENT_DTYPE, KIND_NAMES, TraceConfig

__all__ = ["EVENT_DTYPE", "KIND_NAMES", "TraceConfig"]
