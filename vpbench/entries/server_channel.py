"""The fleet server's closed loop (``server``), which also counts the
channel's messages in the traced stretch: after the profiled flushes it
sums ``stats["msgs"]`` (each segment's messages entering the channel, every
round) over the stretch's finished requests into ``rec.trace_msgs``.  The
window's loop is ``server``'s own."""
from __future__ import annotations

from vpbench.entries import server
from vpbench.entries.server import PRIME_PROFILER  # noqa: F401  (read by the harness)


class Session(server.Session):
    def trace(self, rec):
        results = []
        flush = self._flush

        def keeping():
            out = flush()
            results.extend(out[2])
            return out

        self._flush = keeping
        try:
            super().trace(rec)
        finally:
            del self._flush
        rec.trace_msgs = sum(int(r.states["stats"]["msgs"].sum()) for r in results)
