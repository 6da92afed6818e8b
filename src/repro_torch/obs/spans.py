"""Host spans: named stretches of the program's host work, marked where the
work happens for a profiler that records.

The sites (``with span(NAME):``), nested as indented:

  repro_torch.serve.flush        ``SnnServer.flush``, whole
    repro_torch.serve.prep       a bucket, from its start to its first dispatch
    repro_torch.dispatch.issue   a dispatch's host issue: buffer copies, fills, replay
    repro_torch.dispatch.fetch   the host blocked in a fetch (``controller._device_get``)
    repro_torch.serve.results    a bucket, from its last fetch to its results
  repro_torch.controller.init    ``Controller.__post_init__``, whole
  repro_torch.graph.capture      a dispatch graph's warm-up and capture

``issue`` and ``fetch`` also sit inside ``Controller.run``, and ``capture``
inside the first dispatch of a controller or of a job-axis width; a capture
is never inside an ``issue``.

While a profiler records (``torch.profiler.profile``), each span enters
``torch.profiler.record_function`` under its name, so the profiler's trace
holds it on the profiler's own clock beside the device's operations (with
CUDA activity also as a user annotation on the device's timeline, which
is not a kernel).  Otherwise a site costs one flag read and reads no
clock.  ``timed`` is the one span that also keeps its own duration.  Spans
are entered from the caller's thread, never from a worker.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

FLUSH = "repro_torch.serve.flush"
PREP = "repro_torch.serve.prep"
DISPATCH = "repro_torch.dispatch.issue"
FETCH = "repro_torch.dispatch.fetch"
RESULTS = "repro_torch.serve.results"
INIT = "repro_torch.controller.init"
CAPTURE = "repro_torch.graph.capture"

_OFF = contextlib.nullcontext()


def span(name):
    """The span ``name`` as a context manager: a ``record_function`` while a
    profiler records, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class timed:
    """``span(name)`` for a caller that keeps its duration: ``seconds``, on
    the host's clock (``time.perf_counter``), profiler or not."""
    __slots__ = ("name", "seconds", "_t0", "_mark")

    def __init__(self, name):
        self.name, self.seconds = name, None

    def __enter__(self):
        self._mark = span(self.name)
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._mark.__exit__(*exc)
        return False
