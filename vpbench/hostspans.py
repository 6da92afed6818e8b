"""The program's host spans in a traced stretch: the ``repro_torch.`` events
among the profiler's host events (``devtrace.Trace.host``), which the
program enters as ``torch.profiler.record_function``s while a profiler
records (``repro_torch/obs/spans.py``).  A stretch that holds none, as of a
program without spans, gives every reader None."""

PREFIX = "repro_torch."
PREP = PREFIX + "serve.prep"
DISPATCH = PREFIX + "dispatch.issue"
FETCH = PREFIX + "dispatch.fetch"
RESULTS = PREFIX + "serve.results"
INIT = PREFIX + "controller.init"
CAPTURE = PREFIX + "graph.capture"
JOB = "vpbench.job"  # the controller entry's span around one simulation


def durations(rec, name):
    """The seconds of each span ``name`` in the traced stretch, or None when
    the stretch holds no span of the program."""
    if rec.trace is None or not any(n.startswith(PREFIX) for n, _, _ in rec.trace.host):
        return None
    return [e - s for n, s, e in rec.trace.host if n == name]


def mean_ms(rec, name):
    """The mean span ``name`` in ms, or None."""
    d = durations(rec, name)
    return sum(d) / len(d) * 1e3 if d else None


def per_bucket_ms(rec, name):
    """The spans ``name`` over the stretch's buckets (its ``serve.prep``
    spans) in ms, or None."""
    d, buckets = durations(rec, name), durations(rec, PREP)
    return sum(d) / len(buckets) * 1e3 if buckets else None


def jobs(rec):
    """Jobs in the traced stretch: the controller entry's simulations (its
    ``vpbench.job`` spans), or else the server's requests, its host fetches
    in the stretch times the window's requests a fetch; None when neither
    is known."""
    sims = durations(rec, JOB)
    if sims is None:
        return None
    if sims:
        return len(sims)
    if not rec.syncs or not rec.served:
        return None
    return len(durations(rec, FETCH)) * rec.served / rec.syncs or None
