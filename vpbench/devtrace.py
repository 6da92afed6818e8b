"""A bounded stretch of a run under ``torch.profiler``, reduced to plain
lists: the device's operations (name, start, end) and the host's spans and
ops (name, start, end), all in seconds on the profiler's clock.  The
benchmark's own spans (``span``) name what the host was doing around its
calls into the program; ``reduce`` turns a trace into the device's busy
time (the union of its operations' intervals), the operations that took
most time and the longest idle gaps, each named by the innermost host
event around it."""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


SPAN_PREFIX = "vpbench."


def span(name):
    """A host span of the benchmark's own, seen in a traced stretch."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class Trace:
    device_ops: list  # [(name, start_s, end_s)] sorted by start
    host: list  # [(name, start_s, end_s)]
    window_s: float  # the traced stretch's wall time

    def ops(self, part: str):
        """The device operations whose name holds ``part``."""
        return [op for op in self.device_ops if part in op[0]]


@contextlib.contextmanager
def traced(out: list, device):
    """Profile the ``with`` body and append its ``Trace`` to ``out``; the
    body's device work is waited for inside the window.  (Off the card, as
    in the CPU rehearsal, only the host is traced.)"""
    from torch.profiler import ProfilerActivity, profile

    card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        if card:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    out.append(from_profiler(prof, wall))


def prime(device):
    """Start and stop the profiler once before the program captures any
    CUDA graph: the CUPTI tracing of a graph instantiated before the
    profiler first ran in the process misses most of its kernels (on the
    H100 with torch 2.11 and CUDA 12.8, the job-axis dispatch graph showed
    1 of 20 rounds' kernels without this, 20 of 20 with it)."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def _annotation(e) -> bool:
    """A host span mirrored on the device's timeline, not an operation."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else e.name().startswith(SPAN_PREFIX)


def from_profiler(prof, wall: float) -> Trace:
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _annotation(e):
                dev.append(rec)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(rec)
    dev.sort(key=lambda r: r[1])
    return Trace(dev, host, wall)


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals sorted by start."""
    busy, end = 0.0, None
    for _, s, e in intervals:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def gaps(intervals):
    """Idle gaps between the union's pieces: [(start, end)]."""
    out, end = [], None
    for _, s, e in intervals:
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def _innermost(host, t):
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "host (no event)"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host event at their middle."""
    by_name = {}
    for name, s, e in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(trace.device_ops), key=lambda g: g[0] - g[1])[:top]
    idle = [[_innermost(trace.host, (s + e) / 2), e - s] for s, e in longest]
    return {"device_ops": [[n[:200], v] for n, v in ops],
            "idle_gaps": [[n[:200], v] for n, v in idle]}
