"""Trace event rings (counterpart of ``repro/obs/trace.py``).

A ring is a fixed-capacity structure-of-arrays buffer of int32
``(kind, seg, unit, t, value)`` records that rides inside the simulation
state tree, one ring per segment, stacked like every other leaf.  The
segment step appends to it on the device; the host drains it at dispatch
boundaries, in the dispatch's one fetch (``core/controller.py``).

Appends past capacity are dropped, never blocking: ``count`` keeps
recording true demand, and the sticky ``overflowed`` flag is
``platform.termination_flags``' flag 6, informational only.  Torch has no
dropping scatter, so ``emit_bulk`` is written as ``channel.box_append_bulk``
is: slot ``count + r`` gathers the r-th selected lane, and slots past the
capacity are never written.

``t`` is always simulated time (cycles), so traces are bit-identical
across backends and dispatch modes.  The event kinds and their fields are
the reference's (docs/observability.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import channel as ch

EV_QUANTUM = 0   # one per segment per round in which local time advanced
EV_ROUTE = 1     # inbox messages consumed at the round's inbox application
EV_TICK = 2      # a spike-mode unit fired its LIF tick
EV_SPIKE_TX = 3  # AER spikes emitted toward one fan-out destination
EV_CIM_START = 4  # a dense CIM OP launched (MMIO CIM_REG_START applied)
EV_CIM_DONE = 5  # a dense CIM OP completed and DMA'd its output rows
EV_WMARK = 6     # a sticky watermark tripped (first time only, per segment)
EV_FAULT = 7     # seeded transport faults fired (drop/duplication)
EV_SPIKE_LOSS = 8  # graceful degradation: spikes lost to outbox overflow

KIND_NAMES = ("quantum", "route", "tick", "spike_tx", "cim_start",
              "cim_done", "watermark", "fault_injected", "spikes_dropped")
WMARK_NAMES = ("inbox", "outbox", "store_log", "snn_mmio_late")

FIELDS = ("kind", "seg", "unit", "t", "value")
EVENT_DTYPE = np.dtype([(f, np.int32) for f in FIELDS])

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static telemetry configuration; ``Controller(obs=None)`` leaves every
    emission out of the step.

    capacity: ring slots per segment.  The fused dispatch drains once per
    dispatch, so the ring must hold every event of up to
    ``rounds_per_dispatch`` rounds; the per-round path and the host-loop
    backends drain at every ``check_every`` boundary.  Undersizing drops
    events and sets the sticky overflow flag; it never blocks and never
    changes the simulation.
    """
    capacity: int = 4096


def ring_state(cap: int, batch=(), device=None):
    """Empty rings of ``cap`` slots over the leading ``batch`` dims (the
    reference's one-segment ring for ``batch=()``)."""
    ring = {f: torch.zeros((*batch, cap), dtype=_I32, device=device) for f in FIELDS}
    ring["count"] = torch.zeros(batch, dtype=_I32, device=device)  # demand, may exceed cap
    ring["overflowed"] = torch.zeros(batch, dtype=torch.bool, device=device)  # sticky
    ring["wmark_seen"] = torch.zeros(batch, dtype=_I32, device=device)  # EV_WMARK dedup mask
    return ring


def emit_bulk(ring, mask, kind, seg, unit, t, value):
    """Append the records of ``mask`` ``(..., n)``'s selected lanes in lane
    order; the values broadcast against ``mask``.  Past-capacity records
    drop; ``count`` records true demand."""
    cap = ring["kind"].shape[-1]
    n = mask.shape[-1]
    dev = mask.device
    order = ch._compaction_order(mask)
    k = mask.sum(-1, dtype=_I32)
    j = torch.arange(cap, dtype=_I32, device=dev) - ring["count"].unsqueeze(-1)
    src = order.gather(-1, j.clamp(0, n - 1).to(torch.int64))
    write = (j >= 0) & (j < k.unsqueeze(-1))
    out = dict(ring)
    for f, v in (("kind", kind), ("seg", seg), ("unit", unit), ("t", t),
                 ("value", value)):
        vals = ch._lanes(v, mask.shape, dev)
        out[f] = torch.where(write, vals.gather(-1, src), ring[f])
    out["count"] = ring["count"] + k
    out["overflowed"] = ring["overflowed"] | (out["count"] > cap)
    return out


def emit(ring, mask, kind, seg, unit, t, value):
    """Append one record (where ``mask``) at each ring's current count."""
    batch = ring["count"].shape
    dev = ring["count"].device

    def lane(v, dtype=_I32):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(batch).unsqueeze(-1)

    return emit_bulk(ring, lane(mask, torch.bool), lane(kind), lane(seg), lane(unit),
                     lane(t), lane(value))


def reset(ring):
    """The ring after a host drain: ``count`` rewinds to zero; the sticky
    ``overflowed`` flag and the EV_WMARK dedup mask stay."""
    return {**ring, "count": torch.zeros_like(ring["count"])}


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def drain(host_ring):
    """Host-side drain of a stacked ``(S, ...)`` ring already fetched from
    the device (numpy or CPU tensors).

    Returns ``(events, lost)``: a chronologically sorted structured array of
    ``EVENT_DTYPE`` records and the number of records dropped to capacity
    since the previous drain."""
    counts = _host(host_ring["count"])
    cap = _host(host_ring["kind"]).shape[1]
    parts, lost = [], 0
    for s in range(counts.shape[0]):
        n = int(counts[s])
        lost += max(0, n - cap)
        n = min(n, cap)
        e = np.empty(n, EVENT_DTYPE)
        for f in FIELDS:
            e[f] = _host(host_ring[f])[s, :n]
        parts.append(e)
    events = np.concatenate(parts) if parts else np.empty(0, EVENT_DTYPE)
    return events[np.argsort(events["t"], kind="stable")], lost
