"""Trace export: Chrome-trace/Perfetto JSON timelines + NDJSON streams
(counterpart of ``repro/obs/export.py``, pure Python: the same JSON text for
the same event array).

``to_chrome_trace`` turns drained trace events (obs/trace.py records) into
the Chrome Trace Event JSON format, which both ``chrome://tracing`` and
https://ui.perfetto.dev load directly:

  - one *process* per segment, one *thread* per track: tid 0 is the
    segment/CPU track (quantum slices, inbox counters), tid 1+u is CIM
    unit u's track (dense OP slices, LIF tick instants);
  - cross-segment spike bursts become flow events (``ph: s``/``f``
    arrows) from the emitting unit's tick to the destination segment one
    tick later — the AER one-tick-per-hop delay drawn on screen;
  - simulated cycles map 1:1 onto trace microseconds (the formats have no
    cycle unit; all times in a trace are simulated, so only ratios
    matter).

``validate_chrome_trace`` checks the schema contract the CI smoke job
enforces on the exported artifact.  The NDJSON writers stream drained
batches as one flat JSON object per line — the
``Controller.run(..., on_telemetry=...)`` dashboard format
(docs/observability.md).
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.obs import trace as tr


def _tracks(events):
    """(segments, units-per-segment) observed in an event batch."""
    segs = sorted(int(s) for s in np.unique(events["seg"]))
    units = {
        s: sorted(int(u) for u in np.unique(
            events["unit"][(events["seg"] == s)
                           & np.isin(events["kind"],
                                     (tr.EV_TICK, tr.EV_SPIKE_TX,
                                      tr.EV_CIM_START, tr.EV_CIM_DONE))]))
        for s in segs
    }
    return segs, units


def to_chrome_trace(events, tick_period: int = 0, title: str = "repro-vp"):
    """Chrome Trace Event JSON (dict) from drained trace records.

    ``tick_period`` (meta["tick_period"] for SNN builds) dates spike-flow
    arrival one LIF tick after emission; 0 draws zero-length flows.
    """
    te = []
    segs, units = _tracks(events)
    for s in segs:
        te.append({"name": "process_name", "ph": "M", "pid": s,
                   "args": {"name": f"segment {s}"}})
        te.append({"name": "thread_name", "ph": "M", "pid": s, "tid": 0,
                   "args": {"name": "cpu/segment"}})
        for u in units[s]:
            te.append({"name": "thread_name", "ph": "M", "pid": s,
                       "tid": 1 + u,
                       "args": {"name": f"cim unit {u}"}})
    flow_id = 0
    for r in events:
        kind, seg, unit = int(r["kind"]), int(r["seg"]), int(r["unit"])
        t, value = int(r["t"]), int(r["value"])
        if kind == tr.EV_QUANTUM:
            te.append({"name": "quantum", "ph": "X", "pid": seg, "tid": 0,
                       "ts": t, "dur": value,
                       "args": {"instructions": unit}})
        elif kind == tr.EV_ROUTE:
            te.append({"name": "inbox", "ph": "C", "pid": seg, "tid": 0,
                       "ts": t,
                       "args": {"consumed": value, "occupancy": unit}})
        elif kind == tr.EV_TICK:
            te.append({"name": "tick", "ph": "i", "pid": seg,
                       "tid": 1 + unit, "ts": t, "s": "t",
                       "args": {"fired": value}})
        elif kind == tr.EV_SPIKE_TX:
            dst_seg, n_spikes = value >> 16, value & 0xFFFF
            flow_id += 1
            te.append({"name": "spikes", "ph": "s", "id": flow_id,
                       "pid": seg, "tid": 1 + unit, "ts": t,
                       "args": {"spikes": n_spikes, "dst_seg": dst_seg}})
            te.append({"name": "spikes", "ph": "f", "bp": "e",
                       "id": flow_id, "pid": dst_seg, "tid": 0,
                       "ts": t + tick_period,
                       "args": {"spikes": n_spikes}})
        elif kind == tr.EV_CIM_START:
            te.append({"name": "cim_op", "ph": "X", "pid": seg,
                       "tid": 1 + unit, "ts": t, "dur": max(value - t, 0),
                       "args": {"busy_until": value}})
        elif kind == tr.EV_CIM_DONE:
            te.append({"name": "cim_done", "ph": "i", "pid": seg,
                       "tid": 1 + unit, "ts": t, "s": "t",
                       "args": {"rows": value}})
        elif kind == tr.EV_WMARK:
            wm = tr.WMARK_NAMES[value] if 0 <= value < len(tr.WMARK_NAMES) \
                else str(value)
            te.append({"name": f"watermark:{wm}", "ph": "i", "pid": seg,
                       "tid": 0, "ts": t, "s": "p", "args": {"flag": value}})
        elif kind == tr.EV_FAULT:
            te.append({"name": "fault_injected", "ph": "i", "pid": seg,
                       "tid": 0, "ts": t, "s": "p",
                       "args": {"dropped": value, "duplicated": unit}})
        elif kind == tr.EV_SPIKE_LOSS:
            te.append({"name": "spikes_dropped", "ph": "i", "pid": seg,
                       "tid": 0, "ts": t, "s": "p",
                       "args": {"lost": value}})
    return {
        "traceEvents": te,
        "displayTimeUnit": "ms",
        "otherData": {"title": title,
                      "timeUnit": "1 trace us = 1 simulated cycle"},
    }


_PHASES = {"X", "i", "C", "M", "s", "f"}


def validate_chrome_trace(obj) -> list:
    """Schema check for an exported trace; returns a list of problems
    (empty = valid).  This is the contract the CI telemetry smoke job
    enforces before uploading the artifact."""
    problems = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a traceEvents array"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list) or not evs:
        return ["traceEvents must be a non-empty array"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        if "pid" not in e or "name" not in e:
            problems.append(f"{where}: missing pid/name")
        if ph != "M" and not isinstance(e.get("ts"), int):
            problems.append(f"{where}: {ph!r} event needs integer ts")
        if ph == "X" and (not isinstance(e.get("dur"), int) or e["dur"] < 0):
            problems.append(f"{where}: X slice needs dur >= 0")
        if ph in ("s", "f") and "id" not in e:
            problems.append(f"{where}: flow event needs an id")
        if ph == "M" and "args" not in e:
            problems.append(f"{where}: metadata event needs args")
    ids = {}
    for e in evs:
        if isinstance(e, dict) and e.get("ph") in ("s", "f"):
            ids.setdefault(e.get("id"), set()).add(e["ph"])
    for fid, phs in ids.items():
        if phs != {"s", "f"}:
            problems.append(f"flow id {fid} lacks a matched s/f pair")
    return problems


def write_chrome_trace(path, events, tick_period: int = 0,
                       title: str = "repro-vp"):
    """Export + validate + write; returns the trace dict."""
    obj = to_chrome_trace(events, tick_period=tick_period, title=title)
    problems = validate_chrome_trace(obj)
    assert not problems, f"invalid chrome trace: {problems[:5]}"
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj


# ---------------------------------------------------------------------------
# NDJSON streaming (the on_telemetry dashboard format)


def ndjson_records(events):
    """Flat dicts, one per trace record, with the kind name spelled out."""
    for r in events:
        kind = int(r["kind"])
        yield {
            "kind": tr.KIND_NAMES[kind] if 0 <= kind < len(tr.KIND_NAMES)
            else str(kind),
            "seg": int(r["seg"]),
            "unit": int(r["unit"]),
            "t": int(r["t"]),
            "value": int(r["value"]),
        }


def write_ndjson(fh, events) -> int:
    """Append one JSON object per event to ``fh``; returns lines written."""
    n = 0
    for rec in ndjson_records(events):
        fh.write(json.dumps(rec) + "\n")
        n += 1
    return n


def ndjson_callback(fh):
    """An ``on_telemetry`` callback streaming every drained batch to ``fh``
    as NDJSON — ``Controller.run(..., on_telemetry=ndjson_callback(f))``."""
    def cb(events):
        write_ndjson(fh, events)
        fh.flush()

    return cb
