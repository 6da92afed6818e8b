"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check against the reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (its ``kind`` picks ``kinds/<kind>.py``, which makes
and builds the jobs and holds their reference), the traffic mix
``traffic/<name>.json`` (its ``entry`` picks ``entries/<entry>.py``, the
loop that drives the program), and each metric ``metrics/<name>.py``, a
reader of the run's ``Record`` that returns a number or None (then the
metric is left out of the line)."""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from vpbench import devtrace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


@dataclasses.dataclass
class Record:
    """What a run measured and counted, for the metric readers."""
    setup_s: float = 0.0
    window_s: float = 0.0  # first job sent to the close of the window
    latencies: list = dataclasses.field(default_factory=list)  # seconds a job
    attempted: int = 0
    failed: int = 0  # jobs that did not come back ok
    rounds: int = 0  # rounds the program ran in the window
    syncs: int | None = None  # the server's host fetches in the window
    served: int | None = None  # the server's finished requests in the window
    capture_s: list | None = None  # each controller's capture
    instrs: int | None = None  # simulated instructions retired in the window
    bound_s: float = 0.0  # least time of the window's jobs' necessary work
    trace: object = None  # devtrace.Trace of the traced stretch
    trace_rounds: int | None = None
    trace_instrs: int | None = None
    tick_bound_s: float | None = None  # the traced stretch's fused ticks' bound


def load_cell(root: Path, workload: str):
    """(benchmark spec, cell, configuration, traffic) of ``workload``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return spec, cell, config, traffic


def metrics_of(spec, cell, trace: bool):
    """The metric entries this cell reports in a run with or without trace."""
    e2e = [m for m in spec["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``, or, for a
    name ``<base>.<part>`` that has no file of its own, of
    ``metrics/<base>.py``: one quantity split by the end-to-end metric it
    moves (``round_us.serve``, ``round_us.sim``) has one reader."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(f"vpbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides=None):
    """One run; returns the result line's object.  ``overrides`` (tests)
    replaces keys of the configuration and the traffic."""
    spec, cell, config, traffic = load_cell(root, workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    kind = importlib.import_module(f"vpbench.kinds.{config['kind']}")
    entry = importlib.import_module(f"vpbench.entries.{traffic['entry']}")
    session = entry.Session(kind, config, traffic, seed, device)
    rec = Record()
    if trace and entry.PRIME_PROFILER:
        devtrace.prime(device)
    session.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the set-up's objects (the pool of built jobs) leave the collector's
    # reach: a full collection in the window then walks the program's own
    # garbage, not the benchmark's pool
    gc.collect()
    gc.freeze()
    rec.setup_s = time.perf_counter() - t_start
    session.window(seconds, rec)
    lat = sorted(rec.latencies)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in session.parts.items())
    print(f"vpbench: set-up {rec.setup_s:.3f} s ({parts}); window {rec.window_s:.3f} s, "
          f"{rec.attempted} jobs, {rec.rounds} rounds; latency ms min "
          f"{1e3 * lat[0]:.3f} median {1e3 * lat[len(lat) // 2]:.3f} max {1e3 * lat[-1]:.3f}",
          file=sys.stderr, flush=True)
    if trace:
        session.trace(rec)
        print(f"vpbench: traced {rec.trace.window_s:.3f} s, {rec.trace_rounds} rounds, "
              f"{len(rec.trace.device_ops)} device ops", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    session.collect()
    judged = session.judge()
    checks = {"failed": {"value": rec.failed, "max": 0},
              "wrong": {"value": judged["wrong"], "max": 0},
              "checked": {"value": judged["checked"], "min": 1}}
    correct = all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
                  for c in checks.values())
    metrics = {}
    for m in metrics_of(spec, cell, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = devtrace.union_s(rec.trace.device_ops)
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = devtrace.breakdown(rec.trace)
    out["checks"] = checks
    # last, once the judge and every reader (files that later cells add)
    # have run: nothing that a result stands on may have loaded JAX
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}")
    return out
