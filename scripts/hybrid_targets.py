"""The JAX package's numbers for ``chip_smoke.py`` phase 10: hybrid jobs,
live RISC-V CPUs injecting a spiking network's raster beside a dense
offload.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/hybrid_targets.py

Prints the ``HYBRID_TARGET`` constant: for ``benchmarks/bench_snn.py``'s
hybrid job (``hybrid_job((48, 40, 16), t_steps=12, rate=0.5, seed=5)``,
channel latency 2000, quantum 700, the termination check every 4 rounds)
and for the same job at a full crossbar's width (spiking layers
256x256x256, the dense half 8x256x4), under the split, packed and auto
placements on ``vmap``: the segments, ``rounds_run``, the spikes, and
whether both halves (the dense ``O`` and the counts the driver CPU
published) equal their oracles; the small job's rounds also on
``sequential`` and ``threads``.  Then the late-injection and late-readback
messages of tests/test_hybrid.py's jobs, on ``vmap`` per-round.  Takes a
few minutes on a CPU (the full-width job ~30 s a placement).
"""
from __future__ import annotations

import pprint
import time

import numpy as np

from repro import snn
from repro.core import channel as ch
from repro.core.controller import Controller
from repro.vp import isa
from repro.vp import workloads as wl

QUANTUM = 700
LATENCY = 2000
CHECK_EVERY = 4  # Controller.run's default
STRATEGIES = ("split", "packed", "auto")
JOBS = {
    "bench_snn": dict(layer_sizes=(48, 40, 16), t_steps=12, rate=0.5, seed=5),
    "full_width": dict(layer_sizes=(256, 256, 256), t_steps=12, rate=0.5, seed=5,
                       dense_layer=wl.Layer("hybrid", "vmm", 8, 256, 4)),
}


def run(job, strategy, backend):
    cfg, states, pending, meta = snn.build_hybrid(job, strategy, channel_latency=LATENCY)
    ctl = Controller(cfg, states, pending, backend=backend, quantum=QUANTUM)
    ctl.run(max_rounds=2000, check_every=CHECK_EVERY)
    st = ctl.result_states()
    o, counts = snn.hybrid_results(st, meta)
    ctl.close()
    return {"segments": cfg.n_segments, "rounds": ctl.rounds_run,
            "spikes": snn.total_spikes(st),
            "correct": bool(np.array_equal(o, job.dense_expected)
                            and np.array_equal(counts, job.snn.expected_counts))}


def late_injection():
    job = snn.hybrid_job((16, 12, 8), t_steps=6, rate=1.0, seed=2)
    cfg, states, pending, _ = snn.build_hybrid(job, "split", tick_period=64,
                                               channel_latency=64)
    ctl = Controller(cfg, states, pending, backend="vmap", quantum=400)
    try:
        ctl.run(max_rounds=800, check_every=2, fused=False)
    except RuntimeError as e:
        return str(e)
    raise AssertionError("the late injection did not raise")


def late_readback():
    job = snn.snn_inference_job((12, 8), t_steps=4, rate=0.6, seed=3)
    descs = snn.segmentation_for(job.layers, "uniform", n_segments=2)
    cfg, states, pending, meta = snn.build_snn(job.layers, descs, job.raster)
    s, k = meta["out_unit"]
    pending = dict(pending)
    for f, v in (("kind", ch.MSG_W_CIM), ("addr", (k << 16) | isa.CIM_REG_COUNTS),
                 ("data", 1), ("t_avail", 6 * 10_000), ("valid", True)):
        pending[f] = pending[f].at[s, -1].set(v)
    ctl = Controller(cfg, states, pending, backend="vmap", quantum=32)
    try:
        ctl.run(max_rounds=400, check_every=2, fused=False)
    except RuntimeError as e:
        return str(e)
    raise AssertionError("the late readback did not raise")


def main():
    target = {}
    for name, kw in JOBS.items():
        job = snn.hybrid_job(**kw)
        entry = {"expected_total": job.snn.expected_total}
        for strategy in STRATEGIES:
            t0 = time.perf_counter()
            entry[strategy] = run(job, strategy, "vmap")
            if name == "bench_snn":
                entry[strategy]["rounds_by_backend"] = {
                    b: run(job, strategy, b)["rounds"] for b in ("sequential", "threads")}
            print(f"# {name} {strategy}: {entry[strategy]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        target[name] = entry
    target["late_injection"] = late_injection()
    target["late_readback"] = late_readback()
    print("HYBRID_TARGET = " + pprint.pformat(target, width=96, sort_dicts=False))


if __name__ == "__main__":
    main()
