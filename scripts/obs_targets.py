"""The JAX package's numbers for ``chip_smoke.py`` phase 11: the
``stats()``/``metrics()`` dicts of five jobs and the drained event streams of
three traced runs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/obs_targets.py

Prints the ``OBS_TARGET`` constant.  ``stats`` and ``metrics``: each array as
``[dtype, shape, values]``, nested as the dicts are, after a fused ``vmap``
run of fig5snn (128x96x64x10, T=24, uniform on 4 segments, quantum 32),
fullxbar (eight full 256x256 crossbars, ``in_cap=8192``), Googlenet-conv1's
uniform offload (quantum = channel latency = 10,000), and the hybrid jobs of
phase 10, split (``benchmarks/bench_snn.py``'s 48x40x16 and the full-width
256x256x256 + 8x256x4; quantum 700, channel latency 2000, the check every 4
rounds).  ``traced``: for ``benchmarks/bench_snn.py``'s telemetry job
(16x12x8, T=96, rate 0.2, 2 segments, ``in_cap=640``, ``out_cap=128``,
``TraceConfig(capacity=1024)``), fullxbar and the full-width hybrid (both
``TraceConfig(capacity=4096)``, a ring that holds a dispatch), each fused:
rounds, events, lost records, events per kind and the sha256 of the drained
event array's bytes (``EVENT_DTYPE``, little-endian int32).  Takes a few
minutes on a CPU.
"""
from __future__ import annotations

import hashlib
import pprint
import time

import numpy as np

from repro import snn
from repro.core import segmentation as sg
from repro.core.controller import Controller
from repro.obs import TraceConfig
from repro.obs import trace as tr
from repro.vp import workloads as wl

QUANTUM, CHECK_EVERY, MAX_ROUNDS = 32, 2, 400
HYBRID = dict(quantum=700, latency=2000, check_every=4)
HYBRID_JOBS = {
    "hybrid_bench_snn": dict(layer_sizes=(48, 40, 16), t_steps=12, rate=0.5, seed=5),
    "hybrid_full_width": dict(layer_sizes=(256, 256, 256), t_steps=12, rate=0.5, seed=5,
                              dense_layer=wl.Layer("hybrid", "vmm", 8, 256, 4)),
}


def spiking(sizes, in_cap, obs=None, **kw):
    job = snn.snn_inference_job(sizes, **kw)
    descs = snn.segmentation_for(len(job.layers), "uniform", n_segments=4)
    cfg, states, pending, _ = snn.build_snn(job.layers, descs, job.raster, in_cap=in_cap)
    return Controller(cfg, states, pending, quantum=QUANTUM, obs=obs), dict(
        max_rounds=MAX_ROUNDS, check_every=CHECK_EVERY)


def fig5snn(obs=None):
    return spiking((128, 96, 64, 10), None, obs, t_steps=24, rate=0.5, seed=2)


def fullxbar(obs=None):
    return spiking((256,) * 9, 8192, obs, t_steps=24, rate=0.5, seed=2)


def telemetry(obs=None):
    job = snn.snn_inference_job((16, 12, 8), t_steps=96, rate=0.2, seed=2)
    descs = snn.segmentation_for(len(job.layers), "uniform", n_segments=2)
    cfg, states, pending, _ = snn.build_snn(job.layers, descs, job.raster, in_cap=640,
                                            out_cap=128)
    return Controller(cfg, states, pending, quantum=QUANTUM, obs=obs), dict(
        max_rounds=MAX_ROUNDS, check_every=CHECK_EVERY)


def googlenet(obs=None):
    layer = next(x for x in wl.TABLE_III if x.name == "Googlenet-conv1")
    descs = sg.uniform(2, 2)
    job = wl.cim_workload(layer, mgr_segments=[0, 1], cim_ids_per_mgr={0: (0, 1), 1: (2, 3)},
                          ordinals=sg.mailbox_ordinals(descs))
    cfg, states, pending = sg.build(descs, programs=job["programs"], dram_words=job["dram"],
                                    crossbars=job["crossbars"], scratch_init=job["scratch"],
                                    channel_latency=10_000)
    return Controller(cfg, states, pending, quantum=10_000, obs=obs), dict(
        max_rounds=2000, check_every=CHECK_EVERY)


def hybrid(name):
    def make(obs=None):
        job = snn.hybrid_job(**HYBRID_JOBS[name])
        cfg, states, pending, _ = snn.build_hybrid(job, "split",
                                                   channel_latency=HYBRID["latency"])
        return Controller(cfg, states, pending, quantum=HYBRID["quantum"], obs=obs), dict(
            max_rounds=2000, check_every=HYBRID["check_every"])
    return make


STATS_JOBS = {"fig5snn": fig5snn, "fullxbar": fullxbar, "googlenet_conv1": googlenet,
              "hybrid_bench_snn": hybrid("hybrid_bench_snn"),
              "hybrid_full_width": hybrid("hybrid_full_width")}
TRACED_JOBS = {"telemetry": (telemetry, 1024), "fullxbar": (fullxbar, 4096),
               "hybrid_full_width": (hybrid("hybrid_full_width"), 4096)}


def encode(d):
    """A stats/metrics dict with each array as [dtype, shape, values]."""
    if isinstance(d, dict):
        return {k: encode(v) for k, v in d.items()}
    a = np.asarray(d)
    return [a.dtype.str, list(a.shape), a.reshape(-1).tolist()]


def event_digest(events):
    return hashlib.sha256(np.ascontiguousarray(events).astype(tr.EVENT_DTYPE).tobytes()).hexdigest()


def main():
    target = {"stats": {}, "traced": {}}
    for name, make in STATS_JOBS.items():
        t0 = time.perf_counter()
        ctl, run = make()
        ctl.run(**run)
        target["stats"][name] = {"rounds": ctl.rounds_run, "stats": encode(ctl.stats()),
                                 "metrics": encode(ctl.metrics())}
        print(f"# {name}: {ctl.rounds_run} rounds ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    for name, (make, cap) in TRACED_JOBS.items():
        t0 = time.perf_counter()
        ctl, run = make(TraceConfig(capacity=cap))
        ctl.run(**run)
        ev = ctl.trace_events()
        target["traced"][name] = {
            "capacity": cap, "rounds": ctl.rounds_run, "dispatches": ctl.dispatches,
            "events": len(ev), "lost": ctl.trace_lost,
            "kinds": np.bincount(ev["kind"], minlength=len(tr.KIND_NAMES)).tolist(),
            "sha256": event_digest(ev)}
        print(f"# traced {name}: {target['traced'][name]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print("OBS_TARGET = " + pprint.pformat(target, width=96, sort_dicts=False, compact=True))


if __name__ == "__main__":
    main()
