"""The JAX package's numbers for ``chip_smoke.py`` phase 15: its
``shard_map`` backend on a mesh of one device, the mesh one H100 gives.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mesh_targets.py

Prints the ``MESH_TARGET`` constant.  On one segment the reference's
``shard_map`` limit is 2^30 (its ``vmap`` special-cases ``t + quantum``:
ROADMAP F6), so these numbers are ``shard_map``'s own, not ``vmap``'s.  For
fig5snn (128x96x64x10, T=24, rate 0.5, seed 2) on one segment (quantum 32,
the check every 2 rounds, at most 400 rounds) and Googlenet-conv1's ``cim``
offload on one segment (``uniform(1, 2)``: one CPU, the DRAM and two
crossbars; quantum = channel latency = 10,000, the check every 2 rounds),
each fused and per-round (asserted equal): ``rounds_run``, the largest
``time``, the spike total and output counts (fig5snn), the instructions
per segment, the CIM ops and whether ``O == A @ B`` (Googlenet-conv1), and
the sha256 of the final ``{"states", "pending"}`` tree
(``tree_digest``: each leaf in sorted-key order as its path, dtype, shape
and bytes).  ``vmap`` holds the same fig5snn build on ``vmap`` after 400
rounds, for the record.  Takes about a minute on a CPU.
"""
from __future__ import annotations

import hashlib
import pprint
import time

import numpy as np

from repro import compat, snn
from repro.core import segmentation as sg
from repro.core.controller import Controller
from repro.vp import workloads as wl

QUANTUM, CHECK_EVERY, MAX_ROUNDS = 32, 2, 400
DENSE_QUANTUM = 10_000


def tree_digest(tree) -> str:
    """sha256 over a tree's leaves in sorted-key order: path, dtype, shape
    and bytes of each (``chip_smoke.tree_digest`` computes the same)."""
    h = hashlib.sha256()

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}/{k}")
            return
        x = np.ascontiguousarray(np.asarray(t))
        h.update(f"{prefix}:{x.dtype}:{x.shape}".encode())
        h.update(x.tobytes())

    walk(tree, "")
    return h.hexdigest()


def fig5snn():
    job = snn.snn_inference_job((128, 96, 64, 10), t_steps=24, rate=0.5, seed=2)
    descs = snn.segmentation_for(len(job.layers), "uniform", n_segments=1)
    cfg, states, pending, meta = snn.build_snn(job.layers, descs, job.raster)
    return (cfg, states, pending), (job, meta), QUANTUM, MAX_ROUNDS


def googlenet_conv1():
    layer = next(x for x in wl.TABLE_III if x.name == "Googlenet-conv1")
    descs = sg.uniform(1, 2)
    job = wl.cim_workload(layer, mgr_segments=[0], cim_ids_per_mgr={0: (0, 1)},
                          ordinals=sg.mailbox_ordinals(descs))
    built = sg.build(descs, programs=job["programs"], dram_words=job["dram"],
                     crossbars=job["crossbars"], scratch_init=job["scratch"],
                     channel_latency=DENSE_QUANTUM)
    return built, (job, layer), DENSE_QUANTUM, 2000


def numbers(make, mesh, fused):
    built, extra, quantum, max_rounds = make()
    ctl = Controller(*built, backend="shard_map" if mesh is not None else "vmap", mesh=mesh,
                     quantum=quantum)
    ctl.run(max_rounds=max_rounds, check_every=CHECK_EVERY, fused=fused)
    st = ctl.result_states()
    out = {"rounds": ctl.rounds_run, "time": int(np.asarray(st["time"]).max()),
           "dispatches": ctl.dispatches,
           "digest": tree_digest({"states": st, "pending": ctl._pending_stacked()})}
    if make is fig5snn:
        job, meta = extra
        out["spikes"] = int(snn.total_spikes(st))
        out["output_counts"] = np.asarray(snn.output_spike_counts(st, meta)).tolist()
        out["oracle_counts"] = np.asarray(job.expected_counts).tolist()
    else:
        job, layer = extra
        o = job["o_word"]
        got = np.asarray(st["dram"]["data"][0, o: o + layer.h * layer.p]).reshape(
            layer.h, layer.p)
        out["instrs"] = np.asarray(st["stats"]["instrs"]).tolist()
        out["cim_ops"] = int(np.asarray(st["cims"]["ops"]).sum())
        out["o_equals_a_b"] = bool(np.array_equal(got, job["expected"]))
    return out


def main():
    mesh = compat.make_mesh((1,), ("segment",))
    target = {}
    for name, make in (("fig5snn", fig5snn), ("googlenet_conv1", googlenet_conv1)):
        t0 = time.perf_counter()
        fused, per_round = numbers(make, mesh, True), numbers(make, mesh, False)
        assert {k: v for k, v in fused.items() if k != "dispatches"} == \
            {k: v for k, v in per_round.items() if k != "dispatches"}, (fused, per_round)
        target[name] = {**fused, "dispatches_per_round_path": per_round["dispatches"]}
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    v = numbers(fig5snn, None, True)
    target["vmap"] = {"fig5snn": {k: v[k] for k in ("rounds", "time", "spikes")}}
    print("MESH_TARGET = " + pprint.pformat(target, width=100, sort_dicts=True))


if __name__ == "__main__":
    main()
