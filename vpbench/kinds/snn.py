"""Spiking jobs: rate-coded inference on a feed-forward LIF chain, each
mapped onto the VP by the port's ``snn.topology.build_snn``.

A configuration of this kind gives ``layer_sizes``, ``strategy``,
``n_segments`` and ``in_cap``; its traffic gives ``pool``, ``t_steps`` and
``rate``.  A job's answer is its output layer's spike counts and its
spikes over all layers; the reference is ``reference.lif_chain``."""
from __future__ import annotations

import numpy as np

from vpbench import bounds, gen, reference


def make_jobs(config, traffic, seed):
    """The run's pool of distinct jobs, each a raster of ``t_steps`` steps: seeds
    change the networks and rasters, not the amount of work."""
    t_steps, rate = int(traffic["t_steps"]), float(traffic["rate"])
    return [gen.snn_job(tuple(config["layer_sizes"]), t_steps, rate, gen.seed_of(seed, i))
            for i in range(int(traffic["pool"]))]


def build(config, job, device):
    """The job as a platform: ``(cfg, states, pending, meta)``."""
    from repro_torch.snn import topology
    from repro_torch.snn.neuron import LIFParams

    layers = [topology.SNNLayer(w, LIFParams(thresh=int(t), leak=int(lk)))
              for w, t, lk in job.layers]
    descs = topology.segmentation_for(len(layers), config["strategy"],
                                      n_segments=int(config["n_segments"]))
    return topology.build_snn(layers, descs, job.raster, in_cap=int(config["in_cap"]),
                              device=device)


def answer(states, meta):
    """What the program says of a finished job, on the host: its output
    counts and its spikes over all layers."""
    from repro_torch.snn import topology

    return (np.asarray(topology.output_spike_counts(states, meta), np.int64),
            int(topology.total_spikes(states)))


def expected(jobs, precision="exact"):
    """The reference's answers for ``jobs``, in their order."""
    counts, per_layer = reference.lif_chain(jobs, precision)
    return [(c, int(t.sum())) for c, t in zip(counts, per_layer)]


def differs(got, want) -> bool:
    return not (np.array_equal(got[0], want[0]) and got[1] == want[1])


def units(job):
    """Crossbar units per layer: 256 x 256 tiles."""
    x = bounds.XBAR
    return [-(-w.shape[0] // x) * -(-w.shape[1] // x) for w, _, _ in job.layers]


def unit_ticks(job) -> int:
    """Unit ticks the job needs: every unit ticks each of its T + L + 1 ticks."""
    return sum(units(job)) * job.n_ticks


def bound_s(job) -> float:
    """Least time of the job's necessary work on the card: each unit's
    tick of weights and state, every tick."""
    per_tick = 0.0
    for (w, _, _), u in zip(job.layers, units(job)):
        rows, cols = w.shape
        per_tick += max((u * (bounds.UNIT_READ + bounds.UNIT_WRITE) + rows * cols)
                        / bounds.PEAK_BYTES_PER_S,
                        2 * rows * cols / bounds.PEAK_INT8_OPS_PER_S)
    return job.n_ticks * per_tick


def instructions(states) -> int:
    """Simulated instructions retired (the platform has no CPU: 0)."""
    return int(states["stats"]["instrs"].sum())
