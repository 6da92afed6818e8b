"""SNN benchmark workloads and the network oracle (counterpart of
``repro/snn/workloads.py``).

The numpy RNG code is the reference's, byte for byte, so a job built here
and one built by the JAX package are identical by construction.  The
oracle is the reference the VP run is checked against: it always runs the
plain LIF (``kernels/lif_step/ref.py``) on the CPU, never the kernel.

Timing contract: one tick of axonal delay per hop.  Input timestep k is
integrated by layer 0 at tick k; a layer's spikes from tick j reach its
destinations at tick j+1.  A feed-forward chain simulates T + L + 1 ticks;
a cyclic network needs an explicit ``n_ticks``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.snn import topology
from repro_torch.snn.neuron import LIFParams, lif_step_multi, pool_state
from repro_torch.snn.topology import SNNLayer, connectivity


def rate_encode(x, t_steps: int, seed: int = 0):
    """Rates x in [0, 1]^n -> Bernoulli spike raster, int (T, n)."""
    rng = np.random.default_rng(seed)
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    return (rng.random((t_steps, x.shape[0])) < x).astype(np.int32)


def random_snn(layer_sizes=(64, 48, 10), seed: int = 0, w_lo: int = -4, w_hi: int = 8):
    """Feed-forward LIF chain with positive-biased random int8 synapses;
    thresholds scale with fan-in so mid-rate input keeps every layer
    spiking."""
    rng = np.random.default_rng(seed)
    layers = []
    for n_in, n_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        w = rng.integers(w_lo, w_hi, (n_out, n_in)).astype(np.int8)
        layers.append(SNNLayer(w, LIFParams(thresh=max(n_in, 1), leak=1)))
    return layers


def _oracle(layers, raster, edges=(), n_ticks=None):
    """Cycle-aware oracle loop on the CPU; returns (output_counts,
    per_layer_totals, per_layer_per_neuron_totals, n_ticks)."""
    t_steps, n_in = raster.shape
    n_layers = len(layers)
    assert layers[0].n_in == n_in
    in_edges, _, _ = connectivity(layers, edges)
    if n_ticks is None:
        assert not topology._cyclic(in_edges), (
            "cyclic connectivity can self-sustain: pass the n_ticks horizon "
            "(the VP runs the same bounded tick_limit)")
        n_ticks = t_steps + n_layers + 1
    assert t_steps <= n_ticks, "raster outlives the tick horizon"
    w_blocks = [[torch.from_numpy(np.asarray(w, np.int8)) for _, w, _ in in_edges[l]]
                for l in range(n_layers)]
    states = [pool_state(l.n_out) for l in layers]
    prev = [torch.zeros((l.n_out,), dtype=torch.int32) for l in layers]
    per_neuron = [np.zeros(l.n_out, np.int64) for l in layers]
    totals = np.zeros(n_layers, np.int64)
    raster_t = torch.from_numpy(np.asarray(raster, np.int32))
    zero_in = torch.zeros((n_in,), dtype=torch.int32)
    for j in range(n_ticks):
        ext = raster_t[j] if j < t_steps else zero_in
        # every layer sees *last* tick's spikes of every source
        feeds = [[ext if src < 0 else prev[src] for src, _, _ in in_edges[l]]
                 for l in range(n_layers)]
        new_prev = []
        for l, layer in enumerate(layers):
            states[l], fired = lif_step_multi(
                states[l], w_blocks[l], feeds[l], layer.params)
            new_prev.append(fired)
            per_neuron[l] += fired.numpy().astype(np.int64)
            totals[l] += int(fired.sum())
        prev = new_prev
    return per_neuron[-1].copy(), totals, per_neuron, n_ticks


def oracle_run(layers, raster, edges=(), n_ticks=None):
    """Plain reference simulation on the CPU; returns (output_counts,
    per_layer_totals)."""
    counts, totals, _, _ = _oracle(layers, raster, edges, n_ticks)
    return counts, totals


@dataclasses.dataclass
class SNNJob:
    layers: list
    raster: np.ndarray
    expected_counts: np.ndarray  # oracle output spike counts
    expected_total: int  # oracle all-layer spike total
    edges: tuple = ()  # recurrent projections (RecurrentEdge, ...)
    n_ticks: int | None = None  # tick horizon (mandatory when cyclic)


def snn_inference_job(layer_sizes=(64, 48, 10), t_steps: int = 12,
                      rate: float = 0.5, seed: int = 0) -> SNNJob:
    """Rate-coded inference job: random input rates -> raster -> oracle."""
    rng = np.random.default_rng(seed + 1)
    layers = random_snn(layer_sizes, seed=seed)
    x = rng.random(layer_sizes[0]) * rate * 2
    raster = rate_encode(x, t_steps, seed=seed + 2)
    counts, totals = oracle_run(layers, raster)
    return SNNJob(layers, raster, counts, int(totals.sum()))
