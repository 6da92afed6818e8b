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
from repro_torch.snn.topology import RecurrentEdge, SNNLayer, connectivity


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


def random_recurrent_snn(layer_sizes=(48, 40, 12), seed: int = 0,
                         w_lo: int = -4, w_hi: int = 8, inhibition: int = 6):
    """Recurrent LIF network: ``random_snn``'s chain plus three kinds of
    cyclic connectivity: the last hidden layer is Elman-style
    self-recurrent (a random ``lateral`` matrix), the output layer a
    winner-take-all pool (``-inhibition`` off-diagonal ``lateral``), and
    the output projects back onto the hidden layer (``RecurrentEdge``).

    Returns (layers, edges) for ``build_snn(..., edges=edges, n_ticks=...)``
    / ``oracle_run(..., edges=edges, n_ticks=...)``.
    """
    rng = np.random.default_rng(seed)
    sizes = list(layer_sizes)
    n_layers = len(sizes) - 1
    assert n_layers >= 2, "a recurrent job needs a hidden and an output layer"
    layers = []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = rng.integers(w_lo, w_hi, (n_out, n_in)).astype(np.int8)
        if i == n_layers - 2:  # Elman hidden: mild random self-coupling
            lateral = rng.integers(-2, 3, (n_out, n_out)).astype(np.int8)
            thresh = max(n_in + n_out // 4, 1)
        elif i == n_layers - 1:  # WTA output: mutual lateral inhibition
            lateral = (-inhibition * (1 - np.eye(n_out, dtype=np.int64))).astype(np.int8)
            thresh = max(n_in, 1)
        else:
            lateral = None
            thresh = max(n_in, 1)
        layers.append(SNNLayer(w, LIFParams(thresh=thresh, leak=1), lateral=lateral))
    feedback = rng.integers(-2, 3, (sizes[-2], sizes[-1])).astype(np.int8)
    edges = (RecurrentEdge(src=n_layers - 1, dst=n_layers - 2, weights=feedback),)
    return layers, edges


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


def oracle_rates(layers, raster, edges=(), n_ticks=None):
    """Profiling pass: per-layer per-neuron emitted-spike totals and the
    tick count, the inputs to ``topology.profile_traffic``."""
    _, _, per_neuron, nt = _oracle(layers, raster, edges, n_ticks)
    return per_neuron, nt


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


@dataclasses.dataclass
class HybridJob:
    """One platform, two concurrent workloads: a dense VMM offload job and
    a spiking network whose raster a live RISC-V CPU injects via MMIO
    (``CIM_REG_SPIKE``) and whose output counts it reads back
    (``CIM_REG_COUNTS``).  Oracle expectations for both halves ride along;
    ``snn.build_hybrid(job, strategy)`` assembles the platform."""
    dense: object  # vp.workloads.Layer
    dense_expected: np.ndarray  # A @ B for the dense half
    snn: SNNJob  # layers + raster + oracle counts over an explicit horizon
    seed: int = 0


def hybrid_job(layer_sizes=(32, 24, 10), t_steps: int = 8, rate: float = 0.5,
               seed: int = 0, dense_layer=None, settle: int = 1) -> HybridJob:
    """The canonical hybrid workload: the conformance dense layer plus a
    rate-coded feed-forward SNN sized for CPU injection (layer 0 and the
    output layer each within one crossbar: the driver program targets one
    input tile and reads one output stripe).

    The tick horizon is explicit (``t_steps + depth + settle``; with
    ``settle=1`` exactly the feed-forward oracle's own window), because the
    driver's count readback is tick-addressed: it asks for the counts as of
    that horizon, which makes the DMA'd values a function of the tick grid
    alone, not of round timing."""
    from repro_torch.vp import workloads as vwl

    dense = dense_layer or vwl.Layer("hybrid", "vmm", 8, 8, 4)
    _, _, o = vwl.layer_data(dense, seed)
    rng = np.random.default_rng(seed + 1)
    layers = random_snn(layer_sizes, seed=seed)
    x = rng.random(layer_sizes[0]) * rate * 2
    raster = rate_encode(x, t_steps, seed=seed + 2)
    n_ticks = t_steps + len(layers) + settle
    counts, totals = oracle_run(layers, raster, n_ticks=n_ticks)
    snn = SNNJob(layers, raster, counts, int(totals.sum()), n_ticks=n_ticks)
    return HybridJob(dense, o, snn, seed)


def snn_skip_job(layer_sizes=(32, 24, 16, 10), t_steps: int = 8,
                 rate: float = 0.5, seed: int = 0, w_lo: int = -4,
                 w_hi: int = 8) -> SNNJob:
    """Feed-forward chain plus a forward *skip* connection from the first
    hidden layer to the output layer (l -> l+k).  Still acyclic, so the
    network drains by itself and needs no tick horizon; the skip's spikes
    arrive one tick after emission, like every hop."""
    assert len(layer_sizes) >= 4, "a skip needs dst > src + 1"
    rng = np.random.default_rng(seed + 3)
    layers = random_snn(layer_sizes, seed=seed)
    src, dst = 0, len(layers) - 1
    skip = RecurrentEdge(src=src, dst=dst, weights=rng.integers(
        w_lo, w_hi, (layers[dst].n_out, layers[src].n_out)).astype(np.int8))
    x = rng.random(layer_sizes[0]) * rate * 2
    raster = rate_encode(x, t_steps, seed=seed + 2)
    counts, totals = oracle_run(layers, raster, edges=(skip,))
    return SNNJob(layers, raster, counts, int(totals.sum()), edges=(skip,))


def snn_recurrent_job(layer_sizes=(48, 40, 12), t_steps: int = 10,
                      rate: float = 0.5, seed: int = 0,
                      settle: int = 6) -> SNNJob:
    """Recurrent inference job: a ``random_recurrent_snn`` network under a
    rate-coded raster, verified over the bounded tick horizon
    ``n_ticks = T + L + settle`` that both the VP (``tick_limit``) and the
    oracle simulate, so the expected counts are exact even where the
    recurrent activity would self-sustain past it."""
    rng = np.random.default_rng(seed + 1)
    layers, edges = random_recurrent_snn(layer_sizes, seed=seed)
    x = rng.random(layer_sizes[0]) * rate * 2
    raster = rate_encode(x, t_steps, seed=seed + 2)
    n_ticks = t_steps + len(layers) + settle
    counts, totals = oracle_run(layers, raster, edges=edges, n_ticks=n_ticks)
    return SNNJob(layers, raster, counts, int(totals.sum()),
                  edges=edges, n_ticks=n_ticks)


def serve_request(layer_sizes=(16, 12, 8), *, t_steps: int = 6,
                  rate: float = 0.5, seed: int = 0, n_segments: int = 2,
                  strategy: str = "uniform", in_cap=None, out_cap=None,
                  faults=None, device=None):
    """One admission-ready serving request (``serve/snn_serve.SnnRequest``),
    built as ``snn_inference_job`` + ``build_snn`` would, on ``device``
    (default: the GPU), carrying the fault-free oracle's output counts.
    Requests of the same ``layer_sizes``/``n_segments``/``strategy`` share
    one compiled shape and so one serving bucket (docs/serving.md)."""
    from repro_torch.serve.snn_serve import SnnRequest

    job = snn_inference_job(layer_sizes, t_steps=t_steps, rate=rate, seed=seed)
    descs = topology.segmentation_for(len(layer_sizes) - 1, strategy,
                                      n_segments=n_segments)
    cfg, states, pending, meta = topology.build_snn(
        job.layers, descs, job.raster, n_ticks=job.n_ticks,
        in_cap=in_cap, out_cap=out_cap, faults=faults, device=device)
    return SnnRequest(cfg, states, pending, meta,
                      expected_counts=tuple(int(c) for c in job.expected_counts))


def network_request(layers, raster, *, edges=(), n_ticks=None, n_segments: int = 2,
                    strategy: str = "uniform", in_cap=None, device=None):
    """One admission-ready serving request of any network ``build_snn``
    wires: wide layers tiled into column groups (the grouped tick), lateral,
    recurrent and skip ``edges`` under the tick horizon ``n_ticks``
    (mandatory when cyclic; each unit carries it as its ``tick_limit``, so
    it rides the request's state, not the bucket key).  The segments are
    ``segmentation_for(layers, strategy, edges=edges)``'s, sized by the
    tiling.  Requests of one network shape, horizon aside, share a bucket
    (docs/serving.md)."""
    from repro_torch.serve.snn_serve import SnnRequest

    descs = topology.segmentation_for(layers, strategy, n_segments=n_segments, edges=edges)
    cfg, states, pending, meta = topology.build_snn(
        layers, descs, raster, edges=edges, n_ticks=n_ticks, in_cap=in_cap, device=device)
    return SnnRequest(cfg, states, pending, meta)


def serve_fleet(n_requests: int, layer_sizes=(16, 12, 8), *, seed: int = 0,
                t_steps_choices=(4, 6, 8), rate: float = 0.5,
                n_segments: int = 2, strategy: str = "uniform",
                in_cap=None, out_cap=None, faults=None, device=None):
    """A heterogeneous request fleet sharing one compiled shape: weights,
    rasters and durations differ per request (the reference's numpy RNG
    code, so a fleet equals the JAX package's).  Returns the requests in
    submission order."""
    rng = np.random.default_rng(seed)
    return [
        serve_request(layer_sizes,
                      t_steps=int(rng.choice(t_steps_choices)),
                      rate=rate, seed=seed + 7919 * (i + 1),
                      n_segments=n_segments, strategy=strategy,
                      in_cap=in_cap, out_cap=out_cap, faults=faults,
                      device=device)
        for i in range(n_requests)
    ]
