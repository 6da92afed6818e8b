"""Recurrent spiking jobs: rate-coded inference on a network whose hidden
layers each feed their own spikes back through a recurrent (lateral)
matrix, served under a tick horizon.  Each is mapped onto the VP by the
port's ``snn.workloads.network_request``: a hidden layer whose fan-in (its
inputs and its own neurons) passes one crossbar tiles into a column group,
which the grouped tick merges.

A configuration of this kind gives ``layer_sizes``, ``recurrent`` (the
half-open range of the recurrent weights), ``lif`` (``thresh`` and
``leak``, one a layer), ``settle``, ``strategy``, ``n_segments`` and
``in_cap``; its traffic gives ``pool``, ``t_steps`` and ``rate``.  A job
runs ``T + L + settle`` ticks.  Its answer is its output layer's spike
counts and its spikes per layer; the reference is ``lif_network`` below,
in float64 PyTorch on the host (exact for these integers), with
``precision="bf16"`` the control: every accumulated sum rounded to
bfloat16 (each contraction, a tick's charge, the membrane)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vpbench import bounds, gen
from vpbench.reference import SPIKE_SAT, _rounded


@dataclasses.dataclass
class RsnnJob:
    """One job: the network, its input raster and its horizon."""
    layers: list  # [(w int8 (n_out, n_in), thresh, leak), ...]
    laterals: list  # [int8 (n_out, n_out) or None, ...], one a layer
    raster: np.ndarray  # int32 (T, n_in)
    n_ticks: int


def make_jobs(config, traffic, seed):
    """The run's pool of distinct jobs from the seed: feed-forward weights
    as ``gen.random_snn`` draws them, a recurrent matrix on every hidden
    layer, input rates uniform in [0, 2 rate], a raster of ``t_steps``;
    job ``i``'s three draws each take a stream of their own,
    ``gen.seed_of(seed, 3 i + k)``."""
    sizes = list(config["layer_sizes"])
    t_steps, rate = int(traffic["t_steps"]), float(traffic["rate"])
    lo, hi = config["recurrent"]
    thresh, leak = config["lif"]["thresh"], config["lif"]["leak"]
    n_ticks = t_steps + len(sizes) - 1 + int(config["settle"])
    jobs = []
    for i in range(int(traffic["pool"])):
        s = [gen.seed_of(seed, 3 * i + k) for k in range(3)]
        ff = gen.random_snn(sizes, seed=s[0])
        rng = np.random.default_rng(s[1])
        laterals = [rng.integers(lo, hi, (n, n)).astype(np.int8) for n in sizes[1:-1]] + [None]
        x = rng.random(sizes[0]) * rate * 2
        layers = [(w, int(t), int(lk)) for (w, _, _), t, lk in zip(ff, thresh, leak)]
        jobs.append(RsnnJob(layers, laterals, gen.rate_encode(x, t_steps, seed=s[2]), n_ticks))
    return jobs


def build(config, job, device):
    """The job as a platform: ``(cfg, states, pending, meta)``."""
    from repro_torch.snn.neuron import LIFParams
    from repro_torch.snn.topology import SNNLayer
    from repro_torch.snn.workloads import network_request

    layers = [SNNLayer(w, LIFParams(thresh=t, leak=lk), lateral=lat)
              for (w, t, lk), lat in zip(job.layers, job.laterals)]
    req = network_request(layers, job.raster, n_ticks=job.n_ticks,
                          n_segments=int(config["n_segments"]), strategy=config["strategy"],
                          in_cap=int(config["in_cap"]), device=device)
    return req.cfg, req.states, req.pending, req.meta


def answer(states, meta):
    """What the program says of a finished job, on the host: its output
    counts and its spikes per layer."""
    from repro_torch.snn import topology

    return (np.asarray(topology.output_spike_counts(states, meta), np.int64),
            np.asarray(topology.layer_spikes(states, meta), np.int64))


def lif_network(jobs, precision: str = "exact", block: int = 64):
    """Output counts int64 (J, n_out) and spikes per layer int64 (J, L) of
    ``jobs`` (one shape), in blocks of ``block`` jobs: per tick every layer
    integrates the previous tick's spikes of the layer before (layer 0 the
    raster's step) and, where it has one, its recurrent matrix over its own
    previous spikes, ``v' = max(v + W s + R s_self - leak, 0)``, fires at
    ``v' >= thresh`` and resets to 0, for ``n_ticks`` ticks.  Under
    ``precision="bf16"`` each sum is rounded as a 16-bit GEMM output or a
    bfloat16 state would be: ``W s`` and ``R s_self`` apart, their sum, and
    ``v'``."""
    outs, totals = [], []
    for i in range(0, len(jobs), block):
        o, t = _block(jobs[i:i + block], precision)
        outs.append(o)
        totals.append(t)
    return np.concatenate(outs), np.concatenate(totals)


def _block(jobs, precision):
    f64 = torch.float64
    n_layers = len(jobs[0].layers)
    stack = lambda xs: torch.from_numpy(np.stack(xs)).to(f64)
    w = [stack([j.layers[l][0] for j in jobs]) for l in range(n_layers)]
    lat = [None if jobs[0].laterals[l] is None else stack([j.laterals[l] for j in jobs])
           for l in range(n_layers)]
    thresh = [torch.tensor([j.layers[l][1] for j in jobs], dtype=f64)[:, None]
              for l in range(n_layers)]
    leak = [torch.tensor([j.layers[l][2] for j in jobs], dtype=f64)[:, None]
            for l in range(n_layers)]
    raster = stack([j.raster for j in jobs])
    n_ticks = jobs[0].n_ticks
    assert all(j.n_ticks == n_ticks and len(j.raster) == len(raster[0]) for j in jobs)
    v = [torch.zeros(len(jobs), x.shape[1], dtype=f64) for x in w]
    prev = [torch.zeros_like(x) for x in v]
    counts = [torch.zeros_like(x) for x in v]
    mv = lambda m, s: torch.bmm(m, s[:, :, None])[:, :, 0]
    for tick in range(n_ticks):
        ext = raster[:, tick] if tick < raster.shape[1] else torch.zeros_like(raster[:, 0])
        fired_now = []
        for l in range(n_layers):
            s = (ext if l == 0 else prev[l - 1]).clamp(-SPIKE_SAT, SPIKE_SAT)
            charge = _rounded(mv(w[l], s), precision)
            if lat[l] is not None:
                charge = _rounded(charge + _rounded(mv(lat[l], prev[l]), precision), precision)
            v1 = _rounded(torch.clamp(v[l] + charge - leak[l], min=0), precision)
            fired = (v1 >= thresh[l]).to(f64)
            v[l] = torch.where(fired > 0, 0.0, v1)
            counts[l] += fired
            fired_now.append(fired)
        prev = fired_now
    per_layer = torch.stack([c.sum(1) for c in counts], 1).to(torch.int64).numpy()
    return counts[-1].to(torch.int64).numpy(), per_layer


def expected(jobs, precision="exact"):
    """The reference's answers for ``jobs``, in their order."""
    counts, per_layer = lif_network(jobs, precision)
    return list(zip(counts, per_layer))


def differs(got, want) -> bool:
    return not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]))


def _tiles(job):
    """Each layer's crossbar tiles as (rows, cols): 256-row stripes over
    256-column slices of the effective fan-in (inputs, then the layer's own
    neurons where it is recurrent)."""
    x = bounds.XBAR
    out = []
    for (w, _, _), lat in zip(job.layers, job.laterals):
        rows, cols = w.shape[0], w.shape[1] + (0 if lat is None else lat.shape[1])
        out.append([(min(x, rows - r), min(x, cols - c))
                    for r in range(0, rows, x) for c in range(0, cols, x)])
    return out


def unit_ticks(job) -> int:
    """Unit ticks the job needs: every crossbar unit ticks each of its ticks."""
    return sum(len(tiles) for tiles in _tiles(job)) * job.n_ticks


def bound_s(job) -> float:
    """Least time of the job's necessary work on the card: each tile's tick
    of weights and state at peak bandwidth or of its int8 MACs at peak
    rate, whichever is larger, every tick."""
    return job.n_ticks * sum(bounds.unit_tick_s(r, c) for tiles in _tiles(job) for r, c in tiles)

