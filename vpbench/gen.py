"""Platform inputs made from a seed: frozen copies of the port's NumPy RNG
code (``repro_torch/snn/workloads.py``: ``rate_encode``, ``random_snn``,
``snn_inference_job``'s draws; ``repro_torch/vp/workloads.py``:
``TABLE_III``, ``layer_data``, ``dram_image``).  Frozen so that the
benchmark's inputs stay what they are whatever a later change does to the
program; ``tests/test_vpbench_frozen.py`` ties each copy to its original.

Weights come back as plain arrays and ``(thresh, leak)`` pairs, not as the
port's layer objects: the reference reads them as they are, and the
benchmark wraps them for the port's builders.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def rate_encode(x, t_steps: int, seed: int = 0):
    """Rates x in [0, 1]^n -> Bernoulli spike raster, int32 (T, n)."""
    rng = np.random.default_rng(seed)
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    return (rng.random((t_steps, x.shape[0])) < x).astype(np.int32)


def random_snn(layer_sizes, seed: int = 0, w_lo: int = -4, w_hi: int = 8):
    """Feed-forward LIF chain: ``[(w int8 (n_out, n_in), thresh, leak)]``
    with positive-biased random synapses and thresholds at the fan-in."""
    rng = np.random.default_rng(seed)
    layers = []
    for n_in, n_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        w = rng.integers(w_lo, w_hi, (n_out, n_in)).astype(np.int8)
        layers.append((w, max(n_in, 1), 1))
    return layers


@dataclasses.dataclass
class SnnJob:
    """One rate-coded inference job: the network and its input raster."""
    layers: list  # [(w int8 (n_out, n_in), thresh, leak), ...]
    raster: np.ndarray  # int32 (T, n_in)

    @property
    def n_ticks(self) -> int:
        """Ticks a feed-forward chain runs: T + L + 1."""
        return len(self.raster) + len(self.layers) + 1


def snn_job(layer_sizes, t_steps: int, rate: float, seed: int) -> SnnJob:
    """``snn_inference_job``'s draws: input rates, network, raster."""
    rng = np.random.default_rng(seed + 1)
    layers = random_snn(layer_sizes, seed=seed)
    x = rng.random(layer_sizes[0]) * rate * 2
    return SnnJob(layers, rate_encode(x, t_steps, seed=seed + 2))


@dataclasses.dataclass(frozen=True)
class Layer:
    network: str
    layer: str
    h: int
    w: int
    p: int

    @property
    def name(self):
        return f"{self.network}-{self.layer}"


TABLE_III = [
    Layer("Googlenet", "conv1", 224, 224, 7),
    Layer("Googlenet", "conv2", 56, 56, 3),
    Layer("ImageNet", "conv1", 224, 224, 11),
    Layer("ImageNet", "conv2", 207, 207, 5),
    Layer("MobileNets", "conv1", 224, 224, 3),
    Layer("MobileNets", "conv2", 112, 112, 3),
]

A_BASE_W = 1024  # DRAM word offset of A


def layer_data(layer: Layer, seed: int = 0):
    """int32 A (h, w), B (w, p) in [-8, 8) and O = A @ B."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 8, (layer.h, layer.w), dtype=np.int32)
    b = rng.integers(-8, 8, (layer.w, layer.p), dtype=np.int32)
    return a, b, a @ b


def dram_image(layer: Layer, a, b):
    """DRAM words holding A then B, room for O; returns (words, A, B and O
    byte addresses, O's word offset)."""
    a_base = A_BASE_W
    b_base = a_base + layer.h * layer.w
    o_base = b_base + layer.w * layer.p
    words = np.zeros(o_base + layer.h * layer.p, np.int32)
    words[a_base:b_base] = a.reshape(-1)
    words[b_base:o_base] = b.reshape(-1)
    return words, a_base * 4, b_base * 4, o_base * 4, o_base


def seed_of(seed: int, i: int) -> int:
    """The seed of job ``i`` of a run seeded ``seed`` (any whole number):
    distinct per (seed, i), non-negative, as ``default_rng`` needs."""
    return (int(seed) % (1 << 62)) * (1 << 20) + int(i)
