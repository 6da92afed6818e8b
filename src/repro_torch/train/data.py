"""Deterministic synthetic token pipeline (counterpart of
``repro/train/data.py``): the reference's numpy code, so the same
(config, step) gives the same tokens bit for bit.

A small active alphabet with a periodic copy structure (x[t] a function of
x[t - period]) and 10% noise, so the loss falls within a few steps.
``device_batch_at(mesh=)`` returns this rank's block of the batch placed as
the reference places it: axis 0 of every key over the batch axes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.common import P, named, shard


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: int = 16  # markov-ish period; smaller = easier


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Host batch, deterministic in (cfg, step): {"tokens": int32 (B, S)}."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    alpha = min(v, 64)
    period = cfg.structure
    base = rng.integers(0, alpha, (b, period))
    reps = -(-s // period)
    toks = np.tile(base, (1, reps))[:, :s]
    drift = rng.integers(0, alpha, (b, s))
    mask = rng.random((b, s)) < 0.1
    toks = np.where(mask, drift, (toks + np.arange(s) // period) % alpha)
    return {"tokens": torch.from_numpy(toks.astype(np.int32))}


def device_batch_at(cfg: DataConfig, step: int, mesh=None, extras=None, device=None) -> dict:
    """``batch_at`` plus ``extras(cfg, step)``'s arrays, on ``device``
    (``cuda`` unless given).  Over ``mesh``, this rank's block of each key
    under the reference's placement ``P(("data", "pod"), None, ...)``, on
    the mesh's device: axis 0 of every key, ``mrope_pos``'s rows too, so
    a data degree that does not divide its 3 rows raises the reference's
    ``ValueError`` and one that does gives each rank a row (ROADMAP F9)."""
    batch = batch_at(cfg, step)
    if extras:
        batch.update(extras(cfg, step))
    if mesh is None:
        device = T.resolve_device(device)
        return {k: v.to(device) for k, v in batch.items()}
    from repro_torch.launch.mesh import mesh_device

    device = mesh_device(mesh) if device is None else torch.device(device)
    return {k: shard(v.to(device), named(mesh, P(("data", "pod"), *([None] * (v.dim() - 1)))))
            for k, v in batch.items()}
