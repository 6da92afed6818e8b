"""Serving steps: prefill and single-token decode (counterpart of
``repro/serve/serve_step.py``).

All slots of a batch advance one position per step (aligned continuous
batching).  The port serves the ssm family, whose decode cache is a fixed
per-layer state with no sequence axis, so ``pad_to`` has nothing to pad
and is accepted for the JAX signature's sake only (tests/test_serve.py
pins the same on the JAX side).
"""
from __future__ import annotations

import torch


def make_prefill(model):
    def prefill(params, batch):
        return model.prefill(params, batch)

    return prefill


def make_decode_step(model):
    def decode_step(params, cache, batch, pos):
        return model.decode_step(params, cache, batch, pos)

    return decode_step


def greedy_generate(model, params, batch, steps: int, pad_to: int | None = None):
    """Prefill, then ``steps - 1`` greedy decode steps -> tokens (B, steps)
    int32, the first from the prefill's logits."""
    cache, lg = model.prefill(params, batch)
    seq = batch["tokens"].shape[1]
    toks = [torch.argmax(lg[:, -1], dim=-1).to(torch.int32)]
    for i in range(steps - 1):
        lg, cache = model.decode_step(params, cache, {"tokens": toks[-1][:, None]}, seq + i)
        toks.append(torch.argmax(lg[:, -1], dim=-1).to(torch.int32))
    return torch.stack(toks, dim=1)
