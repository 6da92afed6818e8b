"""Serving steps: prefill and single-token decode over a batched cache
(counterpart of ``repro/serve/serve_step.py``).

All slots of a batch advance one position per step (aligned continuous
batching).  A KV cache (dense, vlm, moe, the hybrid family's shared
attention, the encdec self-attention) comes out of the prefill as long as
the prompt; ``greedy_generate(pad_to=)`` pads its sequence axis, found by
``cache_seq_axes``, so decode appends.  An ssm state has no sequence axis
and the encdec cross cache is fixed-length memory, so ``pad_to`` leaves
both as they are.

Over a mesh (``mesh=``) the batch and the cache are this rank's blocks of
the batch axes and the weights are in ``model.run_pspecs``' layout: the MoE
layers run expert-parallel (``ep_moe`` at prefill, ``ep_moe_decode`` at
decode); every rank issues the same steps.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def make_prefill(model, mesh=None):
    def prefill(params, batch):
        return model.prefill(params, batch, mesh=mesh)

    return prefill


def make_decode_step(model, mesh=None):
    def decode_step(params, cache, batch, pos):
        return model.decode_step(params, cache, batch, pos, mesh=mesh)

    return decode_step


def cache_seq_axes(cfg, cache, seq: int, batch: int):
    """Per-leaf index of the sequence axis in a decode cache (in
    ``tree.leaves`` order), or None for leaves that are not
    sequence-addressed.

    Derived from ``models.model.cache_specs``, probed at two sequence
    lengths (``kind="decode"``): the axis whose size moved is the sequence
    axis.  Shape matching would be wrong where an unrelated axis collides
    with the prompt length (an ssm cell's batch axis sits where a KV cell
    keeps its sequence axis)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import cache_specs

    def probe(s):
        sds, _ = cache_specs(cfg, ShapeConfig("probe", s, batch, "decode"))
        return [x for _, x in T.leaves(sds)]

    lo, hi = probe(seq), probe(seq + 1)
    live = [x for _, x in T.leaves(cache)]
    if len(lo) != len(live):
        raise ValueError(f"cache_specs tree ({len(lo)} leaves) does not match the live "
                         f"decode cache ({len(live)} leaves)")
    axes = []
    for a, b, leaf in zip(lo, hi, live):
        if not len(a.shape) == len(b.shape) == leaf.dim():
            raise ValueError(f"cache leaf {tuple(leaf.shape)} against specs {a.shape}")
        moved = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(moved) > 1:
            raise ValueError(f"specs {a.shape} and {b.shape} differ on more than one axis")
        axes.append(moved[0] if moved else None)
    return axes


def _pad_seq(cfg, cache, seq, batch, pad_to):
    """Zero-pad every sequence-addressed cache leaf to ``pad_to`` positions."""
    axes = dict(zip([p for p, _ in T.leaves(cache)], cache_seq_axes(cfg, cache, seq, batch)))

    def pad(path, x):
        ax = axes[path]
        if ax is None or x.shape[ax] >= pad_to:
            return x
        shape = list(x.shape)
        shape[ax] = pad_to - x.shape[ax]
        return torch.cat([x, x.new_zeros(shape)], dim=ax)

    return T.map_with_path(pad, cache)


def decode_batch(cfg, tokens, pos: int):
    """One decode step's batch: ``tokens`` (B, 1), and for M-RoPE every
    row at the text position ``pos``, as the reference's
    ``greedy_generate`` builds it."""
    db = {"tokens": tokens}
    if cfg.mrope:
        db["mrope_pos"] = torch.full((3, tokens.shape[0], 1), pos, dtype=torch.int32,
                                     device=tokens.device)
    return db


def greedy_generate(model, params, batch, steps: int, mesh=None, pad_to: int | None = None):
    """Prefill, then ``steps - 1`` greedy decode steps -> tokens (B, steps)
    int32, the first from the prefill's logits.  Without ``pad_to`` a dense
    cache has no room past the prompt, and each decode write lands on its
    last position, as the reference's clamped write does.  Over ``mesh``,
    this rank's batch block and its tokens."""
    cache, lg = model.prefill(params, batch, mesh=mesh)
    b, seq = batch["tokens"].shape
    if pad_to:
        cache = _pad_seq(model.cfg, cache, seq, b, pad_to)
    toks = [torch.argmax(lg[:, -1], dim=-1).to(torch.int32)]
    for i in range(steps - 1):
        lg, cache = model.decode_step(params, cache,
                                      decode_batch(model.cfg, toks[-1][:, None], seq + i),
                                      seq + i, mesh=mesh)
        toks.append(torch.argmax(lg[:, -1], dim=-1).to(torch.int32))
    return torch.stack(toks, dim=1)
