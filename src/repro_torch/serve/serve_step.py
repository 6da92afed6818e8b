"""Serving steps: prefill and single-token decode over a batched cache
(counterpart of ``repro/serve/serve_step.py``).

All slots of a batch advance one position per step (aligned continuous
batching).  A KV cache (dense, vlm, moe, the hybrid family's shared
attention, the encdec self-attention) comes out of the prefill as long as
the prompt; ``greedy_generate(pad_to=)`` pads its sequence axis, found by
``cache_seq_axes``, so decode appends.  An ssm state has no sequence axis
and the encdec cross cache is fixed-length memory, so ``pad_to`` leaves
both as they are.

Over a mesh (``mesh=``) the batch is this rank's block of the batch axes
and the weights are in ``model.run_pspecs``' layout: tensor parallel over
'model' where their specs split them, the MoE layers expert-parallel
(``ep_moe`` at prefill, ``ep_moe_decode`` at decode); every rank issues the
same steps.  The prefill's cache holds this rank's rows (and kv heads and
ssm channels over 'model'); ``_pad_seq(mesh=, layout=)`` pads it to the
global length and lays every attention entry out as
``model.decode_layout`` says (split-KV decode: the rows gathered where the
pspec keeps the batch whole, this rank's block of positions kept), and
the decode steps read and write it in that layout.  The logits are this
rank's vocab block, so the greedy token is combined over 'model'
(``next_token``).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.common import entry_axes
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L


def make_prefill(model, mesh=None):
    def prefill(params, batch):
        return model.prefill(params, batch, mesh=mesh)

    return prefill


def make_decode_step(model, mesh=None):
    def decode_step(params, cache, batch, pos, layout=None):
        return model.decode_step(params, cache, batch, pos, mesh=mesh, layout=layout)

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


def _pad_seq(cfg, cache, seq, batch, pad_to, mesh=None, layout=None):
    """Zero-pad every sequence-addressed cache leaf to ``pad_to`` positions
    (None: leave the lengths).  Over ``mesh`` (with ``layout``, the
    decode layout at the global batch and length ``pad_to or seq``) the
    prefill's cache, the step's rows (the layout's "batch"), becomes the
    decode step's blocks: each attention entry (the encdec cross memory
    too) gathered over the batch axes where its pspec keeps the batch whole
    and the step holds this rank's rows, and cut to this rank's block of
    positions where it splits the sequence."""
    axes = dict(zip([p for p, _ in T.leaves(cache)], cache_seq_axes(cfg, cache, seq, batch)))

    def pad(path, x):
        ax = axes[path]
        if ax is None or not pad_to or x.shape[ax] >= pad_to:
            return x
        shape = list(x.shape)
        shape[ax] = pad_to - x.shape[ax]
        return torch.cat([x, x.new_zeros(shape)], dim=ax)

    cache = T.map_with_path(pad, cache)
    if mesh is None:
        return cache
    from repro_torch.models.model import attn_cache_keys

    rows = entry_axes(layout["batch"][0])

    def place(x, ps):
        b_dim = x.dim() - 4  # (..., B, S, Hkv, Dh)
        if ps[b_dim] is None and rows:
            x = M.gather(x, mesh, rows, b_dim)
        seq_axes = entry_axes(ps[b_dim + 1])
        blk = x.shape[b_dim + 1] // M.axis_size(mesh, seq_axes)
        return x.narrow(b_dim + 1, M.axis_index(mesh, seq_axes) * blk, blk).contiguous()

    for keys in attn_cache_keys(cfg):
        parent, ps = cache, layout
        for k in keys[:-1]:
            parent, ps = parent[k], ps[k]
        parent[keys[-1]] = T.tree_map(place, parent[keys[-1]], ps[keys[-1]])
    return cache


def decode_layout_of(model, batch, mesh, pad_to=None):
    """``model.decode_layout`` for the cache ``greedy_generate`` decodes
    from the prefill of ``batch`` (this rank's block of it over ``mesh``):
    the global batch, the prompt's length or ``pad_to``, an encdec model's
    memory as long as the batch's frames."""
    from repro_torch.models.model import decode_layout

    b, seq = batch["tokens"].shape
    frames = batch["enc_feats"].shape[1] if "enc_feats" in batch else None
    return decode_layout(model, mesh, b * M.axis_size(mesh, L.row_axes(mesh)), pad_to or seq,
                         cross_length=frames)


def decode_batch(cfg, tokens, pos: int):
    """One decode step's batch: ``tokens`` (B, 1), and for M-RoPE every
    row at the text position ``pos``, as the reference's
    ``greedy_generate`` builds it."""
    db = {"tokens": tokens}
    if cfg.mrope:
        db["mrope_pos"] = torch.full((3, tokens.shape[0], 1), pos, dtype=torch.int32,
                                     device=tokens.device)
    return db


def next_token(cfg, lg, mesh=None):
    """The greedy tokens (B,) int32 of last-position logits ``lg`` (B, V):
    ``torch.argmax``'s first maximal index; over ``mesh``, of the whole
    vocab where ``lg`` is this rank's vocab block (``mesh.argmax``)."""
    v = lg.shape[-1]
    if not L.split_over_model(mesh, v, cfg.vocab_size):
        return torch.argmax(lg, dim=-1).to(torch.int32)
    return M.argmax(lg, mesh, "model", L.tp_index(mesh) * v).to(torch.int32)


def greedy_generate(model, params, batch, steps: int, mesh=None, pad_to: int | None = None):
    """Prefill, then ``steps - 1`` greedy decode steps -> tokens (B, steps)
    int32, the first from the prefill's logits.  Without ``pad_to`` a dense
    cache has no room past the prompt, and each decode write lands on its
    last position, as the reference's clamped write does.  Over ``mesh``,
    this rank's batch block and its tokens (the same on every 'model'
    rank); the cache in ``decode_layout_of``'s layout."""
    cfg = model.cfg
    cache, lg = model.prefill(params, batch, mesh=mesh)
    b, seq = batch["tokens"].shape
    layout = None if mesh is None else decode_layout_of(model, batch, mesh, pad_to)
    if pad_to or mesh is not None:
        cache = _pad_seq(cfg, cache, seq, b, pad_to, mesh=mesh, layout=layout)
    toks = [next_token(cfg, lg[:, -1], mesh)]
    for i in range(steps - 1):
        lg, cache = model.decode_step(params, cache,
                                      decode_batch(cfg, toks[-1][:, None], seq + i),
                                      seq + i, mesh=mesh, layout=layout)
        toks.append(next_token(cfg, lg[:, -1], mesh))
    return torch.stack(toks, dim=1)
