"""Gradient compression for the cross-pod reduction: int8 blockwise
quantization with error feedback (counterpart of
``repro/train/compression.py``).

A float32 tensor becomes int8 values and one float32 scale per 256-block
(4x fewer bytes); the error-feedback residual of each round is added to
the next round's input before it is quantized, so the long-run average
converges to the true value.  Rounding is half to even, as ``jnp.round``.
"""
from __future__ import annotations

import torch

BLOCK = 256
_F32 = torch.float32


def compress(x):
    """float32 tensor -> (int8 q (n_blocks, BLOCK), float32 scales
    (n_blocks,), the original shape)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0 + 1e-12
    q = torch.round(blocks / scale[:, None]).to(torch.int8)
    return q, scale, tuple(x.shape)


def decompress(q, scale, shape):
    flat = (q.to(_F32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def _map(fn, tree, *rest):
    """``fn`` over a dict tree's leaves (a compressed leaf is one tuple)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def compress_tree(tree, error_feedback=None):
    """Returns (compressed tree of (q, scale, shape) leaves, new error
    feedback tree): each leaf plus its residual is quantized, and the new
    residual is what the quantization lost."""
    if error_feedback is None:
        error_feedback = _map(torch.zeros_like, tree)

    def one(x, e):
        xe = x + e
        c = compress(xe)
        return c, xe - decompress(*c)

    pairs = _map(one, tree, error_feedback)
    return _map(lambda pair: pair[0], pairs), _map(lambda pair: pair[1], pairs)


def decompress_tree(comp):
    return _map(lambda c: decompress(*c), comp)


def compressed_bytes(tree) -> int:
    """Bytes of a tensor tree once compressed: one per value and four per
    block's scale, as the reference counts them."""
    total = 0

    def add(x):
        nonlocal total
        total += x.numel() + 4 * (x.numel() // BLOCK + 1)

    _map(add, tree)
    return total
