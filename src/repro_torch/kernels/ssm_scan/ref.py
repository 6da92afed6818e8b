"""Plain-PyTorch selective scan (the Mamba-1 recurrence; counterpart of
``repro/kernels/ssm_scan/ref.py``) — the CPU path of the wrappers in
``ops.py`` and the reference the CUDA kernels are held to on the card.

  h_t = da_t * h_{t-1} + dbx_t          (elementwise over (D, N))
  y_t[d] = sum_n h_t[d, n] * c_t[n]

Shapes: da, dbx (B, S, D, N); c (B, S, N); h0 (B, D, N) or None (zeros,
the TPU kernel's function) -> y (B, S, D), h_S (B, D, N); all float32.

The sum over n is taken in a fixed pairwise order: the products are padded
with zeros to a power of two and halved, ``p[j] + p[j + w]`` for
w = P/2, ..., 1.  The CUDA kernel sums in the same order and rounds every
product and sum as these tensor ops do, so the two agree bit for bit.
The JAX package's einsum sums in another order: against it the scan holds
to rtol = atol = 1e-5, as tests/test_kernels.py holds the Pallas kernel.

``selective_scan_fused`` is the scan of a Mamba-1 block from its
(B, S, D)-sized inputs: it expands ``da = exp(dt * A)`` and
``dbx = (dt * x) * B`` chunk by chunk, as the JAX package's ``chunk_step``
(``repro/models/ssm.py``), scans each chunk from the carried state and adds
``x * d_skip``.
"""
from __future__ import annotations

import torch


def pairwise_sum(p):
    """Sum over the last axis in the kernel's order (see module doc)."""
    n = p.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        p = torch.nn.functional.pad(p, (0, width - n))
    while width > 1:
        width //= 2
        p = p[..., :width] + p[..., width:]
    return p[..., 0]


def selective_scan(da, dbx, c, h0=None):
    b, s, d, n = da.shape
    h = torch.zeros((b, d, n), dtype=da.dtype, device=da.device) if h0 is None else h0
    ys = []
    for t in range(s):
        h = da[:, t] * h + dbx[:, t]
        ys.append(pairwise_sum(h * c[:, t, None, :]))
    return torch.stack(ys, dim=1), h


def selective_scan_fused(dt, x, b, c, a, h0=None, d_skip=None, chunk=None,
                         scan=selective_scan):
    """dt, x (B, S, D); b, c (B, S, N); a (D, N); h0 (B, D, N) or None;
    d_skip (D,) or None -> (y (B, S, D), h_S (B, D, N)), all float32.

    The (B, chunk, D, N) tiles of ``da`` and ``dbx`` exist one chunk at a
    time (``chunk`` None: the whole sequence).  ``scan`` runs each chunk:
    this module's ``selective_scan``, or the unfused kernel's wrapper
    (expansion here, scan on the card)."""
    s = dt.shape[1]
    chunk = s if chunk is None else min(chunk, s)
    h = h0
    ys = []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        dt_c = dt[:, sl]
        da_c = (dt_c[..., None] * a).exp_()
        dbx_c = (dt_c * x[:, sl])[..., None] * b[:, sl, None, :]
        y_c, h = scan(da_c, dbx_c, c[:, sl].contiguous(), h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    if d_skip is not None:
        y = y + x * d_skip
    return y, h
