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
``x * d_skip``.  ``selective_scan_fused_bwd`` is its gradient, the reverse
recurrence written out (the JAX package differentiates its
``associative_scan`` instead; there is no Pallas backward):

  g_t = C_t * dy_t + da_{t+1} * g_{t+1}     (g_S's carry is dh_last)
  e_t = g_t * h_{t-1} * da_t                (the gradient of dt_t * A)
  d_dt_t = sum_n e_t * A + (sum_n g_t * B_t) * x_t
  d_x_t  = (sum_n g_t * B_t) * dt_t + dy_t * d_skip
  d_A    = sum_{b,t} e_t * dt_t
  d_B_t  = sum_d g_t * dt_t * x_t,  d_C_t = sum_d h_t * dy_t
  d_h0   = da_0 * g_0,  d_skip's = sum_{b,t} dy_t * x_t
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


def selective_scan_fused_bwd(dt, x, b, c, a, h0, d_skip, dy, dh_last=None, chunk=None):
    """The gradient of ``selective_scan_fused`` (module doc): the inputs of
    the forward, ``dy`` (B, S, D) and ``dh_last`` (B, D, N) or None (zero)
    -> (d_dt, d_x, d_b, d_c, d_a, d_h0, d_skip's gradient); the last two
    are None where ``h0`` or ``d_skip`` is.

    A forward pass keeps the state entering each chunk; the chunks are then
    walked from last to first, each one's (B, chunk, D, N) states
    recomputed from its entering state and the reverse recurrence run over
    them, so as in the forward only one chunk's tiles exist at a time."""
    bsz, s, d = dt.shape
    chunk = s if chunk is None else min(chunk, s)
    n = b.shape[-1]
    h = torch.zeros((bsz, d, n), dtype=dt.dtype, device=dt.device) if h0 is None else h0

    def expand(lo, hi):
        dt_c = dt[:, lo:hi]
        dtx = dt_c * x[:, lo:hi]
        return dt_c, dtx, (dt_c[..., None] * a).exp_(), dtx[..., None] * b[:, lo:hi, None, :]

    bounds = [(lo, min(lo + chunk, s)) for lo in range(0, s, chunk)]
    entering = []
    for lo, hi in bounds:
        entering.append(h)
        _, _, da_c, dbx_c = expand(lo, hi)
        for t in range(hi - lo):
            h = da_c[:, t] * h + dbx_c[:, t]
    g = torch.zeros_like(h) if dh_last is None else dh_last
    d_a = torch.zeros_like(a)
    d_dt, d_x, d_b, d_c = [], [], [], []
    for (lo, hi), h in zip(reversed(bounds), reversed(entering)):
        dt_c, dtx, da_c, dbx_c = expand(lo, hi)
        prev = []  # h_{t-1} for each step of the chunk
        for t in range(hi - lo):
            prev.append(h)
            h = da_c[:, t] * h + dbx_c[:, t]
        prev = torch.stack(prev, dim=1)
        cur = da_c * prev + dbx_c
        dy_c, b_c, c_c = dy[:, lo:hi], b[:, lo:hi], c[:, lo:hi]
        gs = [None] * (hi - lo)
        for t in reversed(range(hi - lo)):
            g = g + dy_c[:, t, :, None] * c_c[:, t, None, :]
            gs[t] = g
            g = da_c[:, t] * g
        gs = torch.stack(gs, dim=1)  # (B, chunk, D, N)
        e = gs * prev * da_c
        d_a = d_a + (e * dt_c[..., None]).sum((0, 1))
        s_gb = (gs * b_c[:, :, None, :]).sum(-1)
        d_dt.append((e * a).sum(-1) + s_gb * x[:, lo:hi])
        dx_c = s_gb * dt_c
        d_x.append(dx_c if d_skip is None else dx_c + dy_c * d_skip)
        d_b.append((gs * dtx[..., None]).sum(2))
        d_c.append((cur * dy_c[..., None]).sum(2))
    cat = lambda parts: torch.cat(parts[::-1], dim=1)
    return (cat(d_dt), cat(d_x), cat(d_b), cat(d_c), d_a, None if h0 is None else g,
            None if d_skip is None else (dy * x).sum((0, 1)))
