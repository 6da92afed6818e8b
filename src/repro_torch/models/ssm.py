"""State-space blocks: Mamba-1 and Mamba-2 (counterpart of
``repro/models/ssm.py``).

The JAX package expands the decay ``da = exp(dt * A)`` and drive
``dbx = dt * x * B`` to transient (B, chunk, d_inner, N) tiles chunk by
chunk and scans them.  Here one call of
``kernels.ssm_scan.ops.selective_scan_fused`` takes the (B, S, d_inner)
inputs, B, C and A and does both: on a CUDA tensor one launch of the
hand-written kernel for the whole prompt, with the expansion in registers
(no tile exists); on the CPU the plain version, which expands chunk by
chunk as the JAX package does.  Decode (seq = 1, state given) is the same
call from the carried state.

Mamba-2 (SSD, the hybrid family's blocks) is the reference's chunked form
in float32 torch ops: per chunk the (B, i, j, H) decay matrix, the
intra-chunk product and the carried state's contribution, chunks in
order; the reference computes it in plain JAX (no Pallas kernel).  Both
blocks are differentiable: the fused scan through its autograd Function
(``ops.SelectiveScanFused``, a CUDA backward on the card), the SSD
through autograd.

Over a mesh (``mesh=``) both blocks run on this rank's ``d_inner`` block
(Mamba-2: its heads), as the specs split it over 'model'.  ``in_proj``'s
block is a block of the concatenated ``[x | z]`` axis (at tp = 2 rank 0
holds all of x, rank 1 all of z), so its output is gathered over 'model'
and each rank keeps its x and z channels (``_split_xz``, GSPMD's reshard
after the split); the held weight stays the spec's block.  Mamba-1's
``x_proj`` and both blocks' ``out_proj`` are row-parallel, summed over
'model'; the scan runs on (B, S, d_inner / tp, N).  Mamba-2 takes its
heads' columns of the replicated ``dt``, ``a_log``, ``dt_bias`` and
``d_skip``, and its gated RMSNorm's mean over ``d_inner`` is a sum over
'model'.  The decode states hold the rank's channels and heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import DTypePolicy, P, ParamSpec, ShapeDtype
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L

_F32 = torch.float32


def _dinner(cfg):
    return cfg.ssm.expand * cfg.d_model


# ---------------------------------------------------------------------------
# Mamba-1


def mamba1_specs(cfg, tp: int = 1):
    """The reference's Mamba-1 specs: ``d_inner`` over 'model' (its
    partition specs name the axis at any ``tp``)."""
    s = cfg.ssm
    d, din, n = cfg.d_model, _dinner(cfg), s.d_state
    dtr = s.dt_rank or d // 16
    dt = cfg.params_dtype
    return {
        "in_proj": ParamSpec((d, 2 * din), dt, P(None, "model")),
        "conv_w": ParamSpec((s.d_conv, din), dt, P(None, "model"), init="small"),
        "conv_b": ParamSpec((din,), _F32, P("model"), init="zeros"),
        "x_proj": ParamSpec((din, dtr + 2 * n), dt, P("model", None)),
        "dt_proj": ParamSpec((dtr, din), dt, P(None, "model"), init="small"),
        "dt_bias": ParamSpec((din,), _F32, P("model"), init="zeros"),
        "a_log": ParamSpec((din, n), _F32, P("model", None), init="ones"),
        "d_skip": ParamSpec((din,), _F32, P("model"), init="ones"),
        "out_proj": ParamSpec((din, d), dt, P("model", None)),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B,S,C), w (K,C). state (B,K-1,C) for decode."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    seq = x.shape[1]
    y = xp[:, 0:seq] * w[0]
    for i in range(1, k):  # the JAX code's sum(), left to right, rounding each add
        y = y + xp[:, i:i + seq] * w[i]
    new_state = xp[:, -(k - 1):]
    return y + b.to(x.dtype), new_state


def _split_xz(xz, mesh, din: int):
    """x and z (each (B, S, din / tp)) of this rank's channels from its
    block of ``in_proj``'s output: the blocks gathered over 'model', then
    this rank's slice of each half (``xz`` split in two without a mesh)."""
    if not L.has_model(mesh):
        return torch.split(xz, [din, din], dim=-1)
    loc = xz.shape[-1] // 2
    full = M.all_gather(xz, mesh, "model", -1)
    lo = L.tp_index(mesh) * loc
    return full[..., lo:lo + loc], full[..., din + lo:din + lo + loc]


def _mamba1_core(cfg, p, xin, h0, policy, mesh=None):
    """xin (B,S,din) post-conv activations; h0 (B,din,N) float32. One fused
    scan.  Over ``mesh``, this rank's channels, ``x_proj`` summed over
    'model'."""
    s = cfg.ssm
    n = s.d_state
    dtr = s.dt_rank or cfg.d_model // 16
    cdt = policy.compute
    seq = xin.shape[1]
    chunk = min(s.chunk, seq)
    assert seq % chunk == 0, (seq, chunk)
    split = L.has_model(mesh)
    xbc = L.model_sum(xin.to(cdt) @ p["x_proj"].to(cdt), mesh, split)  # (B,S,dtr+2N)
    xbc = L.model_input(xbc, mesh, split)  # into dt_proj's block and the scan
    dt_in, bmat, cmat = torch.split(xbc.to(_F32), [dtr, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].to(_F32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])  # (din, N)
    return scan_ops.selective_scan_fused(dt, xin.to(_F32), bmat, cmat, a, h0,
                                         p["d_skip"], chunk=chunk)


def mamba1_block(cfg, p, x, policy: DTypePolicy, state=None, mesh=None):
    """Full block. state = None (prefill, h0 = 0) or dict for the decode carry."""
    cdt = policy.compute
    b = x.shape[0]
    xz = L.model_input(x.to(cdt), mesh, L.has_model(mesh)) @ p["in_proj"].to(cdt)
    xin, z = _split_xz(xz, mesh, _dinner(cfg))
    conv_state = None if state is None else state["conv"]
    h0 = (torch.zeros((b, xin.shape[-1], cfg.ssm.d_state), dtype=_F32, device=x.device)
          if state is None else state["ssm"])
    xin, new_conv = _causal_conv(xin, p["conv_w"].to(cdt), p["conv_b"], conv_state)
    xin = F.silu(xin)
    y, h_last = _mamba1_core(cfg, p, xin, h0, policy, mesh)
    out = (y.to(cdt) * F.silu(z)) @ p["out_proj"].to(cdt)
    return L.model_sum(out, mesh, L.has_model(mesh)), {"conv": new_conv, "ssm": h_last}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)


def mamba2_specs(cfg, tp: int = 1):
    """The reference's Mamba-2 specs: the x/z projection and ``d_inner``
    over 'model', the small B/C/dt projection replicated."""
    s = cfg.ssm
    d, din, n = cfg.d_model, _dinner(cfg), s.d_state
    nh = din // s.head_dim
    dt = cfg.params_dtype
    return {
        "in_proj": ParamSpec((d, 2 * din), dt, P(None, "model")),
        "bcdt_proj": ParamSpec((d, 2 * n + nh), dt, P(None, None)),
        "conv_x_w": ParamSpec((s.d_conv, din), dt, P(None, "model"), init="small"),
        "conv_x_b": ParamSpec((din,), _F32, P("model"), init="zeros"),
        "conv_bc_w": ParamSpec((s.d_conv, 2 * n), dt, P(None, None), init="small"),
        "conv_bc_b": ParamSpec((2 * n,), _F32, P(), init="zeros"),
        "a_log": ParamSpec((nh,), _F32, P(), init="ones"),
        "dt_bias": ParamSpec((nh,), _F32, P(), init="zeros"),
        "d_skip": ParamSpec((nh,), _F32, P(), init="ones"),
        "norm_scale": ParamSpec((din,), _F32, P("model"), init="ones"),
        "out_proj": ParamSpec((din, d), dt, P("model", None)),
    }


def _ssd_core(cfg, xh, bmat, cmat, dt, a_log, h0):
    """Chunked SSD, chunk by chunk as the reference's ``lax.scan``.  xh
    (B,S,H,P), bmat/cmat (B,S,N), dt (B,S,H), h0 (B,H,N,P), all float32.
    Returns y (B,S,H,P) and the last state."""
    b, seq, nh, pd = xh.shape
    chunk = min(cfg.ssm.chunk, seq)
    assert seq % chunk == 0
    la = -torch.exp(a_log) * dt  # (B,S,H) log decay per step (negative)
    ii = torch.arange(chunk, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    h, ys = h0, []
    for c in range(seq // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, bc, cc, dtc = xh[:, sl], bmat[:, sl], cmat[:, sl], dt[:, sl]
        cs = torch.cumsum(la[:, sl], dim=1)  # (B,c,H) cumulative log decay
        # intra-chunk: Y[i] = sum_{j<=i} C_i.B_j dt_j exp(cs_i - cs_j) x_j
        decay = cs[:, :, None, :] - cs[:, None, :, :]  # (B,i,j,H)
        # the reference's where(causal, exp(decay), 0), with the mask on the
        # exponent: the same values, but above the diagonal decay > 0 may
        # overflow exp, whose gradient 0 * inf is NaN (ROADMAP F4)
        gate = torch.exp(torch.where(causal, decay, -torch.inf))
        scores = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * gate
        y = torch.einsum("bijh,bjh,bjhp->bihp", scores, dtc, xc)
        # inter-chunk: the carried state's contribution
        y = y + torch.einsum("bin,bih,bhnp->bihp", cc, torch.exp(cs), h)
        dec_end = torch.exp(cs[:, -1:, :] - cs)  # (B,c,H)
        st = torch.einsum("bjn,bjh,bjhp->bhnp", bc, dtc * dec_end, xc)
        h = torch.exp(cs[:, -1])[:, :, None, None] * h + st
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba2_block(cfg, p, x, policy: DTypePolicy, state=None, mesh=None):
    """Full block. state = None (prefill, zero carries) or the decode carry
    ``{"conv_x", "conv_bc", "ssm"}``.  Over ``mesh``, this rank's heads."""
    s = cfg.ssm
    cdt = policy.compute
    b, seq, _ = x.shape
    din, n = _dinner(cfg), s.d_state
    split = L.has_model(mesh)
    xz = L.model_input(x.to(cdt), mesh, split) @ p["in_proj"].to(cdt)
    xin, z = _split_xz(xz, mesh, din)
    dl = xin.shape[-1]  # this rank's channels
    nh, pd = dl // s.head_dim, s.head_dim
    heads = slice(L.tp_index(mesh) * nh, (L.tp_index(mesh) + 1) * nh)
    bcdt = x.to(cdt) @ p["bcdt_proj"].to(cdt)
    bc, dt_in = bcdt[..., :2 * n], L.model_input(bcdt[..., 2 * n:], mesh, split)[..., heads]
    xin, new_conv_x = _causal_conv(xin, p["conv_x_w"].to(cdt), p["conv_x_b"],
                                   None if state is None else state["conv_x"])
    bc, new_conv_bc = _causal_conv(bc, p["conv_bc_w"].to(cdt), p["conv_bc_b"],
                                   None if state is None else state["conv_bc"])
    # silu(xin) meets only its float32 cast: XLA drops the product's
    # rounding to bf16 there (the logistic is still rounded per op)
    xh = (xin.to(_F32) * L.logistic(xin).to(_F32)).reshape(b, seq, nh, pd)
    bc = L.model_input(L.silu(bc), mesh, split)  # into this rank's heads
    bmat, cmat = torch.split(bc, [n, n], dim=-1)
    dt = F.softplus(dt_in.to(_F32) + p["dt_bias"][heads])  # (B,S,H)
    h0 = (torch.zeros((b, nh, n, pd), dtype=_F32, device=x.device)
          if state is None else state["ssm"])
    y, h_last = _ssd_core(cfg, xh, bmat.to(_F32), cmat.to(_F32), dt, p["a_log"][heads], h0)
    y = y + xh * (dt * p["d_skip"][heads])[..., None]  # dt-scaled skip (Mamba-2's D term)
    y = y.reshape(b, seq, dl)
    # gated RMSNorm (its mean over all of d_inner: this block's share of it
    # summed over 'model'; a factor of 1 without), then the out-projection
    yz = y * L.silu(z.to(_F32))
    var = L.model_sum((yz * yz).mean(-1, keepdim=True) * (dl / din), mesh, split)
    var = L.model_input(var, mesh, split)
    yz = yz * torch.rsqrt(var + 1e-6) * p["norm_scale"]
    out = L.model_sum(yz.to(cdt) @ p["out_proj"].to(cdt), mesh, split)
    return out, {"conv_x": new_conv_x, "conv_bc": new_conv_bc, "ssm": h_last}


def ssm_block(cfg, p, x, policy, state=None, mesh=None):
    if cfg.ssm.version == 1:
        return mamba1_block(cfg, p, x, policy, state, mesh)
    return mamba2_block(cfg, p, x, policy, state, mesh)


def ssm_state_shape(cfg, batch: int, tp: int = 1):
    """Decode-state shapes and dtypes for one layer (of one rank's channels
    and heads at ``tp``)."""
    s = cfg.ssm
    din = _dinner(cfg) // tp
    if s.version == 1:
        return {
            "conv": ShapeDtype((batch, s.d_conv - 1, din), torch.bfloat16),
            "ssm": ShapeDtype((batch, din, s.d_state), _F32),
        }
    return {
        "conv_x": ShapeDtype((batch, s.d_conv - 1, din), torch.bfloat16),
        "conv_bc": ShapeDtype((batch, s.d_conv - 1, 2 * s.d_state), torch.bfloat16),
        "ssm": ShapeDtype((batch, din // s.head_dim, s.d_state, s.head_dim), _F32),
    }
