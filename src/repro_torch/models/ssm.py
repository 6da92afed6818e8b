"""State-space blocks: Mamba-1 (counterpart of ``repro/models/ssm.py``).

The JAX package expands the decay ``da = exp(dt * A)`` and drive
``dbx = dt * x * B`` to transient (B, chunk, d_inner, N) tiles chunk by
chunk and scans them.  Here one call of
``kernels.ssm_scan.ops.selective_scan_fused`` takes the (B, S, d_inner)
inputs, B, C and A and does both: on a CUDA tensor one launch of the
hand-written kernel for the whole prompt, with the expansion in registers
(no tile exists); on the CPU the plain version, which expands chunk by
chunk as the JAX package does.  Decode (seq = 1, state given) is the same
call from the carried state.

Mamba-2 (SSD) is not ported yet: ROADMAP module item 13.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import DTypePolicy, ParamSpec, ShapeDtype
from repro_torch.kernels.ssm_scan import ops as scan_ops

_F32 = torch.float32


def _dinner(cfg):
    return cfg.ssm.expand * cfg.d_model


def _mamba2_missing():
    return NotImplementedError("Mamba-2 (SSD) blocks are not ported yet: ROADMAP "
                               "module item 13 (LM stack)")


# ---------------------------------------------------------------------------
# Mamba-1


def mamba1_specs(cfg):
    s = cfg.ssm
    d, din, n = cfg.d_model, _dinner(cfg), s.d_state
    dtr = s.dt_rank or d // 16
    dt = cfg.params_dtype
    return {
        "in_proj": ParamSpec((d, 2 * din), dt),
        "conv_w": ParamSpec((s.d_conv, din), dt, init="small"),
        "conv_b": ParamSpec((din,), _F32, init="zeros"),
        "x_proj": ParamSpec((din, dtr + 2 * n), dt),
        "dt_proj": ParamSpec((dtr, din), dt, init="small"),
        "dt_bias": ParamSpec((din,), _F32, init="zeros"),
        "a_log": ParamSpec((din, n), _F32, init="ones"),
        "d_skip": ParamSpec((din,), _F32, init="ones"),
        "out_proj": ParamSpec((din, d), dt),
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


def _mamba1_core(cfg, p, xin, h0, policy):
    """xin (B,S,din) post-conv activations; h0 (B,din,N) float32. One fused scan."""
    s = cfg.ssm
    n = s.d_state
    dtr = s.dt_rank or cfg.d_model // 16
    cdt = policy.compute
    seq = xin.shape[1]
    chunk = min(s.chunk, seq)
    assert seq % chunk == 0, (seq, chunk)
    xbc = xin.to(cdt) @ p["x_proj"].to(cdt)  # (B,S,dtr+2N)
    dt_in, bmat, cmat = torch.split(xbc.to(_F32), [dtr, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].to(_F32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])  # (din, N)
    return scan_ops.selective_scan_fused(dt, xin.to(_F32), bmat, cmat, a, h0,
                                         p["d_skip"], chunk=chunk)


def mamba1_block(cfg, p, x, policy: DTypePolicy, state=None):
    """Full block. state = None (prefill, h0 = 0) or dict for the decode carry."""
    cdt = policy.compute
    b = x.shape[0]
    din = _dinner(cfg)
    xz = x.to(cdt) @ p["in_proj"].to(cdt)
    xin, z = torch.split(xz, [din, din], dim=-1)
    conv_state = None if state is None else state["conv"]
    h0 = (torch.zeros((b, din, cfg.ssm.d_state), dtype=_F32, device=x.device)
          if state is None else state["ssm"])
    xin, new_conv = _causal_conv(xin, p["conv_w"].to(cdt), p["conv_b"], conv_state)
    xin = F.silu(xin)
    y, h_last = _mamba1_core(cfg, p, xin, h0, policy)
    out = (y.to(cdt) * F.silu(z)) @ p["out_proj"].to(cdt)
    return out, {"conv": new_conv, "ssm": h_last}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD): not ported


def mamba2_specs(cfg):
    raise _mamba2_missing()


def mamba2_block(cfg, p, x, policy, state=None):
    raise _mamba2_missing()


def ssm_block(cfg, p, x, policy, state=None):
    if cfg.ssm.version == 1:
        return mamba1_block(cfg, p, x, policy, state)
    return mamba2_block(cfg, p, x, policy, state)


def ssm_state_shape(cfg, batch: int):
    """Decode-state shapes and dtypes for one layer."""
    s = cfg.ssm
    if s.version != 1:
        raise _mamba2_missing()
    din = _dinner(cfg)
    return {
        "conv": ShapeDtype((batch, s.d_conv - 1, din), torch.bfloat16),
        "ssm": ShapeDtype((batch, din, s.d_state), _F32),
    }
