"""Wrapper for the selective scan (counterpart of
``repro/kernels/ssm_scan/ops.py``).

``selective_scan(da, dbx, c, h0=None)`` returns ``(y, h_last)``;
``ssm_scan(da, dbx, c)`` returns ``y`` from h0 = 0, the JAX signature.  A
CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches the
hand-written kernel ``kernels/csrc/ssm_scan.cu`` on the current stream, or
raises — there is no fallback.  ``selective_scan.launches`` counts kernel
launches of both functions, so a run can show that its scans went through
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan import ref

MAX_N = 64  # the kernel keeps the N state values of a row in registers
_F32 = torch.float32
_fn = []


def _launcher():
    if not _fn:
        fn = build.load("ssm_scan").ssm_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _check(name, x, shape, device):
    if x.dtype != _F32 or tuple(x.shape) != shape or x.device != device:
        raise ValueError(f"selective_scan: {name} must be float32 {shape} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"selective_scan: {name} must be contiguous")


def _scan(da, dbx, c, h0, want_h):
    if da.dim() != 4:
        raise ValueError(f"selective_scan: da must be (B, S, D, N), got {tuple(da.shape)}")
    b, s, d, n = da.shape
    dev = da.device
    _check("da", da, (b, s, d, n), dev)
    _check("dbx", dbx, (b, s, d, n), dev)
    _check("c", c, (b, s, n), dev)
    if h0 is not None:
        _check("h0", h0, (b, d, n), dev)
    if s < 1 or d < 1 or not 1 <= n <= MAX_N or not 1 <= b <= 65535:
        raise ValueError(f"selective_scan: shape {(b, s, d, n)} outside the kernel's "
                         f"range (S, D >= 1, 1 <= N <= {MAX_N}, 1 <= B <= 65535)")
    if dev.type == "cpu":
        return ref.selective_scan(da, dbx, c, h0)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not {dev}")
    y = torch.empty((b, s, d), dtype=_F32, device=dev)
    h_last = torch.empty((b, d, n), dtype=_F32, device=dev) if want_h else None
    ptrs = [x.data_ptr() for x in (da, dbx, c, h0, y, h_last) if x is not None]
    vec = n % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(da.data_ptr(), dbx.data_ptr(), c.data_ptr(), ptr(h0),
                          y.data_ptr(), ptr(h_last), b, s, d, n, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    selective_scan.launches += 1
    return y, h_last


def selective_scan(da, dbx, c, h0=None):
    """da, dbx (B, S, D, N) float32; c (B, S, N); h0 (B, D, N) or None
    (zeros) -> (y (B, S, D), h_last (B, D, N))."""
    return _scan(da, dbx, c, h0, want_h=True)


def ssm_scan(da, dbx, c):
    """da, dbx (B, S, D, N); c (B, S, N) -> y (B, S, D); h0 = 0."""
    return _scan(da, dbx, c, None, want_h=False)[0]


selective_scan.launches = 0
