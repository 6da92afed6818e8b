"""Wrappers for the selective scan (counterpart of
``repro/kernels/ssm_scan/ops.py``).

``selective_scan(da, dbx, c, h0=None)`` returns ``(y, h_last)``;
``ssm_scan(da, dbx, c)`` returns ``y`` from h0 = 0, the JAX signature.
``selective_scan_fused(dt, x, b, c, a, h0=None, d_skip=None)`` is the scan
of a Mamba-1 block from its (B, S, D)-sized inputs, with the ``da``/``dbx``
expansion inside the kernel.  A CPU tensor runs the plain version
(``ref.py``); a CUDA tensor launches the hand-written kernel
``kernels/csrc/ssm_scan.cu`` on the current stream, or raises — there is no
fallback.  ``selective_scan.launches`` counts launches of the unfused
kernel (both of its functions), ``selective_scan_fused.launches`` of the
fused one, so a run can show that its scans went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LOCK, build, count_launch
from repro_torch.kernels.ssm_scan import ref

MAX_N = 64  # the kernel keeps the N state values of a row in registers
_F32 = torch.float32
_fns = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "ssm_scan_launch": [_P] * 6 + [_I] * 5 + [_P],
    "ssm_scan_fused_launch": [_P] * 4 + [_L] * 4 + [_P] * 5 + [_I] * 5 + [_P],
}


def _launcher(name):
    with LOCK:
        if name not in _fns:
            fn = getattr(build.load("ssm_scan"), name)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def _check(name, x, shape, device, who="selective_scan", contiguous=True):
    if x.dtype != _F32 or tuple(x.shape) != shape or x.device != device:
        raise ValueError(f"{who}: {name} must be float32 {shape} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_range(who, b, s, d, n):
    if s < 1 or d < 1 or not 1 <= n <= MAX_N or not 1 <= b <= 65535:
        raise ValueError(f"{who}: shape {(b, s, d, n)} outside the kernel's "
                         f"range (S, D >= 1, 1 <= N <= {MAX_N}, 1 <= B <= 65535)")


def _ptr(x):
    return None if x is None else x.data_ptr()


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
    _check_range("selective_scan", b, s, d, n)
    if dev.type == "cpu":
        return ref.selective_scan(da, dbx, c, h0)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not {dev}")
    y = torch.empty((b, s, d), dtype=_F32, device=dev)
    h_last = torch.empty((b, d, n), dtype=_F32, device=dev) if want_h else None
    ptrs = [x.data_ptr() for x in (da, dbx, c, h0, y, h_last) if x is not None]
    vec = n % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher("ssm_scan_launch")(
            da.data_ptr(), dbx.data_ptr(), c.data_ptr(), _ptr(h0), y.data_ptr(),
            _ptr(h_last), b, s, d, n, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    count_launch(selective_scan, launches=1)
    return y, h_last


def selective_scan(da, dbx, c, h0=None):
    """da, dbx (B, S, D, N) float32; c (B, S, N); h0 (B, D, N) or None
    (zeros) -> (y (B, S, D), h_last (B, D, N))."""
    return _scan(da, dbx, c, h0, want_h=True)


def ssm_scan(da, dbx, c):
    """da, dbx (B, S, D, N); c (B, S, N) -> y (B, S, D); h0 = 0."""
    return _scan(da, dbx, c, None, want_h=False)[0]


def selective_scan_fused(dt, x, b, c, a, h0=None, d_skip=None, chunk=None):
    """The scan of a Mamba-1 block with its expansion fused in:
    ``da = exp(dt * a)`` and ``dbx = (dt * x) * b`` per state element, the
    recurrence from ``h0``, ``y + x * d_skip``.

    dt, x (B, S, D) float32, contiguous; b, c (B, S, N) float32 at any row
    strides with the last stride 1 (the slices of one projection's output;
    any other layout is made contiguous); a (D, N); h0 (B, D, N) or None
    (zeros); d_skip (D,) or None -> (y (B, S, D), h_last (B, D, N)).  One
    launch covers the whole sequence; ``chunk`` bounds the plain version's
    transient (B, chunk, D, N) tiles on the CPU and is not used on the
    card."""
    who = "selective_scan_fused"
    if dt.dim() != 3 or b.dim() != 3:
        raise ValueError(f"{who}: dt must be (B, S, D) and b (B, S, N), got "
                         f"{tuple(dt.shape)} and {tuple(b.shape)}")
    bsz, s, d = dt.shape
    n = b.shape[-1]
    dev = dt.device
    _check("dt", dt, (bsz, s, d), dev, who)
    _check("x", x, (bsz, s, d), dev, who)
    _check("b", b, (bsz, s, n), dev, who, contiguous=False)
    _check("c", c, (bsz, s, n), dev, who, contiguous=False)
    _check("a", a, (d, n), dev, who)
    if h0 is not None:
        _check("h0", h0, (bsz, d, n), dev, who)
    if d_skip is not None:
        _check("d_skip", d_skip, (d,), dev, who)
    _check_range(who, bsz, s, d, n)
    if dev.type == "cpu":  # the plain expansion, each chunk through selective_scan
        return ref.selective_scan_fused(dt, x, b, c, a, h0, d_skip, chunk,
                                        scan=selective_scan)
    if dev.type != "cuda":
        raise ValueError(f"{who} runs on cpu or cuda, not {dev}")
    b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (b, c))
    y = torch.empty((bsz, s, d), dtype=_F32, device=dev)
    h_last = torch.empty((bsz, d, n), dtype=_F32, device=dev)
    vec = n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (a, h0, h_last)
                             if t is not None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher("ssm_scan_fused_launch")(
            dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), b.stride(0),
            b.stride(1), c.stride(0), c.stride(1), a.data_ptr(), _ptr(h0), _ptr(d_skip),
            y.data_ptr(), h_last.data_ptr(), bsz, s, d, n, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan fused kernel launch failed: CUDA error {err}")
    count_launch(selective_scan_fused, launches=1)
    return y, h_last


selective_scan.launches = 0
selective_scan_fused.launches = 0
