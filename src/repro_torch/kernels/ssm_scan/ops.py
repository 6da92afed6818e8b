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
fused one and ``selective_scan_fused_bwd.launches`` of its backward, so a
run can show that its scans went through the kernels.
``selective_scan_fused`` is differentiable (``SelectiveScanFused``).

Under a dispatch mode (``common.dispatch_mode_on``: a counter of
``analysis.roofline``, fake tensors) the fused scan and its backward each
reach the dispatcher as one custom op
(``torch.ops.repro_torch.selective_scan_fused`` and ``..._bwd``), whose
kernel is the code above and whose fake implementation gives the outputs'
shapes: a counter sees a scan as one op (``analysis.roofline``'s byte
count reads each input once and writes each output once, the kernel's
traffic), and under fake tensors (``launch/dryrun.py``) a scan is traced as
one op, not as the plain version's S steps.  With no mode on they run
their code directly, as the main paths do.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from repro_torch.common import dispatch_mode_on
from repro_torch.kernels import LOCK, build, count_launch
from repro_torch.kernels.ssm_scan import ref

MAX_N = 64  # the kernel keeps the N state values of a row in registers
_F32 = torch.float32
_fns = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "ssm_scan_launch": [_P] * 6 + [_I] * 5 + [_P],
    "ssm_scan_fused_launch": [_P] * 4 + [_L] * 4 + [_P] * 5 + [_I] * 5 + [_P],
    "ssm_scan_fused_bwd_launch": [_P] * 4 + [_L] * 4 + [_P] * 12 + [_I] * 5 + [_P],
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


def _check_fused(who, dt, x, b, c, a, h0, d_skip):
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who} runs on cpu or cuda, not {dev}")
    return bsz, s, d, n


def _unit_rows(t):
    return t if t.stride(-1) == 1 else t.contiguous()


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
    card.

    Differentiable: when grad mode is on and an input requires a gradient,
    the call goes through ``SelectiveScanFused``, whose backward is
    ``selective_scan_fused_bwd``; otherwise nothing is saved."""
    _check_fused("selective_scan_fused", dt, x, b, c, a, h0, d_skip)
    args = (dt, x, b, c, a, h0, d_skip)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return SelectiveScanFused.apply(*args, chunk)
    return _fused(*args, chunk)


def _fused(dt, x, b, c, a, h0, d_skip, chunk):
    if dispatch_mode_on():  # one op for the modes (the module docstring)
        return _fused_op(dt, x, b, c, a, h0, d_skip, chunk)
    return _fused_run(dt, x, b, c, a, h0, d_skip, chunk)


@torch.library.custom_op("repro_torch::selective_scan_fused", mutates_args=())
def _fused_op(dt: Tensor, x: Tensor, b: Tensor, c: Tensor, a: Tensor, h0: Optional[Tensor],
              d_skip: Optional[Tensor], chunk: Optional[int]) -> tuple[Tensor, Tensor]:
    return _fused_run(dt, x, b, c, a, h0, d_skip, chunk)


@_fused_op.register_fake
def _(dt, x, b, c, a, h0, d_skip, chunk):
    bsz, s, d = dt.shape
    return dt.new_empty((bsz, s, d)), dt.new_empty((bsz, d, b.shape[-1]))


def _fused_run(dt, x, b, c, a, h0, d_skip, chunk):
    if dt.device.type == "cpu":  # the plain expansion, each chunk through selective_scan
        return ref.selective_scan_fused(dt, x, b, c, a, h0, d_skip, chunk,
                                        scan=selective_scan)
    bsz, s, d = dt.shape
    n = b.shape[-1]
    dev = dt.device
    b, c = _unit_rows(b), _unit_rows(c)
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


class SelectiveScanFused(torch.autograd.Function):
    """``selective_scan_fused`` with a gradient: the forward is the fused
    scan (the kernel on the card, the plain version on the CPU) and saves
    only its inputs; the backward recomputes the states from them
    (``selective_scan_fused_bwd``: the kernel on the card, the plain
    reverse recurrence on the CPU)."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a, h0, d_skip, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(dt, x, b, c, a, h0, d_skip)
        return _fused(dt, x, b, c, a, h0, d_skip, chunk)

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, x, b, c, a, h0, d_skip = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(dt)
        return (*_fused_bwd(dt, x, b, c, a, h0, d_skip, dy.contiguous(),
                            None if dh_last is None else dh_last.contiguous(), ctx.chunk),
                None)


def bwd_layout(n):
    """The backward kernel's buffers for N = ``n``: (steps between its saved
    states, rows of D a block covers, lanes a saved state is padded to)."""
    with LOCK:
        if "ssm_scan_bwd_layout" not in _fns:
            fn = build.load("ssm_scan").ssm_scan_bwd_layout
            fn.argtypes, fn.restype = [_I, ctypes.POINTER(_I)], _I
            _fns["ssm_scan_bwd_layout"] = fn
        out = (_I * 3)()
        if _fns["ssm_scan_bwd_layout"](n, out) != 0:
            raise ValueError(f"selective_scan_fused_bwd: N = {n} outside 1..{MAX_N}")
        return tuple(out)


def selective_scan_fused_bwd(dt, x, b, c, a, h0, d_skip, dy, dh_last=None, chunk=None):
    """The gradient of ``selective_scan_fused(dt, x, b, c, a, h0, d_skip)``
    given ``dy`` (B, S, D) and ``dh_last`` (B, D, N) or None (zero), float32
    and contiguous -> (d_dt, d_x, d_b, d_c, d_a, d_h0, d_skip's gradient),
    d_b and d_c contiguous, the last two None where ``h0`` or ``d_skip`` is.
    On the card one launch of ``ssm_scan_fused_bwd_launch`` computes every
    per-step gradient, d_b and d_c as partial sums over each block's rows
    of D and d_a per batch row, which one torch sum each finishes (a fixed
    order: no atomics); the plain version on the CPU (``ref.py``)."""
    who = "selective_scan_fused_bwd"
    bsz, s, d, n = _check_fused(who, dt, x, b, c, a, h0, d_skip)
    _check("dy", dy, (bsz, s, d), dt.device, who)
    if dh_last is not None:
        _check("dh_last", dh_last, (bsz, d, n), dt.device, who)
    return _fused_bwd(dt, x, b, c, a, h0, d_skip, dy, dh_last, chunk)


def _bwd_buffers(bsz, s, d, n, layout, with_h0, device):
    """The backward launch's scratch and outputs for a (B, S, D, N) =
    (``bsz``, ``s``, ``d``, ``n``) call and the kernel's ``layout``
    (``bwd_layout``): the saved states (B, ceil(S / stride), D, lanes),
    d_dt and d_x (B, S, D), the d_b and d_c partials (B, S, ceil(D / rows),
    N), d_a per batch row (B, D, N), d_h0 (B, D, N) or None."""
    stride, rows, lanes = layout
    empty = lambda *shape: torch.empty(shape, dtype=_F32, device=device)
    n_blk = -(-d // rows)
    return {"states": empty(bsz, -(-s // stride), d, lanes), "d_dt": empty(bsz, s, d),
            "d_x": empty(bsz, s, d), "d_b": empty(bsz, s, n_blk, n),
            "d_c": empty(bsz, s, n_blk, n), "d_a": empty(bsz, d, n),
            "d_h0": empty(bsz, d, n) if with_h0 else None}


def _bwd_arguments(dt, x, b, c, a, h0, d_skip, dy, dh_last, buf):
    """``ssm_scan_fused_bwd_launch``'s arguments before the stream: b and c
    with unit last strides, ``buf`` from ``_bwd_buffers``."""
    bsz, s, d = dt.shape
    n = b.shape[-1]
    vec = n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (a, h0, dh_last) if t is not None)
    return (dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1), a.data_ptr(), _ptr(h0), _ptr(d_skip), dy.data_ptr(),
            _ptr(dh_last), buf["states"].data_ptr(), buf["d_dt"].data_ptr(),
            buf["d_x"].data_ptr(), buf["d_b"].data_ptr(), buf["d_c"].data_ptr(),
            buf["d_a"].data_ptr(), _ptr(buf["d_h0"]), bsz, s, d, n, int(vec))


def _bwd_result(buf, x, dy, d_skip):
    """The gradients from a launch's ``buf``: the partials summed over the
    blocks of D (d_b, d_c) and over B (d_a) in torch's fixed order."""
    return (buf["d_dt"], buf["d_x"], buf["d_b"].sum(2), buf["d_c"].sum(2), buf["d_a"].sum(0),
            buf["d_h0"], None if d_skip is None else (dy * x).sum((0, 1)))


def _fused_bwd(dt, x, b, c, a, h0, d_skip, dy, dh_last, chunk):
    if dispatch_mode_on():  # one op for the modes (the module docstring)
        grads = iter(_fused_bwd_op(dt, x, b, c, a, h0, d_skip, dy, dh_last, chunk))
        return tuple(None if absent else next(grads)
                     for absent in (False,) * 5 + (h0 is None, d_skip is None))
    return _fused_bwd_run(dt, x, b, c, a, h0, d_skip, dy, dh_last, chunk)


@torch.library.custom_op("repro_torch::selective_scan_fused_bwd", mutates_args=())
def _fused_bwd_op(dt: Tensor, x: Tensor, b: Tensor, c: Tensor, a: Tensor, h0: Optional[Tensor],
                  d_skip: Optional[Tensor], dy: Tensor, dh_last: Optional[Tensor],
                  chunk: Optional[int]) -> list[Tensor]:
    """The gradients ``_fused_bwd_run`` returns, the absent ones left out
    (a custom op returns no None)."""
    out = _fused_bwd_run(dt, x, b, c, a, h0, d_skip, dy, dh_last, chunk)
    return [g for g in out if g is not None]


@_fused_bwd_op.register_fake
def _(dt, x, b, c, a, h0, d_skip, dy, dh_last, chunk):
    bsz, s, d = dt.shape
    n = b.shape[-1]
    shapes = [(bsz, s, d), (bsz, s, d), (bsz, s, n), (bsz, s, n), (d, n)]
    shapes += [(bsz, d, n)] * (h0 is not None) + [(d,)] * (d_skip is not None)
    return [dt.new_empty(shp) for shp in shapes]


def _fused_bwd_run(dt, x, b, c, a, h0, d_skip, dy, dh_last, chunk):
    if dt.device.type == "cpu":
        return ref.selective_scan_fused_bwd(dt, x, b, c, a, h0, d_skip, dy, dh_last, chunk)
    bsz, s, d = dt.shape
    n = b.shape[-1]
    dev = dt.device
    b, c = _unit_rows(b), _unit_rows(c)
    buf = _bwd_buffers(bsz, s, d, n, bwd_layout(n), h0 is not None, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher("ssm_scan_fused_bwd_launch")(
            *_bwd_arguments(dt, x, b, c, a, h0, d_skip, dy, dh_last, buf), stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan backward kernel launch failed: CUDA error {err}")
    count_launch(selective_scan_fused_bwd, launches=1)
    return _bwd_result(buf, x, dy, d_skip)


selective_scan.launches = 0
selective_scan_fused.launches = 0
selective_scan_fused_bwd.launches = 0
