"""Wrapper for the fused LIF step (counterpart of
``repro/kernels/lif_step/ops.py``).

``lif_step_units`` takes the JAX signature.  A CPU tensor runs the plain
version (``ref.py``); a CUDA tensor launches the hand-written kernel
``kernels/csrc/lif_step.cu`` on the current stream, or raises — there is no
fallback.  ``lif_step_units.launches`` counts kernel launches, so a run can
show that its ticks went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lif_step import ref

_I32 = torch.int32
_SHMEM_LIMIT = 48 * 1024  # static shared-memory launch limit, bytes
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("lif_step").lif_step_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(f"lif_step_units: {name} must be {dtype} {shape} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"lif_step_units: {name} must be contiguous")


def lif_step_units(weights, spikes, v, refrac, thresh, leak, refrac_period,
                   extra=None):
    """Batched over units: weights (U, R, C) int8; spikes (U, C) int32;
    v/refrac (U, R) int32; thresh/leak/refrac_period (U,) int32;
    extra (U, R) int32 or None -> (v', refrac', fired) each (U, R) int32."""
    if weights.device.type == "cpu":
        return ref.lif_step_units(weights, spikes, v, refrac, thresh, leak,
                                  refrac_period, extra)
    if weights.device.type != "cuda":
        raise ValueError(f"lif_step_units runs on cpu or cuda, not {weights.device}")
    u, r, c = weights.shape
    dev = weights.device
    _check("weights", weights, torch.int8, (u, r, c), dev)
    _check("spikes", spikes, _I32, (u, c), dev)
    for name, x in (("v", v), ("refrac", refrac)) + (
            (("extra", extra),) if extra is not None else ()):
        _check(name, x, _I32, (u, r), dev)
    for name, x in (("thresh", thresh), ("leak", leak),
                    ("refrac_period", refrac_period)):
        _check(name, x, _I32, (u,), dev)
    if c * 4 > _SHMEM_LIMIT or u > 65535:
        raise ValueError(f"lif_step_units: shape {(u, r, c)} exceeds the "
                         "kernel's launch limits (C <= 12288, U <= 65535)")
    outs = [torch.empty((u, r), dtype=_I32, device=dev) for _ in range(3)]
    if u == 0 or r == 0:
        return tuple(outs)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(weights.data_ptr(), spikes.data_ptr(), v.data_ptr(),
                 refrac.data_ptr(), thresh.data_ptr(), leak.data_ptr(),
                 refrac_period.data_ptr(),
                 None if extra is None else extra.data_ptr(),
                 *(o.data_ptr() for o in outs), u, r, c, stream)
    if err != 0:
        raise RuntimeError(f"lif_step kernel launch failed: CUDA error {err}")
    lif_step_units.launches += 1
    return tuple(outs)


lif_step_units.launches = 0
