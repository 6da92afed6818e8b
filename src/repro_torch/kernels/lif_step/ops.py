"""Wrapper for the fused LIF step (counterpart of
``repro/kernels/lif_step/ops.py``).

``lif_step_units`` takes the JAX signature.  A CPU tensor runs the plain
version (``ref.py``); a CUDA tensor launches the hand-written kernel
``kernels/csrc/lif_step.cu`` on the current stream, or raises — there is no
fallback.  With any fault input (``f_and``, ``f_xor``, ``dead``, ``dth``) the
kernel's fault variant runs, each absent input passed as null (neutral).
``lif_step_units.launches`` counts kernel launches of both variants and
``lif_step_units.fault_launches`` those of the fault variant, so a run can
show that its ticks went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lif_step import ref

_I32 = torch.int32
_SHMEM_LIMIT = 48 * 1024  # static shared-memory launch limit, bytes
_fns = {}


def _launcher(faults: bool):
    if faults not in _fns:
        lib = build.load("lif_step")
        fn = lib.lif_step_faults_launch if faults else lib.lif_step_launch
        n_ptrs = 15 if faults else 11
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[faults] = fn
    return _fns[faults]


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(f"lif_step_units: {name} must be {dtype} {shape} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"lif_step_units: {name} must be contiguous")


def lif_step_units(weights, spikes, v, refrac, thresh, leak, refrac_period,
                   extra=None, f_and=None, f_xor=None, dead=None, dth=None):
    """Batched over units: weights (U, R, C) int8; spikes (U, C) int32;
    v/refrac (U, R) int32; thresh/leak/refrac_period (U,) int32;
    extra (U, R) int32 or None; fault inputs, each optional: f_and/f_xor
    (U, R, C) int8, dead (U, R) bool, dth (U, R) int32 -> (v', refrac',
    fired) each (U, R) int32.  The kernel reads ``dead``'s bytes (torch.bool
    stores 0 or 1 in one byte) as uint8."""
    if weights.device.type == "cpu":
        return ref.lif_step_units(weights, spikes, v, refrac, thresh, leak,
                                  refrac_period, extra, f_and, f_xor, dead, dth)
    if weights.device.type != "cuda":
        raise ValueError(f"lif_step_units runs on cpu or cuda, not {weights.device}")
    u, r, c = weights.shape
    dev = weights.device
    _check("weights", weights, torch.int8, (u, r, c), dev)
    _check("spikes", spikes, _I32, (u, c), dev)
    per_row = (("v", v, _I32), ("refrac", refrac, _I32), ("extra", extra, _I32),
               ("dead", dead, torch.bool), ("dth", dth, _I32))
    per_cell = (("f_and", f_and), ("f_xor", f_xor))
    for name, x, dtype in per_row:
        if x is not None:
            _check(name, x, dtype, (u, r), dev)
    for name, x in per_cell:
        if x is not None:
            _check(name, x, torch.int8, (u, r, c), dev)
    for name, x in (("thresh", thresh), ("leak", leak),
                    ("refrac_period", refrac_period)):
        _check(name, x, _I32, (u,), dev)
    if c * 4 > _SHMEM_LIMIT or u > 65535:
        raise ValueError(f"lif_step_units: shape {(u, r, c)} exceeds the "
                         "kernel's launch limits (C <= 12288, U <= 65535)")
    outs = [torch.empty((u, r), dtype=_I32, device=dev) for _ in range(3)]
    if u == 0 or r == 0:
        return tuple(outs)
    ptr = lambda x: None if x is None else x.data_ptr()
    faults = tuple(ptr(x) for x in (f_and, f_xor, dead, dth))
    faulted = any(p is not None for p in faults)
    fn = _launcher(faulted)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(weights.data_ptr(), spikes.data_ptr(), v.data_ptr(),
                 refrac.data_ptr(), thresh.data_ptr(), leak.data_ptr(),
                 refrac_period.data_ptr(), ptr(extra),
                 *(faults if faulted else ()),
                 *(o.data_ptr() for o in outs), u, r, c, stream)
    if err != 0:
        raise RuntimeError(f"lif_step kernel launch failed: CUDA error {err}")
    lif_step_units.launches += 1
    lif_step_units.fault_launches += int(faulted)
    return tuple(outs)


lif_step_units.launches = 0
lif_step_units.fault_launches = 0
