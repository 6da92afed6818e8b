"""Wrappers for the crossbar VMM (counterpart of
``repro/kernels/crossbar_vmm/ops.py``).

The three functions take the JAX signatures.  A CPU tensor runs the plain
version (``ref.py``); a CUDA tensor launches the hand-written kernel
``kernels/csrc/crossbar_vmm.cu`` on the current stream, or raises — there
is no fallback.  ``crossbar_vmm_batch.launches`` counts kernel launches of
all three, so a run can show that its dense completions went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.crossbar_vmm import ref

_I32 = torch.int32
_SHMEM_LIMIT = 48 * 1024  # static shared-memory launch limit, bytes
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("crossbar_vmm").crossbar_vmm_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _no_faults(f_and, f_xor):
    if f_and is not None or f_xor is not None:
        raise NotImplementedError(
            "crossbar fault masks (f_and/f_xor) come with ROADMAP module item 9")


def _launch(weights, x, w_stride, r, in_res, out_res):
    """x (B, C) int32 on CUDA; batch row b reads weights at ``b * w_stride``
    bytes -> (B, r) int32."""
    b, c = x.shape
    dev = x.device
    if weights.dtype != torch.int8 or weights.device != dev or not weights.is_contiguous():
        raise ValueError("crossbar_vmm: weights must be contiguous int8 on "
                         f"{dev}, got {weights.dtype} on {weights.device}")
    if x.dtype != _I32 or not x.is_contiguous():
        raise ValueError(f"crossbar_vmm: x must be contiguous int32, got {x.dtype}")
    if not (1 <= in_res <= 15 and 1 <= out_res <= 15):
        raise ValueError(f"crossbar_vmm: resolutions must be 1..15 bits, got "
                         f"in_res={in_res} out_res={out_res}")
    if c * 4 > _SHMEM_LIMIT or b > 65535:
        raise ValueError(f"crossbar_vmm: shape (B={b}, C={c}) exceeds the kernel's "
                         "launch limits (C <= 12288, B <= 65535)")
    out = torch.empty((b, r), dtype=_I32, device=dev)
    if b == 0 or r == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(weights.data_ptr(), x.data_ptr(), out.data_ptr(), b, r, c,
                 w_stride, in_res, out_res, stream)
    if err != 0:
        raise RuntimeError(f"crossbar_vmm kernel launch failed: CUDA error {err}")
    crossbar_vmm_batch.launches += 1
    return out


def _device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"crossbar_vmm runs on cpu or cuda, not {x.device}")
    return x.device.type


def crossbar_vmm(weights, x, in_res: int = 8, out_res: int = 8,
                 f_and=None, f_xor=None):
    """weights int8 (R, C); x int32 (C,) -> int32 (R,)."""
    _no_faults(f_and, f_xor)
    if _device(x) == "cpu":
        return ref.crossbar_vmm(weights, x, in_res, out_res)
    r, c = weights.shape
    if tuple(x.shape) != (c,):
        raise ValueError(f"crossbar_vmm: x must be ({c},), got {tuple(x.shape)}")
    return _launch(weights, x.reshape(1, c), 0, r, in_res, out_res)[0]


def crossbar_vmm_batch(weights, x, in_res: int = 8, out_res: int = 8,
                       f_and=None, f_xor=None):
    """Batched over units: weights (U, R, C) int8; x (U, C) int32 -> (U, R).

    Used by the CIM quantum-boundary completion (``vp/cim.finish_ops``), one
    call over every unit of every segment per round."""
    _no_faults(f_and, f_xor)
    if _device(x) == "cpu":
        return ref.crossbar_vmm_batch(weights, x, in_res, out_res)
    u, r, c = weights.shape
    if tuple(x.shape) != (u, c):
        raise ValueError(f"crossbar_vmm_batch: x must be ({u}, {c}), got {tuple(x.shape)}")
    return _launch(weights, x, r * c, r, in_res, out_res)


def crossbar_matmul(weights, x, in_res: int = 8, out_res: int = 8):
    """weights (R, C) int8, x (C, N) int32 -> (R, N): one crossbar, N input
    vectors (the kernel with a weights stride of 0)."""
    if _device(x) == "cpu":
        return ref.crossbar_matmul(weights, x, in_res, out_res)
    r, c = weights.shape
    if x.dim() != 2 or x.shape[0] != c:
        raise ValueError(f"crossbar_matmul: x must be ({c}, N), got {tuple(x.shape)}")
    return _launch(weights, x.t().contiguous(), 0, r, in_res, out_res).t()


crossbar_vmm_batch.launches = 0
