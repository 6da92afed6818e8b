"""Wrappers for the crossbar VMM (counterpart of
``repro/kernels/crossbar_vmm/ops.py``).

The three functions take the JAX signatures.  A CPU tensor runs the plain
version (``ref.py``); a CUDA tensor launches the hand-written kernel
``kernels/csrc/crossbar_vmm.cu`` on the current stream, or raises — there
is no fallback.  With a fault mask (``f_and``/``f_xor``) the kernel's
fault variant runs, an absent mask passed as null (neutral).
``crossbar_vmm_batch.launches`` counts kernel launches of all three
functions and both variants, ``crossbar_vmm_batch.fault_launches`` those of
the fault variant.

``finish_ops`` is the whole quantum-boundary completion of
``vp/cim.finish_ops`` (the ``done`` gate, the VMM, the selects) in one
launch of the same source's fused kernel, with its own ``launches`` and
``fault_launches`` (the launches issued from the host); the kernel also
counts its runs on the card (``kernels.card_counts("finish_ops",
device)``), so a run whose rounds replay a captured graph can show that its
dense completions went through it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, card_counts, check_inputs, unit_rows
from repro_torch.kernels.crossbar_vmm import ref
from repro_torch.vp import isa

_I32 = torch.int32
_SHMEM_LIMIT = 48 * 1024  # static shared-memory launch limit, bytes
XBAR = 256  # the fused completion's largest C (one input per thread of a block)
_fns = {}
_finish_fns = {}


def _launcher(faults: bool):
    if faults not in _fns:
        lib = build.load("crossbar_vmm")
        fn = lib.crossbar_vmm_faults_launch if faults else lib.crossbar_vmm_launch
        fn.argtypes = ([ctypes.c_void_p] * (5 if faults else 3) + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[faults] = fn
    return _fns[faults]


def _launch(weights, x, w_stride, r, in_res, out_res, f_and=None, f_xor=None):
    """x (B, C) int32 on CUDA; batch row b reads weights (and the masks,
    laid out like them) at ``b * w_stride`` bytes -> (B, r) int32."""
    b, c = x.shape
    dev = x.device
    for name, t in (("weights", weights), ("f_and", f_and), ("f_xor", f_xor)):
        if t is None:
            continue
        if t.dtype != torch.int8 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"crossbar_vmm: {name} must be contiguous int8 on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if t.shape != weights.shape:
            raise ValueError(f"crossbar_vmm: {name} must have the weights' shape "
                             f"{tuple(weights.shape)}, got {tuple(t.shape)}")
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
    masks = tuple(None if t is None else t.data_ptr() for t in (f_and, f_xor))
    faulted = any(p is not None for p in masks)
    fn = _launcher(faulted)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(weights.data_ptr(), *(masks if faulted else ()), x.data_ptr(),
                 out.data_ptr(), b, r, c, w_stride, in_res, out_res, stream)
    if err != 0:
        raise RuntimeError(f"crossbar_vmm kernel launch failed: CUDA error {err}")
    crossbar_vmm_batch.launches += 1
    crossbar_vmm_batch.fault_launches += int(faulted)
    return out


def _device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"crossbar_vmm runs on cpu or cuda, not {x.device}")
    return x.device.type


def crossbar_vmm(weights, x, in_res: int = 8, out_res: int = 8,
                 f_and=None, f_xor=None):
    """weights int8 (R, C); x int32 (C,) -> int32 (R,); fault masks f_and/f_xor
    int8 (R, C), each optional."""
    if _device(x) == "cpu":
        return ref.crossbar_vmm(weights, x, in_res, out_res, f_and, f_xor)
    r, c = weights.shape
    if tuple(x.shape) != (c,):
        raise ValueError(f"crossbar_vmm: x must be ({c},), got {tuple(x.shape)}")
    return _launch(weights, x.reshape(1, c), 0, r, in_res, out_res, f_and, f_xor)[0]


def crossbar_vmm_batch(weights, x, in_res: int = 8, out_res: int = 8,
                       f_and=None, f_xor=None):
    """Batched over units: weights (U, R, C) int8; x (U, C) int32 -> (U, R);
    per-unit fault masks f_and/f_xor int8 (U, R, C), each optional.

    Used by the CIM quantum-boundary completion (``vp/cim.finish_ops``), one
    call over every unit of every segment per round."""
    if _device(x) == "cpu":
        return ref.crossbar_vmm_batch(weights, x, in_res, out_res, f_and, f_xor)
    u, r, c = weights.shape
    if tuple(x.shape) != (u, c):
        raise ValueError(f"crossbar_vmm_batch: x must be ({u}, {c}), got {tuple(x.shape)}")
    return _launch(weights, x, r * c, r, in_res, out_res, f_and, f_xor)


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
crossbar_vmm_batch.fault_launches = 0


# the fused completion's pointer array, in the order of crossbar_vmm.cu's
# FinishArgs: cims fields per unit, t_end, per-unit arrays, then the outputs
FINISH_UNIT = ("present", "state", "busy_until", "op_done_at", "ops", "in_count")
FINISH_POINTERS = (FINISH_UNIT + ("t_end", "weights", "f_and", "f_xor", "in_buf", "out_buf")
                   + tuple(f + "_out" for f in ref.FINISH_OUTPUTS) + ("done", "launches"))


def _finish_launcher(faults: bool):
    if faults not in _finish_fns:
        lib = build.load("crossbar_vmm")
        fn = lib.finish_ops_faults_launch if faults else lib.finish_ops_launch
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _finish_fns[faults] = fn
    return _finish_fns[faults]


def _finish_arguments(cims, t_end):
    """Checks the fused completion's inputs against the weights' device and
    allocates its outputs.  Returns (pointer array in ``FINISH_POINTERS``
    order, the C entry's int arguments, whether a mask is given, the result
    tuple the outputs fill)."""
    w = cims["weights"]
    s, n, r, c = w.shape
    dev = w.device
    if c > XBAR or s * n > 65535:
        raise ValueError(f"finish_ops: shape (U={s * n}, C={c}) exceeds the kernel's launch "
                         f"limits (C <= {XBAR}, U <= 65535)")
    in_buf, in_s0, in_s1 = unit_rows(cims["in_buf"])
    tensors = {**{f: cims[f] for f in FINISH_UNIT + ("weights", "out_buf")}, "in_buf": in_buf,
               "t_end": t_end, "f_and": cims.get("f_and"), "f_xor": cims.get("f_xor")}
    unit, cells = (s, n), (s, n, r, c)
    kinds = {**{f: (_I32, unit) for f in FINISH_UNIT}, "present": (torch.bool, unit),
             "t_end": (_I32, (s,)), "weights": (torch.int8, cells), "f_and": (torch.int8, cells),
             "f_xor": (torch.int8, cells), "in_buf": (_I32, (s, n, c)),
             "out_buf": (_I32, (s, n, r))}
    check_inputs("finish_ops", dev, [(f, tensors[f], *kinds[f]) for f in kinds],
                 strided=("in_buf",))
    new = {f: torch.empty(cims[f].shape, dtype=_I32, device=dev) for f in ref.FINISH_OUTPUTS}
    done = torch.empty(unit, dtype=torch.bool, device=dev)
    tensors.update({f + "_out": x for f, x in new.items()}, done=done,
                   launches=card_counts("finish_ops", dev))
    ptrs = (ctypes.c_void_p * len(FINISH_POINTERS))(
        *(None if tensors[f] is None else tensors[f].data_ptr() for f in FINISH_POINTERS))
    faulted = tensors["f_and"] is not None or tensors["f_xor"] is not None
    # the Table II configuration: 8-bit inputs and outputs
    ints = (s * n, n, r, c, in_s0, in_s1, isa.CIM_ST_OP, isa.CIM_ST_IDLE, 8, 8)
    return ptrs, ints, faulted, ({**cims, **new}, done)


def finish_ops(cims, t_end):
    """The quantum-boundary completion of every unit: cims fields ``(S, n,
    ...)`` as ``vp/cim.cim_state`` lays them out, stacked over S segments,
    ``t_end`` (S,) int32; the crossbar fault masks ``f_and``/``f_xor`` (S,
    n, R, C) int8 are read from ``cims`` where present (then the fault
    variant runs).  Returns (cims', done bool (S, n)) as ``ref.finish_ops``
    does; every field it writes is a new tensor, the input state stays
    valid."""
    if _device(cims["weights"]) == "cpu":
        return ref.finish_ops(cims, t_end)
    dev = cims["weights"].device
    ptrs, ints, faulted, result = _finish_arguments(cims, t_end)
    if ints[0] == 0:
        return result
    fn = _finish_launcher(faulted)
    with torch.cuda.device(dev):
        err = fn(ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"finish_ops kernel launch failed: CUDA error {err}")
    finish_ops.launches += 1
    finish_ops.fault_launches += int(faulted)
    return result


finish_ops.launches = 0
finish_ops.fault_launches = 0
