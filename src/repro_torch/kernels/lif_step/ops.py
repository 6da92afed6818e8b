"""Wrapper for the fused LIF step (counterpart of
``repro/kernels/lif_step/ops.py``).

``lif_step_units`` takes the JAX signature.  A CPU tensor runs the plain
version (``ref.py``); a CUDA tensor launches the hand-written kernel
``kernels/csrc/lif_step.cu`` on the current stream, or raises — there is no
fallback.  With any fault input (``f_and``, ``f_xor``, ``dead``, ``dth``) the
kernel's fault variant runs, each absent input passed as null (neutral).
``lif_step_units.launches`` counts kernel launches of both variants and
``lif_step_units.fault_launches`` those of the fault variant.

``snn_tick`` is the whole quantum-boundary tick of ``vp/cim.snn_tick`` (the
fire gate, the step, the selects and counters) in one launch of the same
source's fused kernel, with its own ``launches`` and ``fault_launches``
(the launches issued from the host); the kernel also counts its runs on
the card (``kernels.card_counts("snn_tick", device)``), so a run whose
rounds replay a captured graph can show that its ticks went through it.
``snn_tick(grouped=True)`` launches the grouped variant (multi-crossbar
column groups: each owner adds its firing contributors' contractions),
counted in ``grouped_launches`` and on the card under
``"snn_tick_grouped"``.  Its first launch on a device lets the kernel take
its stage's dynamic shared memory there (``snn_tick_prepare``), so, like
the card's launch counts, it must come before any capture of the tick.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LOCK, build, card_counts, check_inputs, count_launch, unit_rows
from repro_torch.kernels.lif_step import ref
from repro_torch.vp import isa

_I32 = torch.int32
_SHMEM_LIMIT = 48 * 1024  # static shared-memory launch limit, bytes
XBAR = 256  # the fused tick's largest crossbar (a cluster of 8 blocks a unit)
_fns = {}
_tick_fns = {}
_grouped_ready = set()  # devices where the grouped tick may take its shared memory


def _launcher(faults: bool):
    with LOCK:
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
    count_launch(lif_step_units, launches=1, fault_launches=int(faulted))
    return tuple(outs)


lif_step_units.launches = 0
lif_step_units.fault_launches = 0


# the fused tick's pointer array, in the order of lif_step.cu's TickArgs:
# cims fields per unit, t_gate, per-unit rows and columns, then the outputs
TICK_UNIT = ("present", "mode", "tick_period", "next_tick", "tick_limit", "ticks", "rows",
             "thresh", "leak", "refrac_period", "spikes_total")
TICK_ROWS = ("weights", "in_buf", "v", "refrac", "spike_counts")
TICK_POINTERS = (TICK_UNIT + ("t_gate",) + TICK_ROWS + ("extra",) + ref.TICK_FAULTS
                 + tuple(f + "_out" for f in ref.TICK_OUTPUTS)
                 + ("fired_rows", "fire", "launches", "owner_slot"))


def _tick_launcher(faults: bool, grouped: bool):
    with LOCK:
        key = (faults, grouped)
        if key not in _tick_fns:
            lib = build.load("lif_step")
            fn = getattr(lib, "snn_tick" + ("_grouped" if grouped else "")
                         + ("_faults" if faults else "") + "_launch")
            fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 4
                           + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _tick_fns[key] = fn
        return _tick_fns[key]


def _prepare_grouped(dev):
    """Raises the grouped tick's dynamic shared-memory limit on ``dev`` (once
    per device, the current one), never inside a capture."""
    with LOCK:
        if dev.index in _grouped_ready:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("snn_tick: launch the grouped tick once before capturing it")
        err = build.load("lif_step").snn_tick_prepare()
        if err != 0:
            raise RuntimeError(f"snn_tick_prepare failed: CUDA error {err}")
        _grouped_ready.add(dev.index)


def _tick_arguments(cims, t_gate, extra, grouped):
    """Checks the fused tick's inputs against the weights' device and
    allocates its outputs.  Returns (pointer array in ``TICK_POINTERS``
    order, the C entry's int arguments, whether a fault input is given, the
    result tuple the outputs fill)."""
    w = cims["weights"]
    s, n, r, c = w.shape
    dev = w.device
    if r > XBAR or c > XBAR or s * n > 65535:
        raise ValueError(f"snn_tick: shape (U={s * n}, R={r}, C={c}) exceeds the kernel's "
                         f"launch limits (R, C <= {XBAR}, U <= 65535)")
    in_buf, in_s0, in_s1 = unit_rows(cims["in_buf"])
    tensors = {**{f: cims[f] for f in TICK_UNIT + TICK_ROWS}, "in_buf": in_buf,
               "t_gate": t_gate, "extra": extra, **{f: cims.get(f) for f in ref.TICK_FAULTS},
               "owner_slot": cims["owner_slot"] if grouped else None}
    unit, rows, cells = (s, n), (s, n, r), (s, n, r, c)
    kinds = {**{f: (_I32, unit) for f in TICK_UNIT}, "present": (torch.bool, unit),
             "t_gate": (_I32, (s,)), "weights": (torch.int8, cells), "in_buf": (_I32, (s, n, c)),
             "v": (_I32, rows), "refrac": (_I32, rows), "spike_counts": (_I32, rows),
             "extra": (_I32, rows), "f_and": (torch.int8, cells), "f_xor": (torch.int8, cells),
             "f_dead": (torch.bool, rows), "f_dth": (_I32, rows), "owner_slot": (_I32, unit)}
    check_inputs("snn_tick", dev, [(f, tensors[f], *kinds[f]) for f in kinds],
                 strided=("in_buf",))
    new = {f: torch.empty(cims[f].shape, dtype=_I32, device=dev) for f in ref.TICK_OUTPUTS}
    fired_rows = torch.empty(rows, dtype=torch.bool, device=dev)
    fire = torch.empty(unit, dtype=torch.bool, device=dev)
    tensors.update({f + "_out": x for f, x in new.items()}, fired_rows=fired_rows, fire=fire,
                   launches=card_counts("snn_tick_grouped" if grouped else "snn_tick", dev))
    ptrs = (ctypes.c_void_p * len(TICK_POINTERS))(
        *(None if tensors[f] is None else tensors[f].data_ptr() for f in TICK_POINTERS))
    faulted = any(tensors[f] is not None for f in ref.TICK_FAULTS)
    return (ptrs, (s * n, n, r, c, in_s0, in_s1, isa.CIM_MODE_SPIKE), faulted,
            ({**cims, **new}, fired_rows, fire, cims["next_tick"]))


def snn_tick(cims, t_gate, extra=None, grouped=False):
    """The quantum-boundary LIF tick of every unit: cims fields ``(S, n,
    ...)`` as ``vp/cim.cim_state`` lays them out, stacked over S segments,
    ``t_gate`` (S,) int32; ``extra`` (S, n, R) int32 charge or None; the
    fault inputs ``f_and``/``f_xor`` (S, n, R, C) int8, ``f_dead`` (S, n, R)
    bool and ``f_dth`` (S, n, R) int32 are read from ``cims`` where present
    (then the fault variant runs).  ``grouped``: the tick of column groups
    (``ref.snn_tick``), reading ``owner_slot`` (S, n) int32.  Returns
    (cims', fired_rows bool (S, n, R), fire bool (S, n), tick_time (S, n))
    as ``ref.snn_tick`` does; every field the tick writes is a new tensor,
    the input state stays valid."""
    dev = cims["weights"].device
    if dev.type == "cpu":
        return ref.snn_tick(cims, t_gate, extra, grouped)
    if dev.type != "cuda":
        raise ValueError(f"snn_tick runs on cpu or cuda, not {dev}")
    ptrs, ints, faulted, result = _tick_arguments(cims, t_gate, extra, grouped)
    if ints[0] == 0:
        return result
    fn = _tick_launcher(faulted, grouped)
    with torch.cuda.device(dev):
        if grouped:
            _prepare_grouped(dev)
        err = fn(ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"snn_tick kernel launch failed: CUDA error {err}")
    count_launch(snn_tick, launches=1, fault_launches=int(faulted),
                 grouped_launches=int(grouped))
    return result


snn_tick.launches = 0
snn_tick.fault_launches = 0
snn_tick.grouped_launches = 0
