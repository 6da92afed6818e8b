"""Wrapper for the instruction-slot scan: one quantum of RISC-V slots on
every segment, then the in-order DRAM store log.

``slot_scan`` takes the plain version's signature (``ref.py``).  A CPU
state runs the plain per-slot loop; a CUDA state launches the hand-written
kernel ``kernels/csrc/slot_scan.cu`` on the current stream, or raises —
there is no fallback.  ``slot_scan.launches`` counts kernel launches, so a
run can show that its slots went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.slot_scan import ref

_I32 = torch.int32
_U8 = torch.uint8
_fn = None

# the kernel's pointer and integer arguments, in csrc/slot_scan.cu's order
POINTERS = (
    "time", "seg_id", "dram_present", "present", "halted", "waiting", "pc",
    "regs", "instret", "prog", "itags", "ihits", "imisses", "dtags", "dhits",
    "dmisses", "last_row", "last_write", "reads", "writes", "scratch",
    "instrs", "mmio_late", "store_peak", "t_limit", "cim_seg", "cim_slot",
    "dram", "ob_kind", "ob_dst", "ob_addr", "ob_data", "ob_t_emit", "ob_valid",
    "ob_count",
    "o_time", "o_halted", "o_waiting", "o_pc", "o_regs", "o_instret", "o_itags",
    "o_ihits", "o_imisses", "o_dtags", "o_dhits", "o_dmisses", "o_last_row",
    "o_last_write", "o_reads", "o_writes", "o_scratch", "o_instrs",
    "o_mmio_late", "o_store_peak",
    "log",
)
INTS = (
    "quantum", "out_cap", "store_log", "n_cim", "dram_segment", "cpi",
    "scratch_cycles", "cache_hit", "dram_access", "page_switch", "write_read_switch", "imiss", "mmio_post",
    "dram_row_bits", "line_words", "isets", "dsets", "dram_words",
    "scratch_words", "prog_words",
)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("slot_scan").slot_scan_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"slot_scan: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"slot_scan: {name} must be contiguous")


def slot_scan(cfg, quantum: int, st, outbox, t_limit, cim_seg, cim_slot):
    """One quantum of instruction slots on every segment, then the store log.

    ``st`` is the stacked segment-state tree (S, ...) after this round's
    inbox, ``t_limit`` (S,) the decoupling bound, ``cim_seg``/``cim_slot``
    the platform's static CIM wiring as int32 tensors on the state's
    device.  Appends to ``outbox`` and applies the store log to
    ``st["dram"]["data"]``, both in place.  Returns ``(st', outbox)``:
    ``st'`` is a new dict whose CPU-side leaves (time, cpu, icache,
    dcache, dram, scratch, stats) are the scan's.
    """
    dev = st["time"].device
    if dev.type == "cpu":
        return ref.slot_scan(cfg, quantum, st, outbox, t_limit, cim_seg, cim_slot)
    if dev.type != "cuda":
        raise ValueError(f"slot_scan runs on cpu or cuda, not {dev}")
    cpu, ic, dc, dram, stats = st["cpu"], st["icache"], st["dcache"], st["dram"], st["stats"]
    s = st["time"].shape[0]
    cap = outbox["valid"].shape[-1]
    n_cim = len(cfg.cim_seg)
    ins = {
        "time": st["time"], "seg_id": st["seg_id"], "dram_present": st["dram_present"],
        "present": cpu["present"], "halted": cpu["halted"], "waiting": cpu["waiting"],
        "pc": cpu["pc"], "regs": cpu["regs"], "instret": cpu["instret"],
        "prog": st["prog"], "itags": ic["tags"], "ihits": ic["hits"],
        "imisses": ic["misses"], "dtags": dc["tags"], "dhits": dc["hits"],
        "dmisses": dc["misses"], "last_row": dram["last_row"],
        "last_write": dram["last_write"], "reads": dram["reads"],
        "writes": dram["writes"], "scratch": st["scratch"],
        "instrs": stats["instrs"], "mmio_late": stats["snn_mmio_late"],
        "store_peak": stats["store_peak"], "t_limit": t_limit,
        "cim_seg": cim_seg, "cim_slot": cim_slot, "dram": dram["data"],
        "ob_kind": outbox["kind"], "ob_dst": outbox["dst"], "ob_addr": outbox["addr"],
        "ob_data": outbox["data"], "ob_t_emit": outbox["t_emit"],
        "ob_valid": outbox["valid"], "ob_count": outbox["count"],
    }
    bools = ("dram_present", "present", "halted", "waiting", "last_write", "ob_valid")
    for name, x in ins.items():
        if name == "prog":
            dtype = torch.uint32
        elif name in bools:
            dtype = torch.bool
        else:
            dtype = _I32
        if name in ("cim_seg", "cim_slot"):
            shape = (n_cim,)
        elif name.startswith("ob_") and name != "ob_count":
            shape = (s, cap)
        else:
            shape = (s, *x.shape[1:])
        _check(name, x, dtype, shape, dev)
    outs = {f"o_{k}": torch.empty_like(ins[k]) for k in (
        "time", "halted", "waiting", "pc", "regs", "instret", "itags", "ihits",
        "imisses", "dtags", "dhits", "dmisses", "last_row", "last_write", "reads",
        "writes", "scratch", "instrs", "mmio_late", "store_peak")}
    outs["log"] = torch.empty((s, 2, max(cfg.store_log, 1)), dtype=_I32, device=dev)
    t = cfg.timing
    ints = {
        "quantum": quantum, "out_cap": cap, "store_log": cfg.store_log,
        "n_cim": n_cim, "dram_segment": cfg.dram_segment, "cpi": t.cpi,
        "scratch_cycles": t.scratch, "cache_hit": t.cache_hit,
        "dram_access": t.dram_access, "page_switch": t.page_switch,
        "write_read_switch": t.write_read_switch, "imiss": t.imiss,
        "mmio_post": t.mmio_post, "dram_row_bits": t.dram_row_bits,
        "line_words": t.line_words, "isets": ic["tags"].shape[-1],
        "dsets": dc["tags"].shape[-1], "dram_words": dram["data"].shape[-1],
        "scratch_words": st["scratch"].shape[-1], "prog_words": st["prog"].shape[-1],
    }
    dram_words = ints["dram_words"]
    if dram_words & (dram_words - 1) or ints["prog_words"] & (ints["prog_words"] - 1):
        raise ValueError("slot_scan: the DRAM backing and the program must hold "
                         "a power-of-two number of words")
    if cfg.store_log < 1 or s > 65535:
        raise ValueError(f"slot_scan: store_log must be >= 1 and S <= 65535, got "
                         f"{cfg.store_log} and {s}")
    tensors = {**ins, **outs}
    ptrs = (ctypes.c_void_p * len(POINTERS))(*(tensors[k].data_ptr() for k in POINTERS))
    vals = (ctypes.c_int * len(INTS))(*(int(ints[k]) for k in INTS))
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(ptrs), len(POINTERS), ctypes.addressof(vals),
                 len(INTS), s, stream)
    if err != 0:
        raise RuntimeError(f"slot_scan kernel launch failed: error {err}")
    slot_scan.launches += 1

    st = dict(st)
    st["time"] = outs["o_time"]
    st["cpu"] = {**cpu, **{k: outs[f"o_{k}"] for k in (
        "halted", "waiting", "pc", "regs", "instret")}}
    st["icache"] = {"tags": outs["o_itags"], "hits": outs["o_ihits"],
                    "misses": outs["o_imisses"]}
    st["dcache"] = {"tags": outs["o_dtags"], "hits": outs["o_dhits"],
                    "misses": outs["o_dmisses"]}
    st["dram"] = {"data": dram["data"], "last_row": outs["o_last_row"],
                  "last_write": outs["o_last_write"], "reads": outs["o_reads"],
                  "writes": outs["o_writes"]}
    st["scratch"] = outs["o_scratch"]
    st["stats"] = {**stats, "instrs": outs["o_instrs"],
                   "snn_mmio_late": outs["o_mmio_late"],
                   "store_peak": outs["o_store_peak"]}
    return st, outbox


slot_scan.launches = 0
