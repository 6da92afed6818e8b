"""Wrapper for the instruction-slot scan: one quantum of RISC-V slots on
every segment, then the in-order DRAM store log.

``slot_scan`` takes the plain version's signature (``ref.py``).  A CPU
state runs the plain per-slot loop; a CUDA state launches the hand-written
kernel ``kernels/csrc/slot_scan.cu`` on the current stream, or raises —
there is no fallback.  ``slot_scan.launches`` counts the launches issued
from the host; the kernel also counts its runs on the card
(``kernels.card_counts("slot_scan", device)``), so a run whose rounds
replay a captured graph can show that its slots went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LOCK, build, card_counts, count_launch
from repro_torch.kernels.slot_scan import ref

_I32 = torch.int32
_U8 = torch.uint8
_fn = None
_ready = set()  # devices where the kernel may take its dynamic shared memory

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
    "log", "launches",
)
INTS = (
    "quantum", "out_cap", "store_log", "n_cim", "dram_segment", "cpi",
    "scratch_cycles", "cache_hit", "dram_access", "page_switch", "write_read_switch", "imiss", "mmio_post",
    "dram_row_bits", "line_shift", "iset_mask", "dset_mask", "dram_words",
    "scratch_words", "prog_words", "tick_period", "local_latency",
    "channel_latency",
)


def _log2(name, x):
    if x < 1 or x & (x - 1):
        raise ValueError(f"slot_scan: {name} must be a power of two, got {x}")
    return x.bit_length() - 1


def pack_ints(cfg, quantum: int, *, out_cap: int, isets: int, dsets: int,
              dram_words: int, scratch_words: int, prog_words: int) -> dict:
    """The kernel's integer arguments (``INTS``) for platform ``cfg``: its
    timing, with the cache geometry as a line shift and set masks, so that
    no slot divides, and the tick period and latencies that turn a
    ``CIM_REG_SPIKE`` store into a tick-addressed spike.  Raises
    ``ValueError`` on a line size, set count, DRAM backing or program that
    is not a power of two, or an empty store log."""
    t = cfg.timing
    _log2("the DRAM backing's word count", dram_words)
    _log2("the program's word count", prog_words)
    if cfg.store_log < 1:
        raise ValueError(f"slot_scan: store_log must be >= 1, got {cfg.store_log}")
    return {
        "quantum": quantum, "out_cap": out_cap, "store_log": cfg.store_log,
        "n_cim": len(cfg.cim_seg), "dram_segment": cfg.dram_segment, "cpi": t.cpi,
        "scratch_cycles": t.scratch, "cache_hit": t.cache_hit,
        "dram_access": t.dram_access, "page_switch": t.page_switch,
        "write_read_switch": t.write_read_switch, "imiss": t.imiss,
        "mmio_post": t.mmio_post, "dram_row_bits": t.dram_row_bits,
        "line_shift": _log2("line_words", t.line_words),
        "iset_mask": (1 << _log2("the icache's set count", isets)) - 1,
        "dset_mask": (1 << _log2("the dcache's set count", dsets)) - 1,
        "dram_words": dram_words, "scratch_words": scratch_words,
        "prog_words": prog_words, "tick_period": cfg.snn_tick_period,
        "local_latency": cfg.local_latency, "channel_latency": cfg.channel_latency,
    }


def _launcher(dev):
    """The kernel's ctypes entry, with its shared-memory limit raised on
    ``dev`` (once per device, never inside a capture)."""
    global _fn
    with LOCK:
        if _fn is None:
            fn = build.load("slot_scan").slot_scan_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
        if dev.index not in _ready:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("slot_scan: launch the kernel once before capturing it")
            with torch.cuda.device(dev):
                err = build.load("slot_scan").slot_scan_prepare()
            if err != 0:
                raise RuntimeError(f"slot_scan_prepare failed: CUDA error {err}")
            _ready.add(dev.index)
        return _fn


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"slot_scan: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"slot_scan: {name} must be contiguous")


def _arguments(cfg, quantum, st, outbox, t_limit, cim_seg, cim_slot):
    """The kernel's tensors (inputs checked, outputs allocated on the state's
    device) and integers, by name."""
    dev = st["time"].device
    cpu, ic, dc, dram, stats = st["cpu"], st["icache"], st["dcache"], st["dram"], st["stats"]
    s = st["time"].shape[0]
    if s > 65535:
        raise ValueError(f"slot_scan: S must be <= 65535, got {s}")
    cap = outbox["valid"].shape[-1]
    ints = pack_ints(cfg, quantum, out_cap=cap, isets=ic["tags"].shape[-1],
                     dsets=dc["tags"].shape[-1], dram_words=dram["data"].shape[-1],
                     scratch_words=st["scratch"].shape[-1], prog_words=st["prog"].shape[-1])
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
            shape = (ints["n_cim"],)
        elif name.startswith("ob_") and name != "ob_count":
            shape = (s, cap)
        else:
            shape = (s, *x.shape[1:])
        _check(name, x, dtype, shape, dev)
    outs = {f"o_{k}": torch.empty_like(ins[k]) for k in (
        "time", "halted", "waiting", "pc", "regs", "instret", "itags", "ihits",
        "imisses", "dtags", "dhits", "dmisses", "last_row", "last_write", "reads",
        "writes", "scratch", "instrs", "mmio_late", "store_peak")}
    # the store log's addresses and data, then the count of skipped slots
    outs["log"] = torch.empty((s, 2 * cfg.store_log + 1), dtype=_I32, device=dev)
    return {**ins, **outs}, ints


def _result(st, tensors):
    """The scan's new state tree from the kernel's outputs."""
    o = lambda k: tensors[f"o_{k}"]
    st = dict(st)
    st["time"] = o("time")
    st["cpu"] = {**st["cpu"], **{k: o(k) for k in ("halted", "waiting", "pc", "regs",
                                                   "instret")}}
    st["icache"] = {"tags": o("itags"), "hits": o("ihits"), "misses": o("imisses")}
    st["dcache"] = {"tags": o("dtags"), "hits": o("dhits"), "misses": o("dmisses")}
    st["dram"] = {"data": st["dram"]["data"], "last_row": o("last_row"),
                  "last_write": o("last_write"), "reads": o("reads"),
                  "writes": o("writes")}
    st["scratch"] = o("scratch")
    st["stats"] = {**st["stats"], "instrs": o("instrs"), "snn_mmio_late": o("mmio_late"),
                   "store_peak": o("store_peak")}
    return st


def slot_scan(cfg, quantum: int, st, outbox, t_limit, cim_seg, cim_slot):
    """One quantum of instruction slots on every segment, then the store log.

    ``st`` is the stacked segment-state tree (S, ...) after this round's
    inbox, ``t_limit`` (S,) the decoupling bound, ``cim_seg``/``cim_slot``
    the platform's static CIM wiring as int32 tensors on the state's
    device.  Appends to ``outbox`` and applies the store log to
    ``st["dram"]["data"]``, both in place.  Returns ``(st', outbox)``:
    ``st'`` is a new dict whose CPU-side leaves (time, cpu, icache,
    dcache, dram, scratch, stats) are the scan's.  After a launch,
    ``slot_scan.skipped`` holds the (S,) int32 count of slots the kernel
    fast-forwarded, on the card.
    """
    dev = st["time"].device
    if dev.type == "cpu":
        return ref.slot_scan(cfg, quantum, st, outbox, t_limit, cim_seg, cim_slot)
    if dev.type != "cuda":
        raise ValueError(f"slot_scan runs on cpu or cuda, not {dev}")
    tensors, ints = _arguments(cfg, quantum, st, outbox, t_limit, cim_seg, cim_slot)
    tensors["launches"] = card_counts("slot_scan", dev)
    ptrs = (ctypes.c_void_p * len(POINTERS))(*(tensors[k].data_ptr() for k in POINTERS))
    vals = (ctypes.c_int * len(INTS))(*(int(ints[k]) for k in INTS))
    fn = _launcher(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(ptrs), len(POINTERS), ctypes.addressof(vals),
                 len(INTS), st["time"].shape[0], stream)
    if err != 0:
        raise RuntimeError(f"slot_scan kernel launch failed: error {err}")
    count_launch(slot_scan, launches=1)
    slot_scan.skipped = tensors["log"][:, -1]
    return _result(st, tensors), outbox


slot_scan.launches = 0
slot_scan.skipped = None
