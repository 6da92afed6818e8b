"""Plain-PyTorch instruction-slot scan: one quantum of RISC-V slots on every
segment of the stack, then the in-order DRAM store log — the CPU path of
the wrapper in ``ops.py`` and the reference the CUDA kernel
(``kernels/csrc/slot_scan.cu``) is held to on the card.

It computes the reference's ``slot`` body ``quantum`` times and then its
``apply_store`` scan (``repro/vp/platform.py``, ``make_segment_step``), as
``quantum`` Python iterations over the leading segment axis, with
``_mem_access`` as the per-slot memory dispatch.  Three rewrites keep it
cheap without changing a bit of the result:

- the program is decoded once per quantum (it cannot change inside one)
  and each slot gathers its decoded fields;
- a slot appends at most one message (a load and a store exclude each
  other, and so do DRAM and CIM addresses), so the reference's four
  masked appends are one;
- once no segment can run (halted, waiting, absent or at ``t_limit``,
  states that last for the rest of the quantum) every remaining slot only
  advances the clock of a live CPU by one cycle up to ``t_limit``, which
  is applied in closed form: ``min(time + remaining, t_limit)``;
- while every CPU that can run waits in a flag poll at a fixed point
  (``lw rd, flag; beq rd, x0, -4`` on a zero scratch word), whole
  iterations are applied in closed form too (``_poll_skip``).

The working buffers (scratch, store log, outbox) carry a sink lane and are
updated in place, the port's counterpart of JAX's dropped scatters.
"""
from __future__ import annotations

import torch

from repro_torch.core import channel as ch
from repro_torch.vp import isa, memory, riscv

_I32 = torch.int32
_I64 = torch.int64
_BOX = ("kind", "dst", "addr", "data", "t_emit")


def _col(x):
    return x.to(_I64).unsqueeze(-1)


def _mem_access(cfg, hot, dram_data, box, mem):
    """Dispatch one memory op per segment; returns (hot, cycles, load_val,
    stall).  Scratch stores, store-log appends and the outbox append land
    in place in ``hot``'s sink buffers and ``box``."""
    t = cfg.timing
    scratch = hot["scratch"]  # (S, scratch words + 1): the last lane is the sink
    n_scratch = scratch.shape[-1] - 1
    addr = mem["addr"]
    a64 = addr.to(_I64)
    widx = (addr >> 2) & (dram_data.shape[-1] - 1)
    is_scratch = (addr >= isa.SCRATCH_BASE) & (addr < isa.SCRATCH_BASE + n_scratch * 4)
    is_cim = (addr >= isa.CIM_BASE) & (addr < isa.SCRATCH_BASE)
    is_dram = (addr >= 0) & (addr < isa.CIM_BASE)
    s_idx = ((a64 - isa.SCRATCH_BASE) >> 2).clamp(0, n_scratch - 1)

    ld, sd = mem["is_load"], mem["is_store"]
    present = hot["dram_present"]
    use_dram_r = ld & is_dram & present
    local_dram_w = sd & is_dram & present
    touch = use_dram_r | local_dram_w
    hot["dcache"], hit = memory.cache_lookup(hot["dcache"], widx, t, touch)
    hot["dram_meta"], dcost = memory.dram_cost(
        hot["dram_meta"], widx, local_dram_w, t, touch & ~hit)

    val = torch.where(is_scratch, scratch.gather(-1, s_idx.unsqueeze(-1)).squeeze(-1),
                      dram_data.gather(-1, _col(widx)).squeeze(-1))
    dram_c = torch.where(hit, t.cache_hit, dcost)
    cycles = torch.where(ld, torch.where(is_scratch, t.scratch, torch.where(
        use_dram_r, dram_c, t.cpi)), 0)
    remote_ld = ld & is_dram & ~present

    st_data = mem["st_data"]
    scratch.scatter_(-1, torch.where(sd & is_scratch, s_idx, n_scratch).unsqueeze(-1),
                     st_data.unsqueeze(-1))
    log = hot["log"]  # (S, 2, store_log + 1): addr and data rows, sink lane last
    count = hot["log_count"]
    li = torch.where(local_dram_w, count.clamp(0, cfg.store_log - 1), cfg.store_log)
    log.scatter_(-1, _col(li).unsqueeze(1).expand(-1, 2, 1),
                 torch.stack([widx, st_data], 1).unsqueeze(-1))
    hot["log_count"] = count + local_dram_w.to(_I32)
    cycles = cycles + torch.where(sd, torch.where(is_scratch, t.scratch, torch.where(
        local_dram_w, dram_c, t.mmio_post)), 0)
    remote_st = sd & is_dram & ~present

    # the slot's one possible message, in the reference's order of kinds:
    # remote DRAM load (tag = seg_id << 8 | rd), remote DRAM store, CIM MMIO
    remote = remote_ld | remote_st
    append = remote
    kind = torch.where(remote_ld, ch.MSG_R_DRAM, torch.full_like(addr, ch.MSG_W_DRAM))
    dst = torch.full_like(addr, cfg.dram_segment)
    m_addr = widx
    data = torch.where(remote_ld, (hot["seg_id"] << 8) | mem["rd"], st_data)
    t_emit = hot["time"]
    if len(cfg.cim_seg):
        u = ((a64 - isa.CIM_BASE) >> 12).clamp(0, len(cfg.cim_seg) - 1)
        reg_off = addr & 0xFFF
        seg_u = hot["cim_seg"][u]
        slot_u = hot["cim_slot"][u]
        cim_store = sd & is_cim
        is_spk = cim_store & (reg_off == isa.CIM_REG_SPIKE)
        period = cfg.snn_tick_period
        if period > 0:
            # tick-addressed AER injection: the store names a LIF tick and
            # becomes a MSG_SPIKE whose t_avail is the tick's grid time
            # (t_emit backs the routing latency out), so under any placement
            # it arrives tagged like a pre-scheduled raster event.  A tick-k
            # spike stored at or after (k+1)*period is late.  int32 wraps,
            # as the reference's does.
            tick = ((st_data >> 16) & 0x7FFF).to(_I64)
            target = riscv._wrap32((tick + 1) * period)
            lat = torch.where(seg_u == hot["seg_id"], cfg.local_latency,
                              cfg.channel_latency)
            late = is_spk & (hot["time"] >= target)
            spike = is_spk
        else:
            late = is_spk  # no ticking spike-mode unit wired: never valid
            spike = torch.zeros_like(is_spk)
        hot["mmio_late"] = hot["mmio_late"] + late.to(_I32)
        # a spike store takes the place of the MSG_W_CIM it does not send
        append = remote | (cim_store & ~is_spk) | spike
        kind = torch.where(remote, kind, torch.where(spike, ch.MSG_SPIKE, ch.MSG_W_CIM)
                           .to(_I32))
        dst = torch.where(remote, dst, seg_u)
        m_addr = torch.where(remote, m_addr, (slot_u << 16) | torch.where(
            spike, st_data & 0xFFFF, reg_off))
        if period > 0:
            data = torch.where(spike, 1, data)
            t_emit = torch.where(spike, riscv._wrap32(target.to(_I64) - lat), t_emit)
    cap = box.shape[-1] - 1
    count = hot["box_count"]
    i = torch.where(append & (count < cap), count, cap)
    box.scatter_(-1, _col(i).unsqueeze(1).expand(-1, 6, 1),
                 torch.stack([kind, dst, m_addr, data, t_emit,
                              torch.ones_like(kind)], 1).unsqueeze(-1))
    hot["box_count"] = count + append.to(_I32)
    return hot, cycles, val, remote_ld


def _slot(cfg, hot, table, dram_data, box, t_limit):
    """One instruction slot on every segment (the reference's ``slot``)."""
    t = cfg.timing
    cpu = hot["cpu"]
    live = cpu["present"] & ~cpu["halted"]
    runnable = live & ~cpu["waiting"] & (hot["time"] < t_limit)
    pc_w = (cpu["pc"] >> 2) & (table.shape[-1] - 1)
    fields = table.gather(-1, _col(pc_w).unsqueeze(1).expand(-1, table.shape[1], 1))
    d = dict(zip(riscv.DECODED, fields.squeeze(-1).unbind(1)))
    hot["icache"], ihit = memory.cache_lookup(hot["icache"], pc_w, t, runnable)
    cpu2, mem = riscv.execute_decoded(cpu, d)
    mem["is_load"] = mem["is_load"] & runnable
    mem["is_store"] = mem["is_store"] & runnable
    hot, mcycles, ld_val, stall = _mem_access(cfg, hot, dram_data, box, mem)
    cpu2 = {k: torch.where(runnable.reshape(-1, *([1] * (v.dim() - 1))), v, cpu[k])
            for k, v in cpu2.items()}
    did_load_local = mem["is_load"] & ~stall
    cpu2 = riscv.writeback(cpu2, torch.where(did_load_local, mem["rd"], 0),
                           torch.where(did_load_local, ld_val, cpu2["regs"][:, 0]))
    cpu2["waiting"] = cpu["waiting"] | stall
    cost = torch.where(runnable, t.cpi + mcycles + (~ihit).to(_I32) * t.imiss, 1)
    hot["time"] = torch.where(live, torch.minimum(hot["time"] + cost, t_limit), hot["time"])
    hot["cpu"] = cpu2
    hot["instrs"] = hot["instrs"] + runnable.to(_I32)
    return hot


def _poll_words(table):
    """(S, program words) bool: word w starts a flag poll, ``lw rd,
    imm(rs1)`` with rd != 0 followed by ``beq rd, x0, -4``, the loop the
    offload managers and the spike driver wait in."""
    d = dict(zip(riscv.DECODED, table.unbind(1)))
    nxt = lambda f: torch.roll(d[f], -1, -1)
    return ((d["op"] == isa.OP_LOAD) & (d["rd"] != 0) & (nxt("op") == isa.OP_BRANCH)
            & (nxt("f3") == isa.F3_BEQ) & (nxt("rs1") == d["rd"]) & (nxt("rs2") == 0)
            & (nxt("imm_b") == -4))


def _poll_skip(cfg, hot, table, polls, runnable, t_limit, remaining):
    """Iterations of a flag poll that every runnable CPU may skip at once,
    or 0.  A poll is at a fixed point when its scratch word and ``rd`` are
    0 and both of its words hit the icache (in different sets, or one
    line): each iteration then only adds ``2*cpi + scratch`` cycles, two
    instructions and two icache hits, as ``_slot`` would, until the clock
    nears ``t_limit``.  The skip leaves the last whole iteration, and the
    rest of the quantum, to ``_slot``; a CPU that cannot run meanwhile
    gains one cycle a slot, up to ``t_limit``."""
    t = cfg.timing
    cpu = hot["cpu"]
    words = table.shape[-1]
    w = ((cpu["pc"] >> 2) & (words - 1)).to(_I64)
    if bool((runnable & ~polls.gather(-1, w.unsqueeze(-1)).squeeze(-1)).any()):
        return 0
    at = lambda f: table[:, riscv.DECODED.index(f)].gather(-1, w.unsqueeze(-1)).squeeze(-1)
    regs = cpu["regs"]
    rd = at("rd").to(_I64).unsqueeze(-1)
    addr = riscv._wrap32(regs.gather(-1, at("rs1").to(_I64).unsqueeze(-1)).squeeze(-1)
                         .to(_I64) + at("imm_i"))
    scratch = hot["scratch"]
    n_scratch = scratch.shape[-1] - 1
    in_scratch = (addr >= isa.SCRATCH_BASE) & (addr < isa.SCRATCH_BASE + n_scratch * 4)
    s_idx = ((addr.to(_I64) - isa.SCRATCH_BASE) >> 2).clamp(0, n_scratch - 1)
    lines = torch.stack([w, (w + 1) % words]) // t.line_words  # (2, S)
    tags = hot["icache"]["tags"]
    sets = lines % tags.shape[-1]
    hits = (tags.gather(-1, sets.T) == lines.T).all(-1)
    fixed = (in_scratch & (scratch.gather(-1, s_idx.unsqueeze(-1)).squeeze(-1) == 0)
             & (regs.gather(-1, rd).squeeze(-1) == 0) & hits
             & ((lines[0] == lines[1]) | (sets[0] != sets[1])))
    if bool((runnable & ~fixed).any()):
        return 0
    step = 2 * t.cpi + t.scratch
    room = torch.where(runnable, (t_limit.to(_I64) - 1 - hot["time"]) // step, remaining // 2)
    return max(min(int(room.min()), remaining // 2) - 1, 0)


def slot_scan(cfg, quantum: int, st, outbox, t_limit, cim_seg, cim_slot):
    """One quantum of instruction slots on every segment, then the store log.

    ``st`` is the stacked segment-state tree (S, ...) after this round's
    inbox; ``t_limit`` (S,) the decoupling bound; ``cim_seg``/``cim_slot``
    the platform's static CIM wiring as int32 tensors.  Appends to ``outbox`` and
    applies the store log to ``st["dram"]["data"]``, both in place.
    Returns ``(st', outbox)``: ``st'`` is a new dict whose CPU-side leaves
    (time, cpu, icache, dcache, dram, scratch, stats) are the scan's.
    """
    s = st["time"].shape[0]
    dev = st["time"].device
    prog = riscv.decode(st["prog"])
    table = torch.stack([prog[k] for k in riscv.DECODED], 1)  # (S, 11, program words)
    dram = st["dram"]
    dram_data = dram["data"]
    stats = st["stats"]
    cap = outbox["valid"].shape[-1]
    box = torch.zeros((s, 6, cap + 1), dtype=_I32, device=dev)
    box[:, :, :cap] = torch.stack([outbox[f] for f in _BOX] + [outbox["valid"].to(_I32)], 1)
    sink = lambda x: torch.cat([x, torch.zeros_like(x[..., :1])], -1)
    hot = {
        "time": st["time"],
        "seg_id": st["seg_id"],
        "dram_present": st["dram_present"],
        "cpu": st["cpu"],
        "icache": st["icache"],
        "dcache": st["dcache"],
        "dram_meta": {k: v for k, v in dram.items() if k != "data"},
        "scratch": sink(st["scratch"]),
        "log": torch.zeros((s, 2, cfg.store_log + 1), dtype=_I32, device=dev),
        "log_count": torch.zeros((s,), dtype=_I32, device=dev),
        "box_count": outbox["count"],
        "instrs": stats["instrs"],
        "mmio_late": stats["snn_mmio_late"],
        "cim_seg": cim_seg,
        "cim_slot": cim_slot,
    }
    polls = _poll_words(table)
    q = 0
    while q < quantum:
        cpu = hot["cpu"]
        live = cpu["present"] & ~cpu["halted"]
        runnable = live & ~cpu["waiting"] & (hot["time"] < t_limit)
        if not bool(runnable.any()):
            hot["time"] = torch.where(live, torch.minimum(
                hot["time"].to(_I64) + (quantum - q), t_limit.to(_I64)).to(_I32), hot["time"])
            break
        k = _poll_skip(cfg, hot, table, polls, runnable, t_limit, quantum - q)
        if k > 0:
            t = cfg.timing
            step = 2 * t.cpi + t.scratch
            n = 2 * k
            hot["time"] = torch.where(runnable, hot["time"] + k * step, torch.where(
                live, torch.minimum(hot["time"].to(_I64) + n, t_limit.to(_I64)).to(_I32),
                hot["time"]))
            inc = runnable.to(_I32) * n
            hot["cpu"] = {**cpu, "instret": cpu["instret"] + inc}
            hot["icache"] = {**hot["icache"], "hits": hot["icache"]["hits"] + inc}
            hot["instrs"] = hot["instrs"] + inc
            q += n
            continue
        hot = _slot(cfg, hot, table, dram_data, box, t_limit)
        q += 1

    # the DRAM store log, in order: sequential semantics, the last store to
    # an address wins
    log = hot["log"][..., :cfg.store_log]
    valid = torch.arange(cfg.store_log, device=dev) < hot["log_count"].unsqueeze(-1)
    memory.write_last_wins(dram_data, log[:, 0], log[:, 1], valid, inplace=True)

    for j, f in enumerate(_BOX):
        outbox[f].copy_(box[:, j, :cap])
    outbox["valid"].copy_(box[:, 5, :cap] != 0)
    outbox["count"].copy_(hot["box_count"])
    st = dict(st)
    st["time"] = hot["time"]
    st["cpu"] = hot["cpu"]
    st["icache"] = hot["icache"]
    st["dcache"] = hot["dcache"]
    st["scratch"] = hot["scratch"][:, :-1].contiguous()
    st["dram"] = {**hot["dram_meta"], "data": dram_data}
    st["stats"] = {**stats, "instrs": hot["instrs"], "snn_mmio_late": hot["mmio_late"],
                   # sticky watermark: past-capacity store-log appends clip onto
                   # the last entry, so a quantum that needed more entries than
                   # store_log must make the controller raise
                   "store_peak": torch.maximum(stats["store_peak"], hot["log_count"])}
    return st, outbox
