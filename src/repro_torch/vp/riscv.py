"""Functional RISC-V ISS: RV32IM subset, real encodings, 32-bit datapath
(counterpart of ``repro/vp/riscv.py``).

Decode is plain bit-slicing; execute is branchless, every instruction
class' result computed and selected by the decoded class mask, as in the
reference.  Every function works over a leading segment axis: cpu leaves
are ``(S, ...)`` and the instruction word is ``(S,)``.

The reference's int32 arithmetic wraps (``rs1 * rs2``, ``pc + imm``).  Torch
does not promise that for int32, so sums and products are formed in int64
and wrapped to 32 bits once (``_wrap32``); right shifts of int32 stay
arithmetic, as in the reference.

Memory dispatch happens in the slot scan (``kernels/slot_scan``): this
module returns a memory-op descriptor per slot.
"""
from __future__ import annotations

import torch

from repro_torch.vp import isa

_I32 = torch.int32
_I64 = torch.int64

DECODED = ("op", "rd", "f3", "rs1", "rs2", "f7", "imm_i", "imm_s", "imm_b",
           "imm_u", "imm_j")


def cpu_state(pc: int = 0):
    return {
        "present": torch.zeros((), dtype=torch.bool),
        "pc": torch.tensor(pc, dtype=_I32),
        "regs": torch.zeros((32,), dtype=_I32),
        "halted": torch.zeros((), dtype=torch.bool),
        "waiting": torch.zeros((), dtype=torch.bool),  # blocked on a remote read
        "instret": torch.zeros((), dtype=_I32),
    }


def _wrap32(x):
    """int64 -> int32 with two's-complement wrap-around."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(_I32)


def _sx(v, bits):
    """Sign-extend the low ``bits`` bits of ``v`` (the reference's
    ``(v << (32 - bits)) >> (32 - bits)``, written without a shift that can
    overflow)."""
    sign = 1 << (bits - 1)
    return ((v & ((1 << bits) - 1)) ^ sign) - sign


def _as_words(instr):
    """Instruction words as int32 bit patterns (``prog`` is uint32, which
    has no shifts on the CPU)."""
    if instr.dtype == torch.uint32:
        return instr.contiguous().view(_I32)
    return instr.to(_I32)


def decode(instr):
    """Bit-slice instruction words (any shape) into the fields of
    ``DECODED``, each int32 of the same shape."""
    i = _as_words(instr)
    op = i & 0x7F
    rd = (i >> 7) & 31
    f3 = (i >> 12) & 7
    rs1 = (i >> 15) & 31
    rs2 = (i >> 20) & 31
    f7 = (i >> 25) & 0x7F
    imm_i = _sx((i >> 20) & 0xFFF, 12)
    imm_s = _sx((f7 << 5) | rd, 12)
    imm_b = _sx(
        (((i >> 31) & 1) << 12)
        | (((i >> 7) & 1) << 11)
        | (((i >> 25) & 0x3F) << 5)
        | (((i >> 8) & 0xF) << 1),
        13,
    )
    imm_u = i & -4096  # upper 20 bits
    imm_j = _sx(
        (((i >> 31) & 1) << 20)
        | (((i >> 12) & 0xFF) << 12)
        | (((i >> 20) & 1) << 11)
        | (((i >> 21) & 0x3FF) << 1),
        21,
    )
    return dict(op=op, rd=rd, f3=f3, rs1=rs1, rs2=rs2, f7=f7, imm_i=imm_i,
                imm_s=imm_s, imm_b=imm_b, imm_u=imm_u, imm_j=imm_j)


def _reg(regs, idx):
    return regs.gather(-1, idx.to(_I64).unsqueeze(-1)).squeeze(-1)


def _set_reg(regs, rd, value):
    """``regs[rd] = value`` unless rd == 0, then x0 pinned to 0 (the
    reference's ``regs.at[rd or 0].set(value or regs[0]).at[0].set(0)``)."""
    nz = rd != 0
    regs = regs.scatter(-1, torch.where(nz, rd, 0).to(_I64).unsqueeze(-1),
                        torch.where(nz, value, regs[..., 0]).unsqueeze(-1))
    return regs.index_fill(-1, torch.zeros(1, dtype=_I64, device=regs.device), 0)


def execute(cpu, instr):
    """One architectural step (no memory side effects).

    Returns (cpu', mem) where mem = dict(is_load, is_store, addr, st_data,
    rd): the slot scan performs the access, adds its cycle cost and writes
    the loaded value back with ``writeback``.
    """
    return execute_decoded(cpu, decode(instr))


def execute_decoded(cpu, d):
    """``execute`` on already decoded fields (the slot scan decodes the
    whole program once per quantum)."""
    pc = cpu["pc"]
    regs = cpu["regs"]
    rs1v = _reg(regs, d["rs1"])
    rs2v = _reg(regs, d["rs2"])
    op, f3, f7, rd = d["op"], d["f3"], d["f7"], d["rd"]

    is_lui = op == isa.OP_LUI
    is_auipc = op == isa.OP_AUIPC
    is_jal = op == isa.OP_JAL
    is_jalr = op == isa.OP_JALR
    is_br = op == isa.OP_BRANCH
    is_load = op == isa.OP_LOAD
    is_store = op == isa.OP_STORE
    is_imm = op == isa.OP_IMM
    is_reg = op == isa.OP_REG

    is_sub = is_reg & (f7 == 0b0100000)
    is_mul = is_reg & (f7 == isa.F7_MULDIV)
    a, b = rs1v.to(_I64), rs2v.to(_I64)
    alu = _wrap32(torch.where(is_mul, a * b, torch.where(
        is_sub, a - b, a + torch.where(is_imm, d["imm_i"], rs2v).to(_I64))))

    taken = (((f3 == isa.F3_BEQ) & (rs1v == rs2v))
             | ((f3 == isa.F3_BNE) & (rs1v != rs2v))
             | ((f3 == isa.F3_BLT) & (rs1v < rs2v))
             | ((f3 == isa.F3_BGE) & (rs1v >= rs2v)))

    pc64 = pc.to(_I64)
    next_pc = pc64 + 4
    next_pc = torch.where(is_br & taken, pc64 + d["imm_b"], next_pc)
    next_pc = torch.where(is_jal, pc64 + d["imm_j"], next_pc)
    next_pc = torch.where(is_jalr, (a + d["imm_i"]) & ~1, next_pc)
    next_pc = _wrap32(next_pc)

    wb = torch.where(is_lui, d["imm_u"], alu)
    wb = torch.where(is_auipc, _wrap32(pc64 + d["imm_u"]), wb)
    wb = torch.where(is_jal | is_jalr, _wrap32(pc64 + 4), wb)
    do_wb = (is_lui | is_auipc | is_jal | is_jalr | is_imm | is_reg) & (rd != 0)
    regs = _set_reg(regs, torch.where(do_wb, rd, 0), wb)

    halted = cpu["halted"] | (is_jal & (rd == 0) & (d["imm_j"] == 0))

    cpu = dict(cpu)
    cpu["regs"] = regs
    cpu["pc"] = torch.where(halted, pc, next_pc)
    cpu["halted"] = halted
    cpu["instret"] = cpu["instret"] + (~halted).to(_I32)

    mem = {
        "is_load": is_load & ~halted,
        "is_store": is_store & ~halted,
        "addr": _wrap32(torch.where(is_store, a + d["imm_s"], a + d["imm_i"])),
        "st_data": rs2v,
        "rd": rd,
    }
    return cpu, mem


def writeback(cpu, rd, value):
    cpu = dict(cpu)
    cpu["regs"] = _set_reg(cpu["regs"], rd, value)
    return cpu
