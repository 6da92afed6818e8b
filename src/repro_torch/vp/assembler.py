"""Two-pass assembler for the RV32IM subset + the VMM benchmark programs
(counterpart of ``repro/vp/assembler.py``: plain Python, copied so the port
never imports the JAX package).

Syntax: one instruction per line, ``label:`` definitions, ``%lo(sym)`` not
needed (flat immediates), registers by ABI name.  Supported mnemonics:

  lui rd, imm20        auipc rd, imm20
  jal rd, label        jalr rd, rs1, imm
  beq/bne/blt/bge rs1, rs2, label
  lw rd, imm(rs1)      sw rs2, imm(rs1)
  addi rd, rs1, imm    add/sub/mul rd, rs1, rs2
  li rd, imm           (pseudo: lui+addi or addi)
  nop / halt           (halt = jal x0, 0 — self-loop, detected by the ISS)
"""
from __future__ import annotations

import re

import numpy as np

from repro_torch.vp import isa


def assemble(src: str, base: int = 0) -> np.ndarray:
    lines = []
    for raw in src.splitlines():
        line = raw.split("#")[0].strip()
        if line:
            lines.append(line)

    # pass 1: labels
    labels: dict[str, int] = {}
    pc = base
    prog: list[str] = []
    for line in lines:
        while True:
            m = re.match(r"^([\w.]+):\s*(.*)$", line)
            if not m:
                break
            labels[m.group(1)] = pc
            line = m.group(2).strip()
        if not line:
            continue
        op = line.split()[0]
        if op == "li":
            _, rd, imm = _split(line)
            pc += 4 if _fits12(int(imm, 0)) else 8
        else:
            pc += 4
        prog.append(line)

    # pass 2: encode
    words: list[int] = []
    pc = base
    for line in prog:
        parts = _split(line)
        op = parts[0]
        if op == "li":
            rd, imm = isa.reg(parts[1]), int(parts[2], 0)
            if _fits12(imm):
                words.append(isa.enc_i(isa.OP_IMM, rd, isa.F3_ADDI, 0, imm))
                pc += 4
            else:
                hi = (imm + 0x800) & 0xFFFFF000
                lo = imm - hi
                words.append(isa.enc_u(isa.OP_LUI, rd, hi))
                words.append(isa.enc_i(isa.OP_IMM, rd, isa.F3_ADDI, rd, lo))
                pc += 8
            continue
        if op == "nop":
            words.append(isa.enc_i(isa.OP_IMM, 0, isa.F3_ADDI, 0, 0))
        elif op == "halt":
            words.append(isa.enc_j(isa.OP_JAL, 0, 0))
        elif op == "lui":
            words.append(isa.enc_u(isa.OP_LUI, isa.reg(parts[1]), int(parts[2], 0)))
        elif op == "jal":
            rd = isa.reg(parts[1])
            words.append(isa.enc_j(isa.OP_JAL, rd, labels[parts[2]] - pc))
        elif op == "jalr":
            words.append(
                isa.enc_i(isa.OP_JALR, isa.reg(parts[1]), 0, isa.reg(parts[2]), int(parts[3], 0))
            )
        elif op in ("beq", "bne", "blt", "bge"):
            f3 = {"beq": isa.F3_BEQ, "bne": isa.F3_BNE, "blt": isa.F3_BLT, "bge": isa.F3_BGE}[op]
            words.append(
                isa.enc_b(isa.OP_BRANCH, f3, isa.reg(parts[1]), isa.reg(parts[2]), labels[parts[3]] - pc)
            )
        elif op == "lw":
            rd, (imm, rs1) = isa.reg(parts[1]), _memarg(parts[2])
            words.append(isa.enc_i(isa.OP_LOAD, rd, isa.F3_LW, rs1, imm))
        elif op == "sw":
            rs2, (imm, rs1) = isa.reg(parts[1]), _memarg(parts[2])
            words.append(isa.enc_s(isa.OP_STORE, isa.F3_SW, rs1, rs2, imm))
        elif op == "addi":
            words.append(
                isa.enc_i(isa.OP_IMM, isa.reg(parts[1]), isa.F3_ADDI, isa.reg(parts[2]), int(parts[3], 0))
            )
        elif op in ("add", "sub", "mul"):
            f7 = {"add": 0, "sub": 0b0100000, "mul": isa.F7_MULDIV}[op]
            words.append(
                isa.enc_r(isa.OP_REG, isa.reg(parts[1]), isa.F3_ADD, isa.reg(parts[2]), isa.reg(parts[3]), f7)
            )
        else:
            raise ValueError(f"unknown mnemonic: {line}")
        pc += 4
    return np.array(words, dtype=np.uint32)


def _split(line: str):
    op, _, rest = line.partition(" ")
    parts = [op] + [p.strip() for p in rest.split(",") if p.strip()]
    return parts


def _fits12(v: int) -> bool:
    return -2048 <= v < 2048


def _memarg(s: str):
    m = re.match(r"(-?\w+)\((\w+)\)$", s)
    return int(m.group(1), 0), isa.reg(m.group(2))


# ---------------------------------------------------------------------------
# benchmark programs


def vmm_riscv_program(h: int, w: int, p: int, a_base: int, b_base: int, o_base: int) -> str:
    """The paper's nested-loop VMM on RISC-V + main memory: O[h,p] = A[h,w] @ B[w,p].

    Word-addressed int32 matrices, row-major.
    """
    return f"""
    li s0, 0                 # i = 0
outer_i:
    li s1, 0                 # j = 0
outer_j:
    li t0, 0                 # acc = 0
    li s2, 0                 # k = 0
    li t4, {w * 4}
    mul t2, s0, t4           # i*w*4
    li t4, {a_base}
    add t2, t2, t4           # t2 = &A[i,0]
    add t3, s1, s1
    add t3, t3, t3           # j*4
    li t4, {b_base}
    add t3, t3, t4           # t3 = &B[0,j]
inner_k:
    lw t4, 0(t2)             # A[i,k]
    lw t5, 0(t3)             # B[k,j]
    mul t6, t4, t5
    add t0, t0, t6
    addi t2, t2, 4
    addi t3, t3, {4 * p}
    addi s2, s2, 1
    li t4, {w}
    blt s2, t4, inner_k
    # O[i,j] = acc
    li t4, {p * 4}
    mul t1, s0, t4
    add t5, s1, s1
    add t5, t5, t5
    add t1, t1, t5           # i*p*4 + j*4
    li t4, {o_base}
    add t1, t1, t4
    sw t0, 0(t1)
    addi s1, s1, 1
    li t4, {p}
    blt s1, t4, outer_j
    addi s0, s0, 1
    li t4, {h}
    blt s0, t4, outer_i
    halt
"""


def vmm_cim_program(h: int, w: int, p: int, cim_base: int, b_base: int, o_base: int,
                    in_res: int = 8, out_res: int = 8) -> str:
    """Offloaded VMM: configure the CIM unit, stream each input vector,
    launch OP, poll STATUS, read back outputs.  (Weights A are preloaded into
    the crossbar by the platform, as in the paper — the crossbar holds the
    matrix; the IN/OP/OUT phases run per vector.)
    """
    cfg = (h & 0x1FF) | (w & 0x1FF) << 9 | (in_res & 0xF) << 18 | (out_res & 0xF) << 22
    return f"""
    li s0, {cim_base}
    li t0, {cfg}
    sw t0, {isa.CIM_REG_CONFIG}(s0)
    li s1, 0                 # j = 0 (vector index)
vec_loop:
    # stream w input elements B[k, j]
    li s2, 0
    li t3, {b_base}
    add t3, t3, s1
    add t3, t3, s1
    add t3, t3, s1
    add t3, t3, s1           # &B[0,j]
in_loop:
    lw t4, 0(t3)
    sw t4, {isa.CIM_REG_INPUT}(s0)
    addi t3, t3, {4 * p}
    addi s2, s2, 1
    li t5, {w}
    blt s2, t5, in_loop
    sw zero, {isa.CIM_REG_START}(s0)
poll:
    lw t4, {isa.CIM_REG_STATUS}(s0)
    li t5, {isa.CIM_ST_OUT}
    bne t4, t5, poll
    # read h outputs -> O[:, j]
    li s2, 0
    li t3, {o_base}
    add t3, t3, s1
    add t3, t3, s1
    add t3, t3, s1
    add t3, t3, s1
out_loop:
    lw t4, {isa.CIM_REG_OUTPUT}(s0)
    sw t4, 0(t3)
    addi t3, t3, {4 * p}
    addi s2, s2, 1
    li t5, {h}
    blt s2, t5, out_loop
    addi s1, s1, 1
    li t5, {p}
    blt s1, t5, vec_loop
    halt
"""
