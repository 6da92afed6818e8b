"""Benchmark workloads: the paper's Table III network layers as VMM jobs and
the programs for both execution modes (counterpart of the dense half of
``repro/vp/workloads.py``; the numpy RNG code is the reference's, so the
jobs are identical by construction).

Modes:
  riscv — nested-loop VMM on the DRAM-resident matrices, run by the CPU
          co-located with main memory (paper §V-B);
  cim   — offload: each managing CPU drives its two CIM-Units in a
          software-pipelined pair (stream j → unit0, stream j+1 → unit1,
          then drain both); inputs staged in local scratch, outputs DMA'd
          back by the units, O written to shared DRAM as posted writes.

The hybrid dense+spiking half (the spike driver program) comes with ROADMAP
module item 8, ``from_arch`` with module item 13.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import segmentation as seg
from repro_torch.vp import isa
from repro_torch.vp.assembler import vmm_riscv_program


@dataclasses.dataclass(frozen=True)
class Layer:
    network: str
    layer: str
    h: int
    w: int
    p: int

    @property
    def name(self):
        return f"{self.network}-{self.layer}"

    def scaled(self, f: int):
        # keep p >= 2 so multi-manager offload benchmarks stay loaded
        return Layer(self.network, self.layer, max(self.h // f, 4), max(self.w // f, 4), max(self.p // f, 2))


TABLE_III = [
    Layer("Googlenet", "conv1", 224, 224, 7),
    Layer("Googlenet", "conv2", 56, 56, 3),
    Layer("ImageNet", "conv1", 224, 224, 11),
    Layer("ImageNet", "conv2", 207, 207, 5),
    Layer("MobileNets", "conv1", 224, 224, 3),
    Layer("MobileNets", "conv2", 112, 112, 3),
]

A_BASE_W = 1024  # DRAM word offsets


def layer_data(layer: Layer, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 8, (layer.h, layer.w), dtype=np.int32)
    b = rng.integers(-8, 8, (layer.w, layer.p), dtype=np.int32)
    o = a @ b
    return a, b, o


def dram_image(layer: Layer, a, b):
    a_base = A_BASE_W
    b_base = a_base + layer.h * layer.w
    o_base = b_base + layer.w * layer.p
    words = np.zeros(o_base + layer.h * layer.p, np.int32)
    words[a_base:b_base] = a.reshape(-1)
    words[b_base:o_base] = b.reshape(-1)
    return words, a_base * 4, b_base * 4, o_base * 4, o_base


def riscv_workload(layer: Layer, seed: int = 0):
    """Program + DRAM image for the RISC-V + main-memory mode (one CPU)."""
    a, b, o = layer_data(layer, seed)
    words, a_b, b_b, o_b, o_w = dram_image(layer, a, b)
    prog = vmm_riscv_program(layer.h, layer.w, layer.p, a_b, b_b, o_b)
    return {"programs": {0: prog}, "dram": words, "expected": o, "o_word": o_w}


def cim_pair_program(cim_bases, h, w, p_lo, p_hi, o_base, p_total, in_res=8, out_res=8,
                     ordinals=(0, 1)):
    """Manager-CPU program driving two CIM units over vectors [p_lo, p_hi).

    ``ordinals``: the two units' mailbox ordinals in the manager's scratch
    (segmentation.mailbox_ordinals) — flag word = ordinal, output area =
    OUT0 + ordinal*256.
    """
    cfg = (h & 0x1FF) | (w & 0x1FF) << 9 | (in_res & 0xF) << 18 | (out_res & 0xF) << 22
    sb = isa.SCRATCH_BASE
    bs = sb + seg.B_STAGE * 4
    f0, f1 = ordinals[0] * 4, ordinals[1] * 4
    out0 = (seg.OUT0 + ordinals[0] * 256) * 4
    out1 = (seg.OUT0 + ordinals[1] * 256) * 4
    src = [
        f"    li s0, {cim_bases[0]}",
        f"    li s1, {cim_bases[1]}",
        f"    li t0, {cfg}",
        f"    sw t0, {isa.CIM_REG_CONFIG}(s0)",
        f"    sw t0, {isa.CIM_REG_CONFIG}(s1)",
        f"    li s2, 0",  # j_local
        f"    li s3, {p_hi - p_lo}",  # nj
        "pair_loop:",
        f"    li t0, {sb}",
        f"    sw zero, {f0}(t0)",
        f"    sw zero, {f1}(t0)",
        # ---- stream vector j -> unit 0
        f"    li t2, {w}",
        "    mul t3, s2, t2",
        "    add t3, t3, t3",
        "    add t3, t3, t3",
        f"    li t5, {bs}",
        "    add t3, t3, t5",
        "    li t4, 0",
        "in0:",
        "    lw t1, 0(t3)",
        f"    sw t1, {isa.CIM_REG_INPUT}(s0)",
        "    addi t3, t3, 4",
        "    addi t4, t4, 1",
        "    blt t4, t2, in0",
        f"    sw zero, {isa.CIM_REG_START}(s0)",
        # ---- stream vector j+1 -> unit 1 (if any)
        "    addi t6, s2, 1",
        "    bge t6, s3, drain0",
        "    mul t3, t6, t2",
        "    add t3, t3, t3",
        "    add t3, t3, t3",
        f"    li t5, {bs}",
        "    add t3, t3, t5",
        "    li t4, 0",
        "in1:",
        "    lw t1, 0(t3)",
        f"    sw t1, {isa.CIM_REG_INPUT}(s1)",
        "    addi t3, t3, 4",
        "    addi t4, t4, 1",
        "    blt t4, t2, in1",
        f"    sw zero, {isa.CIM_REG_START}(s1)",
        # ---- drain unit 0: poll flag, copy outputs to O[:, p_lo + j]
        "drain0:",
        f"    li t0, {sb}",
        "poll0:",
        f"    lw t1, {f0}(t0)",
        "    beq t1, zero, poll0",
        f"    li t3, {sb + out0}",  # src in scratch
        f"    addi t5, s2, {p_lo}",  # global j
        "    add t5, t5, t5",
        "    add t5, t5, t5",  # j*4
        f"    li t1, {o_base}",
        "    add t5, t5, t1",  # &O[0, j]
        "    li t4, 0",
        f"    li t2, {h}",
        "out0:",
        "    lw t1, 0(t3)",
        "    sw t1, 0(t5)",
        "    addi t3, t3, 4",
        f"    addi t5, t5, {4 * p_total}",  # O row stride
        "    addi t4, t4, 1",
        "    blt t4, t2, out0",
        # ---- drain unit 1 (if started)
        "    addi t6, s2, 1",
        "    bge t6, s3, next_pair",
        f"    li t0, {sb}",
        "poll1:",
        f"    lw t1, {f1}(t0)",
        "    beq t1, zero, poll1",
        f"    li t3, {sb + out1}",
        f"    addi t5, t6, {p_lo}",
        "    add t5, t5, t5",
        "    add t5, t5, t5",
        f"    li t1, {o_base}",
        "    add t5, t5, t1",
        "    li t4, 0",
        f"    li t2, {h}",
        "out1:",
        "    lw t1, 0(t3)",
        "    sw t1, 0(t5)",
        "    addi t3, t3, 4",
        f"    addi t5, t5, {4 * p_total}",
        "    addi t4, t4, 1",
        "    blt t4, t2, out1",
        "next_pair:",
        "    addi s2, s2, 2",
        f"    li t2, {w}",  # restore w bound (clobbered)
        "    blt s2, s3, pair_loop",
        "    halt",
    ]
    return "\n".join(src)


def cim_workload(layer: Layer, mgr_segments, cim_ids_per_mgr, seed: int = 0, ordinals=None):
    """Programs + crossbar/scratch/DRAM images for offload mode.

    mgr_segments: list of CPU segment ids driving CIM pairs
    cim_ids_per_mgr: {mgr_seg: (global_cim_id0, global_cim_id1)}
    Vectors are split contiguously across managers.
    """
    a, b, o = layer_data(layer, seed)
    words, a_b, b_b, o_b, o_w = dram_image(layer, a, b)
    n_mgr = len(mgr_segments)
    per = -(-layer.p // n_mgr)
    programs, crossbars, scratch = {}, {}, {}
    for mi, m in enumerate(mgr_segments):
        p_lo, p_hi = mi * per, min((mi + 1) * per, layer.p)
        if p_lo >= p_hi:
            continue
        g0, g1 = cim_ids_per_mgr[m]
        crossbars[g0] = a.astype(np.int8)
        crossbars[g1] = a.astype(np.int8)
        bases = (seg.cim_global_base(g0), seg.cim_global_base(g1))
        ords = ((ordinals or {}).get(g0, 0), (ordinals or {}).get(g1, 1))
        programs[m] = cim_pair_program(
            bases, layer.h, layer.w, p_lo, p_hi, o_b, layer.p, ordinals=ords
        )
        # stage this manager's input vectors (column-major by local j)
        bl = np.ascontiguousarray(b[:, p_lo:p_hi].T).reshape(-1)  # (nj, w)
        scratch[m] = {seg.B_STAGE: bl.astype(np.int32)}
    return {
        "programs": programs,
        "dram": words,
        "crossbars": crossbars,
        "scratch": scratch,
        "expected": o,
        "o_word": o_w,
    }
