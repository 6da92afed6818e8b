"""The ISA constants the CPU-free step and the builder use (counterpart of
``repro/vp/isa.py``; the RISC-V encodings and the MMIO register map come
with the dense slice, ROADMAP module item 6)."""
from __future__ import annotations

DRAM_WORDS = 1 << 18  # default DRAM backing size in words

CIM_ST_IDLE, CIM_ST_IN, CIM_ST_OP, CIM_ST_OUT = 0, 1, 2, 3

CIM_MODE_DENSE, CIM_MODE_SPIKE = 0, 1


def pack_mode(mode: int, thresh: int = 1, leak: int = 0, refrac: int = 0) -> int:
    """Encode a CIM_REG_MODE register value."""
    return (mode & 1) | (thresh & 0xFFFF) << 1 | (leak & 0xFF) << 17 | (refrac & 0xF) << 25
