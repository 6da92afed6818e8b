"""RISC-V core state constructor (counterpart of ``repro/vp/riscv.py``).

Only ``cpu_state``: a CPU-free platform still carries a halted core per
segment.  The ISS itself comes with the dense slice (ROADMAP module item 6).
"""
from __future__ import annotations

import torch


def cpu_state(pc: int = 0):
    return {
        "present": torch.zeros((), dtype=torch.bool),
        "pc": torch.tensor(pc, dtype=torch.int32),
        "regs": torch.zeros((32,), dtype=torch.int32),
        "halted": torch.zeros((), dtype=torch.bool),
        "waiting": torch.zeros((), dtype=torch.bool),  # blocked on a remote read
        "instret": torch.zeros((), dtype=torch.int32),
    }
