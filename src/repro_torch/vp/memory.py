"""Memory-module state constructors (counterpart of ``repro/vp/memory.py``).

Only the constructors: ``segment_state`` holds caches and DRAM even on a
CPU-free platform.  The cache and DRAM timing models come with the dense
slice (ROADMAP module item 6).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.vp import isa


@dataclasses.dataclass(frozen=True)
class Timing:
    """Cycle costs (CPU @1.7 GHz domain, Table II)."""

    cpi: int = 1
    scratch: int = 1
    cache_hit: int = 1
    dram_access: int = 20
    page_switch: int = 8
    write_read_switch: int = 3
    imiss: int = 10
    mmio_post: int = 1
    dram_row_bits: int = 9  # words per row = 512
    dcache_sets: int = 1024  # 32 KB / 32 B lines
    icache_sets: int = 512  # 16 KB
    line_words: int = 8


def cache_state(n_sets: int):
    return {
        "tags": torch.full((n_sets,), -1, dtype=torch.int32),
        "hits": torch.zeros((), dtype=torch.int32),
        "misses": torch.zeros((), dtype=torch.int32),
    }


def dram_state(backing_words: int = isa.DRAM_WORDS):
    return {
        "data": torch.zeros((backing_words,), dtype=torch.int32),
        "last_row": torch.full((), -1, dtype=torch.int32),
        "last_write": torch.zeros((), dtype=torch.bool),
        "reads": torch.zeros((), dtype=torch.int32),
        "writes": torch.zeros((), dtype=torch.int32),
    }
