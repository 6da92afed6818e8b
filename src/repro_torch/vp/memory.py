"""Memory modules: shared DRAM with page-switch / write->read-switch delays
and direct-mapped L1 caches (counterpart of ``repro/vp/memory.py``).

``cache_lookup`` and ``dram_cost`` work over a leading segment axis: every
state leaf is ``(S, ...)`` and the address and predicate are ``(S,)``.
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


def cache_lookup(cache, word_addr, t: Timing, pred):
    """Returns (cache', hit).  Every mutation is gated on ``pred``; the
    tag write is one targeted scatter per segment (one index per row, so
    the result is deterministic on every device)."""
    line = word_addr // t.line_words
    n = cache["tags"].shape[-1]
    s = (line % n).to(torch.int64).unsqueeze(-1)
    cur = cache["tags"].gather(-1, s).squeeze(-1)
    hit = cur == line
    cache = dict(cache)
    cache["tags"] = cache["tags"].scatter(
        -1, s, torch.where(pred, line, cur).unsqueeze(-1))
    cache["hits"] = cache["hits"] + (pred & hit).to(torch.int32)
    cache["misses"] = cache["misses"] + (pred & ~hit).to(torch.int32)
    return cache, hit


def dram_cost(dram, word_addr, is_write, t: Timing, pred):
    """Returns (dram', cycles) applying row-buffer and write->read switch
    penalties.  Scalar state only, gated on ``pred``; never touches the
    data array."""
    row = word_addr >> t.dram_row_bits
    cost = (t.dram_access
            + (row != dram["last_row"]).to(torch.int32) * t.page_switch
            + (dram["last_write"] & ~is_write).to(torch.int32) * t.write_read_switch)
    dram = dict(dram)
    dram["last_row"] = torch.where(pred, row, dram["last_row"])
    dram["last_write"] = torch.where(pred, is_write, dram["last_write"])
    dram["reads"] = dram["reads"] + (pred & ~is_write).to(torch.int32)
    dram["writes"] = dram["writes"] + (pred & is_write).to(torch.int32)
    return dram, cost.to(torch.int32)


def write_last_wins(base, idx, vals, mask, inplace: bool = False):
    """``base.at[idx].set(vals)`` along the last axis for the lanes where
    ``mask`` holds, the last such lane winning on a duplicate index (what a
    sequential store does, and what a CUDA scatter with duplicate indices
    does not promise).

    Every lane writes — a masked lane writes the value its index will hold
    anyway (the winning lane's, or the old one) — so duplicate indices
    always carry identical values and the scatter is deterministic.  The
    winner per index is an ``amax`` scatter-reduce of lane numbers, which
    is order-independent too.  ``idx`` must lie in range.
    """
    n = idx.shape[-1]
    idx = idx.to(torch.int64)
    lane = torch.arange(n, dtype=torch.int32, device=idx.device).expand(idx.shape)
    win = torch.full(base.shape, -1, dtype=torch.int32, device=base.device)
    win = win.scatter_reduce(-1, idx, torch.where(mask, lane, -1), "amax")
    w = win.gather(-1, idx)
    val = torch.where(w >= 0, vals.to(base.dtype).gather(-1, w.clamp(min=0).to(torch.int64)),
                      base.gather(-1, idx))
    return base.scatter_(-1, idx, val) if inplace else base.scatter(-1, idx, val)
