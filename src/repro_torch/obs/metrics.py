"""Typed metrics registry over the simulation state (counterpart of
``repro/obs/metrics.py``: the same metrics, names, kinds and dicts).

Every quantity the VP already tracks on-device — per-segment stats
counters, per-unit CIM/SNN counters, channel watermarks — is declared here
once as a typed ``Metric`` (counter / gauge / histogram + unit + axis), so
tools iterate the registry instead of hard-coding state paths, and new
counters get discoverable names + docs for free.

``collect(states, pending)`` snapshots the registry from stacked state (a
pure host-side read: the caller provides already-stacked pytrees, e.g.
``Controller.metrics()``).  ``legacy_stats(states)`` reproduces the exact
historical ``Controller.stats()`` dict — the back-compat shim contract is
pinned by tests/test_obs.py (and held here by tests/test_torch_obs.py).

Kinds:
  counter   — monotonically nondecreasing over a run (events, ops, spikes)
  gauge     — instantaneous or high-water level (occupancy, watermarks)
  histogram — binned counts (the Fig. 1a transaction-kind histogram)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    unit: str
    per: str  # "segment" | "unit" | "bin"
    description: str
    source: str  # "states" | "pending"
    extract: Callable = dataclasses.field(compare=False, repr=False)


REGISTRY: dict[str, Metric] = {}


def _register(name, kind, unit, per, description, source="states"):
    def deco(fn):
        REGISTRY[name] = Metric(name, kind, unit, per, description, source, fn)
        return fn

    return deco


def _A(x):
    """A leaf as a numpy array of its own (a CPU tensor's ``numpy()`` shares
    the tensor's memory, which a later dispatch may write)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


_register("cpu.instructions", "counter", "instructions", "segment",
          "RISC-V instructions retired per segment CPU")(
    lambda s: _A(s["stats"]["instrs"]))
_register("channel.messages_emitted", "counter", "messages", "segment",
          "TLM messages appended to each segment's outbox")(
    lambda s: _A(s["stats"]["msgs"]))
_register("channel.txn_histogram", "histogram", "messages", "bin",
          "consumed inbox messages binned by kind (Fig. 1a; bins are "
          "channel.MSG_* ids, per segment)")(
    lambda s: _A(s["stats"]["txn_hist"]))
_register("channel.outbox_watermark", "gauge", "messages", "segment",
          "sticky per-round outbox high-water mark (vs VPConfig.out_cap)")(
    lambda s: _A(s["stats"]["outbox_peak"]))
_register("channel.inbox_watermark", "gauge", "messages", "segment",
          "sticky inbox merge high-water mark (vs VPConfig.in_cap)",
          source="pending")(
    lambda p: _A(p["max_count"]))
_register("channel.inbox_occupancy", "gauge", "messages", "segment",
          "valid messages currently pending per segment inbox",
          source="pending")(
    lambda p: _A(p["valid"]).sum(-1))
_register("channel.messages_routed", "counter", "messages", "segment",
          "messages ever routed toward each segment (route demand, "
          "counted even when a merge truncates)", source="pending")(
    lambda p: _A(p["routed_total"]))
_register("mem.dcache_hits", "counter", "accesses", "segment",
          "D-cache hits")(lambda s: _A(s["dcache"]["hits"]))
_register("mem.dcache_misses", "counter", "accesses", "segment",
          "D-cache misses")(lambda s: _A(s["dcache"]["misses"]))
_register("mem.dram_reads", "counter", "accesses", "segment",
          "DRAM read accesses")(lambda s: _A(s["dram"]["reads"]))
_register("mem.dram_writes", "counter", "accesses", "segment",
          "DRAM writes (local stores + posted remote writes)")(
    lambda s: _A(s["dram"]["writes"]))
_register("mem.store_log_watermark", "gauge", "stores", "segment",
          "sticky per-quantum DRAM store-log high-water mark (vs "
          "VPConfig.store_log)")(
    lambda s: _A(s["stats"]["store_peak"]))
_register("cim.dense_ops", "counter", "ops", "unit",
          "dense VMM OPs completed per CIM unit")(
    lambda s: _A(s["cims"]["ops"]))
_register("snn.ticks", "counter", "ticks", "unit",
          "LIF ticks fired per spike-mode unit")(
    lambda s: _A(s["cims"]["ticks"]))
_register("snn.spikes_emitted", "counter", "spikes", "unit",
          "spikes emitted per spike-mode unit (stripe owner counters)")(
    lambda s: _A(s["cims"]["spikes_total"]))
_register("snn.spikes_in", "counter", "spikes", "unit",
          "AER spike events integrated per unit (consumed-side traffic; "
          "snn.consumed_rates aggregates this per stripe group)")(
    lambda s: _A(s["cims"]["spikes_in"]))
_register("snn.spikes_consumed", "counter", "spikes", "segment",
          "AER spike events integrated per segment")(
    lambda s: _A(s["stats"]["spikes_consumed"]))
_register("snn.mmio_late", "counter", "ops", "segment",
          "hybrid MMIO ops that violated their tick-grid deadline "
          "(sticky; nonzero raises in the controller)")(
    lambda s: _A(s["stats"]["snn_mmio_late"]))
_register("channel.inbox_lost", "counter", "messages", "segment",
          "messages discarded by truncating inbox merges (nonzero only "
          "under faults.FaultConfig(on_overflow='drop'); otherwise the "
          "inbox watermark aborts first)", source="pending")(
    lambda p: _A(p["lost_total"]))


# fault-injection counters (repro_torch.faults): the stats keys exist only when
# the platform was built with the matching fault family enabled — the
# extractors report zeros otherwise, so collect() stays total
def _stat_or_zeros(s, key):
    st = s["stats"]
    return _A(st[key]) if key in st else np.zeros_like(_A(st["instrs"]))


_register("faults.spikes_dropped", "counter", "spikes", "segment",
          "AER spikes lost in flight to seeded transport faults "
          "(faults.FaultConfig.p_spike_drop)")(
    lambda s: _stat_or_zeros(s, "spikes_dropped"))
_register("faults.spikes_duped", "counter", "spikes", "segment",
          "AER spikes delivered twice by seeded transport faults "
          "(faults.FaultConfig.p_spike_dup)")(
    lambda s: _stat_or_zeros(s, "spikes_duped"))
_register("faults.outbox_lost", "counter", "spikes", "segment",
          "messages truncated at the outbox under the graceful-degradation "
          "overflow policy (faults.FaultConfig(on_overflow='drop'))")(
    lambda s: _stat_or_zeros(s, "outbox_lost"))


def collect(states, pending=None) -> dict:
    """Snapshot every registered metric from stacked state.

    Returns ``{name: ndarray}`` — counters/gauges are ``(S,)`` or
    ``(S, n_units)``, the histogram ``(S, 8)``.  ``pending``-sourced
    metrics (channel occupancy/watermark/routed) are skipped when no
    pending box is supplied.
    """
    out = {}
    for m in REGISTRY.values():
        if m.source == "pending":
            if pending is None:
                continue
            out[m.name] = m.extract(pending)
        else:
            out[m.name] = m.extract(states)
    return out


def describe() -> list:
    """Registry rows (name, kind, unit, per, description) for docs/tools."""
    return [(m.name, m.kind, m.unit, m.per, m.description)
            for m in REGISTRY.values()]


def legacy_stats(states) -> dict:
    """The historical ``Controller.stats()`` dict, bit-for-bit.

    Kept as a thin view over the registry's sources so existing callers
    (benchmarks, examples, tests) keep working; new code should prefer
    ``Controller.metrics()`` / ``collect``.  The shape of this dict is a
    compatibility contract — tests/test_obs.py pins it.
    """
    st = states["stats"]
    return {
        "instructions": _A(st["instrs"]),
        "messages": _A(st["msgs"]),
        "txn_histogram": _A(st["txn_hist"]).sum(0),
        "cache": {
            "d_hits": _A(states["dcache"]["hits"]),
            "d_misses": _A(states["dcache"]["misses"]),
        },
        "dram": {
            "reads": _A(states["dram"]["reads"]),
            "writes": _A(states["dram"]["writes"]),
        },
        "cim_ops": _A(states["cims"]["ops"]),
        "snn": {
            "spikes": _A(states["cims"]["spikes_total"]),
            "ticks": _A(states["cims"]["ticks"]),
        },
    }
