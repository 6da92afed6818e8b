"""VP segmentation strategies and the platform builder (counterpart of
``repro/core/segmentation.py``).

``build`` assembles the stacked simulation state on the host and moves it
to the device once.  This slice builds the CPU-free platforms the spiking
path needs (``crossbars=`` and ``cim_init=``); programs, DRAM images and
scratch presets come with the dense slice (ROADMAP module item 6), fault
injection with ROADMAP module item 9.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import channel as ch
from repro_torch.vp import isa
from repro_torch.vp import platform as pf

# scratch mailbox layout (word offsets): unit k of a manager flags at
# FLAG0 + k and writes its outputs at OUT0 + 256 * k
FLAG0 = 0
OUT0 = 256


@dataclasses.dataclass
class SegmentDesc:
    cpu: bool = False
    dram: bool = False
    n_cims: int = 0
    cim_mgr: int = -1  # segment id of the managing CPU


def uniform(n_cpus: int = 2, cims_per_cpu: int = 2):
    return [
        SegmentDesc(cpu=True, dram=(i == 0), n_cims=cims_per_cpu, cim_mgr=i)
        for i in range(n_cpus)
    ]


def load_oriented():
    return [
        SegmentDesc(cpu=True, dram=True),
        SegmentDesc(cpu=True),
        SegmentDesc(n_cims=2, cim_mgr=1),
        SegmentDesc(n_cims=2, cim_mgr=1),
    ]


def build(descs, *, programs=None, dram_words=None, crossbars=None,
          scratch_init=None, cim_init=None, channel_latency: int = 10_000,
          local_latency: int = 64, use_kernel: bool = False,
          in_cap: int | None = None, out_cap: int | None = None,
          store_log: int | None = None, faults=None, fault_uids=None,
          device=None):
    """Assemble the stacked simulation state; returns ``(cfg, states,
    pending)`` with every tensor on ``device`` (default: the GPU).

    crossbars: {global_cim_id: np.int8 (R, C)} preloaded weights
    cim_init: {global_cim_id: {field: value}} per-slot CIM state presets
    in_cap/out_cap/store_log: channel-box and store-log capacities
    """
    if programs or dram_words is not None or scratch_init:
        raise NotImplementedError(
            "programs=, dram_words= and scratch_init= (live CPUs) come with "
            "ROADMAP module item 6")
    if faults is not None or fault_uids is not None:
        raise NotImplementedError("fault injection comes with ROADMAP module item 9")
    device = tree.resolve_device(device)
    if channel_latency < local_latency:
        raise ValueError("intra-segment hops cannot be slower than cross-segment channels")
    # the SNN bit-exactness guarantee (tick-bucketed AER delivery) requires
    # every ticking spike-mode unit's tick to cover one channel hop
    for g, fields in (cim_init or {}).items():
        if int(fields.get("mode", 0)) == isa.CIM_MODE_SPIKE and \
                int(fields.get("tick_period", 0)) > 0 and \
                int(fields["tick_period"]) < channel_latency:
            raise ValueError(
                f"cim {g}: tick_period must be >= channel latency (snn/topology.py)")
    n = len(descs)
    cim_seg, cim_slot, mgr_of = [], [], []
    for s, d in enumerate(descs):
        for k in range(d.n_cims):
            cim_seg.append(s)
            cim_slot.append(k)
            mgr_of.append(d.cim_mgr if d.cim_mgr >= 0 else s)
    snn_fanout = 1
    snn_grouped = False
    for g, fields in (cim_init or {}).items():
        if "dst_seg" in fields:
            snn_fanout = max(snn_fanout, int(np.size(fields["dst_seg"])))
        if "owner_slot" in fields and int(fields["owner_slot"]) != cim_slot[g]:
            snn_grouped = True
    periods = sorted({
        int(f["tick_period"]) for f in (cim_init or {}).values()
        if int(f.get("mode", 0)) == isa.CIM_MODE_SPIKE
        and int(f.get("tick_period", 0)) > 0
    })
    if len(periods) > 1:
        raise ValueError(
            f"spike-mode units disagree on tick_period ({periods}): the AER tick "
            "grid — and tick-addressed CPU spike injection — is global")
    cfg = pf.VPConfig(
        n_segments=n,
        in_cap=pf.IN_CAP if in_cap is None else in_cap,
        out_cap=pf.OUT_CAP if out_cap is None else out_cap,
        store_log=pf.STORE_LOG if store_log is None else store_log,
        # only a preset in-flight dense OP makes the CPU machinery live here
        # (programs are refused above, so every CPU halts at build time)
        has_cpu=any("state" in f or "busy_until" in f
                    for f in (cim_init or {}).values()),
        n_cim_slots=max([2] + [d.n_cims for d in descs]),
        dram_segment=next((i for i, d in enumerate(descs) if d.dram), 0),
        channel_latency=channel_latency,
        local_latency=local_latency,
        cim_seg=tuple(cim_seg),
        cim_slot=tuple(cim_slot),
        use_kernel=use_kernel,
        has_snn=any(int(f.get("mode", 0)) == isa.CIM_MODE_SPIKE
                    for f in (cim_init or {}).values()),
        snn_fanout=snn_fanout,
        snn_grouped=snn_grouped,
        snn_tick_period=periods[0] if periods else 0,
        faults=faults,
    )
    # per-segment states are built as host tensors and edited in place
    states = []
    for s, d in enumerate(descs):
        st = pf.segment_state(cfg)
        st["seg_id"].fill_(s)
        st["cpu"]["present"].fill_(d.cpu)
        # CPUs without a program halt immediately and never un-halt
        st["cpu"]["halted"].fill_(d.cpu)
        st["dram_present"].fill_(d.dram)
        st["cims"]["present"][: d.n_cims] = True
        states.append(st)

    # manager mailbox of unit g managed by CPU segment m: per-manager ordinal
    per_mgr_count: dict[int, int] = {}
    for g, (s, k) in enumerate(zip(cim_seg, cim_slot)):
        m = mgr_of[g]
        idx = per_mgr_count.get(m, 0)
        per_mgr_count[m] = idx + 1
        cims = states[s]["cims"]
        cims["mgr_seg"][k] = m
        cims["flag_addr"][k] = FLAG0 + idx
        cims["out_addr"][k] = OUT0 + idx * 256
        if crossbars and g in crossbars:
            src = np.asarray(crossbars[g], np.int8)
            cims["weights"][k, : src.shape[0], : src.shape[1]] = torch.from_numpy(src)
        for f, val in (cim_init or {}).get(g, {}).items():
            cims[f][k] = torch.as_tensor(np.asarray(val)).to(cims[f].dtype)

    stacked = tree.stack(states)
    stacked = tree.tree_map(lambda x: x.to(device), stacked)
    pending = ch.empty_pending(cfg.in_cap, (n,), device)
    return cfg, stacked, pending

