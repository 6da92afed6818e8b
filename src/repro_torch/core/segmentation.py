"""VP segmentation strategies (paper §IV-C, Fig. 4a/4b) and the platform
builder (counterpart of ``repro/core/segmentation.py``).

``build`` assembles the stacked simulation state on the host and moves it
to the device once: programs, DRAM images, crossbar weights, scratch
presets, CIM state presets and the structural fault sites, for spiking,
dense and hybrid (programs beside spike-mode units) platforms alike.

Strategies:
  uniform        — every CPU segment gets an equal share of CIM-Units
                   (Fig. 4a: 2 segments x {1 CPU, 2 CIM}); DRAM in segment 0
  load_oriented  — one CPU manages all CIM-Units, the other is free; CIMs
                   live in their own segments (Fig. 4b)
  auto           — greedy balanced partition over per-module cost estimates
  traffic        — ``traffic_partition``: stripe groups placed to cut the
                   cross-segment spike traffic (``snn.auto_segmentation_for``)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import faults as flt
from repro_torch import tree
from repro_torch.core import channel as ch
from repro_torch.vp import isa
from repro_torch.vp import platform as pf
from repro_torch.vp.assembler import assemble

# scratch mailbox layout (word offsets): unit k of a manager flags at
# FLAG0 + k and writes its outputs at OUT0 + 256 * k
FLAG0, FLAG1 = 0, 1
OUT0, OUT1 = 256, 512
B_STAGE = 1024  # staged input vectors for offload mode


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


def auto_segmentation(module_costs: dict, n_segments: int):
    """Greedy longest-processing-time partition of modules onto segments.

    module_costs: {"cpu0": c, "cpu1": c, "dram": c, "cim0": c, ...} — host
    cost estimates.  Returns segment descriptors with balanced total cost.
    CPUs anchor segments; DRAM joins the lightest CPU segment; CIMs fill
    greedily, managed by the heaviest CPU.
    """
    cpus = sorted([k for k in module_costs if k.startswith("cpu")])
    cims = sorted(
        [k for k in module_costs if k.startswith("cim")],
        key=lambda k: -module_costs[k],
    )
    n_segments = max(n_segments, len(cpus))
    descs = [SegmentDesc() for _ in range(n_segments)]
    loads = np.zeros(n_segments)
    for i, c in enumerate(cpus):
        descs[i].cpu = True
        descs[i].cim_mgr = i
        loads[i] += module_costs[c]
    d = int(np.argmin(loads[: len(cpus)]))
    descs[d].dram = True
    loads[d] += module_costs.get("dram", 0.0)
    mgr = int(np.argmax(loads[: len(cpus)]))  # heaviest CPU manages offload
    for c in cims:
        s = int(np.argmin(loads))
        descs[s].n_cims += 1
        if descs[s].cim_mgr < 0:
            descs[s].cim_mgr = mgr
        loads[s] += module_costs[c]
    return [d for d in descs if d.cpu or d.dram or d.n_cims]


def traffic_partition(widths, loads, traffic, n_segments: int,
                      slots_per_seg: int, refine_passes: int = 4,
                      pinned=None):
    """Spike-traffic-aware placement of shard groups onto segments.

    widths:  slots each group needs (a column group's ``width`` co-located
             slots are atomic)
    loads:   per-group compute cost (synaptic ops/tick), the tie-breaker
    traffic: (G, G) spike rates, traffic[i, j] events/tick from group i to
             group j (``snn.profile_traffic`` / ``measure_traffic``); the
             diagonal (a stripe's lateral spikes to itself) never crosses a
             segment and is left out of the cut
    pinned:  optional {group_index: segment_id} of groups whose placement
             is fixed (e.g. a hybrid job's injector pseudo-group); they seed
             their segments first and never move

    Minimizes the cross-segment traffic cut under per-segment slot budgets:
    groups are seeded greedily (widest first, then by traffic degree), each
    into the feasible segment with the highest affinity (ties: the fullest
    segment, then the lightest load); then up to ``refine_passes``
    single-move passes relocate any group whose move strictly reduces the
    cut.  Deterministic.  Returns an int array: segment id per group.
    """
    widths = np.asarray(widths, int)
    loads = np.asarray(loads, float)
    traffic = np.asarray(traffic, float)
    pinned = dict(pinned or {})
    g = len(widths)
    assert traffic.shape == (g, g) and len(loads) == g
    traffic = traffic - np.diag(np.diag(traffic))  # self-traffic never cut
    assert widths.max(initial=0) <= slots_per_seg, \
        "a column group is atomic: raise slots_per_seg to its width"
    assert n_segments * slots_per_seg >= widths.sum(), "not enough slots"
    sym = traffic + traffic.T
    assign = np.full(g, -1, int)
    used = np.zeros(n_segments, int)
    load = np.zeros(n_segments, float)

    for i, s in sorted(pinned.items()):
        assert 0 <= s < n_segments, f"pinned group {i} to missing segment {s}"
        assert used[s] + widths[i] <= slots_per_seg, \
            f"pinned group {i} does not fit segment {s}'s slot budget"
        assign[i] = s
        used[s] += widths[i]
        load[s] += loads[i]

    def affinity(i, s):
        members = np.flatnonzero(assign == s)
        return sym[i, members].sum()

    order = sorted((i for i in range(g) if i not in pinned),
                   key=lambda i: (-widths[i], -sym[i].sum(), -loads[i], i))
    for i in order:
        feas = [s for s in range(n_segments) if used[s] + widths[i] <= slots_per_seg]
        if not feas:
            raise AssertionError(
                f"slot budgets too fragmented for a width-{widths[i]} group; "
                "raise n_segments or slots_per_seg"
            )
        s = max(feas, key=lambda s: (affinity(i, s), used[s], -load[s], -s))
        assign[i] = s
        used[s] += widths[i]
        load[s] += loads[i]

    for _ in range(refine_passes):
        moved = False
        for i in range(g):
            if i in pinned:
                continue
            best_s, best_gain = assign[i], 0.0
            here = affinity(i, assign[i])
            for s in range(n_segments):
                if s == assign[i] or used[s] + widths[i] > slots_per_seg:
                    continue
                gain = affinity(i, s) - here
                if gain > best_gain + 1e-12:
                    best_s, best_gain = s, gain
            if best_s != assign[i]:
                used[assign[i]] -= widths[i]
                load[assign[i]] -= loads[i]
                assign[i] = best_s
                used[best_s] += widths[i]
                load[best_s] += loads[i]
                moved = True
        if not moved:
            break
    return assign


def build(descs, *, programs=None, dram_words=None, crossbars=None,
          scratch_init=None, cim_init=None, channel_latency: int = 10_000,
          local_latency: int = 64, use_kernel: bool = False,
          in_cap: int | None = None, out_cap: int | None = None,
          store_log: int | None = None, faults=None, fault_uids=None,
          device=None):
    """Assemble the stacked simulation state; returns ``(cfg, states,
    pending)`` with every tensor on ``device`` (default: the GPU).

    programs: {seg_id: asm_source or np.uint32 array}
    dram_words: np.int32 array preloaded at address 0 of the DRAM segment
    crossbars: {global_cim_id: np.int8 (R, C)} preloaded weights
    scratch_init: {seg_id: {word_offset: np.int32 array}}
    cim_init: {global_cim_id: {field: value}} per-slot CIM state presets
    in_cap/out_cap/store_log: channel-box and store-log capacities
    faults: ``repro_torch.faults.FaultConfig`` or None.  Structural
        crossbar/neuron fault sites are drawn here per unit, inside the
        region of its ``crossbars`` entry; transport and overflow behaviour
        follow the config in the step.  None builds a fault-free tree.
    fault_uids: {global_cim_id: stable_uid}, the placement-invariant unit
        identities of the fault draws (default: the global cim id)
    """
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
        # a CPU whose segment has no program halts at build time and can
        # never un-halt, so only programmed CPUs (or a preset in-flight dense
        # OP) make the instruction machinery live
        has_cpu=(any(d.cpu and s in (programs or {}) for s, d in enumerate(descs))
                 or any("state" in f or "busy_until" in f
                        for f in (cim_init or {}).values())),
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
        # CPUs without a program halt immediately (otherwise they spin on
        # zero words forever) and never un-halt
        st["cpu"]["halted"].fill_(d.cpu and s not in (programs or {}))
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
        if faults is not None:
            uid = (fault_uids or {}).get(g, g)
            if faults.has_transport_faults:
                cims["f_uid"][k] = uid
            if faults.has_xbar_faults or faults.has_neuron_faults:
                # faults land only in the unit's programmed region
                rows, cols = (np.asarray(crossbars[g]).shape
                              if crossbars and g in crossbars else (0, 0))
                masks = flt.unit_masks(faults, uid, rows, cols, cims["weights"].shape[-1])
                fields = (("f_and", "f_xor") if faults.has_xbar_faults else ()) + (
                    ("f_dead", "f_dth") if faults.has_neuron_faults else ())
                for f in fields:
                    cims[f][k] = torch.from_numpy(masks[f])

    if dram_words is not None:
        words = np.asarray(dram_words, np.int32)
        states[cfg.dram_segment]["dram"]["data"][: len(words)] = torch.from_numpy(words)
    for s, prog in (programs or {}).items():
        words = assemble(prog) if isinstance(prog, str) else np.asarray(prog, np.uint32)
        states[s]["prog"][: len(words)] = torch.from_numpy(words.astype(np.uint32))
    for s, inits in (scratch_init or {}).items():
        for off, arr in inits.items():
            arr = np.asarray(arr, np.int32)
            states[s]["scratch"][off: off + len(arr)] = torch.from_numpy(arr)

    stacked = tree.stack(states)
    stacked = tree.tree_map(lambda x: x.to(device), stacked)
    pending = ch.empty_pending(cfg.in_cap, (n,), device)
    return cfg, stacked, pending



def cim_global_base(g: int) -> int:
    return isa.CIM_BASE + g * isa.CIM_STRIDE


def mailbox_ordinals(descs) -> dict[int, int]:
    """global cim id -> mailbox ordinal within its manager CPU's scratch.

    Mirrors build()'s assignment (global-id order within each manager);
    programs must use these ordinals for flag/output addresses — e.g. under
    load-oriented segmentation one CPU manages all four units, so a program
    driving units (0, 2) polls flags 0 and 2, not 0 and 1."""
    mgr_of = []
    for s, d in enumerate(descs):
        for _ in range(d.n_cims):
            mgr_of.append(d.cim_mgr if d.cim_mgr >= 0 else s)
    per_mgr: dict[int, int] = {}
    out = {}
    for g, m in enumerate(mgr_of):
        out[g] = per_mgr.get(m, 0)
        per_mgr[m] = out[g] + 1
    return out
