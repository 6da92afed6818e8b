"""Simulation controller: quantum stepping and time-decoupled
synchronization (counterpart of ``repro/core/controller.py``).

Per round (the paper's ``exec`` + ``sync``):

  limit_i = min_{j != i} (time_j + latency[j, i])      # decoupling bound
  states'_i, outbox_i = segment_step(states_i, pending_i, limit_i)
  pending' = merge(pending, route(outboxes))           # sync

Backends for the ``exec`` phase:
  sequential — segments stepped one after another, each as a one-segment
               stack (the conventional SystemC baseline, "sq");
  vmap       — all segments stepped as one batched step over the leading
               segment axis (the default, "pll").

Both give bit-identical results.  A round issues no host sync; the host
reads the termination flags once per check point, at exactly the rounds
the reference evaluates them, so ``rounds_run`` and every watermark
message equal the reference's.  The reference's device-resident fused
dispatch has no counterpart yet: here it is a CUDA-graph-captured round
loop, queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import channel as ch
from repro_torch.vp import isa
from repro_torch.vp import platform as pf

_BIG = 2**30


@dataclasses.dataclass
class Controller:
    cfg: pf.VPConfig
    states: object  # stacked (S, ...) tree of tensors
    pending: object  # stacked (S, in_cap)
    backend: str = "vmap"
    quantum: int = 10_000
    mesh: object = None  # shard_map backend only (not in this slice)
    rounds_run: int = 0
    obs: object = None  # telemetry (not in this slice)
    device: object = None  # None = the GPU

    def __post_init__(self):
        if self.obs is not None:
            raise NotImplementedError("telemetry (obs=) comes with ROADMAP module item 10")
        if self.backend == "threads":
            raise NotImplementedError(
                "the threads backend is queued in ROADMAP.md (module item 5b)")
        if self.backend == "shard_map" or self.mesh is not None:
            raise NotImplementedError(
                "multi-device backends come with ROADMAP module item 12")
        if self.backend not in ("sequential", "vmap"):
            raise ValueError(self.backend)
        self.device = tree.resolve_device(self.device)
        # own the state: the caller's tensors are never shared with a run
        self.states = tree.tree_map(lambda x: x.to(self.device, copy=True), self.states)
        self.pending = tree.tree_map(lambda x: x.to(self.device, copy=True), self.pending)
        self._finished = False  # a run() observed clean termination
        # the CPU-free step is only valid while nothing but AER spikes can
        # circulate: a hand-injected MMIO/DMA message in the initial inbox
        # needs the full step (one host check at construction)
        if not self.cfg.has_cpu:
            injected = self.pending["valid"] & (self.pending["kind"] != ch.MSG_SPIKE)
            if bool(injected.any()):
                self.cfg = dataclasses.replace(self.cfg, has_cpu=True)
        if self.cfg.has_cpu and self.cfg.has_snn:
            # a spiking platform takes the full step with every CPU halted
            # and no spike-count readback asked for: a live CPU beside
            # spike-mode units (tick-addressed CIM_REG_SPIKE stores) or a
            # CIM_REG_COUNTS request makes a hybrid job
            cpu, pen = self.states["cpu"], self.pending
            counts = pen["valid"] & (pen["kind"] == ch.MSG_W_CIM) & (
                (pen["addr"] & 0xFFFF) == isa.CIM_REG_COUNTS)
            if bool((cpu["present"] & ~cpu["halted"]).any() | counts.any()
                    | (self.states["cims"]["count_req"] >= 0).any()):
                raise NotImplementedError(
                    "hybrid dense+spiking jobs (live CPUs beside spike-mode units, "
                    "CIM_REG_COUNTS readbacks) come with ROADMAP module item 8")
        self.lat = self.cfg.latency_matrix(self.device)
        self._step = pf.make_segment_step(self.cfg, self.quantum, self.obs)
        s = self.cfg.n_segments
        self._eye = torch.eye(s, dtype=torch.bool, device=self.device)
        self._list_mode = self.backend == "sequential"
        if self._list_mode:
            self._states_l = [tree.take(self.states, i) for i in range(s)]
            self._pending_l = [tree.take(self.pending, i) for i in range(s)]

    # ------------------------------------------------------------------
    def _limits(self, times):
        # limit_i = min_{j != i}(t_j + lat[j, i]); single segment: t + q
        if self.cfg.n_segments == 1:
            return times + self.quantum
        tl = torch.where(self._eye, _BIG, times.unsqueeze(1) + self.lat)
        return tl.min(dim=0).values

    def round(self):
        if self.backend == "vmap":
            lim = self._limits(self.states["time"])
            self.states, outboxes, pending = self._step(self.states, self.pending, lim)
            fresh = ch.route(outboxes, self.lat, self.cfg.in_cap)
            self.pending = ch.merge_pending(pending, fresh)
        else:
            lim = self._limits(torch.cat([st["time"] for st in self._states_l]))
            results = [self._step(st, pen, lim[i:i + 1]) for i, (st, pen)
                       in enumerate(zip(self._states_l, self._pending_l))]
            self._states_l = [r[0] for r in results]
            fresh = ch.route(tree.cat([r[1] for r in results]), self.lat,
                             self.cfg.in_cap)
            self._pending_l = [ch.merge_pending(r[2], tree.take(fresh, i))
                               for i, r in enumerate(results)]
        self.rounds_run += 1

    def _stacked(self):
        return tree.cat(self._states_l) if self._list_mode else self.states

    def _pending_stacked(self):
        return tree.cat(self._pending_l) if self._list_mode else self.pending

    @staticmethod
    def _flag_detail(flag_name, values, cap, kwarg=None):
        """Shared watermark formatter: names the tripped flag, the first
        segment past the cap, and the cap itself, then the full per-segment
        watermark vector (and the smallest sufficient cap)."""
        values = np.asarray(values)
        seg = int(np.flatnonzero(values > cap)[0])
        hint = "" if kwarg is None else (
            f"; smallest sufficient {kwarg}={int(values.max())}")
        return (f"flag '{flag_name}' tripped first at segment {seg} "
                f"({int(values[seg])} > cap {cap}; per-segment watermarks "
                f"{values.tolist()}{hint})")

    def _drop(self) -> bool:
        """Graceful degradation (``FaultConfig(on_overflow="drop")``): inbox
        and outbox overflow is counted spike loss, not an abort."""
        return self.cfg.faults is not None and self.cfg.faults.drop_overflow

    def _check_overflow(self):
        msg = overflow_error(self._stacked(), self._pending_stacked(),
                             in_cap=self.cfg.in_cap, out_cap=self.cfg.out_cap,
                             store_log=self.cfg.store_log, drop=self._drop())
        if msg is not None:
            raise RuntimeError(msg)

    def done(self) -> bool:
        """Termination check and loud overflow validation: one host read of
        the six flags of ``platform.termination_flags``.  Under the drop
        policy only the store log and late MMIO stay fatal."""
        flags = torch.stack(pf.termination_flags(
            self._stacked(), self._pending_stacked(), self.cfg.in_cap,
            self.cfg.out_cap, self.cfg.store_log)).cpu().tolist()
        d, in_over, out_over, store_over, mmio_late, _trace_over = flags
        if ((in_over or out_over) and not self._drop()) or store_over or mmio_late:
            self._check_overflow()  # raises with the detailed watermark message
        return d

    def block_until_ready(self):
        """Wait for this controller's device work; returns self."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def close(self):
        """Nothing to release on these backends; kept for the reference's
        interface.  Reading results stays valid."""

    def run(self, max_rounds: int = 10_000, check_every: int = 4,
            fused: bool | None = None):
        """Run to completion; returns (rounds, host_seconds).

        The flags are checked after every ``check_every``-th round since
        this call started, as in the reference on every dispatch path, so
        results, ``rounds_run`` and overflow errors equal the reference's.
        """
        if fused:
            raise NotImplementedError(
                "fused device-resident dispatch is queued in ROADMAP.md "
                "(CUDA-graph round loop, module item 5a)")
        t0 = _time.perf_counter()
        if self._finished:
            # termination is final: a second run() on a finished controller
            # must not burn rounds
            return self.rounds_run, _time.perf_counter() - t0
        for r in range(max_rounds):
            self.round()
            if (r + 1) % check_every == 0 and self.done():
                self._finished = True
                break
        else:
            self._check_overflow()  # done() may never have seen the last rounds
        self.block_until_ready()
        return self.rounds_run, _time.perf_counter() - t0

    # ------------------------------------------------------------------
    def result_states(self):
        """Stacked (S, ...) states regardless of backend."""
        return self._stacked()

    def sim_time(self):
        return self._stacked()["time"].cpu().numpy()


def overflow_error(states, pending, *, in_cap: int, out_cap: int,
                   store_log: int, drop: bool = False):
    """The detailed watermark error message, or ``None`` when clean — the
    reference's formatter, byte for byte.  With ``drop`` (graceful
    degradation) inbox and outbox overflow is no error."""
    watermark = pending["max_count"].cpu().numpy()
    if not drop and (watermark > in_cap).any():
        return (
            "pending inbox overflow: "
            f"{Controller._flag_detail('inbox', watermark, in_cap, 'in_cap')}; "
            "raise in_cap (builder kwarg) or thin the workload's traffic"
        )
    out_peak = states["stats"]["outbox_peak"].cpu().numpy()
    if not drop and (out_peak > out_cap).any():
        return (
            "outbox overflow: "
            f"{Controller._flag_detail('outbox', out_peak, out_cap, 'out_cap')}; "
            "raise out_cap (builder kwarg) or thin the workload's traffic"
        )
    store_peak = states["stats"]["store_peak"].cpu().numpy()
    if (store_peak > store_log).any():
        return (
            "DRAM store-log overflow: "
            f"{Controller._flag_detail('store_log', store_peak, store_log, 'store_log')}"
            " stores in one quantum; raise store_log "
            "(builder kwarg) or shrink the quantum"
        )
    mmio_late = states["stats"]["snn_mmio_late"].cpu().numpy()
    if (mmio_late > 0).any():
        return (
            "late SNN MMIO ops: "
            f"{Controller._flag_detail('snn_mmio_late', mmio_late, 0)}: a "
            "CIM_REG_SPIKE store executed at/after its target tick's grid "
            "time, or a CIM_REG_COUNTS readback was served after the unit "
            "ticked past the requested count — the result would depend on "
            "round timing, not the tick grid.  Issue the op earlier in "
            "the program, or raise tick_period (builder kwarg) so the "
            "injection window covers it"
        )
    return None
