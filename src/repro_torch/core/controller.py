"""Simulation controller: quantum stepping and time-decoupled
synchronization (counterpart of ``repro/core/controller.py``).

Per round (the paper's ``exec`` + ``sync``):

  limit_i = min_{j != i} (time_j + latency[j, i])      # decoupling bound
  states'_i, outbox_i = segment_step(states_i, pending_i, limit_i)
  pending' = merge(pending, route(outboxes))           # sync

Backends for the ``exec`` phase:
  sequential — segments stepped one after another, each as a one-segment
               stack (the conventional SystemC baseline, "sq");
  threads    — one host thread per segment, each stepping its one-segment
               stack, in a persistent pool of ``vp-seg`` workers (the
               paper's literal mechanism); on the card each worker issues
               its segment's step on a CUDA stream of its own;
  vmap       — all segments stepped as one batched step over the leading
               segment axis (the default, "pll").

All three give bit-identical results.  A round issues no host sync.  On
``vmap``, ``run()`` defaults to the reference's fused dispatch: up to
``rounds_per_dispatch`` rounds per host dispatch, the termination and
watermark flags evaluated on the device at every ``check_every``-th round,
and one host fetch of ``(rounds run, done, over)`` per dispatch
(``_HOST_FETCH``).  On the card the dispatch is a CUDA graph captured
once per controller: a WHILE node on the device-side ``running`` flag runs
round after round and stops on the card at ``done``, ``over`` or the
dispatch's last round, with the flag check in an IF node on the check
point; one launch a dispatch.  On the CPU the same round and check bodies
run eagerly.  ``sequential`` and ``threads``
keep their per-round host loop, as the reference's host-loop backends do.
Results, ``rounds_run`` and every watermark message equal the reference's
on every path.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time as _time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import channel as ch
from repro_torch.vp import platform as pf

_BIG = 2**30

# dtypes _foreach_copy_ takes on every device; any other leaf copies alone
_FOREACH_DTYPES = (torch.int32, torch.bool, torch.int8, torch.int64, torch.float32)


def _device_get(x):
    return x.cpu()


# the single host-transfer primitive of the fused dispatch: one copy of the
# (rounds run, done, over) tuple per dispatch, through ``Controller._fetch``,
# so tests can monkeypatch it to count device syncs
_HOST_FETCH = _device_get


def _own(x):
    return x.clone(memory_format=torch.contiguous_format)


def _assign(dst, src):
    """Copy every leaf of the tree ``src`` that is not ``dst``'s own tensor
    into ``dst``'s (the same keys, shapes and dtypes), with one foreach
    copy.  A source that shares storage with any of ``dst``'s leaves is
    cloned first, so no copy reads a buffer another copy writes."""
    want, got = tree.leaves(dst), tree.leaves(src)
    if [p for p, _ in want] != [p for p, _ in got]:
        raise RuntimeError("fused dispatch: a round changed the state tree's keys")
    pairs = [(d, s) for (_, d), (_, s) in zip(want, got) if s is not d]
    if not pairs:
        return
    for (path, d), (_, s) in zip(want, got):
        if s.shape != d.shape or s.dtype != d.dtype:
            raise RuntimeError(f"fused dispatch: leaf {path} changed from {d.dtype} "
                               f"{tuple(d.shape)} to {s.dtype} {tuple(s.shape)}")
    owned = {d.untyped_storage().data_ptr() for _, d in want}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in owned else s)
             for d, s in pairs]
    fast = [p for p in pairs if p[0].dtype in _FOREACH_DTYPES]
    if fast:
        torch._foreach_copy_([d for d, _ in fast], [s for _, s in fast])
    for d, s in pairs:
        if d.dtype not in _FOREACH_DTYPES:
            d.copy_(s)


def _copy(src):
    """A new tree holding the values of ``src`` (one foreach copy)."""
    dst = tree.tree_map(torch.empty_like, src)
    _assign(dst, src)
    return dst


class _Dispatch:
    """The fused dispatch's buffers on the controller's device: the (S, ...)
    state and pending trees that the rounds read and are copied back into,
    ``args`` = (r0, k, check_every) set by the host per dispatch, ``out`` =
    (rounds run, done, over) fetched once per dispatch, and the predicates
    of the dispatch graph's WHILE node (``running``) and of the check's IF
    node (``at``)."""

    def __init__(self, states, pending):
        self.states = tree.tree_map(_own, states)
        self.pending = tree.tree_map(_own, pending)
        dev = states["time"].device
        self.args = torch.zeros(3, dtype=torch.int32, device=dev)
        self.out = torch.zeros(3, dtype=torch.int32, device=dev)
        self.running = torch.zeros((), dtype=torch.bool, device=dev)
        self.at = torch.zeros((), dtype=torch.bool, device=dev)  # a check point

    def start(self, r0, k, check_every):
        """Device fills only: no host-to-device copy, no sync."""
        for x, v in zip(self.args, (r0, k, check_every)):
            x.fill_(v)
        self.out.zero_()
        self.running.fill_(True)


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
        self._pool = None  # the threads backend's workers, made below
        if self.backend == "shard_map" or self.mesh is not None:
            raise NotImplementedError(
                "multi-device backends come with ROADMAP module item 12")
        if self.backend not in ("sequential", "threads", "vmap"):
            raise ValueError(self.backend)
        self.device = tree.resolve_device(self.device)
        self.dispatches = 0  # fused dispatches issued
        self.dispatch_syncs = 0  # _HOST_FETCH calls from the fused dispatch
        self.capture_seconds = None  # warm-up and capture of the dispatch graph
        self._disp = None  # the fused dispatch's buffers, made at its first use
        self._graph = None  # its dispatch graph (on the card)
        # own the state: the caller's tensors are never shared with a run
        self.states = tree.tree_map(lambda x: x.to(self.device, copy=True), self.states)
        self.pending = tree.tree_map(lambda x: x.to(self.device, copy=True), self.pending)
        self._finished = False  # a run() observed clean termination
        self._closed = False  # close() was called
        # the CPU-free step is only valid while nothing but AER spikes can
        # circulate: a hand-injected MMIO/DMA message in the initial inbox
        # needs the full step (one host check at construction)
        if not self.cfg.has_cpu:
            injected = self.pending["valid"] & (self.pending["kind"] != ch.MSG_SPIKE)
            if bool(injected.any()):
                self.cfg = dataclasses.replace(self.cfg, has_cpu=True)
        self.lat = self.cfg.latency_matrix(self.device)
        self._step = pf.make_segment_step(self.cfg, self.quantum, self.obs)
        self._step.prepare(self.device)
        s = self.cfg.n_segments
        self._eye = torch.eye(s, dtype=torch.bool, device=self.device)
        # sequential and threads keep per-segment state as persistent lists
        self._list_mode = self.backend in ("sequential", "threads")
        if self._list_mode:
            self._states_l = [tree.take(self.states, i) for i in range(s)]
            self._pending_l = [tree.take(self.pending, i) for i in range(s)]
        if self.backend == "threads":
            # one persistent pool for the controller's life: a pool made and
            # torn down every round would charge the paper's parallel
            # mechanism thread spawns and joins per quantum
            self._pool = cf.ThreadPoolExecutor(max_workers=s, thread_name_prefix="vp-seg")
            self._streams = None
            if self.device.type == "cuda":
                # each worker issues its segment's step on a stream of its
                # own; ``_ready`` (recorded on the controller's stream once
                # the round's limits are made) gates them, each worker's
                # ``_done`` event gates the controller's route and merge
                self._streams = [torch.cuda.Stream(self.device) for _ in range(s)]
                self._ready = torch.cuda.Event()
                self._done = [torch.cuda.Event() for _ in range(s)]

    # ------------------------------------------------------------------
    def _limits(self, times):
        # limit_i = min_{j != i}(t_j + lat[j, i]); single segment: t + q
        if self.cfg.n_segments == 1:
            return times + self.quantum
        tl = torch.where(self._eye, _BIG, times.unsqueeze(1) + self.lat)
        return tl.min(dim=0).values

    def _require_open(self):
        if self._closed:
            raise RuntimeError(
                "Controller is closed: close() released its host resources "
                "(the threads backend's worker pool); build a new Controller "
                "to run again"
            )

    def _vmap_round(self, states, pending):
        lim = self._limits(states["time"])
        states, outboxes, pending = self._step(states, pending, lim)
        fresh = ch.route(outboxes, self.lat, self.cfg.in_cap)
        return states, ch.merge_pending(pending, fresh)

    def _segment_step(self, i, lim):
        """Segment ``i``'s step as a one-segment stack, under the decoupling
        bound ``lim[i]``.  On the threads backend's card path it runs on
        the worker's stream, after the round's ``_ready`` event, and records
        the worker's ``_done`` event.

        No tensor here needs ``record_stream``.  A block the caching
        allocator hands a worker's stream was last read on the controller's
        stream before a later round's ``_ready`` record (the controller
        drops a round's outboxes and states only after reading them), and
        every later launch on the worker's stream waits on that record.  A
        block of the controller's stream that a worker reads (the limits,
        the merged inboxes) is dropped only after the controller's stream
        waited on every worker's ``_done`` event, so it is reused only by
        work ordered after the worker's reads."""
        st, pen = self._states_l[i], self._pending_l[i]
        if self._pool is None or self._streams is None:
            return self._step(st, pen, lim[i:i + 1])
        stream = self._streams[i]
        with torch.cuda.stream(stream):
            stream.wait_event(self._ready)
            out = self._step(st, pen, lim[i:i + 1])
            self._done[i].record(stream)
        return out

    def round(self):
        self._require_open()
        if self.backend == "vmap":
            self.states, self.pending = self._vmap_round(self.states, self.pending)
        else:
            s = self.cfg.n_segments
            lim = self._limits(torch.cat([st["time"] for st in self._states_l]))
            if self._pool is None:
                results = [self._segment_step(i, lim) for i in range(s)]
            else:
                if self._streams is not None:
                    current = torch.cuda.current_stream(self.device)
                    self._ready.record(current)
                # list() reads every future: a worker's exception raises here
                results = list(self._pool.map(self._segment_step, range(s), [lim] * s))
                if self._streams is not None:
                    for done in self._done:
                        current.wait_event(done)
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
        """Release host resources (the threads backend's persistent pool).
        Idempotent; a closed controller refuses to ``run``/``round`` with
        the reference's error.  Reading results (``result_states``/
        ``sim_time``/``done``) stays valid."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._pool = None
        self._closed = True

    def __del__(self):
        pool = self.__dict__.get("_pool")
        if pool is not None:
            pool.shutdown(wait=False)

    def _fetch(self, x):
        """The dispatch-boundary host sync: one ``_HOST_FETCH`` of the
        (rounds run, done, over) tuple, counted so the one-sync-per-dispatch
        contract is testable."""
        self.dispatch_syncs += 1
        return _HOST_FETCH(x)

    def _round_body(self, d):
        """One round over the buffers ``d``, copied back into them, and the
        reference megaloop's carry step: ``i += 1``, ``done = over = 0``,
        ``at`` = this is a check point, ``running = i < k``."""
        r0, k, check_every = d.args
        i, done, over = d.out
        states, pending = self._vmap_round(d.states, d.pending)
        _assign(d.states, states)
        _assign(d.pending, pending)
        i.add_(1)
        done.zero_()
        over.zero_()
        d.at.copy_((r0 + i) % check_every == 0)
        d.running.copy_(i < k)

    def _check_body(self, d):
        """The flags at a check point: ``done``, ``over`` and ``running``."""
        i, done, over = d.out
        fin, in_over, out_over, st_over, late, _trace = pf.termination_flags(
            d.states, d.pending, self.cfg.in_cap, self.cfg.out_cap, self.cfg.store_log)
        # under the drop policy channel overflow is counted loss; the store
        # log and late MMIO stay fatal
        bad = st_over | late if self._drop() else in_over | out_over | st_over | late
        done.copy_(fin & ~bad)
        over.copy_(bad)
        d.running.copy_(~(fin | bad) & (i < d.args[1]))

    def _eager(self, d):
        """The dispatch graph's loop run on the host (the CPU path): rounds
        while ``running`` holds, each round's check where ``at`` holds."""
        while bool(d.running):
            self._round_body(d)
            if bool(d.at):
                self._check_body(d)

    def capture(self):
        """Warm up and capture the fused dispatch on the card (once per
        controller; ``run`` does it at its first fused dispatch).  The
        warm-up runs one round and one check on a throwaway copy of the
        state: each kernel's first load, the platform's device tables and
        the allocator settle outside the capture.  Then the round body and
        the check body are captured as two graphs and built into the
        dispatch graph (``kernels/dispatch_graph``): a WHILE node on the
        device-side ``running`` flag around a round, whose check sits in an
        IF node on ``at``.  A failure raises: there is no eager fallback.
        Returns the seconds taken."""
        from repro_torch.kernels.dispatch_graph import DispatchGraph

        if self.device.type != "cuda":
            raise ValueError(f"capture runs on the card, not on {self.device}")
        if self._graph is not None:
            return self.capture_seconds
        t0 = _time.perf_counter()
        scratch = _Dispatch(self.states, self.pending)
        scratch.start(0, 1, 1)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._round_body(scratch)
            self._check_body(scratch)
        current.wait_stream(side)
        del scratch
        d = self._buffers()
        round_graph, check_graph = (torch.cuda.CUDAGraph(keep_graph=True) for _ in range(2))
        with torch.cuda.graph(round_graph):
            self._round_body(d)
        with torch.cuda.graph(check_graph):
            self._check_body(d)
        self._graph = DispatchGraph(round_graph, check_graph, d.running, d.at)
        torch.cuda.synchronize(self.device)
        self.capture_seconds = _time.perf_counter() - t0
        return self.capture_seconds

    def _buffers(self):
        """The fused dispatch's buffers, made from the live trees at the
        first use; the live trees then are the buffers."""
        if self._disp is None:
            self._disp = _Dispatch(self._states, self._pending)
            self.states, self.pending = self._disp.states, self._disp.pending
        return self._disp

    def _dispatch(self, r0, k, check_every):
        """One fused dispatch of up to ``k`` rounds; returns (rounds run,
        done, over) after one host fetch."""
        if self.device.type == "cuda":
            self.capture()
        d = self._buffers()
        # round() (or a caller) may have rebound the live trees: bring them
        # into the buffers; a copy handed out before stays the caller's
        _assign(d.states, self._states)
        _assign(d.pending, self._pending)
        self.states, self.pending = d.states, d.pending
        d.start(r0, k, check_every)
        if self._graph is not None:
            self._graph.replay()
        else:
            self._eager(d)
        self.dispatches += 1
        ran, done, over = self._fetch(d.out).tolist()
        return ran, bool(done), bool(over)

    def run(self, max_rounds: int = 10_000, check_every: int = 4,
            fused: bool | None = None, rounds_per_dispatch: int = 256,
            on_telemetry=None):
        """Run to completion; returns (rounds, host_seconds).

        ``vmap`` defaults to the fused dispatch (``fused=True``): up to
        ``rounds_per_dispatch`` rounds per host dispatch, the termination
        predicate and the overflow watermarks evaluated on the device at
        every ``check_every``-th round since this call started, one host
        fetch per dispatch.  ``fused=False``, and ``sequential`` and
        ``threads`` always, run the per-round host loop with the flags read
        at the same rounds.
        Both give the reference's results, ``rounds_run`` and overflow
        errors.  ``on_telemetry`` is accepted for the reference's signature
        and unused: telemetry (``obs``) is refused at construction.
        """
        del on_telemetry
        t0 = _time.perf_counter()
        self._require_open()
        if self._finished:
            # termination is final: a second run() on a finished controller
            # must not burn rounds
            return self.rounds_run, _time.perf_counter() - t0
        if rounds_per_dispatch < 1:
            raise ValueError("rounds_per_dispatch must be >= 1")
        if fused is None:
            fused = self.backend == "vmap"
        if fused and self.backend == "vmap":
            if check_every < 1:
                raise ValueError("check_every must be >= 1")
            done = over = False
            ran = 0
            while ran < max_rounds:
                i, done, over = self._dispatch(
                    ran, min(rounds_per_dispatch, max_rounds - ran), check_every)
                ran += i
                self.rounds_run += i
                if done or over:
                    break
            if over or not done:
                # a watermark tripped at a check point, or max_rounds ran
                # out before the predicate saw the last rounds
                self._check_overflow()
            self._finished = done and not over
            # the last fetch waited for the stream: nothing is left to wait for
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


def _tree_property(name):
    """``Controller.states``/``.pending``: the live tree, except while it is
    the fused dispatch's buffers, which the next dispatch overwrites in
    place; then a copy, made at the first read after a dispatch, so a tree
    read from a controller stays as it was when the controller runs on."""
    live, copy = "_" + name, "_" + name + "_copy"

    def get(self):
        tree_ = self.__dict__[live]
        d = self.__dict__.get("_disp")
        if d is None or tree_ is not getattr(d, name):
            return tree_
        if self.__dict__.get(copy) is None:
            self.__dict__[copy] = _copy(tree_)
        return self.__dict__[copy]

    def set(self, value):
        self.__dict__[live] = value
        self.__dict__[copy] = None

    return property(get, set)


Controller.states = _tree_property("states")
Controller.pending = _tree_property("pending")
