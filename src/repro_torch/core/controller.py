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
               segment axis (the default, "pll");
  shard_map  — one mesh device per segment (a ``DeviceMesh`` from
               ``launch/mesh``, one process per device, every rank running
               the same program): each rank steps its own segment, and
               routing is an all-gather of the segments' times and outboxes
               over the mesh (NCCL on the card, gloo on the CPU).

All four give the reference's results (``shard_map`` keeps its quirk F6:
with one segment its limit is 2^30, not ``t + quantum``).  A round issues
no host sync.  On ``vmap``, ``run()`` defaults to the reference's fused dispatch: up to
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
``shard_map`` runs the reference's fused dispatch with its rounds issued by
the host (NCCL collectives are not captured into the dispatch graph): at
each check point the flags are reduced across ranks and read on the host,
and the dispatch ends with one fetch.  Its reads (``result_states``,
``stats``, ``metrics``, the watermark messages) gather the global tree on
every rank.
Results, ``rounds_run`` and every watermark message equal the reference's
on every path.

Telemetry (``obs=TraceConfig(...)``): a trace ring per segment rides the
state tree, so the step appends to it on every backend and the captured
dispatch carries it; the dispatch's one fetch brings it back
(``trace_events``, ``trace_lost``).  ``stats()``/``metrics()`` read the
counters the state already holds.  ``job_mega_fn`` below is the serving
job axis: J platforms in one dispatch (``serve/snn_serve.py``).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time as _time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core import channel as ch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.vp import platform as pf

_BIG = 2**30

# dtypes _foreach_copy_ takes on every device; any other leaf copies alone
_FOREACH_DTYPES = (torch.int32, torch.bool, torch.int8, torch.int64, torch.float32)


_PINNED = {}  # (leaf index, shape, dtype, device) -> the fetch's pinned host buffer


def _device_get(x):
    """The tensors of the tree ``x`` (tuples and dicts) on the host: on the
    card, numpy copies, each leaf copied without blocking into a pinned host
    buffer and the stream waited for once, however many leaves the fetch
    holds; a CPU tensor comes back as itself (``.cpu()``), to be read
    before the next dispatch."""
    leaves, stream = [], None

    def get(t):
        nonlocal stream
        if t.device.type != "cuda":
            return t.cpu()
        key = (len(leaves), tuple(t.shape), t.dtype, t.device)
        leaves.append(key)
        if key not in _PINNED:
            _PINNED[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        stream = torch.cuda.current_stream(t.device)
        return _PINNED[key].copy_(t, non_blocking=True)

    out = tree.tree_map(get, x)
    if stream is None:
        return out
    stream.synchronize()
    return tree.tree_map(lambda b: b.numpy().copy(), out)


# the single host-transfer primitive of the fused dispatch: one fetch of the
# (rounds run, done, over) tuple, and of the trace rings with telemetry on,
# per dispatch, through ``Controller._fetch``, so tests can monkeypatch it
# to count device syncs
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
    mesh: object = None  # shard_map backend only: a 1-D DeviceMesh
    rounds_run: int = 0
    obs: object = None  # obs.trace.TraceConfig, or None = no telemetry op in the step
    device: object = None  # None = the GPU

    def __post_init__(self):
        self._pool = None  # the threads backend's workers, made below
        if self.backend not in ("sequential", "threads", "vmap", "shard_map"):
            raise ValueError(self.backend)
        self._shard = self.backend == "shard_map"
        whole_pending = self.pending
        if self._shard:
            # this rank keeps its own segment, as a one-segment stack
            self._seg = self._mesh_setup()
            self.states = tree.take(self.states, self._seg)
            self.pending = tree.take(self.pending, self._seg)
        else:
            self.device = tree.resolve_device(self.device)
        self.dispatches = 0  # fused dispatches issued
        self.dispatch_syncs = 0  # _HOST_FETCH calls from the fused dispatch
        self.check_syncs = 0  # shard_map: host reads of the reduced flags at check points
        self.trace_lost = 0  # telemetry records dropped to ring capacity
        self._events = []  # drained batches (numpy EVENT_DTYPE arrays)
        self.capture_seconds = None  # warm-up and capture of the dispatch graph
        self._disp = None  # the fused dispatch's buffers, made at its first use
        self._graph = None  # its dispatch graph (on the card)
        # own the state: the caller's tensors are never shared with a run
        self.states = tree.tree_map(lambda x: x.to(self.device, copy=True), self.states)
        self.pending = tree.tree_map(lambda x: x.to(self.device, copy=True), self.pending)
        if self.obs is not None and "trace" not in self.states:
            # one ring per segment inside the state tree, so every backend
            # and the captured dispatch carry it like any other leaf
            self.states = {**self.states, "trace": obs_trace.ring_state(
                int(self.obs.capacity), self.states["time"].shape, self.device)}
        self._finished = False  # a run() observed clean termination
        self._closed = False  # close() was called
        # the CPU-free step is only valid while nothing but AER spikes can
        # circulate: a hand-injected MMIO/DMA message in the initial inbox
        # needs the full step (one host check at construction)
        if not self.cfg.has_cpu:
            injected = whole_pending["valid"] & (whole_pending["kind"] != ch.MSG_SPIKE)
            if bool(injected.any()):
                self.cfg = dataclasses.replace(self.cfg, has_cpu=True)
        self.lat = self.cfg.latency_matrix(self.device)
        self._step = pf.make_segment_step(self.cfg, self.quantum, self.obs)
        self._step.prepare(self.device)
        s = self.cfg.n_segments
        self._eye = torch.eye(s, dtype=torch.bool, device=self.device)
        if self._shard:
            self._others = ~self._eye[self._seg]
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
    def _mesh_setup(self):
        """Check the mesh (one segment per device, the reference's
        contract), resolve the device to this rank's and return this rank's
        segment."""
        from repro_torch.launch.mesh import mesh_device

        if self.mesh is None:
            raise ValueError("shard_map backend needs a mesh")
        if self.mesh.ndim != 1:
            raise ValueError(f"the shard_map backend takes a 1-D mesh, not {self.mesh}")
        n, s = self.mesh.size(), self.cfg.n_segments
        if s != n:
            raise ValueError(f"the shard_map backend runs one segment per mesh device: "
                             f"{s} segments on a mesh of {n} devices")
        mine = mesh_device(self.mesh)
        self.device = mine if self.device is None else torch.device(self.device)
        if self.device.type != mine.type:
            raise ValueError(f"device {self.device} is not on the mesh's "
                             f"{self.mesh.device_type} devices")
        self._group = self.mesh.get_group(0)
        return self.mesh.get_local_rank(0)

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

    def _shard_round(self, states, pending):
        """The reference's ``shard_map`` round body on this rank's segment
        ``i``: all-gather the segments' times; the limit
        ``min_{j != i}(t_j + lat[j, i])``, with no one-segment case (F6);
        the local step; all-gather the outboxes; the fresh inbox by the
        rank-and-drop rule (``channel.route_to``); ``merge_pending``."""
        i = self._seg
        times = _all_gather(states["time"], self._group, self.cfg.n_segments)
        lim = torch.where(self._others, times + self.lat[:, i], _BIG).min().reshape(1)
        states, outbox, pending = self._step(states, pending, lim)
        packed = torch.stack([outbox[f] for f in ch.FIELDS] + [outbox["valid"].to(torch.int32)],
                             dim=1)  # (1, fields, out_cap): one all-gather
        got = _all_gather(packed, self._group, self.cfg.n_segments)
        boxes = {f: got[:, k] for k, f in enumerate(ch.FIELDS)}
        boxes["valid"] = got[:, len(ch.FIELDS)].bool()
        fresh = ch.route_to(boxes, self.lat[:, i], self.cfg.in_cap, i)
        return states, ch.merge_pending(pending, fresh)

    def _reduced_flags(self):
        """The six ``termination_flags`` of the whole simulation, as a (6,)
        int32 tensor on every rank: this rank's flags, ``done`` negated,
        all-reduced by MAX (``done`` holds where every segment is done)."""
        f = pf.termination_flags(self._states, self._pending, self.cfg.in_cap,
                                 self.cfg.out_cap, self.cfg.store_log)
        v = torch.stack((~f[0],) + tuple(f[1:])).to(torch.int32)
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self._group)
        v[0] = 1 - v[0]
        return v

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
        elif self._shard:
            self.states, self.pending = self._shard_round(self._states, self._pending)
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
        return self._read("states") if self._list_mode or self._shard else self.states

    def _pending_stacked(self):
        return self._read("pending") if self._list_mode or self._shard else self.pending

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
        the six flags of ``platform.termination_flags`` (on ``shard_map``,
        reduced across ranks).  Under the drop policy only the store log and
        late MMIO stay fatal."""
        if self._shard:
            flags = self._reduced_flags().bool().tolist()
        else:
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
        (rounds run, done, over) tuple and, with telemetry on, the trace
        rings, counted so the one-sync-per-dispatch contract is testable."""
        self.dispatch_syncs += 1
        return _HOST_FETCH(x)

    def _ingest(self, host_ring, on_telemetry=None):
        """Account a fetched (host-side) ring: collect events, track loss."""
        events, lost = obs_trace.drain(host_ring)
        self.trace_lost += lost
        if len(events):
            self._events.append(events)
            if on_telemetry is not None:
                on_telemetry(events)

    def drain_telemetry(self, on_telemetry=None):
        """Fetch and reset the trace rings; returns the drained batch (empty
        without telemetry).  A host sync: ``run`` calls it on the per-round
        path at ``check_every`` boundaries and at the end only; the fused
        dispatch drains in its one fetch instead."""
        if self.obs is None:
            return np.empty(0, obs_trace.EVENT_DTYPE)
        before = len(self._events)
        if self._shard:
            ring = self._states["trace"]
            self._ingest(_HOST_FETCH(self._gather(ring)), on_telemetry)
            self.states = {**self._states, "trace": obs_trace.reset(ring)}
        elif self._list_mode:
            self._ingest(_HOST_FETCH(tree.cat([st["trace"] for st in self._states_l])),
                         on_telemetry)
            self._states_l = [{**st, "trace": obs_trace.reset(st["trace"])}
                              for st in self._states_l]
        else:
            # drained before the reset: on the CPU the fetch is the ring itself
            ring = self._states["trace"]
            self._ingest(_HOST_FETCH(ring), on_telemetry)
            if self._disp is not None and self._states is self._disp.states:
                ring["count"].zero_()  # the dispatch's buffer: a device fill
                self.states = self._states  # drops a copy read before
            else:
                self.states = {**self._states, "trace": obs_trace.reset(ring)}
        return self._events[-1] if len(self._events) > before \
            else np.empty(0, obs_trace.EVENT_DTYPE)

    def trace_events(self):
        """All telemetry drained so far, one structured array
        (``obs.trace.EVENT_DTYPE``); batches are time-sorted per drain."""
        if not self._events:
            return np.empty(0, obs_trace.EVENT_DTYPE)
        return np.concatenate(self._events)

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

        if self.device.type != "cuda" or self.backend != "vmap":
            raise ValueError(f"capture is the vmap backend's, on the card, not "
                             f"{self.backend} on {self.device}")
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

    def _dispatch(self, r0, k, check_every, on_telemetry=None):
        """One fused dispatch of up to ``k`` rounds; returns (rounds run,
        done, over) after one host fetch, which brings the trace rings too
        when telemetry is on (their reset is a device fill, no sync)."""
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
        if self.obs is None:
            ran, done, over = self._fetch(d.out).tolist()
        else:
            out, ring = self._fetch((d.out, d.states["trace"]))
            ran, done, over = out.tolist()
            self._ingest(ring, on_telemetry)
            d.states["trace"]["count"].zero_()
        return ran, bool(done), bool(over)

    def _shard_dispatch(self, r0, k, check_every, on_telemetry=None):
        """One fused ``shard_map`` dispatch of up to ``k`` rounds, issued by
        the host: at each check point the flags are reduced across ranks and
        read on the host (``check_syncs``), and the dispatch stops there on
        ``done`` or ``over``; then one ``_fetch`` of (done, over) at the
        last round, with the gathered trace rings when telemetry is on.
        Returns (rounds run, done, over) as the reference's megaloop does."""
        i, last = 0, None
        while i < k:
            self.states, self.pending = self._shard_round(self._states, self._pending)
            i += 1
            last = None  # (done, over) stay 0 but at a check point
            if (r0 + i) % check_every == 0:
                v = self._reduced_flags()
                bad = v[3] | v[4] if self._drop() else v[1] | v[2] | v[3] | v[4]
                last = torch.stack([v[0] & (1 - bad), bad])
                self.check_syncs += 1
                if bool(last.any()):
                    break
        if last is None:
            last = torch.zeros(2, dtype=torch.int32, device=self.device)
        self.dispatches += 1
        if self.obs is None:
            done, over = self._fetch(last).tolist()
        else:
            ring = self._states["trace"]
            out, host_ring = self._fetch((last, self._gather(ring)))
            done, over = out.tolist()
            self._ingest(host_ring, on_telemetry)
            self.states = {**self._states, "trace": obs_trace.reset(ring)}
        return i, bool(done), bool(over)

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
        errors.

        ``on_telemetry`` (with ``obs``) receives each drained batch of trace
        events as it reaches the host: once per fused dispatch, in the
        dispatch's one fetch, or at ``check_every`` boundaries on the
        per-round path, where a watermark error is raised only after the
        drain, so the telemetry before it is kept.
        """
        t0 = _time.perf_counter()
        self._require_open()
        if self._finished:
            # termination is final: a second run() on a finished controller
            # must not burn rounds
            return self.rounds_run, _time.perf_counter() - t0
        if rounds_per_dispatch < 1:
            raise ValueError("rounds_per_dispatch must be >= 1")
        if fused is None:
            fused = self.backend in ("vmap", "shard_map")
        if fused and self.backend in ("vmap", "shard_map"):
            if check_every < 1:
                raise ValueError("check_every must be >= 1")
            dispatch = self._shard_dispatch if self._shard else self._dispatch
            done = over = False
            ran = 0
            while ran < max_rounds:
                i, done, over = dispatch(
                    ran, min(rounds_per_dispatch, max_rounds - ran), check_every,
                    on_telemetry)
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
            if (r + 1) % check_every == 0:
                try:
                    finished = self.done()
                finally:
                    # drain even when done() raises on a watermark
                    if self.obs is not None:
                        self.drain_telemetry(on_telemetry)
                if finished:
                    self._finished = True
                    break
        else:
            self._check_overflow()  # done() may never have seen the last rounds
        if self.obs is not None:
            self.drain_telemetry(on_telemetry)
        self.block_until_ready()
        return self.rounds_run, _time.perf_counter() - t0

    # ------------------------------------------------------------------
    def result_states(self):
        """Stacked (S, ...) states regardless of backend."""
        return self._stacked()

    def sim_time(self):
        return self._stacked()["time"].cpu().numpy()

    def _gather(self, local):
        """A tree of this rank's one-segment stacks, gathered over the mesh
        into the (S, ...) tree, the same on every rank."""
        return tree.tree_map(
            lambda x: _all_gather(x, self._group, self.cfg.n_segments), local)

    def _read(self, name):
        """The stacked live tree ``name`` for a host read (no copy of the
        dispatch's buffers: the reader copies each leaf it reads).  On
        ``shard_map`` a gather: every rank must read together."""
        if self._list_mode:
            return tree.cat(getattr(self, f"_{name}_l"))
        if self._shard:
            return self._gather(getattr(self, f"_{name}"))
        return getattr(self, f"_{name}")

    def stats(self):
        """The reference's coarse stats dict (``obs/metrics.legacy_stats``):
        the same keys, dtypes and values; prefer ``metrics()``."""
        return obs_metrics.legacy_stats(self._read("states"))

    def metrics(self):
        """Typed metrics snapshot ``{name: ndarray}`` over every metric of
        the ``obs/metrics.py`` registry."""
        return obs_metrics.collect(self._read("states"), self._read("pending"))


def _all_gather(x, group, n):
    """``x`` (a one-segment or job-shard stack) gathered from the ``n``
    ranks of ``group`` along its leading axis.  A bool tensor travels as
    uint8 and a uint32 one as its int32 bits (gloo takes neither), and each
    comes back as it was, so trees keep their dtypes."""
    if x.dtype == torch.bool:
        src = x.to(torch.uint8)
    elif x.dtype == torch.uint32:
        src = x.view(torch.int32)
    else:
        src = x
    src = src.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    if x.dtype == torch.bool:
        return out.bool()
    return out.view(x.dtype)


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


# ---------------------------------------------------------------------------
# job-axis dispatch (fleet serving: serve/snn_serve.py)
#
# The Controller batches the segments of one platform; serving stacks a
# second leading axis of J independent platforms ("jobs") and runs them in
# one dispatch.  The jobs share a compiled shape (one VPConfig) but carry
# their own rasters, weights, fault seeds and trace rings.  The step is
# written over a segment axis and every per-segment op, the three VP
# kernels among them, is independent across segments, so a round steps all
# J*S segments as one flattened stack (the slot scan's wiring tables name
# segments within a platform, by ``seg_id``, so they need no per-job
# offset); the limits, ``route``, ``merge_pending`` and the flags take a
# (J, S) view.  A finished job is frozen: every changed leaf becomes
# ``where(active, new, old)``, so a job's final state is its state at the
# first check round that saw it done, where its solo run stops.  Per-job
# caps ride as (J,) tensors into ``platform.job_termination_flags``: a
# cap-padded bucket still trips each job's watermark against its own cap.

_JOB_FN_CACHE: dict = {}  # (cfg, quantum, obs) -> _JobMegaloop


def _same(a, b):
    """``a`` is ``b``'s memory, in the same layout (a view the step passed
    through)."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


class _JobDispatch:
    """One (J, device) job-axis dispatch's buffers: the (J, S, ...) state and
    pending trees, the per-job carries ``rounds``/``done``/``over`` (J,) and
    caps (3, J), ``args`` = (r0, k, check_every), the iteration count ``i``
    and the dispatch graph's predicates ``running`` and ``at``."""

    def __init__(self, states, pending, rounds):
        self.states = tree.tree_map(_own, states)
        self.pending = tree.tree_map(_own, pending)
        dev = rounds.device
        j = rounds.shape[0]
        self.rounds = torch.zeros(j, dtype=torch.int32, device=dev)
        self.done = torch.zeros(j, dtype=torch.bool, device=dev)
        self.over = torch.zeros(j, dtype=torch.bool, device=dev)
        self.caps = torch.zeros(3, j, dtype=torch.int32, device=dev)
        self.args = torch.zeros(3, dtype=torch.int32, device=dev)
        self.i = torch.zeros((), dtype=torch.int32, device=dev)
        self.running = torch.zeros((), dtype=torch.bool, device=dev)
        self.at = torch.zeros((), dtype=torch.bool, device=dev)

    def carries(self):
        return (self.rounds, self.done, self.over, self.caps)

    def copy(self):
        other = _JobDispatch(self.states, self.pending, self.rounds)
        for dst, src in zip(other.carries() + (other.args,), self.carries() + (self.args,)):
            dst.copy_(src)
        return other


class _JobMegaloop:
    """The job-axis dispatch for one (cfg, quantum, obs): ``__call__`` runs
    up to ``k`` rounds of every active job, with the reference's signature
    and results.  On the card a dispatch is one replay of a graph captured
    per (device, J) at its first call (``kernels/dispatch_graph``: a WHILE
    node on "any job active and i < k" around a round, the check in an IF
    node); on the CPU the same bodies run eagerly.  The trees and carries it
    returns are its buffers, valid until its next call with the same J:
    passed back in, they are not copied."""

    def __init__(self, cfg, quantum, obs):
        self.cfg, self.quantum = cfg, quantum
        self._step = pf.make_segment_step(cfg, quantum, obs)
        self._drop = cfg.faults is not None and cfg.faults.drop_overflow
        self._dev = {}  # device -> (latency matrix, eye)
        self._disp = {}  # (device, J) -> [_JobDispatch, dispatch graph or None]

    def _tables(self, dev):
        if dev not in self._dev:
            self._step.prepare(dev)
            s = self.cfg.n_segments
            self._dev[dev] = (self.cfg.latency_matrix(dev),
                              torch.eye(s, dtype=torch.bool, device=dev))
        return self._dev[dev]

    def _round(self, states, pending):
        """One round of every job over (J, S, ...) trees."""
        j, s = states["time"].shape
        lat, eye = self._tables(states["time"].device)
        times = states["time"]
        if s == 1:
            lim = times + self.quantum
        else:
            lim = torch.where(eye, _BIG, times.unsqueeze(-1) + lat).min(dim=-2).values
        flat = lambda t: tree.tree_map(lambda x: x.reshape(j * s, *x.shape[2:]), t)
        unflat = lambda t: tree.tree_map(lambda x: x.reshape(j, s, *x.shape[1:]), t)
        st, outboxes, pen = self._step(flat(states), flat(pending), lim.reshape(-1))
        fresh = ch.route(unflat(outboxes), lat, self.cfg.in_cap)
        return unflat(st), ch.merge_pending(unflat(pen), fresh)

    def _round_body(self, d):
        """A round of the active jobs into the buffers ``d`` (finished jobs
        frozen), ``rounds += active``, ``i += 1``, ``at`` = a check point,
        ``running`` = any job active and ``i < k``."""
        r0, k, check_every = d.args
        active = ~(d.done | d.over)
        states, pending = self._round(d.states, d.pending)

        def freeze(new, old):
            if _same(new, old):
                return old
            return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        _assign(d.states, tree.tree_map(freeze, states, d.states))
        _assign(d.pending, tree.tree_map(freeze, pending, d.pending))
        d.rounds.add_(active.to(torch.int32))
        d.i.add_(1)
        d.at.copy_((r0 + d.i) % check_every == 0)
        d.running.copy_(active.any() & (d.i < k))

    def _check_body(self, d):
        """Each job's flags at a check point: ``done`` and ``over`` of the
        active jobs, then ``running``."""
        fin, in_o, out_o, st_o, late, _trace = pf.job_termination_flags(
            d.states, d.pending, d.caps[0], d.caps[1], d.caps[2])
        # under the drop policy channel overflow is counted loss
        bad = st_o | late if self._drop else in_o | out_o | st_o | late
        active = ~(d.done | d.over)
        done = d.done | (active & fin & ~bad)
        over = d.over | (active & bad)
        d.done.copy_(done)
        d.over.copy_(over)
        d.running.copy_((~(done | over)).any() & (d.i < d.args[1]))

    def _capture(self, d):
        """Warm up on a throwaway copy (first loads, device tables, the
        allocator settle outside the capture), then capture the round and
        the check and build the dispatch graph.  A failure raises: there is
        no eager fallback on the card."""
        from repro_torch.kernels.dispatch_graph import DispatchGraph

        dev = d.rounds.device
        scratch = d.copy()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._round_body(scratch)
            self._check_body(scratch)
        current.wait_stream(side)
        torch.cuda.synchronize(dev)
        del scratch
        graphs = [torch.cuda.CUDAGraph(keep_graph=True) for _ in range(2)]
        with torch.cuda.graph(graphs[0]):
            self._round_body(d)
        with torch.cuda.graph(graphs[1]):
            self._check_body(d)
        graph = DispatchGraph(graphs[0], graphs[1], d.running, d.at)
        torch.cuda.synchronize(dev)
        return graph

    def __call__(self, states, pending, rounds, done, over, in_cap, out_cap, store_log,
                 r0, k, check_every):
        """One dispatch of up to ``k`` rounds of the (J, S, ...) stacks.
        ``rounds``/``done``/``over`` are the (J,) carries of the previous
        dispatch (padding lanes enter with ``done=True``), the caps (J,)
        int32 tensors, all on the states' device; ``r0`` is the active
        jobs' shared round count and ``check_every`` the check period, as
        in ``Controller.run``.  Returns ``(states, pending, rounds, done,
        over)``."""
        dev = rounds.device
        key = (dev, rounds.shape[0])
        if key not in self._disp:
            self._disp[key] = [_JobDispatch(states, pending, rounds), None]
        d = self._disp[key][0]
        _assign(d.states, states)
        _assign(d.pending, pending)
        for dst, src in zip(d.carries(), (rounds, done, over)):
            if src is not dst:
                dst.copy_(src)
        for row, cap in zip(d.caps, (in_cap, out_cap, store_log)):
            row.copy_(cap)
        for x, v in zip(d.args, (r0, k, check_every)):
            x.fill_(v)
        d.i.zero_()
        if k > 0:
            d.running.copy_((~(d.done | d.over)).any())
        else:
            d.running.fill_(False)
        if dev.type == "cuda":
            if self._disp[key][1] is None:
                self._disp[key][1] = self._capture(d)
            self._disp[key][1].replay()
        else:
            while bool(d.running):
                self._round_body(d)
                if bool(d.at):
                    self._check_body(d)
        return d.states, d.pending, d.rounds, d.done, d.over


def job_mega_fn(cfg, quantum: int = 10_000, obs=None):
    """The cached job-axis dispatch for ``cfg`` (one device).  One entry
    serves every bucket width of a workload shape; on the card each width
    is captured once, at its first dispatch."""
    key = (cfg, quantum, obs)
    if key not in _JOB_FN_CACHE:
        _JOB_FN_CACHE[key] = _JobMegaloop(cfg, quantum, obs)
    return _JOB_FN_CACHE[key]


class _ShardedJobMegaloop:
    """The job-axis dispatch fanned across the ``axis`` dim of a mesh: each
    rank runs its own ``_JobMegaloop`` on its slice of the job axis, with no
    collective inside a round, so a rank whose jobs all finish stops early;
    the five outputs are all-gathered once at the end, so every rank returns
    the whole (J, ...) result.  Every rank passes the same global inputs."""

    def __init__(self, cfg, mesh, quantum, obs, axis):
        from repro_torch.launch.mesh import mesh_device

        self._local = _JobMegaloop(cfg, quantum, obs)
        self._mesh, self._axis = mesh, axis
        self._n = mesh.size(mesh.mesh_dim_names.index(axis))
        self.device = mesh_device(mesh)

    def __call__(self, states, pending, rounds, done, over, in_cap, out_cap, store_log,
                 r0, k, check_every):
        j = rounds.shape[0]
        if j % self._n:
            raise ValueError(f"the job axis's {j} jobs must split evenly over the "
                             f"mesh's {self._n} devices")
        group = self._mesh.get_group(self._axis)
        lo = self._mesh.get_local_rank(self._axis) * (j // self._n)
        mine = lambda x: x[lo:lo + j // self._n].to(self.device)
        out = self._local(tree.tree_map(mine, states), tree.tree_map(mine, pending),
                          *(mine(x) for x in (rounds, done, over, in_cap, out_cap, store_log)),
                          r0, k, check_every)
        return tree.tree_map(lambda x: _all_gather(x, group, self._n), out)


def sharded_job_mega_fn(cfg, mesh, quantum: int = 10_000, obs=None, axis: str = "jobs"):
    """The job-axis dispatch fanned across ``mesh``'s ``axis`` dim
    (``_ShardedJobMegaloop``).  J must divide by the dim's size (the server
    pads buckets with inert ``done=True`` lanes to arrange that).  Mesh
    dependent, so made per call rather than cached, as the reference's."""
    return _ShardedJobMegaloop(cfg, mesh, quantum, obs, axis)
