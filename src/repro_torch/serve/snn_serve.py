"""Fleet-scale SNN serving: independent inference jobs batched through one
job-axis dispatch (counterpart of ``repro/serve/snn_serve.py``).

* ``SnnRequest`` — one built platform (cfg, states, pending, meta), e.g.
  from ``snn.workloads.serve_request``.
* ``SnnServer.submit`` — admission queue: stamps arrival time, returns a
  ticket.
* ``SnnServer.flush`` — buckets the queue by compiled shape, pads each
  bucket, and runs it through ``controller.job_mega_fn``: per-job
  termination flags, per-job watermarks against each request's own caps,
  per-job fault seeds and trace rings in the stacked state.  On the card a
  dispatch is one replay of the bucket's captured graph and one host fetch.

Bucketing (docs/serving.md), as the reference's:

* **Same compiled shape.** Requests share a bucket iff their configs match
  after ``_normalize``: the transport fault seed becomes 0 (it rides the
  state) and the channel caps are dropped (they become per-job operands),
  except under ``on_overflow="drop"``, where capacity changes the spike
  loss and the caps stay in the key.
* **Cap padding.** A bucket's boxes are sized to the bucket maximum; each
  job is judged against its own caps, so an overflowing job fails at the
  same check round with the same message as its solo run.
* **Padding lanes.** Buckets are padded to a power-of-two width by
  replicating lane 0 with ``done=True``: frozen from round 0.

Results equal each request's solo run at the same ``check_every``; a
finished job freezes at the first check round that saw it done.  With
``mesh=`` (a 1-D ``jobs`` mesh from ``launch.mesh.make_serve_mesh``) every
rank submits the same requests, each bucket is split over the mesh
(``controller.sharded_job_mega_fn``) and every rank gets every result.
"""
from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import controller as ctl
from repro_torch.obs import spans
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class SnnRequest:
    """One admission-ready inference job: a built platform plus its meta.
    ``expected_counts`` is optional oracle output carried for end-to-end
    verification; the server never reads it."""
    cfg: object
    states: object
    pending: object
    meta: dict
    expected_counts: tuple | None = None


@dataclasses.dataclass
class SnnResult:
    """Outcome of one served request.  ``ok=False`` carries the watermark
    message the request's solo ``Controller.run`` would have raised, or a
    max_rounds note.  ``latency_s`` is host wall time from ``submit`` to the
    request's bucket completing.

    ``states``' leaves are views into one copy per leaf of the bucket's real
    lanes: a result kept keeps its bucket's copy of each leaf it keeps (all
    of the bucket's lanes).  Clone the leaves of a result held for long."""
    request_id: int
    ok: bool
    error: str | None
    rounds: int
    latency_s: float
    states: object
    meta: dict
    events: object = None  # drained telemetry (numpy EVENT_DTYPE), obs only
    trace_lost: int = 0

    def output_counts(self):
        """Per-output-unit spike counts (topology.output_spike_counts)."""
        from repro_torch.snn import topology as topo

        return topo.output_spike_counts(self.states, self.meta)


def _normalize(cfg):
    """The bucket key: cfg with the per-job fields factored out."""
    fc = cfg.faults
    if fc is not None:
        fc = dataclasses.replace(fc, seed=0)
    if fc is not None and fc.drop_overflow:
        # capacity changes the spike loss under the drop policy: the caps
        # must match exactly, so they stay in the key
        return dataclasses.replace(cfg, faults=fc)
    return dataclasses.replace(cfg, faults=fc, in_cap=0, out_cap=0, store_log=0)


def _split(states, n: int):
    """The first ``n`` lanes of the stacked tree of dicts ``states`` as ``n``
    trees of its structure, and the number of copies made: each leaf's
    lanes are copied once, together, and each tree's leaves are views into
    the copies (one ``unbind`` a leaf)."""
    if not isinstance(states, dict):
        return states[:n].clone().unbind(0), 1
    parts, copies = {}, 0
    for k, v in states.items():
        parts[k], c = _split(v, n)
        copies += c
    return [{k: p[j] for k, p in parts.items()} for j in range(n)], copies


def _pad_pending(pending, cap: int):
    """Grow a (S, cap0) pending box to the bucket's in_cap with empty slots
    (zeros, ``valid`` False): shape only, dead slots are never read."""
    cur = pending["valid"].shape[-1]
    if cur == cap:
        return pending
    out = dict(pending)
    for f in ("kind", "addr", "data", "t_avail", "valid"):
        x = pending[f]
        out[f] = torch.cat([x, x.new_zeros(*x.shape[:-1], cap - cur)], -1)
    return out


class SnnServer:
    """Admission queue and bucketed batch execution of SNN inference jobs
    on one device (``device=None``: the GPU), or split over a mesh's ranks
    (``mesh=``; ``device=None``: this rank's device), so ``bucket_size``
    must then be a multiple of the mesh size.

    ``submit`` appends and stamps; ``flush`` serves every queued request and
    returns ``{ticket: SnnResult}``.  ``bucket_size`` caps how many jobs
    share one dispatch.  ``check_every`` fixes the termination-check cadence
    of every bucket: results equal solo runs at the same cadence.
    """

    def __init__(self, *, quantum: int = 10_000, check_every: int = 4,
                 rounds_per_dispatch: int = 256, max_rounds: int = 10_000,
                 bucket_size: int = 8, mesh=None, obs=None, device=None):
        if bucket_size < 1:
            raise ValueError("bucket_size must be >= 1")
        if mesh is not None:
            n = mesh.size()
            if bucket_size % n:
                raise ValueError(
                    f"bucket_size={bucket_size} must be a multiple of the "
                    f"mesh's {n} devices (shard_map splits the job axis "
                    "evenly)")
        self.quantum = quantum
        self.check_every = check_every
        self.rounds_per_dispatch = rounds_per_dispatch
        self.max_rounds = max_rounds
        self.bucket_size = bucket_size
        self.mesh = mesh
        self.obs = obs
        if mesh is not None and device is None:
            from repro_torch.launch.mesh import mesh_device

            self.device = mesh_device(mesh)
        else:
            self.device = tree.resolve_device(device)
        self.dispatches = 0  # job-axis dispatches issued
        self.dispatch_syncs = 0  # host fetches from the serving loop
        self.served = 0  # requests completed over the server's life
        self.result_copies = 0  # device copies the results steps have issued
        self._queue = []  # (ticket, SnnRequest, t_submit)
        self._next_id = 0
        self._sharded_cache = {}  # bucket cfg -> its sharded dispatch

    # -- admission ------------------------------------------------------
    def submit(self, request: SnnRequest) -> int:
        """Queue one request; returns its ticket (key into flush()'s dict)."""
        ticket = self._next_id
        self._next_id += 1
        self._queue.append((ticket, request, _time.perf_counter()))
        return ticket

    def __len__(self):
        return len(self._queue)

    # -- batching -------------------------------------------------------
    def _pad_width(self, n: int) -> int:
        """Lanes per bucket: the next power of two, at most bucket_size
        (bounds the captured graphs per cfg to log2(bucket_size) widths), or
        bucket_size itself under a mesh (the job axis must split evenly)."""
        if self.mesh is not None:
            return self.bucket_size
        w = 1
        while w < n:
            w *= 2
        return min(w, self.bucket_size)

    def _mega(self, bucket_cfg):
        if self.mesh is None:
            return ctl.job_mega_fn(bucket_cfg, self.quantum, self.obs)
        if bucket_cfg not in self._sharded_cache:
            self._sharded_cache[bucket_cfg] = ctl.sharded_job_mega_fn(
                bucket_cfg, self.mesh, self.quantum, self.obs)
        return self._sharded_cache[bucket_cfg]

    # -- execution ------------------------------------------------------
    def flush(self) -> dict:
        """Serve every queued request; returns ``{ticket: SnnResult}``."""
        with spans.span(spans.FLUSH):
            results = {}
            queue, self._queue = self._queue, []
            for key_cfg, entries in self._buckets_of(queue):
                results.update(self._run_bucket(key_cfg, entries))
        return results

    def _buckets_of(self, queue):
        """Group by normalized cfg (first-seen order; submission order
        within a group), chunked to bucket_size."""
        groups: dict = {}
        for entry in queue:
            groups.setdefault(_normalize(entry[1].cfg), []).append(entry)
        for key_cfg, entries in groups.items():
            for i in range(0, len(entries), self.bucket_size):
                yield key_cfg, entries[i:i + self.bucket_size]

    def _run_bucket(self, key_cfg, entries):
        with spans.span(spans.PREP):
            reqs = [e[1] for e in entries]
            bucket_cfg = dataclasses.replace(
                key_cfg,
                in_cap=max(r.cfg.in_cap for r in reqs),
                out_cap=max(r.cfg.out_cap for r in reqs),
                store_log=max(r.cfg.store_log for r in reqs),
            )
            n = len(entries)
            width = self._pad_width(n)
            dev = self.device

            def prep(req):
                st = tree.tree_map(lambda x: x.to(dev), req.states)
                if self.obs is not None and "trace" not in st:
                    st = {**st, "trace": obs_trace.ring_state(
                        int(self.obs.capacity), (bucket_cfg.n_segments,), dev)}
                pen = tree.tree_map(lambda x: x.to(dev), req.pending)
                return st, _pad_pending(pen, bucket_cfg.in_cap)

            lanes = [prep(r) for r in reqs]
            lanes += [lanes[0]] * (width - n)  # inert padding lanes (done0=True)
            states = tree.stack([lane[0] for lane in lanes])
            pending = tree.stack([lane[1] for lane in lanes])

            def pad(vals):
                return torch.tensor(list(vals) + [vals[0]] * (width - n),
                                    dtype=torch.int32).to(dev)

            in_cap = pad([r.cfg.in_cap for r in reqs])
            out_cap = pad([r.cfg.out_cap for r in reqs])
            store_log = pad([r.cfg.store_log for r in reqs])
            rounds = torch.zeros(width, dtype=torch.int32, device=dev)
            done = torch.arange(width, device=dev) >= n  # padding lanes frozen from round 0
            over = torch.zeros(width, dtype=torch.bool, device=dev)
            mega = self._mega(bucket_cfg)

        per_job_events = [[] for _ in range(n)]
        per_job_lost = [0] * n
        ran = 0
        while ran < self.max_rounds:
            k = min(self.rounds_per_dispatch, self.max_rounds - ran)
            states, pending, rounds, done, over = mega(
                states, pending, rounds, done, over, in_cap, out_cap, store_log,
                ran, k, self.check_every)
            self.dispatches += 1
            self.dispatch_syncs += 1
            # one host fetch per dispatch: the carries and the trace rings
            # come back together, as in Controller.run
            if self.obs is None:
                rounds_h, done_h, over_h = ctl._HOST_FETCH((rounds, done, over))
            else:
                rounds_h, done_h, over_h, ring = ctl._HOST_FETCH(
                    (rounds, done, over, states["trace"]))
                for j in range(n):
                    ev, lost = obs_trace.drain({f: x[j] for f, x in ring.items()})
                    per_job_lost[j] += lost
                    if len(ev):
                        per_job_events[j].append(ev)
                states["trace"]["count"].zero_()  # the dispatch's buffer: a device fill
            prev, ran = ran, int(rounds_h.max())
            if (done_h | over_h).all() or ran == prev:
                break
        t_done = _time.perf_counter()

        with spans.span(spans.RESULTS):
            # one copy of each state leaf's n real lanes: the buffers belong
            # to the dispatch, which the next bucket of this shape overwrites.
            # Each result's leaves are views into these copies.
            per_job, copies = _split(states, n)
            self.result_copies += copies
            out = {}
            for j, (ticket, req, t_submit) in enumerate(entries):
                error = None
                if bool(over_h[j]) or not bool(done_h[j]):
                    # read here, before the next dispatch: no copy of pending
                    pen_j = tree.tree_map(lambda x: x[j], pending)
                    drop = req.cfg.faults is not None and req.cfg.faults.drop_overflow
                    error = ctl.overflow_error(
                        per_job[j], pen_j, in_cap=req.cfg.in_cap, out_cap=req.cfg.out_cap,
                        store_log=req.cfg.store_log, drop=drop)
                    if error is None:
                        error = (f"max_rounds={self.max_rounds} exhausted "
                                 "before termination")
                events = (np.concatenate(per_job_events[j]) if per_job_events[j]
                          else np.empty(0, obs_trace.EVENT_DTYPE))
                out[ticket] = SnnResult(
                    request_id=ticket, ok=error is None, error=error,
                    rounds=int(rounds_h[j]), latency_s=t_done - t_submit,
                    states=per_job[j], meta=req.meta, events=events,
                    trace_lost=per_job_lost[j])
                self.served += 1
        return out
