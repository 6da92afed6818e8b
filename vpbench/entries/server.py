"""A closed loop of ``clients`` callers against the port's fleet server
(``repro_torch.serve.snn_serve.SnnServer``): each client keeps one request
outstanding and sends its next once the previous has come back, so every
flush serves one request of each client.  Requests are the pool's built
platforms in turn; the server copies what it serves and never writes a
submitted request, so a request is sent again as it is.

A job's latency runs from just before its ``submit`` to the return of the
``flush`` that served it.  Traffic keys: ``clients``, ``bucket_size``,
``sample_share`` (the share of finished requests kept for the check, drawn
from the seed; the first finished request is always kept),
``trace_buckets`` (flushes profiled in a traced run)."""
from __future__ import annotations

import time

import numpy as np

from vpbench import bounds, devtrace, gen

WARM_FLUSHES = 2  # the first captures the bucket width's graph
# the traced stretch replays a graph captured in set-up: the profiler runs
# once before it (``devtrace.prime``) so that its kernels are traced
PRIME_PROFILER = True


def _width(n, bucket):
    """Lanes of a bucket of ``n`` requests: the next power of two, at most
    ``bucket`` (the server pads each bucket so)."""
    w = 1
    while w < n:
        w *= 2
    return min(w, bucket)


class Session:
    def __init__(self, kind, config, traffic, seed, device):
        self.kind, self.config, self.traffic = kind, config, traffic
        self.seed, self.device = seed, device
        self.clients = int(traffic["clients"])
        self.sent = 0  # requests drawn from the pool so far

    def setup(self):
        from repro_torch.serve.snn_serve import SnnRequest, SnnServer

        t0 = time.perf_counter()
        self.jobs = self.kind.make_jobs(self.config, self.traffic, self.seed)
        self.bound_s = [self.kind.bound_s(job) for job in self.jobs]
        t1 = time.perf_counter()
        self.requests = []
        for job in self.jobs:
            cfg, states, pending, meta = self.kind.build(self.config, job, self.device)
            self.requests.append(SnnRequest(cfg, states, pending, meta))
        c = self.config
        self.server = SnnServer(quantum=int(c["quantum"]), check_every=int(c["check_every"]),
                                rounds_per_dispatch=int(c["rounds_per_dispatch"]),
                                max_rounds=int(c["max_rounds"]),
                                bucket_size=int(self.traffic["bucket_size"]),
                                device=self.device)
        t2 = time.perf_counter()
        for _ in range(WARM_FLUSHES):
            self._flush()
        self.parts = {"jobs": t1 - t0, "build": t2 - t1, "warm-up": time.perf_counter() - t2}
        self.sent = 0
        self._sample = np.random.default_rng(gen.seed_of(self.seed, 1 << 18))
        self.kept = []  # (pool index, result) of the sampled finished requests

    def _flush(self):
        """One request of each client, served; returns (pool indices,
        submit times, results in submission order, return time)."""
        idx, t_sub, tickets = [], [], []
        for _ in range(self.clients):
            i = self.sent % len(self.requests)
            self.sent += 1
            idx.append(i)
            t_sub.append(time.perf_counter())
            tickets.append(self.server.submit(self.requests[i]))
        with devtrace.span("flush"):
            out = self.server.flush()
        t_done = time.perf_counter()
        return idx, t_sub, [out[t] for t in tickets], t_done

    def window(self, seconds, rec):
        srv = self.server
        syncs0, served0 = srv.dispatch_syncs, srv.served
        share = float(self.traffic["sample_share"])
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            idx, t_sub, results, t_done = self._flush()
            rec.rounds += max(r.rounds for r in results)
            for i, ts, r in zip(idx, t_sub, results):
                rec.latencies.append(t_done - ts)
                rec.attempted += 1
                rec.failed += not r.ok
                rec.bound_s += self.bound_s[i]
                if self._sample.random() < share or not self.kept:
                    # the answer's leaves only: the rest of the clone is freed
                    r.states = {"cims": r.states["cims"]}
                    self.kept.append((i, r))
            if t_done >= deadline:
                break
        rec.window_s = t_done - t0
        rec.syncs = srv.dispatch_syncs - syncs0
        rec.served = srv.served - served0

    def trace(self, rec):
        """``trace_buckets`` flushes more, profiled."""
        traces, rounds, ticks, tick_bytes = [], 0, 0, 0
        with devtrace.traced(traces, self.device):
            for _ in range(int(self.traffic["trace_buckets"])):
                idx, _, results, _ = self._flush()
                n = max(r.rounds for r in results)
                rounds += n
                ticks += sum(self.kind.unit_ticks(self.jobs[i]) for i in idx)
                cfg = self.requests[idx[0]].cfg
                segments = _width(len(idx), self.server.bucket_size) * cfg.n_segments
                tick_bytes += n * bounds.tick_bytes(segments * cfg.n_cim_slots, segments, 0)
        rec.trace = traces[0]
        rec.trace_rounds = rounds
        rec.tick_bound_s = (tick_bytes + ticks * bounds.WEIGHTS) / bounds.PEAK_BYTES_PER_S

    def collect(self):
        """The kept requests' answers on the host; the program's state freed."""
        self.answers = [(i, self.kind.answer(r.states, r.meta)) for i, r in self.kept]
        del self.kept, self.requests, self.server

    def judge(self):
        """How many finished jobs were checked, and how many of them the
        reference says are wrong."""
        ids = sorted({i for i, _ in self.answers})
        want = dict(zip(ids, self.kind.expected([self.jobs[i] for i in ids])))
        wrong = sum(self.kind.differs(a, want[i]) for i, a in self.answers)
        return {"checked": len(self.answers), "wrong": wrong}
