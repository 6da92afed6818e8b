"""Whole simulations, one after another: each job is a new
``repro_torch.core.controller.Controller`` over the built platform (the
controller copies the set-up's initial state, so every job starts from
it), ``run`` to its end on the ``vmap`` backend with the fused dispatch,
and its answer read back to the host.  A job's latency runs from before
the controller is made to its answer on the host.

Traffic keys: ``clients`` (1: a caller waits for each simulation),
``pool`` (distinct jobs, sent in turn), ``trace_jobs`` (jobs profiled in a
traced run)."""
from __future__ import annotations

import time

from vpbench import devtrace

WARM_JOBS = 1  # builds and loads every kernel the job runs
# each traced job captures its own graph inside the profiled stretch, which
# names its kernels right; priming the profiler before the window's
# hundreds of captures and releases named them wrongly (H100, torch 2.11)
PRIME_PROFILER = False


class Session:
    def __init__(self, kind, config, traffic, seed, device):
        if int(traffic.get("clients", 1)) != 1:
            raise ValueError("the controller entry serves one client")
        self.kind, self.config, self.traffic = kind, config, traffic
        self.seed, self.device = seed, device
        self.sent = 0

    def setup(self):
        t0 = time.perf_counter()
        self.jobs = self.kind.make_jobs(self.config, self.traffic, self.seed)
        t1 = time.perf_counter()
        self.built = [self.kind.build(self.config, job, self.device) for job in self.jobs]
        t2 = time.perf_counter()
        for _ in range(WARM_JOBS):
            self._job()
        self.parts = {"jobs": t1 - t0, "build": t2 - t1, "warm-up": time.perf_counter() - t2}
        self.sent = 0
        self.answers = []  # (pool index, answer) of every job in the window

    def _job(self):
        """One simulation; returns (pool index, ok, answer, rounds,
        instructions, capture seconds)."""
        from repro_torch.core.controller import Controller

        i = self.sent % len(self.built)
        self.sent += 1
        cfg, states, pending, meta = self.built[i]
        c = self.config
        max_rounds = int(c["max_rounds"])
        with devtrace.span("job"):
            ctl = Controller(cfg, states, pending, backend="vmap", quantum=int(c["quantum"]),
                             device=self.device)
            try:
                ctl.run(max_rounds=max_rounds, check_every=int(c["check_every"]),
                        rounds_per_dispatch=int(c["rounds_per_dispatch"]))
                ok = ctl.done()
            except RuntimeError:  # a watermark the run tripped
                ok = False
            with devtrace.span("answer"):
                final = ctl.result_states()
                ans = self.kind.answer(final, meta)
                instrs = self.kind.instructions(final)
            ctl.close()
        return i, ok, ans, ctl.rounds_run, instrs, ctl.capture_seconds

    def window(self, seconds, rec):
        rec.capture_s, rec.instrs = [], 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            t_sub = time.perf_counter()
            i, ok, ans, rounds, instrs, capture = self._job()
            t_done = time.perf_counter()
            rec.latencies.append(t_done - t_sub)
            rec.attempted += 1
            rec.failed += not ok
            rec.rounds += rounds
            rec.instrs += instrs
            rec.bound_s += self.kind.bound_s(self.jobs[i]) or 0.0
            if capture is not None:
                rec.capture_s.append(capture)
            self.answers.append((i, ans))
            if t_done >= deadline:
                break
        rec.window_s = t_done - t0

    def trace(self, rec):
        traces, rounds, instrs = [], 0, 0
        with devtrace.traced(traces, self.device):
            for _ in range(int(self.traffic["trace_jobs"])):
                _, _, _, n, k, _ = self._job()
                rounds += n
                instrs += k
        rec.trace, rec.trace_rounds, rec.trace_instrs = traces[0], rounds, instrs

    def collect(self):
        del self.built

    def judge(self):
        """How many finished jobs were checked, and how many of them the
        reference says are wrong."""
        want = self.kind.expected(self.jobs)
        wrong = sum(self.kind.differs(a, want[i]) for i, a in self.answers)
        return {"checked": len(self.answers), "wrong": wrong}
