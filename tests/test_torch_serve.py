"""The port's fleet serving (``serve/snn_serve.py`` over
``core/controller.job_mega_fn``) against its own solo runs and against the
JAX package's server, bit for bit: a bucket's per-job states, rounds, output
counts and watermark errors equal each request's solo run at the same
``check_every`` on every backend and dispatch path, and the JAX package's
served results leaf for leaf; mixed caps and per-job fault seeds share a
bucket; an overflow stays with its request; padding lanes are inert;
telemetry rides per job; run re-entry and counters across runs.
Counterpart of tests/test_serve.py:68-355 (its ``shard_map`` case is in
tests/test_torch_distributed.py; its ``pad_to`` cases belong to the LM
stack)."""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctl
from repro.core.controller import Controller as JController
from repro.faults import FaultConfig as JFaultConfig
from repro.obs import TraceConfig as JTraceConfig
from repro.serve import snn_serve as jserve
from repro.snn import workloads as jwl
from repro.vp import platform as jpf
from repro_torch import faults, tree
from repro_torch.core import controller as ctl
from repro_torch.core.controller import Controller
from repro_torch.obs import TraceConfig, spans
from repro_torch.serve.snn_serve import SnnServer, _normalize
from repro_torch.snn import workloads as wl
from repro_torch.vp import platform as pf
from torch_parity import (assert_dict_equal, assert_tree_equal, carry_across, carry_request,
                          cfg_fields, single_torch_thread)

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

QUANTUM = 10_000
CHECK_EVERY = 4
MAX_ROUNDS = 300
SIZES = (12, 10, 8)
MODES = [("sequential", False), ("threads", False), ("vmap", False), ("vmap", True)]
RUN = dict(check_every=CHECK_EVERY, max_rounds=MAX_ROUNDS)


def server(**kw):
    return SnnServer(quantum=QUANTUM, device="cpu", **RUN, **kw)


def jserver(**kw):
    return jserve.SnnServer(quantum=QUANTUM, **RUN, **kw)


def serve(srv, reqs):
    tickets = [srv.submit(r) for r in reqs]
    res = srv.flush()
    return [res[t] for t in tickets]


def solo(req, backend="vmap", fused=True, obs=None):
    c = Controller(req.cfg, req.states, req.pending, backend=backend, quantum=QUANTUM,
                   obs=obs, device="cpu")
    rounds, _ = c.run(fused=fused, **RUN)
    c.close()
    return rounds, c


def assert_states_equal(a, b, what="states"):
    la, lb = tree.leaves(tree.to_numpy(a)), tree.leaves(tree.to_numpy(b))
    assert [p for p, _ in la] == [p for p, _ in lb], f"{what}: keys"
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, f"{what}{path}"
        np.testing.assert_array_equal(y, x, err_msg=f"{what}{path}")


@pytest.fixture(scope="module")
def fleet():
    # 5 requests -> the 8-wide bucket runs with 3 inert padding lanes
    return wl.serve_fleet(5, SIZES, seed=3, device="cpu")


@pytest.fixture(scope="module")
def served(fleet):
    srv = server(bucket_size=8)
    return serve(srv, fleet), srv


# ---------------------------------------------------------------------------
# serving conformance: batched == solo, and == the JAX package's server


@pytest.mark.parametrize("backend,fused", MODES)
def test_bucket_matches_solo(fleet, served, backend, fused):
    results, _ = served
    for res, req in zip(results, fleet):
        assert res.ok, res.error
        rounds, c = solo(req, backend, fused)
        assert res.rounds == rounds
        assert_states_equal(c.result_states(), res.states)
        assert res.output_counts().tolist() == list(req.expected_counts)


def test_served_results_match_the_jax_server(served):
    results, srv = served
    jsrv = jserver(bucket_size=8)
    want = serve(jsrv, jwl.serve_fleet(5, SIZES, seed=3))
    assert (srv.dispatches, srv.dispatch_syncs, srv.served) == \
        (jsrv.dispatches, jsrv.dispatch_syncs, jsrv.served)
    for w, g in zip(want, results):
        assert (g.request_id, g.ok, g.error, g.rounds, g.trace_lost) == \
            (w.request_id, w.ok, w.error, w.rounds, w.trace_lost)
        assert_tree_equal(w.states, g.states, "served states")
        np.testing.assert_array_equal(g.output_counts(), w.output_counts())
        assert len(g.events) == len(w.events) == 0


def test_fleet_matches_jax_fleet():
    """``serve_fleet`` keeps the reference's RNG code: the same requests."""
    fc = dict(seed=5, p_spike_drop=0.1)
    want = jwl.serve_fleet(3, SIZES, seed=9, in_cap=256, faults=JFaultConfig(**fc))
    got = wl.serve_fleet(3, SIZES, seed=9, in_cap=256, faults=faults.FaultConfig(**fc),
                         device="cpu")
    for w, g in zip(want, got):
        assert cfg_fields(g.cfg) == cfg_fields(w.cfg)
        assert_tree_equal(w.states, g.states, "states")
        assert_tree_equal(w.pending, g.pending, "pending")
        assert repr(g.meta) == repr(w.meta) and g.expected_counts == w.expected_counts


def test_carried_requests_serve_as_built_ones(served):
    """JAX-built requests carried across (``torch_parity.carry_request``)
    serve to the same results as the port's own builds."""
    results, _ = served
    got = serve(server(bucket_size=8),
                [carry_request(r) for r in jwl.serve_fleet(5, SIZES, seed=3)])
    for w, g in zip(results, got):
        assert (g.ok, g.rounds) == (w.ok, w.rounds)
        assert_states_equal(w.states, g.states)


def test_bucketing_matches_jax():
    reqs = [wl.serve_request(SIZES, seed=100, in_cap=128, out_cap=64, device="cpu"),
            wl.serve_request(SIZES, seed=101, in_cap=256, out_cap=128, device="cpu")]
    jreqs = [jwl.serve_request(SIZES, seed=100, in_cap=128, out_cap=64),
             jwl.serve_request(SIZES, seed=101, in_cap=256, out_cap=128)]
    for r, jr in zip(reqs, jreqs):
        assert cfg_fields(_normalize(r.cfg)) == cfg_fields(jserve._normalize(jr.cfg))
    drop = faults.FaultConfig(seed=3, p_spike_drop=0.1, on_overflow="drop")
    jdrop = JFaultConfig(seed=3, p_spike_drop=0.1, on_overflow="drop")
    assert cfg_fields(_normalize(dataclasses.replace(reqs[0].cfg, faults=drop))) == \
        cfg_fields(jserve._normalize(dataclasses.replace(jreqs[0].cfg, faults=jdrop)))
    for size in (1, 2, 4, 8):
        srv, jsrv = server(bucket_size=size), jserver(bucket_size=size)
        assert [srv._pad_width(n) for n in range(1, 10)] == \
            [jsrv._pad_width(n) for n in range(1, 10)]


def test_mixed_caps_one_bucket():
    """Pad-compatible caps: one bucket, per-job watermark semantics."""
    ra = wl.serve_request(SIZES, seed=100, in_cap=128, out_cap=64, device="cpu")
    rb = wl.serve_request(SIZES, seed=101, in_cap=256, out_cap=128, device="cpu")
    assert _normalize(ra.cfg) == _normalize(rb.cfg)
    srv = server(bucket_size=2)
    got = serve(srv, [ra, rb])
    assert srv.dispatches >= 1
    for res, req in zip(got, (ra, rb)):
        assert res.ok, res.error
        rounds, c = solo(req)
        assert res.rounds == rounds
        assert_states_equal(c.result_states(), res.states)
        assert res.states["cims"]["in_buf"].shape == c.result_states()["cims"]["in_buf"].shape


def test_per_job_fault_seeds_one_bucket():
    """Different fault seeds batch together (the seed rides the state) and
    reproduce their solo faulted runs and the JAX server's."""
    reqs = [wl.serve_request(SIZES, seed=7, t_steps=6, device="cpu",
                             faults=faults.FaultConfig(seed=s, p_spike_drop=0.1))
            for s in (1, 2)]
    assert reqs[0].cfg != reqs[1].cfg
    assert _normalize(reqs[0].cfg) == _normalize(reqs[1].cfg)
    srv = server(bucket_size=2)
    got = serve(srv, reqs)
    assert srv.dispatches == 1
    want = serve(jserver(bucket_size=2), [
        jwl.serve_request(SIZES, seed=7, t_steps=6, faults=JFaultConfig(seed=s, p_spike_drop=0.1))
        for s in (1, 2)])
    for res, req, w in zip(got, reqs, want):
        assert res.ok, res.error
        rounds, c = solo(req)
        assert res.rounds == rounds == w.rounds
        assert_states_equal(c.result_states(), res.states)
        assert_tree_equal(w.states, res.states, "faulted served states")
    assert not np.array_equal(got[0].output_counts(), got[1].output_counts()) or \
        int(got[0].states["stats"]["spikes_dropped"].sum()) != \
        int(got[1].states["stats"]["spikes_dropped"].sum())


@functools.lru_cache(maxsize=None)
def _overflowing_request():
    """A request whose wide hidden layer overflows its own small inbox
    mid-run (the reference test's recipe, searched with the JAX package's
    solo runs); returns its args and the reference's solo message."""
    for t_steps in (2, 3):
        for seed in (13, *range(20)):
            kw = dict(t_steps=t_steps, rate=0.9, seed=seed, in_cap=48)
            try:
                req = jwl.serve_request((8, 64, 8), **kw)
            except AssertionError:
                continue
            c = JController(req.cfg, req.states, req.pending, quantum=QUANTUM)
            try:
                c.run(**RUN)
            except RuntimeError as e:
                return kw, str(e)
    pytest.fail("no overflowing workload in the search budget")


def test_overflow_is_per_request_not_per_bucket():
    """One job's watermark abort becomes ok=False with the solo error
    message, the reference's byte for byte; its bucket mates complete."""
    kw, jax_msg = _overflowing_request()
    bad = wl.serve_request((8, 64, 8), device="cpu", **kw)
    with pytest.raises(RuntimeError) as e:
        solo(bad)
    assert str(e.value) == jax_msg
    mate = wl.serve_request((8, 64, 8), t_steps=2, rate=0.2, seed=1000, in_cap=256,
                            device="cpu")
    good = wl.serve_request(SIZES, seed=5, device="cpu")
    srv = server(bucket_size=4)
    res_bad, res_mate, res_good = serve(srv, [bad, mate, good])
    assert not res_bad.ok and res_bad.error == jax_msg
    assert res_mate.ok and res_mate.output_counts().tolist() == list(mate.expected_counts)
    assert res_good.ok and res_good.output_counts().tolist() == list(good.expected_counts)
    want = serve(jserver(bucket_size=4), [
        jwl.serve_request((8, 64, 8), **kw),
        jwl.serve_request((8, 64, 8), t_steps=2, rate=0.2, seed=1000, in_cap=256),
        jwl.serve_request(SIZES, seed=5)])
    for w, g in zip(want, (res_bad, res_mate, res_good)):
        assert (g.ok, g.error, g.rounds) == (w.ok, w.error, w.rounds)
        assert_tree_equal(w.states, g.states, "states")


def test_padding_lanes_are_inert(served):
    """5 jobs in an 8-wide bucket: identical results at exact width."""
    results, _ = served
    got = serve(server(bucket_size=5), wl.serve_fleet(5, SIZES, seed=3, device="cpu"))
    for a, b in zip(results, got):
        assert a.rounds == b.rounds
        assert_states_equal(a.states, b.states)


def test_serve_with_telemetry(fleet):
    """Per-job trace rings: each request's events equal its solo traced
    stream and the JAX server's; tracing leaves the served results as they
    were."""
    got = serve(server(bucket_size=8, obs=TraceConfig(capacity=4096)),
                wl.serve_fleet(5, SIZES, seed=3, device="cpu"))
    want = serve(jserver(bucket_size=8, obs=JTraceConfig(capacity=4096)),
                 jwl.serve_fleet(5, SIZES, seed=3))
    for res, req, w in zip(got, fleet, want):
        assert res.ok, res.error
        rounds, untraced = solo(req)
        assert res.rounds == rounds
        assert_states_equal(untraced.result_states(),
                            {k: v for k, v in res.states.items() if k != "trace"})
        _, traced = solo(req, obs=TraceConfig(capacity=4096))
        np.testing.assert_array_equal(res.events, traced.trace_events())
        assert_states_equal(traced.result_states(), res.states, "traced")
        assert len(res.events) > 0 and res.trace_lost == 0
        assert_tree_equal(w.states, res.states, "traced served states")
        np.testing.assert_array_equal(res.events, w.events)


def _serve_profiled(srv, reqs):
    """``serve`` under the CPU profiler, and the ops that ran inside its
    buckets' results spans, counted by name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = serve(srv, reqs)
    ops = collections.Counter()
    for e in prof.events():
        p = e.cpu_parent
        while p is not None and p.name != spans.RESULTS:
            p = p.cpu_parent
        if p is not None:
            ops[e.name] += 1
    return got, ops


def _results_bucket(case):
    """A bucket's requests and the server's ``obs``: 1, 3 (4 lanes, one
    padding) or 8 requests; 3 traced; or an inbox overflow and its mate."""
    if case == "overflow":
        kw, _ = _overflowing_request()
        return [wl.serve_request((8, 64, 8), device="cpu", **kw),
                wl.serve_request((8, 64, 8), t_steps=2, rate=0.2, seed=1000, in_cap=256,
                                 device="cpu")], None
    n = {"n1": 1, "n3": 3, "n8": 8, "obs": 3}[case]
    obs = TraceConfig(capacity=4096) if case == "obs" else None
    return wl.serve_fleet(n, SIZES, seed=20 + n, device="cpu"), obs


@pytest.mark.parametrize("case", ["n1", "n3", "n8", "obs", "overflow"])
def test_results_copy_each_state_leaf_once(case):
    """A bucket's results step copies each state leaf once, its real lanes
    together, and pending never (a failed lane's watermarks are read where
    the dispatch left them): ``result_copies`` and the clones inside the
    results span both count the state leaves, whatever the bucket's width.
    A result's leaves are views holding the bucket's real lanes, not its
    padding; each equals its solo run (states, rounds, events, or the solo
    run's watermark message while its mate completes) and stays so through
    the next bucket."""
    reqs, obs = _results_bucket(case)
    n = len(reqs)
    srv = server(bucket_size=8, obs=obs)
    got, ops = _serve_profiled(srv, reqs)
    leaves = len(tree.leaves(got[0].states))  # the request's, and a traced bucket's ring
    ring = len(tree.leaves(got[0].states["trace"])) if obs is not None else 0
    assert leaves == len(tree.leaves(reqs[0].states)) + ring and (ring > 0) == (obs is not None)
    assert srv.result_copies == ops["aten::clone"] == ops["aten::copy_"] == leaves
    assert [r.ok for r in got] == [case != "overflow"] + [True] * (n - 1)
    for res, req in zip(got, reqs):
        for path, x in tree.leaves(res.states):
            assert x._base is not None and x.untyped_storage().nbytes() == n * x.nbytes, path
        if not res.ok:
            with pytest.raises(RuntimeError) as e:
                solo(req)
            assert res.error == str(e.value) and "inbox overflow" in res.error
            continue
        rounds, c = solo(req, obs=obs)
        assert res.rounds == rounds
        assert_states_equal(c.result_states(), res.states)
        if obs is not None:
            assert len(res.events) > 0 and res.trace_lost == 0
            np.testing.assert_array_equal(res.events, c.trace_events())
    kept = [tree.tree_map(torch.clone, r.states) for r in got]
    serve(srv, reqs)
    assert srv.result_copies == 2 * leaves
    for k, res in zip(kept, got):
        assert_states_equal(k, res.states, "after the next bucket")


def test_job_dispatch_matches_jax_dispatch_by_dispatch():
    """``job_mega_fn`` called directly, dispatch after dispatch of 3 rounds
    over a bucket with a padding lane: carries, states and pending equal the
    reference's after every dispatch."""
    reqs = wl.serve_fleet(3, SIZES, seed=4, device="cpu")
    jreqs = jwl.serve_fleet(3, SIZES, seed=4)
    cfg = reqs[0].cfg
    lanes = list(range(3)) + [0]
    j = dict(states=jax.tree.map(lambda *v: jnp.stack(v), *[jreqs[i].states for i in lanes]),
             pending=jax.tree.map(lambda *v: jnp.stack(v), *[jreqs[i].pending for i in lanes]))
    t = dict(states=tree.stack([reqs[i].states for i in lanes]),
             pending=tree.stack([reqs[i].pending for i in lanes]))
    jc = [jnp.zeros(4, jnp.int32), jnp.arange(4) >= 3, jnp.zeros(4, bool)]
    tc = [torch.zeros(4, dtype=torch.int32), torch.arange(4) >= 3,
          torch.zeros(4, dtype=torch.bool)]
    caps = [cfg.in_cap, cfg.out_cap, cfg.store_log]
    jmega = jctl.job_mega_fn(jreqs[0].cfg, QUANTUM)
    mega = ctl.job_mega_fn(cfg, QUANTUM)
    ran = 0
    for _ in range(20):
        out_j = jmega(j["states"], j["pending"], *jc,
                      *(jnp.full(4, c, jnp.int32) for c in caps),
                      jnp.int32(ran), jnp.int32(3), jnp.int32(CHECK_EVERY))
        out_t = mega(t["states"], t["pending"], *tc,
                     *(torch.full((4,), c, dtype=torch.int32) for c in caps),
                     ran, 3, CHECK_EVERY)
        j["states"], j["pending"], jc = out_j[0], out_j[1], list(out_j[2:])
        t["states"], t["pending"], tc = out_t[0], out_t[1], list(out_t[2:])
        assert_tree_equal(j["states"], t["states"], f"states after round {ran}")
        assert_tree_equal(j["pending"], t["pending"], f"pending after round {ran}")
        for a, b, name in zip(jc, tc, ("rounds", "done", "over")):
            assert_tree_equal(a, b, name)
        ran = int(tc[0].max())
        if bool((tc[1] | tc[2]).all()):
            break
    assert bool(tc[1].all()) and ran > 3


def test_job_termination_flags_match_jax(served):
    """Per-job flags against per-job caps: final, initial and over-cap
    states side by side."""
    results, _ = served
    fleet = jwl.serve_fleet(2, SIZES, seed=3)
    jstates = jax.tree.map(lambda *v: jnp.stack(v), *[fleet[0].states, fleet[1].states])
    jpending = jax.tree.map(lambda *v: jnp.stack(v), *[fleet[0].pending, fleet[1].pending])
    states = carry_across(jstates)
    pending = carry_across(jpending)
    states = tree.tree_map(lambda a, b: torch.cat([a, b.unsqueeze(0)]), states,
                           results[0].states)
    pending = tree.tree_map(lambda a: torch.cat([a, a[:1]]), pending)
    caps = (np.array([4096, 1, 4096], np.int32), np.array([4096, 4096, 0], np.int32),
            np.array([2048, 2048, 0], np.int32))
    want = jpf.job_termination_flags(tree.to_numpy(states), tree.to_numpy(pending),
                                     *(jnp.asarray(c) for c in caps))
    got = pf.job_termination_flags(states, pending, *(torch.from_numpy(c) for c in caps))
    for w, g in zip(want, got):
        assert_tree_equal(w, g, "flag")
    assert len({tuple(bool(v) for v in x) for x in got}) > 1, "flags that differ by job"


def test_mesh_and_sharded_job_axis_refuse_naming_item_12():
    """The sharded server's contract (tests/test_torch_distributed.py serves
    over a 2-rank mesh): a bucket size that the mesh does not divide raises
    the reference's message byte for byte, and so does a zero bucket; a job
    axis that the mesh does not divide raises before any collective.  A
    mesh of two CPU devices without process groups is enough for both."""
    import types

    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("jobs",),
                      _init_backend=False, _rank=0)
    with pytest.raises(ValueError) as want:
        jserve.SnnServer(bucket_size=3, mesh=types.SimpleNamespace(devices=np.empty(2)))
    with pytest.raises(ValueError) as got:
        SnnServer(bucket_size=3, mesh=mesh)
    assert str(got.value) == str(want.value)
    assert SnnServer(bucket_size=4, mesh=mesh)._pad_width(1) == 4
    reqs = wl.serve_fleet(3, SIZES, seed=3, device="cpu")
    fn = ctl.sharded_job_mega_fn(reqs[0].cfg, mesh, QUANTUM)
    three = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="3 jobs must split evenly over the mesh's 2 devices"):
        fn(tree.stack([r.states for r in reqs]), tree.stack([r.pending for r in reqs]),
           three, three.bool(), three.bool(), three, three, three, 0, 4, CHECK_EVERY)
    with pytest.raises(ValueError, match="bucket_size must be >= 1"):
        SnnServer(bucket_size=0, device="cpu")


if HAVE_HYPOTHESIS:

    @settings(max_examples=4, deadline=None)
    @given(n=st.integers(1, 6), seed=st.integers(0, 50), bucket=st.sampled_from([2, 4, 8]))
    def test_property_batched_equals_solo(n, seed, bucket):
        reqs = wl.serve_fleet(n, SIZES, seed=seed, device="cpu")
        for res, req in zip(serve(server(bucket_size=bucket), reqs), reqs):
            assert res.ok, res.error
            rounds, c = solo(req)
            assert res.rounds == rounds
            assert_states_equal(c.result_states(), res.states)


# ---------------------------------------------------------------------------
# Controller.run re-entry, and counters and telemetry across runs


@pytest.mark.parametrize("backend,fused", MODES)
def test_run_reentry_is_free(backend, fused):
    req = wl.serve_request(SIZES, seed=3, device="cpu")
    c = Controller(req.cfg, req.states, req.pending, backend=backend, quantum=QUANTUM,
                   device="cpu")
    rounds, _ = c.run(fused=fused, **RUN)
    before = (rounds, c.dispatches, c.dispatch_syncs, c.sim_time().copy(),
              tree.tree_map(torch.clone, c.result_states()))
    rounds2, _ = c.run(fused=fused, **RUN)
    assert rounds2 == rounds == c.rounds_run
    assert (c.dispatches, c.dispatch_syncs) == before[1:3]
    np.testing.assert_array_equal(c.sim_time(), before[3])
    assert_states_equal(before[4], c.result_states())
    c.close()


def test_run_reentry_continues_unfinished():
    """A partial run (max_rounds hit early) continues when re-entered."""
    req = wl.serve_request(SIZES, seed=3, device="cpu")
    c = Controller(req.cfg, req.states, req.pending, quantum=QUANTUM, device="cpu")
    c.run(max_rounds=CHECK_EVERY, check_every=CHECK_EVERY)
    assert not c._finished
    rounds, _ = c.run(**RUN)
    ref, want = solo(req)
    assert rounds == ref
    assert_states_equal(want.result_states(), c.result_states())


def test_counters_accumulate_across_runs():
    """A run split at a check boundary reports the stats and metrics of one
    continuous run (and the reference's), and reading does not change them."""
    req = wl.serve_request(SIZES, seed=3, device="cpu")
    jreq = jwl.serve_request(SIZES, seed=3)
    one = Controller(req.cfg, req.states, req.pending, quantum=QUANTUM, device="cpu")
    one.run(**RUN)
    two = Controller(req.cfg, req.states, req.pending, quantum=QUANTUM, device="cpu")
    two.run(max_rounds=CHECK_EVERY, check_every=CHECK_EVERY)
    two.run(**RUN)
    ref = JController(jreq.cfg, jreq.states, jreq.pending, quantum=QUANTUM)
    ref.run(max_rounds=CHECK_EVERY, check_every=CHECK_EVERY)
    ref.run(**RUN)
    assert one.rounds_run == two.rounds_run == ref.rounds_run
    for name in ("stats", "metrics"):
        a, b, w = getattr(one, name)(), getattr(two, name)(), getattr(ref, name)()
        assert_dict_equal(w, b, name)
        assert_dict_equal(w, a, name)
        assert_dict_equal(w, getattr(two, name)(), f"{name}, read again")


@pytest.mark.parametrize("fused", [False, True])
def test_telemetry_not_double_counted_across_runs(fused):
    """Drained events accumulate once: a split run's events equal one run's
    (and the reference's split run's), and a re-entered finished run drains
    nothing new."""
    def build(obs):
        req = wl.serve_request(SIZES, seed=3, device="cpu")
        return Controller(req.cfg, req.states, req.pending, quantum=QUANTUM, obs=obs,
                          device="cpu")

    one = build(TraceConfig(capacity=4096))
    one.run(fused=fused, **RUN)
    two = build(TraceConfig(capacity=4096))
    two.run(max_rounds=CHECK_EVERY, check_every=CHECK_EVERY, fused=fused)
    two.run(fused=fused, **RUN)
    jreq = jwl.serve_request(SIZES, seed=3)
    ref = JController(jreq.cfg, jreq.states, jreq.pending, quantum=QUANTUM,
                      obs=JTraceConfig(capacity=4096))
    ref.run(max_rounds=CHECK_EVERY, check_every=CHECK_EVERY, fused=fused)
    ref.run(fused=fused, **RUN)
    ea, eb = one.trace_events(), two.trace_events()
    assert len(ea) == len(eb) > 0
    order = list(ea.dtype.names)
    np.testing.assert_array_equal(np.sort(ea, order=order), np.sort(eb, order=order))
    np.testing.assert_array_equal(eb, ref.trace_events())
    assert_tree_equal(ref.result_states(), two.result_states(), "states")
    n = len(eb)
    two.run(fused=fused, **RUN)
    assert len(two.trace_events()) == n
