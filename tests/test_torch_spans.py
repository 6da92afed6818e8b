"""The program's host spans (``obs/spans.py``) in the fleet server and the
controller: with no profiler, a served flush and a ``Controller.run`` read
no clock in ``obs/spans`` and call no profiler; under ``torch.profiler``
each span is one of its host events, inside the caller's own
``record_function``: each bucket gives one ``serve.prep`` and one
``serve.results``, ``dispatch.issue`` and ``dispatch.fetch`` count the
dispatches and host fetches, a flush's children lie inside it, one
``controller.init`` a controller; ``timed`` keeps the profiler's duration;
results bit-equal with the profiler on and off.  On the card: a capture's
span is ``capture_seconds``, never inside an issue, and its mirror on the
device's timeline is a user annotation, not a kernel."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tree
from repro_torch.core.controller import Controller
from repro_torch.obs import spans
from repro_torch.serve.snn_serve import SnnServer
from repro_torch.snn import workloads as wl


SIZES = (12, 10, 8)
RUN = dict(quantum=10_000, check_every=4, max_rounds=300)
SERVE_NAMES = (spans.FLUSH, spans.PREP, spans.DISPATCH, spans.FETCH, spans.RESULTS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as ``torch_parity.single_torch_thread`` gives
    the parity tests (this file imports no JAX: its card test runs where
    there is none)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet():
    return wl.serve_fleet(5, SIZES, seed=3, device="cpu")


def server(bucket_size, device="cpu"):
    # 8 rounds a dispatch: a bucket takes several dispatches and fetches
    return SnnServer(rounds_per_dispatch=8, bucket_size=bucket_size, device=device, **RUN)


def serve(srv, reqs):
    tickets = [srv.submit(r) for r in reqs]
    out = srv.flush()
    return [out[t] for t in tickets]


def simulate(req, device="cpu"):
    ctl = Controller(req.cfg, req.states, req.pending, backend="vmap",
                     quantum=RUN["quantum"], device=device)
    ctl.run(max_rounds=RUN["max_rounds"], check_every=RUN["check_every"], rounds_per_dispatch=8)
    ctl.close()
    return ctl


def assert_trees_equal(a, b):
    la, lb = tree.leaves(tree.to_numpy(a)), tree.leaves(tree.to_numpy(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


class _NoClock:
    def perf_counter(self):
        raise AssertionError("a span read the clock with no profiler")


def _host_events(prof):
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _spans_of(host):
    """``{name: [(start_ns, end_ns)]}`` of the program's spans."""
    out = {}
    for name, s, e in host:
        if name.startswith("repro_torch."):
            out.setdefault(name, []).append((s, e))
    return out


def _inside(inner, outer):
    """Whether the span ``inner`` lies within one of the spans ``outer``."""
    si, ei = inner
    return any(s <= si and ei <= e for s, e in outer)


def test_off_reads_no_clock_and_records_nothing(fleet, monkeypatch):
    monkeypatch.setattr(spans, "time", _NoClock())

    def no_profiler_call(*a, **k):
        raise AssertionError("a span called the profiler with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", no_profiler_call)
    assert spans.span(spans.FLUSH) is spans.span(spans.FETCH)  # the shared no-op
    assert serve(server(4), fleet[:3])
    simulate(fleet[0])


@pytest.mark.parametrize("bucket,buckets", [(2, 3), (4, 2), (8, 1)])
def test_spans_count_buckets_dispatches_and_fetches(fleet, bucket, buckets):
    srv = server(bucket)  # 5 requests
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = serve(srv, fleet)
    got = _spans_of(_host_events(prof))
    assert all(r.ok for r in results)
    assert set(got) == set(SERVE_NAMES)
    assert len(got[spans.FLUSH]) == 1
    assert len(got[spans.PREP]) == len(got[spans.RESULTS]) == buckets
    assert len(got[spans.DISPATCH]) == srv.dispatches > buckets  # several dispatches a bucket
    assert len(got[spans.FETCH]) == srv.dispatch_syncs
    for name in (spans.PREP, spans.DISPATCH, spans.FETCH, spans.RESULTS):
        assert all(_inside(x, got[spans.FLUSH]) for x in got[name]), name
    children = sum(e - s for name in (spans.PREP, spans.DISPATCH, spans.FETCH, spans.RESULTS)
                   for s, e in got[name])
    (s, e), = got[spans.FLUSH]
    assert 0 < children <= e - s


def test_controller_spans_count_inits_dispatches_and_fetches(fleet):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctls = [simulate(req) for req in fleet[:2]]
    got = _spans_of(_host_events(prof))
    assert set(got) == {spans.INIT, spans.DISPATCH, spans.FETCH}  # no capture off the card
    assert len(got[spans.INIT]) == 2
    assert len(got[spans.DISPATCH]) == sum(c.dispatches for c in ctls)
    assert len(got[spans.FETCH]) == sum(c.dispatch_syncs for c in ctls)
    # a fetch follows its issue: none lies inside one
    assert not any(_inside(f, got[spans.DISPATCH]) for f in got[spans.FETCH])


def test_timed_keeps_its_seconds_on_the_profilers_clock():
    with spans.timed("repro_torch.test.timed") as off:
        pass
    assert off.seconds >= 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.timed("repro_torch.test.timed") as on:
            t = time.perf_counter()
            while time.perf_counter() - t < 0.005:
                pass
    (s, e), = _spans_of(_host_events(prof))["repro_torch.test.timed"]
    assert abs((e - s) - on.seconds * 1e9) <= max(0.1 * (e - s), 200_000)


def test_results_bit_equal_with_the_profiler_on_and_off(fleet):
    off = serve(server(4), fleet)
    with profile(activities=[ProfilerActivity.CPU]):
        on = serve(server(4), fleet)
    for a, b in zip(off, on):
        assert (a.ok, a.error, a.rounds) == (b.ok, b.error, b.rounds)
        assert_trees_equal(a.states, b.states)
    off_ctl = simulate(fleet[1])
    with profile(activities=[ProfilerActivity.CPU]):
        on_ctl = simulate(fleet[1])
    assert (off_ctl.rounds_run, off_ctl.dispatches) == (on_ctl.rounds_run, on_ctl.dispatches)
    assert_trees_equal(off_ctl.result_states(), on_ctl.result_states())


@pytest.mark.parametrize("caller", ["serve", "controller"])
def test_spans_on_the_profilers_clock(fleet, caller):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if caller == "serve":
            with record_function("vpbench.flush"):
                serve(server(2), fleet)
            names, outer = SERVE_NAMES, "vpbench.flush"
        else:
            with record_function("vpbench.job"):
                simulate(fleet[0])
            names, outer = (spans.INIT, spans.DISPATCH, spans.FETCH), "vpbench.job"
    host = _host_events(prof)
    lo, hi = next((s, e) for n, s, e in host if n == outer)
    got = _spans_of(host)
    assert set(got) == set(names)
    for name in names:
        assert all(lo <= s <= e <= hi for s, e in got[name]), \
            f"{name} is not among the profiler's events inside {outer}"


@pytest.mark.cuda
def test_capture_span_is_capture_seconds_and_outside_issue(fleet):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dispatch graph has no CPU mode")
    from torch.autograd import DeviceType

    dev = torch.device("cuda", 0)
    req = wl.serve_fleet(2, SIZES, seed=5, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctl = simulate(req[0], dev)
        srv = server(2, dev)
        serve(srv, req)
        serve(srv, req)  # the width's graph is captured once
    got = _spans_of(_host_events(prof))
    assert len(got[spans.CAPTURE]) == 2  # the controller's and the job axis width's
    assert len(got[spans.DISPATCH]) == ctl.dispatches + srv.dispatches
    assert len(got[spans.FETCH]) == ctl.dispatch_syncs + srv.dispatch_syncs
    assert not any(_inside(c, got[spans.DISPATCH]) for c in got[spans.CAPTURE])
    durations = sorted(e - s for s, e in got[spans.CAPTURE])
    assert any(abs(d - ctl.capture_seconds * 1e9) <= max(0.1 * d, 200_000) for d in durations)
    # the spans' mirrors on the device's timeline are annotations, no kernel
    kernels = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and not e.is_user_annotation]
    assert kernels and not [k for k in kernels if k.startswith("repro_torch.")]
