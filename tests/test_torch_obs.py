"""The port's observability (``repro_torch/obs``, ``Controller.stats``/
``metrics``, trace rings appended by the step and carried by the fused
dispatch) against the JAX package, bit for bit: the ring functions on the
same inputs, the exporters' JSON text, the stats and metrics dicts (keys,
dtypes, values) on every backend and dispatch mode, traced trees (the ring
included), ``trace_events()`` and ``trace_lost``; traced trees minus the
ring equal untraced ones; one host fetch per fused dispatch with telemetry
on; and the ``stats()`` reads of tests/test_system.py as parity cases.
Counterpart of tests/test_obs.py and of the telemetry cases of
tests/test_conformance.py."""
import dataclasses
import hashlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import snn as jsnn
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.faults import FaultConfig as JFaultConfig
from repro.obs import TraceConfig as JTraceConfig
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtr
from repro.vp import workloads as jwl
from repro_torch import faults, snn, tree
from repro_torch.core import controller as ctl_mod
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.obs import TraceConfig, export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as tr
from repro_torch.vp import platform as pf
from repro_torch.vp import workloads as wl
from torch_parity import assert_dict_equal, assert_tree_equal, single_torch_thread

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)


def assert_events_equal(want, got, what="events"):
    assert got.dtype == want.dtype == tr.EVENT_DTYPE, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_port_trees_equal(a, b, what):
    la, lb = tree.leaves(tree.to_numpy(a)), tree.leaves(tree.to_numpy(b))
    assert [p for p, _ in la] == [p for p, _ in lb], f"{what}: keys"
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, f"{what}{path}"
        np.testing.assert_array_equal(y, x, err_msg=f"{what}{path}")


def minus_ring(states):
    return {k: v for k, v in states.items() if k != "trace"}


# ---------------------------------------------------------------------------
# ring mechanics: the same inputs through both packages' functions

RNG = np.random.default_rng(11)
LANES = 24
BULK = {"mask": RNG.random(LANES) < 0.6, "unit": RNG.integers(0, 4, LANES),
        "t": RNG.integers(0, 50, LANES), "value": RNG.integers(-9, 9, LANES)}
STACKED = {k: np.stack([RNG.random(10) < 0.5 if k == "mask" else RNG.integers(0, 40, 10)
                        for _ in range(3)]) for k in ("mask", "unit", "t", "value")}


def _j(x):
    return jnp.asarray(x.astype(np.int32) if x.dtype != bool else x)


def _t(x):
    return torch.from_numpy(x.astype(np.int32) if x.dtype != bool else x)


def _case_mask_and_sort(m, arr):
    ring = m.ring_state(8)
    for i, t in enumerate((5, 3, 7)):
        ring = m.emit(ring, True, m.EV_TICK, 0, i, t, i * 10)
    return m.emit(ring, False, m.EV_TICK, 0, 99, 0, 0)  # masked out


def _case_overflow(m, arr):
    ring = m.ring_state(2)
    for i in range(5):
        ring = m.emit(ring, True, m.EV_QUANTUM, 0, 0, i, i)
    return ring


def _case_bulk_past_capacity(m, arr):
    ring = m.ring_state(32)
    for rep in range(3):  # ~43 records into 32 slots
        ring = m.emit_bulk(ring, arr(BULK["mask"]), m.EV_SPIKE_TX, rep,
                           arr(BULK["unit"]), arr(BULK["t"]), arr(BULK["value"]))
    return ring


def _case_reset_keeps_sticky(m, arr):
    ring = m.ring_state(4)
    for i in range(6):
        ring = m.emit(ring, True, m.EV_WMARK, 0, -1, i, 1)
    ring = dict(ring)
    ring["wmark_seen"] = ring["wmark_seen"] | 0b0010
    ring = m.reset(ring)
    return m.emit_bulk(ring, arr(BULK["mask"][:5]), m.EV_ROUTE, 2, arr(BULK["unit"][:5]),
                       arr(BULK["t"][:5]), arr(BULK["value"][:5]))


RING_CASES = {"mask_and_sort": _case_mask_and_sort, "overflow": _case_overflow,
              "bulk_past_capacity": _case_bulk_past_capacity,
              "reset_keeps_sticky": _case_reset_keeps_sticky}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_functions_match_jax(case):
    want = RING_CASES[case](jtr, _j)
    got = RING_CASES[case](tr, _t)
    assert_tree_equal(want, got, f"{case} ring")
    ev_w, lost_w = jtr.drain(jax.tree.map(lambda x: np.asarray(x)[None], want))
    ev_g, lost_g = tr.drain(tree.tree_map(lambda x: x.unsqueeze(0), got))
    assert lost_g == lost_w
    assert_events_equal(ev_w, ev_g, case)
    if case == "mask_and_sort":
        assert ev_g["t"].tolist() == [3, 5, 7] and ev_g["unit"].tolist() == [1, 0, 2]
    if case == "overflow":
        assert int(got["count"]) == 5 and bool(got["overflowed"]) and lost_g == 3
        assert ev_g["t"].tolist() == [0, 1], "first records survive, no wrap"
    if case == "reset_keeps_sticky":
        assert bool(got["overflowed"]) and int(got["wmark_seen"]) == 0b0010


def test_stacked_rings_match_vmapped_jax():
    """The port's functions take any leading batch dims: (S, cap) rings with
    (S, n) lanes equal the reference's rings under ``jax.vmap``."""
    seg = np.arange(3)
    want = jax.vmap(lambda *a: jtr.emit_bulk(jtr.ring_state(12), *a[:1], jtr.EV_TICK, *a[1:]))(
        _j(STACKED["mask"]), _j(seg), *(_j(STACKED[k]) for k in ("unit", "t", "value")))
    got = tr.emit_bulk(tr.ring_state(12, (3,)), _t(STACKED["mask"]), tr.EV_TICK,
                       _t(seg).unsqueeze(-1), *(_t(STACKED[k]) for k in ("unit", "t", "value")))
    assert_tree_equal(want, got, "stacked ring")
    ev_w, lost_w = jtr.drain(jax.tree.map(np.asarray, want))
    ev_g, lost_g = tr.drain(got)
    assert lost_g == lost_w
    assert_events_equal(ev_w, ev_g)


def test_constants_match_jax():
    for name in ("EV_QUANTUM", "EV_ROUTE", "EV_TICK", "EV_SPIKE_TX", "EV_CIM_START",
                 "EV_CIM_DONE", "EV_WMARK", "EV_FAULT", "EV_SPIKE_LOSS", "KIND_NAMES",
                 "WMARK_NAMES", "FIELDS", "EVENT_DTYPE"):
        assert getattr(tr, name) == getattr(jtr, name), name
    assert TraceConfig() == TraceConfig(capacity=JTraceConfig().capacity)
    with pytest.raises(dataclasses.FrozenInstanceError):
        TraceConfig().capacity = 1


# ---------------------------------------------------------------------------
# exporters: the same JSON text for the same event array


def _events(recs):
    e = np.empty(len(recs), tr.EVENT_DTYPE)
    for i, r in enumerate(recs):
        e[i] = r
    return e


SYNTHETIC = _events([
    (tr.EV_QUANTUM, 0, 120, 0, 32),
    (tr.EV_ROUTE, 1, 4, 32, 6),
    (tr.EV_TICK, 1, 0, 40, 3),
    (tr.EV_SPIKE_TX, 1, 0, 40, (0 << 16) | 3),
    (tr.EV_CIM_START, 0, 1, 50, 90),
    (tr.EV_CIM_DONE, 0, 1, 90, 8),
    (tr.EV_WMARK, 0, -1, 95, 1),
    (tr.EV_FAULT, 1, 2, 96, 5),
    (tr.EV_SPIKE_LOSS, 0, -1, 97, 7),
    (11, 0, 0, 98, 0),  # an unknown kind: named by its number in NDJSON
])


@pytest.mark.parametrize("tick_period", [0, 16])
def test_chrome_trace_text_matches_jax(tmp_path, tick_period):
    want = jexport.to_chrome_trace(SYNTHETIC, tick_period=tick_period, title="t")
    got = export.to_chrome_trace(SYNTHETIC, tick_period=tick_period, title="t")
    assert json.dumps(got) == json.dumps(want)
    assert export.validate_chrome_trace(got) == jexport.validate_chrome_trace(want)
    events = SYNTHETIC[:-1]
    jexport.write_chrome_trace(tmp_path / "j.json", events, tick_period=tick_period)
    export.write_chrome_trace(tmp_path / "t.json", events, tick_period=tick_period)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_validate_matches_jax_on_malformed_traces():
    obj = export.to_chrome_trace(SYNTHETIC[:-1])
    bad = json.loads(json.dumps(obj))
    del next(e for e in bad["traceEvents"] if e["ph"] == "X")["ts"]
    orphan = json.loads(json.dumps(obj))
    orphan["traceEvents"] = [e for e in orphan["traceEvents"] if e["ph"] != "f"]
    for case in ({}, {"traceEvents": []}, bad, orphan, {"traceEvents": [1, {"ph": "Q"}]}):
        assert export.validate_chrome_trace(case) == jexport.validate_chrome_trace(case)
        assert export.validate_chrome_trace(case) != []


def test_ndjson_text_matches_jax():
    want, got = io.StringIO(), io.StringIO()
    assert export.write_ndjson(got, SYNTHETIC) == jexport.write_ndjson(want, SYNTHETIC)
    assert got.getvalue() == want.getvalue()
    want, got = io.StringIO(), io.StringIO()
    jexport.ndjson_callback(want)(SYNTHETIC)
    export.ndjson_callback(got)(SYNTHETIC)
    assert got.getvalue() == want.getvalue()


# ---------------------------------------------------------------------------
# the registry and stats()/metrics() on the hybrid job (CPUs, dense CIM and
# SNN: every metric source) on every backend and dispatch mode

MODES = [("vmap", True), ("vmap", False), ("sequential", None), ("threads", None)]
HYBRID = dict(quantum=400, max_rounds=800, check_every=2)


def test_registry_matches_jax():
    assert obs_metrics.describe() == jmetrics.describe()
    for name, m in obs_metrics.REGISTRY.items():
        j = jmetrics.REGISTRY[name]
        assert (m.name, m.kind, m.unit, m.per, m.description, m.source) == \
            (j.name, j.kind, j.unit, j.per, j.description, j.source)


@pytest.fixture(scope="module")
def hybrid():
    """The 16x12x8 packed hybrid at quantum 400 (tests/test_obs.py's job),
    traced by the JAX package on its fused and per-round paths, and the
    port's untraced fused run."""
    job_j = jsnn.hybrid_job((16, 12, 8), t_steps=6, rate=0.5, seed=2)
    built_j = jsnn.build_hybrid(job_j, "packed", channel_latency=2000)
    job = snn.hybrid_job((16, 12, 8), t_steps=6, rate=0.5, seed=2)
    built = snn.build_hybrid(job, "packed", channel_latency=2000, device="cpu")
    want = {}
    for fused in (True, False):
        c = JController(*built_j[:3], backend="vmap", quantum=HYBRID["quantum"],
                        obs=JTraceConfig())
        c.run(max_rounds=HYBRID["max_rounds"], check_every=HYBRID["check_every"], fused=fused)
        want[fused] = c
    plain = Controller(*built[:3], quantum=HYBRID["quantum"], device="cpu")
    plain.run(max_rounds=HYBRID["max_rounds"], check_every=HYBRID["check_every"])
    return want, built, plain


@pytest.mark.parametrize("backend,fused", MODES)
def test_traced_hybrid_matches_jax(hybrid, backend, fused):
    """Traced trees (the ring included: the lanes' order decides its slots),
    events, stats and metrics equal the JAX package's run on the same
    path (``sequential`` and ``threads`` drain where the per-round path
    does); the traced tree minus its ring equals the untraced run."""
    want_by_path, built, plain = hybrid
    want = want_by_path[fused is True]
    got = Controller(*built[:3], backend=backend, quantum=HYBRID["quantum"],
                     obs=TraceConfig(), device="cpu")
    batches = []
    got.run(max_rounds=HYBRID["max_rounds"], check_every=HYBRID["check_every"], fused=fused,
            on_telemetry=batches.append)
    got.close()
    assert got.rounds_run == want.rounds_run == plain.rounds_run
    assert_tree_equal(want.result_states(), got.result_states(), "traced states")
    assert_tree_equal(want._pending_stacked(), got._pending_stacked(), "pending")
    ev = got.trace_events()
    assert_events_equal(want.trace_events(), ev)
    assert got.trace_lost == want.trace_lost == 0
    assert [len(b) for b in batches] == [len(b) for b in got._events] and all(map(len, batches))
    kinds = np.bincount(ev["kind"], minlength=len(tr.KIND_NAMES))
    for k in (tr.EV_QUANTUM, tr.EV_ROUTE, tr.EV_TICK, tr.EV_SPIKE_TX, tr.EV_CIM_START,
              tr.EV_CIM_DONE):
        assert kinds[k] > 0, tr.KIND_NAMES[k]
    assert_dict_equal(want.stats(), got.stats(), "stats")
    assert_dict_equal(want.metrics(), got.metrics(), "metrics")
    assert_dict_equal(got.stats(), plain.stats(), "traced vs untraced stats")
    assert_port_trees_equal(plain.result_states(), minus_ring(got.result_states()),
                            "traced minus ring vs untraced")
    # every LIF spike shows on a tick event once; the timeline is valid
    assert int(ev["value"][ev["kind"] == tr.EV_TICK].sum()) == snn.total_spikes(
        plain.result_states())
    assert export.validate_chrome_trace(export.to_chrome_trace(
        ev, tick_period=built[0].snn_tick_period)) == []


def test_stats_and_metrics_untraced_match_jax(hybrid):
    """stats()/metrics() need no telemetry: the untraced run's dicts equal
    the reference's (whose values tracing does not change), and reading
    them does not change them."""
    want, _, plain = hybrid
    st = plain.stats()
    assert_dict_equal(want[True].stats(), st, "stats")
    assert_dict_equal(want[True].metrics(), plain.metrics(), "metrics")
    assert_dict_equal(st, plain.stats(), "a second read")
    partial = obs_metrics.collect(plain.result_states())
    assert_dict_equal(jmetrics.collect(want[True].result_states()), partial, "states only")


# ---------------------------------------------------------------------------
# the small spiking job: capacity, dispatch modes, fetches, faults, errors


def _snn(pkg, **kw):
    job = pkg.snn_inference_job((16, 12, 8), t_steps=6, rate=0.5, seed=3)
    descs = pkg.segmentation_for(len(job.layers), "uniform", n_segments=2)
    return job, pkg.build_snn(job.layers, descs, job.raster, **kw)


def _pair(obs_cap=4096, fused=True, rounds_per_dispatch=256, jkw=None, kw=None,
          on_telemetry=None):
    """The small job traced by both packages (``on_telemetry`` given to the
    port's run); returns (jax ctl, port ctl, job, the port's build)."""
    _, built_j = _snn(jsnn, **(jkw or {}))
    job, built = _snn(snn, device="cpu", **(kw or {}))
    want = JController(*built_j[:3], quantum=32, obs=JTraceConfig(capacity=obs_cap))
    got = Controller(*built[:3], quantum=32, obs=TraceConfig(capacity=obs_cap), device="cpu")
    want.run(max_rounds=300, check_every=2, fused=fused, rounds_per_dispatch=rounds_per_dispatch)
    got.run(max_rounds=300, check_every=2, fused=fused, rounds_per_dispatch=rounds_per_dispatch,
            on_telemetry=on_telemetry)
    return want, got, job, built


def test_undersized_ring_is_informational_and_matches_jax():
    want, got, job, built = _pair(obs_cap=8)
    assert got.trace_lost == want.trace_lost > 0, "an 8-slot ring must overflow here"
    assert got.rounds_run == want.rounds_run
    assert_tree_equal(want.result_states(), got.result_states(), "states")
    assert_events_equal(want.trace_events(), got.trace_events())
    flags = pf.termination_flags(got.result_states(), got._pending_stacked(), 1 << 20,
                                 1 << 20, 1 << 20)
    assert bool(flags[5]), "flag 6 reports the lost records"
    ref = Controller(*built[:3], quantum=32, device="cpu")
    ref.run(max_rounds=300, check_every=2)
    assert not bool(pf.termination_flags(ref.result_states(), ref._pending_stacked(),
                                         1 << 20, 1 << 20, 1 << 20)[5])
    assert ref.rounds_run == got.rounds_run
    assert_port_trees_equal(ref.result_states(), minus_ring(got.result_states()), "minus ring")
    np.testing.assert_array_equal(snn.output_spike_counts(got.result_states(), built[3]),
                                  job.expected_counts)


def test_event_stream_identical_across_dispatch_modes():
    streams, batches = {}, {}
    for fused in (False, True):
        got_batches = []
        want, got, _, _ = _pair(fused=fused, on_telemetry=got_batches.append)
        assert_events_equal(want.trace_events(), got.trace_events(), f"fused={fused}")
        streams[fused] = np.sort(got.trace_events(), order=list(tr.FIELDS))
        batches[fused] = got_batches
    np.testing.assert_array_equal(streams[False], streams[True])
    for fused, got in batches.items():
        assert sum(len(b) for b in got) == len(streams[fused])
        assert all(len(b) for b in got), "empty batches are not delivered"


def test_one_host_fetch_per_fused_dispatch_with_telemetry(monkeypatch):
    """The rings travel in the dispatch's one fetch: drains add no sync."""
    real, calls = ctl_mod._HOST_FETCH, []

    def counting_fetch(x):
        calls.append(1)
        return real(x)

    monkeypatch.setattr(ctl_mod, "_HOST_FETCH", counting_fetch)
    want, got, _, _ = _pair(rounds_per_dispatch=3)
    assert got.dispatches == want.dispatches > 1
    assert len(calls) == got.dispatches == got.dispatch_syncs
    assert_events_equal(want.trace_events(), got.trace_events())
    assert_tree_equal(want.result_states(), got.result_states(), "states")


@pytest.mark.parametrize("fused", [True, False])
def test_faulted_drop_policy_trace_matches_jax(fused):
    """Transport faults and the drop policy over a small outbox: the
    fault_injected, spikes_dropped and watermark lanes."""
    fc = dict(seed=7, p_spike_drop=0.2, p_spike_dup=0.1, on_overflow="drop")
    want, got, _, _ = _pair(fused=fused, jkw=dict(faults=JFaultConfig(**fc), out_cap=8),
                            kw=dict(faults=faults.FaultConfig(**fc), out_cap=8))
    ev = got.trace_events()
    for k in (tr.EV_FAULT, tr.EV_SPIKE_LOSS, tr.EV_WMARK):
        assert (ev["kind"] == k).any(), tr.KIND_NAMES[k]
    assert_events_equal(want.trace_events(), ev)
    assert_tree_equal(want.result_states(), got.result_states(), "states")
    assert_dict_equal(want.metrics(), got.metrics(), "metrics")


@pytest.mark.parametrize("fused", [True, False])
def test_watermark_error_keeps_the_telemetry_before_it(fused):
    """An outbox overflow raises the reference's message on both paths, and
    the events drained before the raise equal the reference's."""
    _, built_j = _snn(jsnn, out_cap=8)
    _, built = _snn(snn, out_cap=8, device="cpu")
    want = JController(*built_j[:3], quantum=32, obs=JTraceConfig())
    got = Controller(*built[:3], quantum=32, obs=TraceConfig(), device="cpu")
    errors = []
    for c in (want, got):
        with pytest.raises(RuntimeError, match="outbox overflow") as e:
            c.run(max_rounds=300, check_every=2, fused=fused)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    ev = got.trace_events()
    assert (ev["kind"] == tr.EV_WMARK).any()
    assert_events_equal(want.trace_events(), ev)


def test_drain_telemetry_between_runs_matches_jax():
    """A user drain between two runs: the batch and the reset ring equal the
    reference's, and no event is drained twice."""
    _, built_j = _snn(jsnn)
    _, built = _snn(snn, device="cpu")
    want = JController(*built_j[:3], quantum=32, obs=JTraceConfig())
    got = Controller(*built[:3], quantum=32, obs=TraceConfig(), device="cpu")
    for c in (want, got):
        c.run(max_rounds=4, check_every=2, fused=False)
        c.drain_telemetry()
        c.run(max_rounds=300, check_every=2, rounds_per_dispatch=5)
    assert_events_equal(want.trace_events(), got.trace_events())
    assert_tree_equal(want.result_states(), got.result_states(), "states")
    assert len(got.drain_telemetry()) == len(want.drain_telemetry()) == 0
    untraced = Controller(*built[:3], quantum=32, device="cpu")
    assert len(untraced.drain_telemetry()) == 0 and len(untraced.trace_events()) == 0


# ---------------------------------------------------------------------------
# the stats() reads of tests/test_system.py, as parity cases


def _system_job(pkg_sg, pkg_wl, case, **dev):
    if case == "riscv":
        layer = pkg_wl.Layer("sys", "riscv", 16, 12, 3)
        job = pkg_wl.riscv_workload(layer)
        return pkg_sg.build(pkg_sg.uniform(2, 2), programs=job["programs"],
                            dram_words=job["dram"], **dev), 4096, 300
    if case == "txn_histogram":
        layer = pkg_wl.Layer("sys", "tr", 8, 8, 2)
        descs = pkg_sg.load_oriented()
        job = pkg_wl.cim_workload(layer, mgr_segments=[1], cim_ids_per_mgr={1: (0, 2)},
                                  ordinals=pkg_sg.mailbox_ordinals(descs))
        latency = 3000
    else:
        layer = pkg_wl.Layer("sys", "cim", 20, 16, 6)
        if case == "cim_uniform":
            descs, mgrs, ids = pkg_sg.uniform(2, 2), [0, 1], {0: (0, 1), 1: (2, 3)}
        else:
            descs, mgrs, ids = pkg_sg.load_oriented(), [1], {1: (0, 2)}
        job = pkg_wl.cim_workload(layer, mgr_segments=mgrs, cim_ids_per_mgr=ids,
                                  ordinals=pkg_sg.mailbox_ordinals(descs))
        latency = 5000
    built = pkg_sg.build(descs, programs=job["programs"], dram_words=job["dram"],
                         crossbars=job["crossbars"], scratch_init=job["scratch"],
                         channel_latency=latency, **dev)
    return built, latency, 300 if case == "txn_histogram" else 400


@pytest.mark.parametrize("case", ["riscv", "cim_uniform", "cim_load_oriented", "txn_histogram"])
def test_system_stats_reads_match_jax(case):
    """tests/test_system.py:29,53,86 read ``stats()`` after a dense run: the
    port's dicts equal the reference's, and the reference test's own
    assertions hold on them."""
    built_j, quantum, max_rounds = _system_job(jsg, jwl, case)
    built, _, _ = _system_job(sg, wl, case, device="cpu")
    want = JController(*built_j, backend="vmap", quantum=quantum)
    got = Controller(*built, backend="vmap", quantum=quantum, device="cpu")
    for c in (want, got):
        c.run(max_rounds=max_rounds, check_every=1)
    assert got.rounds_run == want.rounds_run
    st = got.stats()
    assert_dict_equal(want.stats(), st, "stats")
    assert_dict_equal(want.metrics(), got.metrics(), "metrics")
    if case == "riscv":
        assert st["dram"]["reads"].sum() >= (16 * 12 + 12 * 3 + 16 * 3) / 8 * 0.5
        assert st["cache"]["d_hits"].sum() > 0
    elif case == "txn_histogram":
        hist = st["txn_histogram"]
        assert hist[1] > 0 and hist[2] > 0 and hist[0] > 0, hist
    else:
        assert st["cim_ops"].sum() == 6


# ---------------------------------------------------------------------------
# the untraced path: exactly the ops it issued before telemetry existed

class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _op_small(**kw):
    job = snn.snn_inference_job((16, 12, 8), t_steps=6, rate=0.6, seed=5)
    descs = snn.segmentation_for(2, "uniform", n_segments=2)
    return snn.build_snn(job.layers, descs, job.raster, device="cpu", **kw)[:3], 32


def _op_cim():
    layer = wl.Layer("mega", "t", 8, 8, 4)
    job = wl.cim_workload(layer, mgr_segments=[0, 1], cim_ids_per_mgr={0: (0, 1), 1: (2, 3)})
    return sg.build(sg.uniform(2, 2), programs=job["programs"], dram_words=job["dram"],
                    crossbars=job["crossbars"], scratch_init=job["scratch"], channel_latency=500,
                    device="cpu"), 500


def _op_hybrid():
    job = snn.hybrid_job((16, 12, 8), t_steps=6, rate=0.5, seed=2)
    return snn.build_hybrid(job, "packed", channel_latency=2000, device="cpu")[:3], 400


OP_JOBS = {
    "snn": _op_small,
    "snn_faults": lambda: _op_small(faults=faults.FaultConfig(
        seed=7, p_spike_drop=0.2, p_spike_dup=0.1, p_dead=0.1, on_overflow="drop")),
    "cim": _op_cim,
    "hybrid": _op_hybrid,
}
# (ops, sha256 of their names in order) of the second round (or a 2-round
# fused dispatch) of each job, counted on the tree before telemetry was
# added (torch 2.13.0+cpu)
UNTRACED_OPS = {
    "snn/vmap/round": (324, "ee6ac18485d2c042"),
    "snn/sequential/round": (618, "003b7b5f7eccea4b"),
    "snn/vmap/dispatch": (818, "1dbc88ce4ff0834a"),
    "snn_faults/vmap/round": (449, "fdba4651534c6a2d"),
    "snn_faults/sequential/round": (868, "50f8d5ddd78c543a"),
    "snn_faults/vmap/dispatch": (1077, "34f2ca70c6fc57a5"),
    "cim/vmap/round": (2352, "afd7060cc8a77dc0"),
    "cim/sequential/round": (4674, "ff5002459a1ece66"),
    "cim/vmap/dispatch": (50381, "36244d85aa4fb029"),
    "hybrid/vmap/round": (156118, "3319bc32301d452c"),
    "hybrid/sequential/round": (4547, "c64827bd02f3de0a"),
    "hybrid/vmap/dispatch": (312406, "462b49a8c816fa40"),
}


@pytest.mark.parametrize("case", list(UNTRACED_OPS))
def test_untraced_path_issues_the_same_ops_as_before(case):
    """``obs=None`` leaves the step, the round and the fused dispatch as they
    were: the same aten ops in the same order (a CPU round's ops are the
    card's kernels, each plain version aside)."""
    name, backend, how = case.split("/")
    built, quantum = OP_JOBS[name]()
    ctl = Controller(*built, backend=backend, quantum=quantum, device="cpu")
    ctl.round()
    with _OpLog() as log:
        if how == "round":
            ctl.round()
        else:
            ctl._dispatch(1, 2, 2)
    got = (len(log.names), hashlib.sha256("\n".join(log.names).encode()).hexdigest()[:16])
    assert got == UNTRACED_OPS[case]
