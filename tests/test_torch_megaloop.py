"""The port's fused dispatch (``Controller.run(fused=True)``, the default on
``vmap``) against its per-round path and against the JAX package's
megaloop: the same final trees leaf for leaf, ``rounds_run``,
``dispatches`` and watermark messages byte for byte, over the reference's
grid of check cadences and dispatch sizes (``tests/test_megaloop.py``);
the one-host-fetch-per-dispatch contract, early termination, errors, a
free re-run and the fused ``degradation_sweep``
(``tests/test_conformance.py``).  On the CPU the dispatch body runs
eagerly; the tests marked ``cuda`` hold the captured graph against the
per-round path on a card.  Quanta stay small: the port's CPU slot scan is
the plain per-slot loop."""
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro import snn as jsnn
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.vp import platform as jpf
from repro.vp import workloads as jwl
from repro_torch import faults, snn, tree
from repro_torch.core import controller as ctl_mod
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.vp import platform as pf
from repro_torch.vp import workloads as wl
from torch_parity import assert_tree_equal

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

QUANTUM = 500  # = the cim job's channel latency; 6 rounds to completion
GRID = [(1, 1), (2, 3), (3, 64), (4, 2), (1, 256)]  # (check_every, rounds_per_dispatch)


def build_cim(pkg_sg, pkg_wl, channel_latency=QUANTUM, **kw):
    """The reference's megaloop job: an 8x8x4 layer offloaded by both
    managers of a uniform 2x2 platform."""
    layer = pkg_wl.Layer("mega", "t", 8, 8, 4)
    job = pkg_wl.cim_workload(layer, mgr_segments=[0, 1],
                              cim_ids_per_mgr={0: (0, 1), 1: (2, 3)})
    return pkg_sg.build(pkg_sg.uniform(2, 2), programs=job["programs"],
                        dram_words=job["dram"], crossbars=job["crossbars"],
                        scratch_init=job["scratch"], channel_latency=channel_latency, **kw)


def build_snn(pkg, **kw):
    job = pkg.snn_inference_job((16, 12, 8), t_steps=6, rate=0.6, seed=5)
    descs = pkg.segmentation_for(2, "uniform", n_segments=2)
    return pkg.build_snn(job.layers, descs, job.raster, **kw)[:3]


SIMS = {"cim": (lambda: build_cim(jsg, jwl), lambda: build_cim(sg, wl, device="cpu"), QUANTUM),
        "snn": (lambda: build_snn(jsnn), lambda: build_snn(snn, device="cpu"), 32)}


def port_run(built, quantum, check_every, max_rounds=300, backend="vmap", device="cpu",
             **kw):
    ctl = Controller(*built, backend=backend, quantum=quantum, device=device)
    ctl.run(max_rounds=max_rounds, check_every=check_every, **kw)
    return ctl


def jax_run(built, quantum, check_every, max_rounds=300, **kw):
    ctl = JController(*built, backend="vmap", quantum=quantum)
    ctl.run(max_rounds=max_rounds, check_every=check_every, **kw)
    return ctl


def assert_same_run(want, got, what):
    """Two port controllers: equal ``rounds_run`` and trees, leaf for leaf."""
    assert got.rounds_run == want.rounds_run, f"{what}: rounds"
    for name, a, b in (("states", want.result_states(), got.result_states()),
                       ("pending", want._pending_stacked(), got._pending_stacked())):
        a, b = tree.leaves(tree.to_numpy(a)), tree.leaves(tree.to_numpy(b))
        assert [p for p, _ in a] == [p for p, _ in b], f"{what} {name}: keys"
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype, f"{what} {name}{path}: dtype"
            np.testing.assert_array_equal(y, x, err_msg=f"{what} {name}{path}")


@pytest.fixture(scope="module")
def sims():
    """Each job built once by both packages, and the port's per-round run
    per check cadence."""
    built = {name: (make_j(), make_t(), q) for name, (make_j, make_t, q) in SIMS.items()}
    per_round = {(name, ce): port_run(b[1], b[2], ce, fused=False)
                 for name, b in built.items() for ce in sorted({ce for ce, _ in GRID})}
    return built, per_round


@pytest.mark.parametrize("check_every,k", GRID)
@pytest.mark.parametrize("name", list(SIMS))
def test_fused_matches_per_round_and_jax(sims, name, check_every, k):
    built, per_round = sims
    jax_built, port_built, quantum = built[name]
    got = port_run(port_built, quantum, check_every, fused=True, rounds_per_dispatch=k)
    assert_same_run(per_round[(name, check_every)], got, f"{name} fused vs per-round")
    want = jax_run(jax_built, quantum, check_every, fused=True, rounds_per_dispatch=k)
    assert (got.rounds_run, got.dispatches, got.dispatch_syncs) == \
        (want.rounds_run, want.dispatches, want.dispatch_syncs)
    assert got.dispatches == -(-got.rounds_run // k)
    assert_tree_equal(want.result_states(), got.result_states(), "states")
    assert_tree_equal(want._pending_stacked(), got._pending_stacked(), "pending")


def test_fused_is_the_vmap_default_and_sequential_loops_per_round(sims):
    built, per_round = sims
    _, port_built, quantum = built["snn"]
    default = port_run(port_built, quantum, 2)
    assert default.dispatches == default.dispatch_syncs == 1
    seq = port_run(port_built, quantum, 2, backend="sequential", fused=True)
    assert seq.dispatches == 0
    assert_same_run(per_round[("snn", 2)], default, "vmap default")
    assert_same_run(per_round[("snn", 2)], seq, "sequential fused=True")


def test_early_termination(sims):
    """A job that finishes long before max_rounds stops at the same check
    round fused and per-round, in one dispatch, as in the reference."""
    built, per_round = sims
    jax_built, port_built, quantum = built["cim"]
    got = port_run(port_built, quantum, 2, max_rounds=500, rounds_per_dispatch=500)
    want = jax_run(jax_built, quantum, 2, max_rounds=500, fused=True,
                   rounds_per_dispatch=500)
    assert got.rounds_run == per_round[("cim", 2)].rounds_run == want.rounds_run < 500
    assert got.dispatches == want.dispatches == 1


def test_inbox_overflow_message_matches_jax(monkeypatch):
    """IN_CAP shrunk so the managers' MMIO burst overflows the pending box:
    the fused and per-round paths stop at the same check and raise the
    reference's message byte for byte."""
    monkeypatch.setattr(jpf, "IN_CAP", 4)
    monkeypatch.setattr(pf, "IN_CAP", 4)
    with pytest.raises(RuntimeError, match="overflow") as want:
        jax_run(build_cim(jsg, jwl), QUANTUM, 2, fused=True, rounds_per_dispatch=64)
    msgs = {}
    for fused in (False, True):
        ctl = Controller(*build_cim(sg, wl, device="cpu"), quantum=QUANTUM, device="cpu")
        with pytest.raises(RuntimeError) as got:
            ctl.run(max_rounds=300, check_every=2, fused=fused, rounds_per_dispatch=64)
        msgs[fused] = (ctl.rounds_run, str(got.value))
    assert msgs[True] == msgs[False]
    assert msgs[True][1] == str(want.value)
    assert msgs[True][1].startswith("pending inbox overflow")


BURST_SIZES = (8, 200, 8)  # 200-neuron middle layer: 200-spike AER bursts


def _burst(pkg, **caps):
    job = pkg.snn_inference_job(BURST_SIZES, t_steps=3, rate=0.9, seed=4)
    descs = pkg.segmentation_for(2, "uniform", n_segments=2)
    return pkg.build_snn(job.layers, descs, job.raster, **caps)[:3]


def _store_log(pkg_sg, pkg_wl, **kw):
    # a RISC-V VMM writing its whole output matrix: store_log=2 overflows
    job = pkg_wl.riscv_workload(pkg_wl.Layer("conf", "t", 8, 8, 4))
    return pkg_sg.build([pkg_sg.SegmentDesc(cpu=True, dram=True)], programs=job["programs"],
                        dram_words=job["dram"], store_log=2, **kw)


CAP_ERRORS = {  # cap -> (builds: JAX, port; quantum; the message's start)
    "out_cap": (lambda: _burst(jsnn, out_cap=64), lambda: _burst(snn, out_cap=64, device="cpu"),
                32, "outbox overflow"),
    "in_cap": (lambda: _burst(jsnn, in_cap=80), lambda: _burst(snn, in_cap=80, device="cpu"),
               32, "pending inbox overflow"),
    "store_log": (lambda: _store_log(jsg, jwl), lambda: _store_log(sg, wl, device="cpu"),
                  400, "DRAM store-log overflow"),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cap", list(CAP_ERRORS))
def test_undersized_cap_raises_actionable_error(cap, fused):
    make_j, make_t, quantum, start = CAP_ERRORS[cap]
    ctl_j = JController(*make_j(), backend="vmap", quantum=quantum)
    with pytest.raises(RuntimeError) as want:
        ctl_j.run(max_rounds=300, check_every=2, fused=fused)
    ctl = Controller(*make_t(), quantum=quantum, device="cpu")
    with pytest.raises(RuntimeError) as got:
        ctl.run(max_rounds=300, check_every=2, fused=fused)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(start)
    assert f"raise {cap}" in str(got.value) and f"smallest sufficient {cap}=" in str(got.value)
    assert (ctl.rounds_run, ctl.dispatches) == (ctl_j.rounds_run, ctl_j.dispatches)
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), "states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), "pending")


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_controller_usable_after_watermark_error(backend):
    """After one controller aborts on overflow its state stays readable,
    and a fresh controller on a fresh job runs to the oracle's counts."""
    bad = Controller(*_burst(snn, out_cap=24, device="cpu"), backend=backend, quantum=32,
                     device="cpu")
    with pytest.raises(RuntimeError, match="outbox overflow"):
        bad.run(max_rounds=300, check_every=2)
    assert int(bad.result_states()["stats"]["outbox_peak"].max()) > 24
    job = snn.snn_inference_job((16, 12, 8), t_steps=6, rate=0.6, seed=5)
    descs = snn.segmentation_for(2, "uniform", n_segments=2)
    cfg, states, pending, meta = snn.build_snn(job.layers, descs, job.raster, device="cpu")
    good = Controller(cfg, states, pending, backend=backend, quantum=32, device="cpu")
    good.run(max_rounds=300, check_every=2)
    np.testing.assert_array_equal(snn.output_spike_counts(good.result_states(), meta),
                                  job.expected_counts)


def test_one_host_fetch_per_dispatch(monkeypatch):
    real, calls = ctl_mod._HOST_FETCH, []

    def counting_fetch(x):
        calls.append(1)
        return real(x)

    monkeypatch.setattr(ctl_mod, "_HOST_FETCH", counting_fetch)
    ctl = port_run(build_snn(snn, device="cpu"), 32, 2, max_rounds=400, fused=True,
                   rounds_per_dispatch=5)
    assert ctl.dispatches > 1
    assert len(calls) == ctl.dispatches == ctl.dispatch_syncs


def test_rounds_per_dispatch_below_one_raises():
    ctl = Controller(*build_snn(snn, device="cpu"), quantum=32, device="cpu")
    with pytest.raises(ValueError, match="rounds_per_dispatch must be >= 1"):
        ctl.run(fused=True, rounds_per_dispatch=0)
    assert (ctl.rounds_run, ctl.dispatches) == (0, 0)


def test_rerun_is_free_and_close_refuses_fused():
    ctl = port_run(build_snn(snn, device="cpu"), 32, 2, fused=True, rounds_per_dispatch=7)
    before = (ctl.rounds_run, ctl.dispatches, ctl.dispatch_syncs)
    assert ctl.run(fused=True)[0] == before[0]
    assert (ctl.rounds_run, ctl.dispatches, ctl.dispatch_syncs) == before
    ref = JController(*build_snn(jsnn), quantum=32)
    ref.close()
    ctl.close()
    with pytest.raises(RuntimeError) as want:
        ref.run(fused=True)
    with pytest.raises(RuntimeError) as got:
        ctl.run(fused=True)
    assert str(got.value) == str(want.value)


def test_round_then_run_continues_the_same_job(sims):
    """Rounds stepped by ``round()`` rebind the live trees; the next fused
    dispatch starts from them, as the per-round path does."""
    built, per_round = sims
    _, port_built, quantum = built["snn"]
    ctl = Controller(*port_built, quantum=quantum, device="cpu")
    ctl.run(max_rounds=3, check_every=2, rounds_per_dispatch=2)
    ctl.round()
    ctl.run(max_rounds=300, check_every=2, rounds_per_dispatch=4)
    want = Controller(*port_built, quantum=quantum, device="cpu")
    for _ in range(4):
        want.round()
    want.run(max_rounds=300, check_every=2, fused=False)
    assert_same_run(want, ctl, "round() between fused runs")


def test_trees_read_from_a_controller_stay_as_they_were(sims):
    """The fused dispatch writes its buffers in place: a tree read after
    one run() must not change when the same controller runs on."""
    built, _ = sims
    _, port_built, quantum = built["snn"]
    ctl = Controller(*port_built, quantum=quantum, device="cpu")
    ctl.run(max_rounds=3, check_every=2, rounds_per_dispatch=2)
    trees = (ctl.states, ctl.pending, ctl.result_states(), ctl._pending_stacked())
    before = [tree.to_numpy(tree.tree_map(torch.clone, t)) for t in trees]
    ctl.run(max_rounds=300, check_every=2)
    assert ctl._finished and ctl.rounds_run > 3
    for want, got in zip(before, trees):
        for (path, x), (_, y) in zip(tree.leaves(want), tree.leaves(tree.to_numpy(got))):
            np.testing.assert_array_equal(y, x, err_msg=f"snapshot{path}")


@pytest.mark.parametrize("fused", [True, False])
def test_degradation_sweep_fused_matches_jax(fused):
    """The sweep fused (its default, as the reference's) and per-round
    against the reference's fused sweep."""
    job_j = jsnn.snn_inference_job((16, 12, 8), t_steps=12, rate=0.4, seed=3)
    job = snn.snn_inference_job((16, 12, 8), t_steps=12, rate=0.4, seed=3)
    want = jfaults.degradation_sweep(job_j, (0.0, 0.3), seed=7)
    got = faults.degradation_sweep(job, (0.0, 0.3), seed=7, fused=fused, device="cpu")
    for w, g in zip(want, got):
        assert (g["rate"], g["fidelity"], g["total_spikes"], g["rounds"]) == \
            (w["rate"], w["fidelity"], w["total_spikes"], w["rounds"])
        np.testing.assert_array_equal(g["counts"], np.asarray(w["counts"]))


if HAVE_HYPOTHESIS:

    @settings(max_examples=6, deadline=None)
    @given(check_every=st.integers(min_value=1, max_value=5),
           k=st.sampled_from([1, 2, 3, 7, 64]),
           backend=st.sampled_from(["vmap", "sequential"]))
    def test_fused_property(check_every, k, backend):
        """Random cadence, dispatch size and per-round backend: the fused
        dispatch equals the per-round run."""
        built = build_snn(snn, device="cpu")
        want = port_run(built, 32, check_every, backend=backend, fused=False)
        got = port_run(built, 32, check_every, fused=True, rounds_per_dispatch=k)
        assert_same_run(want, got, f"check_every={check_every} k={k} vs {backend}")


# ---------------------------------------------------------------------------
# on a card: the captured dispatch against the per-round path


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("check_every,k", GRID)
@pytest.mark.parametrize("name", list(SIMS))
def test_cuda_captured_dispatch_matches_per_round(name, check_every, k):
    _cuda()
    _, make_t, quantum = SIMS[name]
    built = make_t()
    want = port_run(built, quantum, check_every, device="cuda", fused=False)
    got = port_run(built, quantum, check_every, device="cuda", fused=True,
                   rounds_per_dispatch=k)
    assert got._graph is not None and got.dispatches == -(-got.rounds_run // k)
    assert_same_run(want, got, f"{name} captured vs per-round")


@pytest.mark.cuda
def test_cuda_captured_dispatch_one_fetch_under_sync_debug(monkeypatch):
    _cuda()
    real = ctl_mod._HOST_FETCH

    def fetch(x):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(x)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(ctl_mod, "_HOST_FETCH", fetch)
    ctl = Controller(*build_snn(snn, device="cuda"), quantum=32, device="cuda")
    ctl.capture()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ctl.run(max_rounds=300, check_every=2, rounds_per_dispatch=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ctl._finished and ctl.dispatch_syncs == ctl.dispatches > 1
