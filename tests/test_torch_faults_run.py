"""Faulted runs of the port against the JAX package: for each fault family
of tests/test_faults.py, the built trees, the final trees and
``rounds_run`` equal the reference's on ``vmap`` and ``sequential``; off
means off (``faults=None`` and zero-rate configs build the clean tree);
results do not depend on the segmentation; the drop policy loses and counts
the reference's spikes, and the default policy raises its message byte for
byte; the store log stays fatal under drop; a small ``degradation_sweep``,
a dense offload under crossbar faults and a wide layer's faulted column
group equal the reference's."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import faults as jflt
from repro import snn as jsnn
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.vp import workloads as jwl
from repro_torch import faults as flt
from repro_torch import snn
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.vp import workloads as wl
from torch_parity import assert_tree_equal, cfg_fields

QUANTUM = 32
SIZES = (32, 24, 10)  # the job of tests/test_faults.py
FAMILIES = {
    "transport": dict(seed=7, p_spike_drop=0.25, p_spike_dup=0.1),
    "crossbar": dict(seed=7, p_stuck0=0.1, p_stuck1=0.05, p_bitflip=0.05,
                     p_row_fail=0.02, p_col_fail=0.02),
    "neuron": dict(seed=7, p_dead=0.2, p_thresh_drift=0.3),
    "all": dict(seed=7, p_spike_drop=0.2, p_stuck0=0.1, p_dead=0.1),
}
FAULT_KEYS = {"cims": ("f_and", "f_xor", "f_dead", "f_dth", "f_uid"),
              "stats": ("spikes_dropped", "spikes_duped", "outbox_lost")}


def _config(pkg, kw):
    return None if kw is None else pkg.FaultConfig(**kw)


def _build(pkg, kw, strategy="uniform", n_segments=2, sizes=SIZES, t_steps=8,
           rate=0.5, seed=2, **build_kw):
    job = pkg.snn_inference_job(sizes, t_steps=t_steps, rate=rate, seed=seed)
    descs = pkg.segmentation_for(pkg.n_units_for(job.layers), strategy,
                                 **({"n_segments": n_segments}
                                    if strategy == "uniform" else {}))
    faults = _config(jflt if pkg is jsnn else flt, kw)
    if pkg is snn:
        build_kw["device"] = "cpu"
    return pkg.build_snn(job.layers, descs, job.raster, faults=faults, **build_kw), job


def _run_jax(built, backend="vmap"):
    cfg, states, pending, meta = built
    ctl = JController(cfg, states, pending, backend=backend, quantum=QUANTUM)
    ctl.run(max_rounds=400, check_every=2, fused=False)
    return ctl


def _run(built, backend="vmap"):
    cfg, states, pending, meta = built
    ctl = Controller(cfg, states, pending, backend=backend, quantum=QUANTUM, device="cpu")
    ctl.run(max_rounds=400, check_every=2)
    return ctl


def _readback(pkg, ctl, meta):
    st = ctl.result_states()
    return (np.asarray(pkg.output_spike_counts(st, meta)).tolist(),
            int(pkg.total_spikes(st)))


@pytest.fixture(scope="module", params=list(FAMILIES))
def family_run(request):
    """The reference run (vmap, per-round dispatch) of one family."""
    built, _ = _build(jsnn, FAMILIES[request.param])
    ctl = _run_jax(built)
    return (request.param, built, ctl.rounds_run,
            jax.tree.map(np.asarray, ctl.result_states()),
            jax.tree.map(np.asarray, ctl._pending_stacked()))


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_family_run_matches_jax(family_run, backend):
    family, (cfg_j, st_j0, pen_j0, _), rounds, st_j, pen_j = family_run
    built, _ = _build(snn, FAMILIES[family])
    assert cfg_fields(built[0]) == cfg_fields(cfg_j)
    assert_tree_equal(st_j0, built[1], f"{family} built states")
    assert_tree_equal(pen_j0, built[2], f"{family} built pending")
    ctl = _run(built, backend)
    assert ctl.rounds_run == rounds
    assert_tree_equal(st_j, ctl.result_states(), f"{family}/{backend} states")
    assert_tree_equal(pen_j, ctl._pending_stacked(), f"{family}/{backend} pending")
    stats = ctl.result_states()["stats"]
    if "spikes_dropped" in stats:  # the transport branch really ran
        assert int(stats["spikes_dropped"].sum()) > 0


@pytest.mark.parametrize("kw,present", [
    (None, ()),
    (dict(seed=99), ()),
    (dict(on_overflow="drop"), ("outbox_lost",)),
    (dict(seed=5, p_spike_dup=0.1), ("f_uid", "spikes_dropped", "spikes_duped")),
    (dict(seed=5, p_dead=0.1), ("f_dead", "f_dth")),
    (dict(seed=5, p_bitflip=0.1), ("f_and", "f_xor")),
], ids=["none", "zero-rate", "drop-only", "transport", "neuron", "crossbar"])
def test_fault_arrays_exist_exactly_when_their_family_is_on(kw, present):
    (cfg, states, _, _), _ = _build(snn, kw)
    (_, st_j, _, _), _ = _build(jsnn, kw)
    assert_tree_equal(st_j, states, "built states")
    have = {k for part, keys in FAULT_KEYS.items() for k in keys if k in states[part]}
    assert have == set(present)
    assert ("faults" in states) == ("f_uid" in present)
    if "f_uid" in present:
        assert states["faults"]["seed"].dtype.is_signed is False


@pytest.mark.parametrize("kw", [None, dict(seed=99)], ids=["none", "zero-rate"])
def test_off_means_off(kw):
    """faults=None and a zero-rate config run to the clean build's result."""
    clean, job = _build(snn, None)
    ctl = _run(_build(snn, kw)[0])
    ref = _run(clean)
    assert ctl.rounds_run == ref.rounds_run
    assert_tree_equal(jax.tree.map(lambda x: x.numpy(), ref.result_states()),
                      ctl.result_states(), "states")
    np.testing.assert_array_equal(
        snn.output_spike_counts(ctl.result_states(), clean[3]), job.expected_counts)


def test_neutral_crossbar_masks_run_as_the_clean_build():
    """Crossbar faults drawn at a rate too small to land: the masks are
    neutral (f_and = -1, f_xor = 0) and the run equals the clean one."""
    built, _ = _build(snn, dict(seed=1, p_col_fail=1e-12))
    cims = built[1]["cims"]
    assert (cims["f_and"] == -1).all() and (cims["f_xor"] == 0).all()
    ctl, ref = _run(built), _run(_build(snn, None)[0])
    assert ctl.rounds_run == ref.rounds_run
    assert _readback(snn, ctl, built[3]) == _readback(snn, ref, built[3])


def test_results_do_not_depend_on_the_segmentation():
    kw = FAMILIES["all"]
    built_j, _ = _build(jsnn, kw)
    want = _readback(jsnn, _run_jax(built_j), built_j[3])
    for strategy, n_segments in (("uniform", 2), ("uniform", 3), ("load_oriented", 4)):
        built, _ = _build(snn, kw, strategy, n_segments)
        assert _readback(snn, _run(built), built[3]) == want, (strategy, n_segments)


BURST = dict(sizes=(8, 200, 8), t_steps=3, rate=0.9, seed=4)


@pytest.mark.parametrize("caps,lost", [
    (dict(out_cap=24), "outbox_lost"),
    (dict(in_cap=48, out_cap=640), "lost_total"),
], ids=["outbox", "inbox"])
def test_drop_policy_counts_the_references_loss(caps, lost):
    drop = dict(on_overflow="drop")
    built_j, _ = _build(jsnn, drop, **BURST, **caps)
    ctl_j = _run_jax(built_j)
    for backend in ("vmap", "sequential"):
        built, _ = _build(snn, drop, **BURST, **caps)
        ctl = _run(built, backend)
        assert ctl.rounds_run == ctl_j.rounds_run
        assert_tree_equal(ctl_j.result_states(), ctl.result_states(), f"{backend} states")
        assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(),
                          f"{backend} pending")
        where = (ctl._pending_stacked() if lost == "lost_total"
                 else ctl.result_states()["stats"])
        assert int(where[lost].sum()) > 0

    # the default policy raises the reference's message, byte for byte
    built_j, _ = _build(jsnn, None, **BURST, **caps)
    with pytest.raises(RuntimeError) as want:
        _run_jax(built_j)
    built, _ = _build(snn, None, **BURST, **caps)
    ctl = Controller(*built[:3], quantum=QUANTUM, device="cpu")
    with pytest.raises(RuntimeError) as got:
        ctl.run(max_rounds=400, check_every=2)
    assert str(got.value) == str(want.value)


def test_store_log_overflow_stays_fatal_under_drop():
    job_j = jwl.riscv_workload(jwl.Layer("flt", "t", 8, 8, 4))
    job = wl.riscv_workload(wl.Layer("flt", "t", 8, 8, 4))
    descs = lambda mod: [mod.SegmentDesc(cpu=True, dram=True)]
    kw = dict(store_log=2)
    cfg_j, st_j, pen_j = jsg.build(descs(jsg), programs=job_j["programs"],
                                   dram_words=job_j["dram"],
                                   faults=jflt.FaultConfig(on_overflow="drop"), **kw)
    with pytest.raises(RuntimeError) as want:
        JController(cfg_j, st_j, pen_j, quantum=400).run(max_rounds=50, check_every=2,
                                                         fused=False)
    built = sg.build(descs(sg), programs=job["programs"], dram_words=job["dram"],
                     faults=flt.FaultConfig(on_overflow="drop"), device="cpu", **kw)
    with pytest.raises(RuntimeError) as got:
        Controller(*built, quantum=400, device="cpu").run(max_rounds=50, check_every=2)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("DRAM store-log overflow")


def test_degradation_sweep_matches_jax():
    job_j = jsnn.snn_inference_job((16, 12, 8), t_steps=8, rate=0.5, seed=2)
    job = snn.snn_inference_job((16, 12, 8), t_steps=8, rate=0.5, seed=2)
    rates = (0.0, 0.3, 1.0)
    want = jsnn.degradation_sweep(job_j, rates, fault_kind="transport", seed=7,
                                  fused=False)
    got = snn.degradation_sweep(job, rates, fault_kind="transport", seed=7,
                                device="cpu")
    assert [r["fidelity"] for r in got][0] == 1.0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        np.testing.assert_array_equal(g.pop("counts"), w.pop("counts"))
        assert g == w


def test_dense_offload_under_crossbar_faults_matches_jax():
    """The 8x8x2 load-oriented offload: the units' masks differ (each has
    its own uid), so the faulted O differs from A @ B column by column."""
    fc = FAMILIES["crossbar"]
    layer_j, layer = jwl.Layer("x", "t", 8, 8, 2), wl.Layer("x", "t", 8, 8, 2)

    def build(sg_mod, wl_mod, lay, faults, **kw):
        descs = sg_mod.load_oriented()
        job = wl_mod.cim_workload(lay, [1], {1: (0, 2)},
                                  ordinals=sg_mod.mailbox_ordinals(descs))
        return sg_mod.build(descs, programs=job["programs"], dram_words=job["dram"],
                            crossbars=job["crossbars"], scratch_init=job["scratch"],
                            channel_latency=1000, faults=faults, **kw), job

    (cfg_j, st_j, pen_j), job_j = build(jsg, jwl, layer_j, jflt.FaultConfig(**fc))
    ctl_j = JController(cfg_j, st_j, pen_j, quantum=1000)
    ctl_j.run(max_rounds=400, check_every=2, fused=False)
    (cfg, states, pending), job = build(sg, wl, layer, flt.FaultConfig(**fc), device="cpu")
    assert cfg_fields(cfg) == cfg_fields(cfg_j)
    assert_tree_equal(st_j, states, "built states")
    ctl = Controller(cfg, states, pending, quantum=1000, device="cpu")
    ctl.run(max_rounds=400, check_every=2)
    assert ctl.rounds_run == ctl_j.rounds_run
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), "states")
    o = ctl.result_states()["dram"]["data"][0, job["o_word"]: job["o_word"] + 16]
    assert not np.array_equal(o.numpy().reshape(8, 2), job["expected"])


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_faulted_wide_run_matches_jax(backend):
    """A wide layer (a 2-tile column group) under crossbar and neuron
    faults: the contributor tile's masks are drawn from its own logical
    (layer, stripe, tile) identity, and the faulted grouped tick gives the
    reference's trees and ``rounds_run``."""
    kw = dict(FAMILIES["crossbar"], p_dead=0.2, p_thresh_drift=0.3)

    def build(pkg, **dev):
        job = pkg.snn_inference_job((300, 8), t_steps=2, rate=0.5, seed=2)
        descs = pkg.segmentation_for(job.layers, "uniform", n_segments=2)
        return pkg.build_snn(job.layers, descs, job.raster,
                             faults=(jflt if pkg is jsnn else flt).FaultConfig(**kw), **dev)

    built_j = build(jsnn)
    ctl_j = _run_jax(built_j)
    built = build(snn, device="cpu")
    assert built[0].snn_grouped and cfg_fields(built[0]) == cfg_fields(built_j[0])
    assert_tree_equal(built_j[1], built[1], "built states")
    ctl = _run(built, backend)
    assert ctl.rounds_run == ctl_j.rounds_run
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), f"{backend} states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), f"{backend} pending")
    assert snn.total_spikes(ctl.result_states()) > 0


def test_fault_config_is_carried_in_the_vp_config():
    (cfg, *_), _ = _build(snn, FAMILIES["all"])
    assert cfg.faults == flt.FaultConfig(**FAMILIES["all"])
    assert dataclasses.asdict(cfg.faults) == dataclasses.asdict(
        jflt.FaultConfig(**FAMILIES["all"]))
