"""Hybrid dense+spiking jobs in the port against the JAX package: live
RISC-V CPUs driving a dense offload and a spiking network in one platform,
the raster injected through tick-addressed ``CIM_REG_SPIKE`` stores and the
output counts read back through ``CIM_REG_COUNTS``.

The port's counterparts of tests/test_hybrid.py (injection equal to the
pre-scheduled raster under every strategy and quantum, the tick grid's
``t_avail``, late injection and late readback raising the reference's
message on both dispatch paths, the default tick period, injector traffic
and the pinned partition, ``spike_events`` and the build refusals), and
beside them: the jobs, the driver program's words, ``build_hybrid``'s trees
and one step from spike-store states (the slot scan's plain version) equal
to the JAX package's; whole runs on ``vmap`` fused and per-round and on
``sequential`` equal to the reference's trees, ``rounds_run`` and
``hybrid_results``; one run under crossbar and transport faults; and the
CUDA kernel's spike-store path against its plain version (``cuda``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import faults as jflt
from repro import snn as jsnn
from repro.core import channel as jch
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.vp import assembler as jasm
from repro.vp import isa as jisa
from repro.vp import workloads as jwl
from repro_torch import faults as flt
from repro_torch import snn, tree
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.kernels.slot_scan import ops, ref
from repro_torch.vp import assembler as asm
from repro_torch.vp import isa
from repro_torch.vp import platform as pf
from repro_torch.vp import workloads as wl
from torch_parity import assert_tree_equal, carry_across, cfg_fields, single_torch_thread

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

JOB = lambda pkg: pkg.hybrid_job((16, 12, 8), t_steps=6, rate=0.5, seed=2)
# near-saturated raster: ~16 events a timestep at ~7 cycles a store cannot
# fit a 64-cycle tick pitch, so tick-0 stores overrun their deadline
DENSE_RASTER_JOB = lambda pkg: pkg.hybrid_job((16, 12, 8), t_steps=6, rate=1.0, seed=2)
LATE = dict(tick_period=64, channel_latency=64)
STRATEGIES = ("split", "packed", "auto")
FAULTS = dict(seed=7, p_stuck0=0.1, p_bitflip=0.05, p_spike_drop=0.2, p_spike_dup=0.1)


def _build(pkg, job, strategy, **kw):
    if pkg is snn:
        kw["device"] = "cpu"
    return pkg.build_hybrid(job, strategy, **kw)


def _run(sim, backend="vmap", quantum=400, fused=None):
    cfg, states, pending, meta = sim
    ctl = Controller(cfg, states, pending, backend=backend, quantum=quantum, device="cpu")
    ctl.run(max_rounds=800, check_every=2, fused=fused)
    ctl.close()
    return ctl, meta


def _run_jax(sim, quantum=400, fused=None):
    cfg, states, pending, meta = sim
    ctl = JController(cfg, states, pending, backend="vmap", quantum=quantum)
    ctl.run(max_rounds=800, check_every=2, fused=fused)
    return ctl, meta


_RUNS = {}


def _port_run(strategy, quantum=400, backend="vmap", fused=None):
    """One port run of JOB, shared by the tests that read it."""
    key = (strategy, quantum, backend, fused)
    if key not in _RUNS:
        _RUNS[key] = _run(_build(snn, JOB(snn), strategy, channel_latency=2000),
                          backend, quantum, fused)
    return _RUNS[key]


def _assert_both_halves(st, meta, job):
    o, counts = snn.hybrid_results(st, meta)
    np.testing.assert_array_equal(counts, job.snn.expected_counts)
    np.testing.assert_array_equal(o, job.dense_expected)


# ---------------------------------------------------------------------------
# jobs, programs and builds equal the reference's


def test_hybrid_job_matches_jax():
    want, got = JOB(jsnn), JOB(snn)
    for w, g in zip(want.snn.layers, got.snn.layers):
        np.testing.assert_array_equal(g.weights, w.weights)
        assert dataclasses.asdict(g.params) == dataclasses.asdict(w.params)
    np.testing.assert_array_equal(got.snn.raster, want.snn.raster)
    np.testing.assert_array_equal(got.snn.expected_counts, want.snn.expected_counts)
    assert got.snn.expected_total == want.snn.expected_total > 0
    assert got.snn.n_ticks == want.snn.n_ticks == 6 + 2 + 1
    assert dataclasses.asdict(got.dense) == dataclasses.asdict(want.dense)
    np.testing.assert_array_equal(got.dense_expected, want.dense_expected)
    assert got.seed == want.seed


def test_spike_events_and_driver_program_match_jax():
    job = JOB(snn)
    events = wl.spike_events(job.snn.raster)
    np.testing.assert_array_equal(events, jwl.spike_events(job.snn.raster))
    assert events.dtype == np.int32 and len(events) == np.count_nonzero(job.snn.raster)
    assert wl.EV_TABLE == jwl.EV_TABLE
    assert wl.injection_cycles_bound(len(events)) == jwl.injection_cycles_bound(len(events))
    args = (sg.cim_global_base(2), sg.cim_global_base(3), len(events), 9, 8, 1, 4096)
    src = wl.spike_driver_program(*args)
    assert src == jwl.spike_driver_program(*args)
    np.testing.assert_array_equal(asm.assemble(src), np.asarray(jasm.assemble(src)))


def test_spike_events_encoding_and_order():
    raster = np.zeros((3, 4), np.int32)
    raster[0, 2] = 1
    raster[2, 0] = 1
    raster[2, 3] = 1
    ev = wl.spike_events(raster)
    assert ev.tolist() == [isa.pack_spike(0, 2), isa.pack_spike(2, 0), isa.pack_spike(2, 3)]
    assert ev.tolist() == [jisa.pack_spike(0, 2), jisa.pack_spike(2, 0), jisa.pack_spike(2, 3)]
    with pytest.raises(ValueError, match="0/1"):
        wl.spike_events(raster * 2)


def _meta_plain(meta):
    m = dict(meta)
    m["groups"] = [{"group": dataclasses.asdict(g["group"]), "units": g["units"]}
                   for g in meta["groups"]]
    return m


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_build_hybrid_matches_jax(strategy):
    want = jsnn.build_hybrid(JOB(jsnn), strategy, channel_latency=2000)
    got = _build(snn, JOB(snn), strategy, channel_latency=2000)
    assert cfg_fields(got[0]) == cfg_fields(want[0])
    assert got[0].has_cpu and got[0].has_snn and got[0].snn_tick_period == 2000
    assert_tree_equal(want[1], got[1], f"{strategy} built states")
    assert_tree_equal(want[2], got[2], f"{strategy} built pending")
    assert _meta_plain(got[3]) == _meta_plain(want[3])


def test_build_hybrid_passes_faults_through_as_jax():
    want = jsnn.build_hybrid(JOB(jsnn), "split", channel_latency=2000,
                             faults=jflt.FaultConfig(**FAULTS))
    got = _build(snn, JOB(snn), "split", channel_latency=2000,
                 faults=flt.FaultConfig(**FAULTS))
    assert cfg_fields(got[0]) == cfg_fields(want[0])
    assert_tree_equal(want[1], got[1], "faulted built states")


def test_build_hybrid_rejects_wide_input_layer():
    wide = snn.hybrid_job((300, 12, 8), t_steps=2, rate=0.1, seed=0)
    with pytest.raises(ValueError, match="one input tile"):
        snn.build_hybrid(wide, "packed", device="cpu")


def test_build_requires_uniform_tick_period():
    descs = [sg.SegmentDesc(cpu=True, dram=True, n_cims=2, cim_mgr=0)]
    cim_init = {
        0: {"mode": isa.CIM_MODE_SPIKE, "tick_period": 10_000},
        1: {"mode": isa.CIM_MODE_SPIKE, "tick_period": 20_000},
    }
    with pytest.raises(ValueError, match="tick_period"):
        sg.build(descs, cim_init=cim_init, device="cpu")


# ---------------------------------------------------------------------------
# one step from spike-store states: the slot scan's plain version


def _unwired(pkg, seg_mod):
    """A dense platform whose CPU stores to a unit's CIM_REG_SPIKE with no
    ticking unit wired: the store is late MMIO."""
    prog = "\n".join([f"    li t0, {seg_mod.cim_global_base(1)}",
                      f"    li t1, {isa.pack_spike(0, 3)}",
                      f"    sw t1, {isa.CIM_REG_SPIKE}(t0)",
                      "    halt"])
    kw = {} if pkg is jsnn else {"device": "cpu"}
    return (*seg_mod.build(seg_mod.uniform(2, 2), programs={0: prog}, **kw), None)


# (state name) -> (builder for one package, quantum, round): the round in
# which the driver CPU streams its spike stores (the late ones: the first
# round past tick 0's 64-cycle deadline)
SPIKE_STATES = {
    "own-segment": (lambda pkg: _build(pkg, JOB(pkg), "packed", channel_latency=2000),
                    400, 0),
    "across": (lambda pkg: _build(pkg, JOB(pkg), "split", channel_latency=2000), 400, 0),
    "late": (lambda pkg: _build(pkg, DENSE_RASTER_JOB(pkg), "split", **LATE), 400, 1),
    "unwired": (lambda pkg: _unwired(pkg, jsg if pkg is jsnn else sg), 64, 0),
}


@pytest.fixture(scope="module")
def spike_snapshots():
    """{name: (port cfg, quantum, numpy states, pending, t_limit, the JAX
    package's step from there)}: a sequential JAX run at the state's round,
    the reference's compiled one-segment step applied segment by segment."""
    out = {}
    for name, (build, quantum, rounds) in SPIKE_STATES.items():
        cfg_j, states, pending, _ = build(jsnn)
        cfg = build(snn)[0]
        ctl = JController(cfg_j, states, pending, backend="sequential", quantum=quantum)
        for _ in range(rounds):
            ctl.round()
        st, pen = jax.tree.map(np.asarray, (ctl._stacked(), ctl._pending_stacked()))
        lim = np.asarray(ctl._limits(st["time"]))
        take = lambda t, i: jax.tree.map(lambda x: x[i], t)
        want = jax.tree.map(lambda *v: np.stack(v), *[
            jax.tree.map(np.asarray, ctl._step_one(take(st, i), take(pen, i), lim[i]))
            for i in range(cfg_j.n_segments)])
        out[name] = (cfg, quantum, st, pen, lim, want)
    return out


@pytest.mark.parametrize("name", list(SPIKE_STATES))
def test_step_at_spike_stores_matches_jax(spike_snapshots, name):
    cfg, quantum, st, pen, lim, want = spike_snapshots[name]
    assert cfg.snn_tick_period == (0 if name == "unwired" else
                                   64 if name == "late" else 2000)
    tst, tpen, tlim = carry_across((st, pen, lim))
    got = pf.make_segment_step(cfg, quantum)(tst, tpen, tlim)
    for what, w, g in zip(("states", "outbox", "pending"), want, got):
        assert_tree_equal(w, g, what)
    box, stats = got[1], got[0]["stats"]
    spikes = int((box["valid"] & (box["kind"] == pf.ch.MSG_SPIKE)).sum())
    late = int(stats["snn_mmio_late"].sum())
    if name == "unwired":
        assert spikes == 0 and late == 1
    else:
        assert spikes > 0 and (late > 0) == (name == "late")


def _scan_inputs(cfg, st, lim, device):
    tst = tree.from_numpy(st, device)
    box = pf.ch.empty_box(cfg.out_cap, (tst["time"].shape[0],), device)
    wiring = [torch.tensor(x, dtype=torch.int32, device=device)
              for x in (cfg.cim_seg, cfg.cim_slot)]
    return tst, box, torch.from_numpy(lim).to(device), wiring


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPIKE_STATES))
def test_cuda_slot_scan_spike_stores_match_plain(spike_snapshots, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfg, quantum, st, _, lim, _ = spike_snapshots[name]
    outs = []
    for fn in (ops.slot_scan, ref.slot_scan):
        tst, box, tlim, wiring = _scan_inputs(cfg, st, lim, "cuda")
        outs.append(tree.to_numpy(fn(cfg, quantum, tst, box, tlim, *wiring)))
    for k in (0, 1):
        for (path, g), (_, w) in zip(tree.leaves(outs[0][k]), tree.leaves(outs[1][k])):
            np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# tick-gate regression: CPU injection equals the pre-scheduled raster


@pytest.fixture(scope="module")
def prescheduled():
    """The same network under pre-scheduled raster events (CPU-free)."""
    job = JOB(snn)
    descs = snn.segmentation_for(job.snn.layers, "uniform", n_segments=2)
    sim = snn.build_snn(job.snn.layers, descs, job.snn.raster, n_ticks=job.snn.n_ticks,
                        device="cpu")
    ctl, meta = _run(sim, quantum=32)
    return ctl.result_states(), meta


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("quantum", [400, 1000])
def test_cpu_injection_matches_prescheduled_raster(prescheduled, strategy, quantum):
    job = JOB(snn)
    ref_states, ref_meta = prescheduled
    hyb, meta = _port_run(strategy, quantum)
    st = hyb.result_states()
    np.testing.assert_array_equal(snn.output_spike_counts(st, meta), job.snn.expected_counts)
    for l, (s_r, k_r) in enumerate(ref_meta["unit_of_layer"]):
        s_h, k_h = meta["unit_of_layer"][l]
        np.testing.assert_array_equal(
            st["cims"]["spike_counts"][s_h, k_h].numpy(),
            ref_states["cims"]["spike_counts"][s_r, k_r].numpy(),
            err_msg=f"layer {l}: CPU injection broke tick bucketing")
    assert snn.total_spikes(st) == job.snn.expected_total
    _assert_both_halves(st, meta, job)


def test_injected_spikes_carry_tick_grid_t_avail():
    """Tick-addressed, not time-addressed: the driver local to the input
    unit (packed) and remote from it (split) give identical counters."""
    counts = {s: snn.output_spike_counts(_port_run(s)[0].result_states(), _port_run(s)[1])
              for s in ("split", "packed")}
    np.testing.assert_array_equal(counts["split"], counts["packed"])
    np.testing.assert_array_equal(counts["split"], JOB(snn).snn.expected_counts)


# ---------------------------------------------------------------------------
# whole runs equal the reference's


@pytest.fixture(scope="module")
def jax_run():
    ctl, meta = _run_jax(jsnn.build_hybrid(JOB(jsnn), "split", channel_latency=2000))
    return ctl, meta


MODES = {"fused": ("vmap", True), "per-round": ("vmap", False),
         "sequential": ("sequential", None)}


@pytest.mark.parametrize("mode", list(MODES))
def test_run_matches_jax(jax_run, mode):
    ctl_j, meta_j = jax_run
    backend, fused = MODES[mode]
    ctl, meta = _port_run("split", 400, backend, fused)
    assert ctl.rounds_run == ctl_j.rounds_run
    assert ctl.dispatches == (ctl_j.dispatches if fused else 0)
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), f"{mode} states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), f"{mode} pending")
    for w, g in zip(jsnn.hybrid_results(ctl_j.result_states(), meta_j),
                    snn.hybrid_results(ctl.result_states(), meta)):
        np.testing.assert_array_equal(g, np.asarray(w))
    _assert_both_halves(ctl.result_states(), meta, JOB(snn))


def test_faulted_run_matches_jax():
    """Crossbar and transport faults on every unit, dense and spiking."""
    ctl_j, meta_j = _run_jax(jsnn.build_hybrid(JOB(jsnn), "split", channel_latency=2000,
                                               faults=jflt.FaultConfig(**FAULTS)))
    ctl, meta = _run(_build(snn, JOB(snn), "split", channel_latency=2000,
                            faults=flt.FaultConfig(**FAULTS)))
    assert ctl.rounds_run == ctl_j.rounds_run
    st = ctl.result_states()
    assert_tree_equal(ctl_j.result_states(), st, "faulted states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), "faulted pending")
    assert int(st["stats"]["spikes_dropped"].sum()) > 0
    o, _ = snn.hybrid_results(st, meta)
    assert not np.array_equal(o, JOB(snn).dense_expected), "the crossbar faults missed O"


def test_default_tick_period_covers_dense_rasters():
    """The builder's own sizing (``injection_cycles_bound``) keeps the
    near-saturated raster deadline-clean."""
    job = DENSE_RASTER_JOB(snn)
    ctl, meta = _run(_build(snn, job, "split", channel_latency=2000), quantum=1000)
    assert meta["tick_period"] == max(2000, wl.injection_cycles_bound(
        np.count_nonzero(job.snn.raster)))
    _assert_both_halves(ctl.result_states(), meta, job)


# ---------------------------------------------------------------------------
# deadline violations raise the reference's message on both dispatch paths


def _late_message(pkg, fused):
    cfg, states, pending, _ = _build(pkg, DENSE_RASTER_JOB(pkg), "split", **LATE)
    if pkg is jsnn:
        ctl = JController(cfg, states, pending, backend="vmap", quantum=400)
    else:
        ctl = Controller(cfg, states, pending, backend="vmap", quantum=400, device="cpu")
    with pytest.raises(RuntimeError, match=r"late SNN MMIO") as ei:
        ctl.run(max_rounds=800, check_every=2, fused=fused)
    assert "tick_period" in str(ei.value)
    return str(ei.value), ctl.rounds_run


@pytest.fixture(scope="module")
def jax_late():
    return _late_message(jsnn, False)


@pytest.mark.parametrize("fused", [False, True], ids=["per-round", "fused"])
def test_late_injection_raises_the_references_message(jax_late, fused):
    assert _late_message(snn, fused) == jax_late


def _late_readback(pkg):
    """A CIM_REG_COUNTS request for tick 1 hand-injected far too late: by
    then the unit has ticked past 1."""
    job = pkg.snn_inference_job((12, 8), t_steps=4, rate=0.6, seed=3)
    descs = pkg.segmentation_for(job.layers, "uniform", n_segments=2)
    kw = {} if pkg is jsnn else {"device": "cpu"}
    cfg, states, pending, meta = pkg.build_snn(job.layers, descs, job.raster, **kw)
    pending = jax.tree.map(np.array, pending) if pkg is jsnn else pending
    s, k = meta["out_unit"]
    for f, v in (("kind", jch.MSG_W_CIM), ("addr", (k << 16) | isa.CIM_REG_COUNTS),
                 ("data", 1), ("t_avail", 6 * 10_000), ("valid", True)):
        pending[f][s, -1] = v
    return cfg, states, pending


@pytest.mark.parametrize("fused", [False, True], ids=["per-round", "fused"])
def test_count_readback_past_tick_raises_the_references_message(fused):
    cfg_j, states_j, pending_j = _late_readback(jsnn)
    with pytest.raises(RuntimeError, match=r"late SNN MMIO") as want:
        JController(cfg_j, states_j, pending_j, backend="vmap", quantum=32).run(
            max_rounds=400, check_every=2)
    ctl = Controller(*_late_readback(snn), backend="vmap", quantum=32, device="cpu")
    assert ctl.cfg.has_cpu
    with pytest.raises(RuntimeError, match=r"late SNN MMIO") as got:
        ctl.run(max_rounds=400, check_every=2, fused=fused)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# CPU<->CIM MMIO traffic enters the placement cut


def test_injector_traffic_matches_jax():
    job = JOB(snn)
    layers, raster = job.snn.layers, job.snn.raster
    rates, traffic = snn.profile_traffic(layers, raster, n_ticks=job.snn.n_ticks,
                                         injector=True)
    jjob = JOB(jsnn)
    w_rates, w_traffic = jsnn.profile_traffic(jjob.snn.layers, jjob.snn.raster,
                                              n_ticks=jjob.snn.n_ticks, injector=True)
    np.testing.assert_array_equal(rates, w_rates)
    np.testing.assert_array_equal(traffic, w_traffic)
    g = len(snn.layer_groups(layers))
    assert traffic.shape == (g + 1, g + 1) and len(rates) == g
    # the injector row carries the raster's events per tick into layer 0
    assert traffic[g, 0] == pytest.approx(np.count_nonzero(raster) / job.snn.n_ticks)
    assert traffic[g, 1:g].sum() == 0
    assert traffic[g - 1, g] > 0  # the counts DMA out of the output stripe


def test_pinned_injector_pulls_chatty_group_into_cpu_segment():
    traffic = np.zeros((4, 4))
    traffic[3, 2] = 10.0  # injector -> group 2 MMIO stream
    args = ([1, 1, 1, 0], [1.0, 1.0, 1.0, 0.0], traffic)
    kw = dict(n_segments=4, slots_per_seg=1, pinned={3: 0})
    assign = sg.traffic_partition(*args, **kw)
    np.testing.assert_array_equal(assign, jsg.traffic_partition(*args, **kw))
    assert assign[3] == 0 and assign[2] == 0
    assert assign[0] != 0 and assign[1] != 0


def test_traffic_partition_pinned_respects_budget():
    with pytest.raises(AssertionError, match="does not fit"):
        sg.traffic_partition([2, 2, 2], [1.0] * 3, np.zeros((3, 3)), n_segments=3,
                             slots_per_seg=2, pinned={0: 0, 1: 0})
