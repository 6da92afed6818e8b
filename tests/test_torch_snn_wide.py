"""Wide spiking layers in the port against the JAX package: the grouped LIF
tick (``vp/cim.snn_tick(grouped=True)``, the tick of column groups whose
contributor tiles forward their charge to the stripe owner) equal to the
reference's on every returned leaf, with ``use_kernel`` off and on (the
Pallas kernel in interpret mode); whole runs of wide jobs (a column group,
and row stripes beside a group) on ``vmap`` fused and per-round and on
``sequential`` equal to the reference's final trees, ``rounds_run`` and
``dispatches``; spike-traffic-aware placement (``traffic_partition``,
``profile_traffic``, ``auto_segmentation_for(traffic=...)``,
``measure_traffic``, ``consumed_rates``) returning what the reference
returns; and on a card the grouped kernel equal to its plain version."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jflt
from repro import snn as jsnn
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.vp import cim as jcim
from repro_torch import snn
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step import ref as lif_ref
from repro_torch.vp import isa
from torch_parity import assert_tree_equal, cfg_fields

QUANTUM = 32
HIGH = jflt.FaultConfig(seed=3, p_stuck0=0.3, p_stuck1=0.2, p_bitflip=0.3,
                        p_dead=0.3, p_thresh_drift=0.5)
FAULT_FIELDS = ("f_and", "f_xor", "f_dead", "f_dth")


# ---------------------------------------------------------------------------
# the grouped tick


def _base(s, n):
    """A zero cims state of the reference's layout, (S, n, ...)."""
    return jax.tree.map(np.array, jax.vmap(lambda _: jcim.cim_state(n))(jnp.arange(s)))


def _mixed_state(s, seed):
    """Two slots a segment, every gate branch (absent, dense mode, no
    period, not due, at the tick limit), partial rows, spike counts past the
    fan-in clip, and ``owner_slot`` drawn in [-3, 3): contributors, owners
    out of range and negative slots."""
    rng = np.random.default_rng(seed)
    c, sh = _base(s, 2), (s, 2)
    c["present"][:] = rng.random(sh) < 0.85
    c["mode"][:] = np.where(rng.random(sh) < 0.85, isa.CIM_MODE_SPIKE, isa.CIM_MODE_DENSE)
    c["tick_period"][:] = rng.choice([0, 8, 16], sh, p=[0.1, 0.45, 0.45])
    c["next_tick"][:] = rng.integers(0, 64, sh)
    c["tick_limit"][:] = rng.choice([0, 3, 5], sh)
    c["ticks"][:] = rng.integers(0, 6, sh)
    c["rows"][:] = rng.choice([256, 200, 17, 0], sh)
    c["thresh"][:] = rng.integers(1, 80, sh)
    c["leak"][:] = rng.integers(0, 6, sh)
    c["refrac_period"][:] = rng.integers(0, 4, sh)
    c["owner_slot"][:] = rng.integers(-3, 3, sh)
    c["weights"][:] = rng.integers(-8, 8, c["weights"].shape)
    c["in_buf"][:] = rng.integers(0, 5, c["in_buf"].shape)
    c["in_buf"][..., :4] = rng.integers(-2000, 2000, (s, 2, 4))
    c["v"][:] = rng.integers(0, 60, c["v"].shape)
    c["refrac"][:] = rng.integers(0, 3, c["refrac"].shape)
    c["spike_counts"][:] = rng.integers(0, 100, c["spike_counts"].shape)
    c["spikes_total"][:] = rng.integers(0, 1000, sh)
    t_gate = rng.integers(0, 96, s).astype(np.int32)
    # segment 0: slot 1 forwards to slot 0, both fire
    for slot, owner in enumerate((0, 0)):
        for f, x in (("present", True), ("mode", isa.CIM_MODE_SPIKE), ("tick_period", 8),
                     ("next_tick", 0), ("tick_limit", 0), ("owner_slot", owner)):
            c[f][0, slot] = x
    t_gate[0] = max(t_gate[0], 8)
    return c, t_gate


def _group_state(kind, seed):
    """Full-width tiles, (S, n) = (2, 4): each segment's slots 1 and 2
    forward to slot 0 (rows 0), slot 3 is a unit of its own.  ``kind``:
    "all" fire, only the "group" fires, "none" fires, a contributor
    "straddle"s its tick limit (the owner fires without it), or "wrap": the
    owners' membranes sit where only the group's summed charge wraps int32."""
    rng = np.random.default_rng(seed)
    c, sh = _base(2, 4), (2, 4)
    c["present"][:] = True
    c["mode"][:] = isa.CIM_MODE_SPIKE
    c["tick_period"][:] = 32
    c["owner_slot"][:] = [0, 0, 0, 3]
    c["rows"][:] = [256, 0, 0, 256]
    c["thresh"][:] = rng.integers(100, 3000, sh)
    c["leak"][:] = rng.integers(0, 4, sh)
    c["refrac_period"][:] = 2
    lo = 0 if kind == "wrap" else -128
    c["weights"][:] = rng.integers(lo, 128, c["weights"].shape)
    c["in_buf"][:] = rng.integers(0, 6, c["in_buf"].shape)
    c["in_buf"][..., :3] = 900
    c["v"][:] = rng.integers(0, 60, c["v"].shape)
    c["refrac"][:] = rng.integers(0, 3, c["refrac"].shape)
    c["spike_counts"][:] = rng.integers(0, 20, c["spike_counts"].shape)
    c["spikes_total"][:] = c["spike_counts"].sum(-1)
    c["ticks"][:] = 5
    due = {"group": [1, 1, 1, 0], "none": [0, 0, 0, 0]}.get(kind, [1, 1, 1, 1])
    c["next_tick"][:] = np.where(np.array(due, bool), 160, 192)
    if kind == "straddle":
        c["tick_limit"][0, 2] = 5  # reached: slot 2 of segment 0 no longer fires
        c["tick_limit"][1, 1] = 6
    if kind == "wrap":
        own = np.einsum("src,sc->sr", c["weights"][:, 0].astype(np.int64),
                        np.clip(c["in_buf"][:, 0], -511, 511).astype(np.int64))
        c["v"][:, 0] = (2**31 - 1 - own).astype(np.int32)  # v + own charge = 2^31 - 1
        c["refrac"][:, 0] = 0
    return c, np.full(2, 192, np.int32)


def _wide_group_state(kind, seed):
    """Full-width tiles, (S, n) = (1, 8): slots 1-6 forward to slot 0, a
    7-tile column group (fan-in 1792, more tiles than one of the kernel's
    stages holds), and slot 7 is a unit of its own.  ``kind``: "all" fire, or
    in "group" contributor 4 has reached its tick limit (the owner fires
    without it)."""
    rng = np.random.default_rng(seed)
    c, sh = _base(1, 8), (1, 8)
    c["present"][:] = True
    c["mode"][:] = isa.CIM_MODE_SPIKE
    c["tick_period"][:] = 32
    c["owner_slot"][:] = [0] * 7 + [7]
    c["rows"][:] = [256] + [0] * 6 + [256]
    c["thresh"][:] = rng.integers(100, 3000, sh)
    c["leak"][:] = rng.integers(0, 4, sh)
    c["refrac_period"][:] = 2
    c["weights"][:] = rng.integers(-128, 128, c["weights"].shape)
    c["in_buf"][:] = rng.integers(0, 6, c["in_buf"].shape)
    c["in_buf"][..., :3] = 900
    c["v"][:] = rng.integers(0, 60, c["v"].shape)
    c["refrac"][:] = rng.integers(0, 3, c["refrac"].shape)
    c["spike_counts"][:] = rng.integers(0, 20, c["spike_counts"].shape)
    c["spikes_total"][:] = c["spike_counts"].sum(-1)
    c["ticks"][:] = 5
    c["next_tick"][:] = 160
    if kind == "group":
        c["tick_limit"][0, 4] = 5  # reached: contributor 4 no longer fires
    return c, np.full(1, 192, np.int32)


# (S, n) = (1, 40): the members of two column groups on both sides of slot 32
BIG_OWNER = np.arange(40)
BIG_OWNER[[1, 2, 12, 20, 33, 35, 37]] = 0
BIG_OWNER[38] = -40  # slot 0, counted from the end
BIG_OWNER[[5, 36]] = 34
BIG_OWNER[39] = -6  # slot 34
BIG_OWNER[25] = 45  # out of range: dropped
BIG_OWNER[30] = 31  # an owner that does not fire
BIG_QUIET = [12, 31, 35]  # not due
BIG_CONTRIB = BIG_OWNER != np.arange(40)


def _big_segment_state(seed):
    """Full-width tiles, (S, n) = (1, 40), a segment past 32 slots: slot 0
    owns a group of members on both sides of slot 32 (1, 2, 20, 33, and 38
    through a negative slot) with candidates that do not fire (12 and 35
    not due, 37 at its tick limit), slot 34 one of 5, 36 and 39 (a negative
    slot); slot 25 names an owner out of range, slot 30 one that does not
    fire; the other slots are units of their own, all due."""
    rng = np.random.default_rng(seed)
    c, sh = _base(1, 40), (1, 40)
    c["present"][:] = True
    c["mode"][:] = isa.CIM_MODE_SPIKE
    c["tick_period"][:] = 32
    c["owner_slot"][:] = BIG_OWNER
    c["rows"][:] = np.where(BIG_CONTRIB, 0, 256)
    c["thresh"][:] = rng.integers(100, 3000, sh)
    c["leak"][:] = rng.integers(0, 4, sh)
    c["refrac_period"][:] = 2
    c["weights"][:] = rng.integers(-128, 128, c["weights"].shape)
    c["in_buf"][:] = rng.integers(0, 6, c["in_buf"].shape)
    c["in_buf"][..., :3] = 900
    c["v"][:] = rng.integers(0, 60, c["v"].shape)
    c["refrac"][:] = rng.integers(0, 3, c["refrac"].shape)
    c["spike_counts"][:] = rng.integers(0, 20, c["spike_counts"].shape)
    c["spikes_total"][:] = c["spike_counts"].sum(-1)
    c["ticks"][:] = 5
    c["next_tick"][:] = 160
    c["next_tick"][0, BIG_QUIET] = 192
    c["tick_limit"][0, 37] = 5  # reached
    return c, np.full(1, 192, np.int32)


def _with_faults(cims, seed):
    """Every fault input, drawn by the reference's ``unit_masks`` at high rates."""
    s, n = cims["present"].shape
    per = [jflt.unit_masks(HIGH, seed * 64 + u, 256, 256, 256) for u in range(s * n)]
    return {**cims, **{f: np.stack([m[f] for m in per]).reshape(s, n, *per[0][f].shape)
                       for f in FAULT_FIELDS}}


STATES = {"mixed S=1": lambda: _mixed_state(1, 11), "mixed S=2": lambda: _mixed_state(2, 12),
          "mixed S=4": lambda: _mixed_state(4, 14)}
STATES.update({k: (lambda k=k: _group_state(k, 20 + i))
               for i, k in enumerate(("all", "group", "none", "straddle", "wrap"))})
STATES.update({f"wide {k}": (lambda k=k: _wide_group_state(k, 30 + i))
               for i, k in enumerate(("all", "group"))})
STATES["40 slots"] = lambda: _big_segment_state(40)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "interpret"])
@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("state", list(STATES))
def test_grouped_tick_matches_jax(state, faulted, use_kernel):
    cims, t_gate = STATES[state]()
    if faulted:
        cims = _with_faults(cims, 5)
    want = jax.vmap(lambda c, t: jcim.snn_tick(c, t, use_kernel, grouped=True))(
        jax.tree.map(jnp.asarray, cims), jnp.asarray(t_gate))
    inputs = {k: torch.from_numpy(np.array(v)) for k, v in cims.items()}
    kept = {k: v.clone() for k, v in inputs.items()}
    launches = lif_ops.snn_tick.launches
    got = lif_ops.snn_tick(inputs, torch.from_numpy(t_gate), grouped=True)
    assert lif_ops.snn_tick.launches == launches  # a CPU tensor takes the plain version
    names = ("cims", "fired_rows", "fire", "tick_time")
    assert_tree_equal(dict(zip(names, want)), dict(zip(names, got)), state)
    for k, v in kept.items():
        assert torch.equal(inputs[k], v), k
    fire = got[2].numpy()
    if state not in ("none",):
        assert fire[0, 0] and fire[0, 1]
    if not state.startswith("mixed"):
        assert not got[0]["v"][:, 1:3].any() and not got[0]["refrac"][:, 1:3].any()
    if state == "wrap":  # the owners' charge wrapped only through the group's sum
        assert (got[0]["v"][:, 0] == 0).any() and not got[1][:, 0].all()
    if state.startswith("wide"):  # every contributor of the 7-tile group
        assert not got[0]["v"][:, 1:7].any() and not got[0]["refrac"][:, 1:7].any()
        assert fire[0, 4] == (state == "wide all") and fire[0, 0] and fire[0, 7]
    if state == "40 slots":  # every contributor, a firing one or not
        assert not got[0]["v"][0, BIG_CONTRIB].any() and not got[0]["refrac"][0, BIG_CONTRIB].any()
        quiet = np.zeros(40, bool)
        quiet[BIG_QUIET + [37]] = True
        assert (fire[0] == ~quiet).all()


# ---------------------------------------------------------------------------
# whole runs


WIDE_JOBS = {"column group": ((300, 8), 4), "stripes and a group": ((96, 300, 16), 4)}
MODES = {"fused": ("vmap", True), "per-round": ("vmap", False),
         "sequential": ("sequential", False)}


def _wide_build(pkg, name, **kw):
    sizes, t_steps = WIDE_JOBS[name]
    job = pkg.snn_inference_job(sizes, t_steps=t_steps, rate=0.5, seed=2)
    descs = pkg.segmentation_for(job.layers, "uniform", n_segments=3)
    return pkg.build_snn(job.layers, descs, job.raster, **kw), job


@pytest.fixture(scope="module", params=list(WIDE_JOBS))
def wide_run(request):
    """The reference run of one wide job: vmap, its default fused dispatch."""
    (cfg, states, pending, meta), job = _wide_build(jsnn, request.param)
    ctl = JController(cfg, states, pending, backend="vmap", quantum=QUANTUM)
    ctl.run(max_rounds=400, check_every=2)
    return request.param, cfg, states, pending, ctl, meta, job


@pytest.mark.parametrize("mode", list(MODES))
def test_wide_run_matches_jax(wide_run, mode):
    name, cfg_j, st_j0, pen_j0, ctl_j, _, job = wide_run
    (cfg, states, pending, meta), _ = _wide_build(snn, name, device="cpu")
    assert cfg.snn_grouped and cfg_fields(cfg) == cfg_fields(cfg_j)
    assert_tree_equal(st_j0, states, f"{name} built states")
    assert_tree_equal(pen_j0, pending, f"{name} built pending")
    backend, fused = MODES[mode]
    ctl = Controller(cfg, states, pending, backend=backend, quantum=QUANTUM, device="cpu")
    ctl.run(max_rounds=400, check_every=2, fused=fused)
    assert ctl.rounds_run == ctl_j.rounds_run
    assert ctl.dispatches == (ctl_j.dispatches if fused else 0)
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), f"{name}/{mode} states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), f"{name}/{mode} pending")
    st = ctl.result_states()
    np.testing.assert_array_equal(snn.output_spike_counts(st, meta), job.expected_counts)
    assert snn.total_spikes(st) == job.expected_total


def test_split_column_group_raises_the_reference_error():
    """A column group must not straddle segments: the port raises the
    reference's error, byte for byte."""
    def build(pkg, seg, **kw):
        descs = [seg.SegmentDesc(cpu=True, dram=True, n_cims=2, cim_mgr=0),
                 seg.SegmentDesc(n_cims=4, cim_mgr=0)]
        layers = pkg.random_snn((300, 32), seed=3)
        raster = pkg.rate_encode(np.full(300, 0.5), 4, seed=4)
        return pkg.build_snn(layers, descs, raster, placement=[1], **kw)

    with pytest.raises(AssertionError) as want:
        build(jsnn, jsg)
    with pytest.raises(AssertionError) as got:
        build(snn, sg, device="cpu")
    assert str(got.value) == str(want.value)
    assert "co-located" in str(got.value)


# ---------------------------------------------------------------------------
# traffic-aware placement


@pytest.mark.parametrize("seed", range(12))
def test_traffic_partition_matches_jax(seed):
    rng = np.random.default_rng(300 + seed)
    g = int(rng.integers(2, 10))
    slots = int(rng.integers(2, 5))
    widths = [int(w) for w in rng.integers(1, slots + 1, g)]
    n_segments = int(rng.integers(-(-sum(widths) // slots), sum(widths) + 2))
    loads = rng.random(g) * 10
    traffic = rng.random((g, g)) * (rng.random((g, g)) < 0.6)
    pinned = None
    if seed % 3 == 0:  # a pinned width-0 pseudo-group, as a hybrid job's injector
        widths[-1] = 0
        pinned = {g - 1: int(rng.integers(0, n_segments))}
    kw = dict(refine_passes=int(rng.integers(0, 5)), pinned=pinned)
    try:
        want = jsg.traffic_partition(widths, loads, traffic, n_segments, slots, **kw)
    except AssertionError as err:
        with pytest.raises(AssertionError, match=re.escape(str(err))):
            sg.traffic_partition(widths, loads, traffic, n_segments, slots, **kw)
        return
    got = sg.traffic_partition(widths, loads, traffic, n_segments, slots, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for s in range(n_segments):
        assert sum(w for w, a in zip(widths, got) if a == s) <= slots


TRAFFIC_JOB = ((96, 600, 32), 5, 0.4, 5)  # a 600-wide fan-in: a 3-tile group


def _traffic_job(pkg):
    sizes, t_steps, rate, seed = TRAFFIC_JOB
    return pkg.snn_inference_job(sizes, t_steps=t_steps, rate=rate, seed=seed)


@pytest.mark.parametrize("injector", [False, True])
def test_profile_traffic_matches_jax(injector):
    want_job, job = _traffic_job(jsnn), _traffic_job(snn)
    want = jsnn.profile_traffic(want_job.layers, want_job.raster, injector=injector)
    got = snn.profile_traffic(job.layers, job.raster, injector=injector)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 0


def test_traffic_aware_placement_matches_jax_and_runs_exactly():
    want_job, job = _traffic_job(jsnn), _traffic_job(snn)
    _, traffic = jsnn.profile_traffic(want_job.layers, want_job.raster)
    want = jsnn.auto_segmentation_for(want_job.layers, n_segments=4, slots_per_seg=4,
                                      traffic=traffic)
    got = snn.auto_segmentation_for(job.layers, n_segments=4, slots_per_seg=4,
                                    traffic=snn.profile_traffic(job.layers, job.raster)[1])
    assert [dataclasses.asdict(d) for d in got[0]] == [dataclasses.asdict(d) for d in want[0]]
    assert [int(p) for p in got[1]] == [int(p) for p in want[1]]
    assert len(got[0]) < 4  # packing the communicating groups drops segments
    cfg, states, pending, meta = snn.build_snn(job.layers, got[0], job.raster,
                                               placement=got[1], device="cpu")
    ctl = Controller(cfg, states, pending, quantum=QUANTUM, device="cpu")
    ctl.run(max_rounds=400, check_every=2)
    np.testing.assert_array_equal(snn.output_spike_counts(ctl.result_states(), meta),
                                  job.expected_counts)


def test_measured_traffic_and_consumed_rates_match_jax():
    """On a finished run of each package, the measured traffic matrix and
    the consumed rates are the reference's, read from the port's tensors
    with one host copy each."""
    runs = {}
    for pkg, kw in ((jsnn, {}), (snn, {"device": "cpu"})):
        job = _traffic_job(pkg)
        descs = pkg.segmentation_for(job.layers, "uniform", n_segments=3)
        cfg, states, pending, meta = pkg.build_snn(job.layers, descs, job.raster, **kw)
        ctl = (JController if pkg is jsnn else Controller)(cfg, states, pending,
                                                           quantum=QUANTUM, **kw)
        ctl.run(max_rounds=400, check_every=2)
        runs[pkg] = (ctl.result_states(), meta)
    for fn in ("measure_traffic", "consumed_rates"):
        want = getattr(jsnn, fn)(*runs[jsnn])
        got = getattr(snn, fn)(*runs[snn])
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and g.shape == w.shape, fn
            np.testing.assert_array_equal(g, w, err_msg=fn)
    assert snn.measure_traffic(*runs[snn])[1].sum() > 0


# ---------------------------------------------------------------------------
# on a card


@pytest.mark.cuda
@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("state", list(STATES))
def test_grouped_kernel_matches_plain_on_the_card(state, faulted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grouped tick kernel has no CPU mode")
    cims, t_gate = STATES[state]()
    if faulted:
        cims = _with_faults(cims, 5)
    c = {k: torch.from_numpy(np.array(v)).cuda() for k, v in cims.items()}
    t = torch.from_numpy(t_gate).cuda()
    launches = lif_ops.snn_tick.grouped_launches
    got = lif_ops.snn_tick(c, t, grouped=True)
    want = lif_ref.snn_tick(c, t, grouped=True)
    assert lif_ops.snn_tick.grouped_launches == launches + 1
    for k in lif_ref.TICK_OUTPUTS:
        assert torch.equal(got[0][k], want[0][k]), k
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
