"""Recurrent, lateral and skip connectivity in the port against the JAX
package: ``random_recurrent_snn``, ``snn_recurrent_job`` and
``snn_skip_job`` build the reference's networks, rasters, oracle counts and
tick horizons; ``oracle_rates``, ``is_cyclic`` and ``edge_dsts`` agree;
every placement builds the reference's platform; whole runs on ``vmap``
fused and per-round and on ``sequential`` equal the reference's final
trees, ``rounds_run`` and ``dispatches``; and the profiling pass costs
cyclic edges as the reference does."""
import dataclasses

import numpy as np
import pytest

from repro import snn as jsnn
from repro.core.controller import Controller as JController
from repro_torch import snn
from repro_torch.core.controller import Controller
from torch_parity import assert_tree_equal, cfg_fields

QUANTUM = 32
JOBS = {
    "recurrent": lambda pkg: pkg.snn_recurrent_job((24, 20, 8), t_steps=6, rate=0.5, seed=3),
    "skip": lambda pkg: pkg.snn_skip_job((16, 12, 10, 8), t_steps=5, rate=0.6, seed=1),
}


def _assert_same_network(want, got):
    assert len(got.layers) == len(want.layers)
    for w, g in zip(want.layers, got.layers):
        np.testing.assert_array_equal(g.weights, w.weights)
        assert dataclasses.asdict(g.params) == dataclasses.asdict(w.params)
        assert (g.lateral is None) == (w.lateral is None)
        if w.lateral is not None:
            np.testing.assert_array_equal(g.lateral, w.lateral)
    assert [(e.src, e.dst) for e in got.edges] == [(e.src, e.dst) for e in want.edges]
    for w, g in zip(want.edges, got.edges):
        assert g.weights.dtype == w.weights.dtype
        np.testing.assert_array_equal(g.weights, w.weights)


@pytest.mark.parametrize("name", list(JOBS))
def test_job_matches_jax(name):
    want, got = JOBS[name](jsnn), JOBS[name](snn)
    _assert_same_network(want, got)
    np.testing.assert_array_equal(got.raster, want.raster)
    np.testing.assert_array_equal(got.expected_counts, want.expected_counts)
    assert got.expected_total == want.expected_total > 0
    assert got.n_ticks == want.n_ticks


def test_random_recurrent_snn_matches_jax():
    w_layers, w_edges = jsnn.random_recurrent_snn((30, 24, 16, 6), seed=9, inhibition=4)
    g_layers, g_edges = snn.random_recurrent_snn((30, 24, 16, 6), seed=9, inhibition=4)
    _assert_same_network(jsnn.SNNJob(w_layers, None, None, 0, w_edges),
                         snn.SNNJob(g_layers, None, None, 0, g_edges))
    assert g_layers[0].lateral is None and g_layers[1].lateral is not None


@pytest.mark.parametrize("name", list(JOBS))
def test_oracle_rates_and_connectivity_match_jax(name):
    want, got = JOBS[name](jsnn), JOBS[name](snn)
    w_rates, w_ticks = jsnn.oracle_rates(want.layers, want.raster, want.edges, want.n_ticks)
    g_rates, g_ticks = snn.oracle_rates(got.layers, got.raster, got.edges, got.n_ticks)
    assert g_ticks == w_ticks
    for w, g in zip(w_rates, g_rates):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert snn.is_cyclic(got.layers, got.edges) == jsnn.is_cyclic(want.layers, want.edges) \
        == (name == "recurrent")
    assert snn.edge_dsts(got.layers, got.edges) == jsnn.edge_dsts(want.layers, want.edges)


def _descs(pkg, job, strategy):
    if strategy == "auto":
        return pkg.auto_segmentation_for(job.layers, n_segments=4, edges=job.edges)
    return pkg.segmentation_for(job.layers, strategy, n_segments=4, edges=job.edges), None


def _build(pkg, job, strategy, **kw):
    descs, placement = _descs(pkg, job, strategy)
    return pkg.build_snn(job.layers, descs, job.raster, edges=job.edges,
                         n_ticks=job.n_ticks, placement=placement, **kw)


@pytest.mark.parametrize("strategy", ["uniform", "load_oriented", "auto"])
def test_recurrent_placements_build_the_references_platform(strategy):
    want = _build(jsnn, JOBS["recurrent"](jsnn), strategy)
    got = _build(snn, JOBS["recurrent"](snn), strategy, device="cpu")
    assert cfg_fields(got[0]) == cfg_fields(want[0])
    assert_tree_equal(want[1], got[1], f"{strategy} built states")
    assert_tree_equal(want[2], got[2], f"{strategy} built pending")
    assert got[3]["edge_dsts"] == want[3]["edge_dsts"]
    assert got[3]["n_ticks"] == want[3]["n_ticks"]


MODES = {"fused": ("vmap", True), "per-round": ("vmap", False),
         "sequential": ("sequential", False)}


@pytest.fixture(scope="module", params=list(JOBS))
def cyclic_run(request):
    """The reference run of one job: vmap, its default fused dispatch."""
    job = JOBS[request.param](jsnn)
    cfg, states, pending, meta = _build(jsnn, job, "uniform")
    ctl = JController(cfg, states, pending, backend="vmap", quantum=QUANTUM)
    ctl.run(max_rounds=400, check_every=2)
    return request.param, ctl


@pytest.mark.parametrize("mode", list(MODES))
def test_run_matches_jax(cyclic_run, mode):
    name, ctl_j = cyclic_run
    job = JOBS[name](snn)
    cfg, states, pending, meta = _build(snn, job, "uniform", device="cpu")
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
    if name == "recurrent":  # the horizon bounds every unit's ticks
        ticks = st["cims"]["ticks"][st["cims"]["present"]]
        assert 0 < int(ticks.max()) <= job.n_ticks


@pytest.mark.parametrize("name", list(JOBS))
def test_profile_traffic_costs_cyclic_edges_as_jax(name):
    want, got = JOBS[name](jsnn), JOBS[name](snn)
    w = jsnn.profile_traffic(want.layers, want.raster, edges=want.edges, n_ticks=want.n_ticks)
    g = snn.profile_traffic(got.layers, got.raster, edges=got.edges, n_ticks=got.n_ticks)
    for a, b in zip(w, g):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b, a)
    if name == "recurrent":  # lateral synapses put rate on the diagonal
        assert np.diag(g[1]).sum() > 0


def test_cyclic_without_horizon_raises():
    job = JOBS["recurrent"](snn)
    descs = snn.segmentation_for(job.layers, "uniform", n_segments=2, edges=job.edges)
    with pytest.raises(ValueError, match="n_ticks"):
        snn.build_snn(job.layers, descs, job.raster, edges=job.edges, device="cpu")
    with pytest.raises(AssertionError, match="n_ticks"):
        snn.oracle_run(job.layers, job.raster, edges=job.edges)
