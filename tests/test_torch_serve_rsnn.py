"""Recurrent and multi-tile networks through the port's fleet server:
requests of a small network of the SHD shape (a hidden layer whose fan-in,
its inputs and its own 40 neurons, makes a 2-tile column group, a lateral
matrix under a tick horizon, a one-tile readout), built by
``snn.workloads.network_request``, served in one bucket with a padding
lane.  Each served result equals the request's solo ``Controller.run`` leaf
for leaf, and its output counts and spikes per layer equal the plain
reference ``tests/reference_rsnn.py``, which in turn equals the port's
cycle-aware oracle.  (The fleet's parity with the JAX package's server is
tests/test_torch_serve.py's.)"""
import numpy as np
import pytest

import reference_rsnn
from repro_torch import tree
from repro_torch.core.controller import Controller
from repro_torch.serve.snn_serve import SnnServer, _normalize
from repro_torch.snn import topology, workloads as wl
from repro_torch.snn.neuron import LIFParams
from repro_torch.snn.topology import SNNLayer
from torch_parity import single_torch_thread

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

SIZES = (300, 40, 8)  # hidden fan-in 300 + 40: a 2-tile column group
T_STEPS, RATE = 8, 0.3
RUN = dict(check_every=4, max_rounds=200)
QUANTUM = 32


def _layers(job):
    return [SNNLayer(w, LIFParams(thresh=int(t), leak=int(lk)), lateral=lat)
            for w, lat, t, lk in zip(job["weights"], job["laterals"], job["thresholds"],
                                     job["leaks"])]


def _request(job):
    return wl.network_request(_layers(job), job["raster"], n_ticks=job["n_ticks"],
                              in_cap=2048, device="cpu")


def _serve(reqs, bucket_size=4):
    srv = SnnServer(quantum=QUANTUM, bucket_size=bucket_size, device="cpu", **RUN)
    tickets = [srv.submit(r) for r in reqs]
    out = srv.flush()
    return [out[t] for t in tickets], srv


def _equal_trees(a, b):
    la, lb = tree.leaves(tree.to_numpy(a)), tree.leaves(tree.to_numpy(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(y, x, err_msg=str(path))


@pytest.fixture(scope="module")
def jobs():
    # settle 6, 6 and 9: horizons of 16 and 19 ticks ride one bucket
    return [reference_rsnn.random_job(SIZES, T_STEPS, RATE, seed, settle)
            for seed, settle in ((11, 6), (12, 6), (13, 9))]


@pytest.fixture(scope="module")
def served(jobs):
    reqs = [_request(j) for j in jobs]
    results, srv = _serve(reqs)  # 3 requests: a 4-wide bucket with one padding lane
    return reqs, results, srv


def test_requests_are_grouped_recurrent_and_share_a_bucket(jobs, served):
    reqs, results, srv = served
    assert all(r.cfg.snn_grouped and r.cfg.has_snn for r in reqs)
    assert len({_normalize(r.cfg) for r in reqs}) == 1
    assert [g["group"].width for g in reqs[0].meta["groups"]] == [2, 1]
    limits = [sorted(set(r.states["cims"]["tick_limit"].flatten().tolist()) - {0})
              for r in reqs]
    assert limits == [[j["n_ticks"]] for j in jobs]
    assert (srv.dispatches, srv.dispatch_syncs, srv.served) == (1, 1, 3)
    assert all(r.ok for r in results)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_round"])
def test_bucket_matches_solo(served, fused):
    reqs, results, _ = served
    for req, res in zip(reqs, results):
        c = Controller(req.cfg, req.states, req.pending, quantum=QUANTUM, device="cpu")
        rounds, _ = c.run(fused=fused, **RUN)
        assert res.rounds == rounds
        _equal_trees(c.result_states(), res.states)
        c.close()


def test_served_answers_match_the_reference(jobs, served):
    reqs, results, _ = served
    for job, req, res in zip(jobs, reqs, results):
        counts, per_layer = reference_rsnn.recurrent_lif(**job)
        assert per_layer.min() > 0
        np.testing.assert_array_equal(topology.output_spike_counts(res.states, req.meta), counts)
        np.testing.assert_array_equal(topology.layer_spikes(res.states, req.meta), per_layer)
        assert topology.total_spikes(res.states) == per_layer.sum()


def test_padding_lane_is_inert(served):
    reqs, results, _ = served
    exact, _ = _serve(reqs, bucket_size=3)
    for a, b in zip(results, exact):
        assert a.rounds == b.rounds
        _equal_trees(a.states, b.states)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_matches_the_ports_oracle(seed):
    job = reference_rsnn.random_job((24, 20, 12, 6), 6, 0.5, seed)
    counts, per_layer = reference_rsnn.recurrent_lif(**job)
    want_counts, want_totals = wl.oracle_run(_layers(job), job["raster"], n_ticks=job["n_ticks"])
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(per_layer, want_totals)
    assert per_layer.min() > 0
