"""The recurrent cell ``shd_rsnn.sweep64`` at a CPU size: the kind's copy of
the reference agrees with the tests' plain reference
(``tests/reference_rsnn.py``) and with the port's cycle-aware oracle; a
rehearsal through its entry is correct and its traced run reports the
channel's messages a round and the serving spans' metrics; the cell once on
the card through ``vpbench/run.py``; and the check fails what it must (half
of a bucket's lanes frozen, an output count altered where it is read, a
round that returns its state unchanged).  ``conftest.SMALL``, which the
other files' rehearsals take, does not list this cell: its CPU size is
``SMALL_RSNN`` here."""
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import ROOT

from vpbench import harness
from vpbench.kinds import rsnn

CELL = "shd_rsnn.sweep64"
# the cell at a CPU size: the hidden fan-in 300 + 40 makes a 2-tile group
SMALL_RSNN = {"config": {"layer_sizes": [300, 40, 8], "lif": {"thresh": [300, 40], "leak": [1, 1]},
                         "in_cap": 2048},
              "traffic": {"pool": 8, "clients": 4, "bucket_size": 4, "t_steps": 8,
                          "trace_buckets": 1, "sample_share": 1.0, "rate": 0.3}}


def _run(trace=False, max_rounds=None, seconds=0.3):
    ov = {k: dict(v) for k, v in SMALL_RSNN.items()}
    if max_rounds is not None:
        ov["config"]["max_rounds"] = max_rounds
    torch.set_num_threads(2)
    return harness.run_cell(ROOT, CELL, 2**31 + 21, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), ov)


def _jobs(seed, sizes=(300, 40, 8), t_steps=8, pool=5):
    _, _, config, traffic = harness.load_cell(ROOT, CELL)
    config = {**config, "layer_sizes": list(sizes),
              "lif": {"thresh": list(sizes[:-1]), "leak": [1] * (len(sizes) - 1)}}
    return rsnn.make_jobs(config, {**traffic, "pool": pool, "t_steps": t_steps, "rate": 0.3},
                          seed)


@pytest.mark.parametrize("sizes", [(300, 40, 8), (24, 20, 12, 6)])
def test_the_kinds_reference_agrees_with_the_tests_and_the_ports_oracle(sizes):
    sys.path.insert(0, str(ROOT / "tests"))
    import reference_rsnn

    from repro_torch.snn import workloads as wl
    from repro_torch.snn.neuron import LIFParams
    from repro_torch.snn.topology import SNNLayer

    jobs = _jobs(2**31 + 3, sizes)
    counts, per_layer = rsnn.lif_network(jobs, block=2)
    assert per_layer.min() > 0
    for k, job in enumerate(jobs):
        weights = [w for w, _, _ in job.layers]
        got = reference_rsnn.recurrent_lif(weights, job.laterals, [t for _, t, _ in job.layers],
                                           [lk for _, _, lk in job.layers], job.raster,
                                           job.n_ticks)
        layers = [SNNLayer(w, LIFParams(thresh=t, leak=lk), lateral=lat)
                  for (w, t, lk), lat in zip(job.layers, job.laterals)]
        oracle = wl.oracle_run(layers, job.raster, n_ticks=job.n_ticks)
        for c, p in (got, oracle):
            assert np.array_equal(counts[k], c) and np.array_equal(per_layer[k], p)


def test_a_rehearsal_is_correct_and_counts_the_channel():
    untraced = _run()
    assert untraced["correct"] is True and untraced["attempted"] >= 4
    assert set(untraced["metrics"]) == {"jobs_per_s.serve", "job_p95_ms", "setup_s"}
    traced = _run(trace=True)
    assert traced["correct"] is True
    assert traced["metrics"]["channel_msgs_per_round"]["value"] > 0
    assert traced["metrics"]["syncs_per_job"]["value"] == pytest.approx(1 / 4)


def test_a_traced_rehearsal_reports_the_cells_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == CELL)
    want = {m["name"] for m in harness.metrics_of(spec, w, True)}
    spans = {"bucket_prep_ms", "bucket_issue_ms", "bucket_fetch_ms", "bucket_results_ms",
             "captures_per_job.serve"}
    got = _run(trace=True)["metrics"]
    # the device's metrics read the card's trace: off the card only the
    # host's are there
    assert spans | {"channel_msgs_per_round", "syncs_per_job"} <= set(got) <= want
    for name in spans:
        assert np.isfinite(got[name]["value"]) and got[name]["value"] >= 0
    assert got["captures_per_job.serve"]["value"] == 0  # off the card nothing is captured


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell runs on the card only")
    out = subprocess.run([sys.executable, "vpbench/run.py", "--workload", CELL, "--seed",
                          str(2**31 + 40 + trace), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in harness.metrics_of(spec, w, bool(trace))}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


def test_the_channel_reader_needs_a_recorded_stretch():
    read = harness.reader("channel_msgs_per_round")
    rec = harness.Record()
    assert read(rec) is None  # an untraced run, or an entry that does not count
    rec.trace_rounds, rec.trace_msgs = 108, 338_000
    assert read(rec) == pytest.approx(338_000 / 108)


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core import controller as ctl

    monkeypatch.setattr(ctl._JobMegaloop, "_round", lambda self, states, pending: (states, pending))
    out = _run(max_rounds=40)
    assert out["correct"] is False and out["failed"] > 0


def test_half_of_the_bucket_left_out(monkeypatch):
    """The dispatch runs the first half of each bucket's lanes; the rest
    come back frozen at their start, reported done."""
    from repro_torch.core import controller as ctl

    call = ctl._JobMegaloop.__call__

    def half(self, states, pending, rounds, done, over, *rest):
        done = done.clone()
        done[(done.shape[0] + 1) // 2:] = True
        return call(self, states, pending, rounds, done, over, *rest)

    monkeypatch.setattr(ctl._JobMegaloop, "__call__", half)
    out = _run()
    assert out["correct"] is False and out["checks"]["wrong"]["value"] > 0


def test_an_output_count_altered_where_it_is_read(monkeypatch):
    from repro_torch.snn import topology

    real = topology.output_spike_counts

    def altered(states, meta):
        counts = real(states, meta)
        counts[0] += 1
        return counts

    monkeypatch.setattr(topology, "output_spike_counts", altered)
    out = _run()
    assert out["correct"] is False and out["checks"]["wrong"]["value"] > 0
