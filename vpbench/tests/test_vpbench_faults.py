"""The check fails what it must: a run with the timed path broken
underneath comes out not correct (each fault a cell can have, planted in
the program at a CPU size, the rest of the run as it is), and the control
(the reference in bfloat16 put in the program's place, at each cell's own
size) is judged wrong on every seed.  The cells run on one card, so no
exchange between cards can be left out."""
import pytest
import torch
from conftest import ROOT, SMALL

from vpbench import control, harness

FLEETS = ["snn_fullwidth.fleet8"]
SOLO = ["googlenet_conv1.riscv"]


def _run(cell, **extra):
    ov = {k: dict(v) for k, v in SMALL[cell].items()}
    ov["config"]["max_rounds"] = 60
    ov["config"].update(extra)
    import time

    torch.set_num_threads(2)
    return harness.run_cell(ROOT, cell, 2**31 + 21, 0.3, False, torch.device("cpu"),
                            time.perf_counter(), ov)


def test_the_unbroken_runs_are_correct():
    for cell in FLEETS + SOLO:
        assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell", FLEETS)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    from repro_torch.core import controller as ctl

    monkeypatch.setattr(ctl._JobMegaloop, "_round", lambda self, states, pending: (states, pending))
    out = _run(cell)
    assert out["correct"] is False and out["failed"] > 0


@pytest.mark.parametrize("cell", SOLO)
def test_a_simulation_whose_round_returns_its_state_unchanged(cell, monkeypatch):
    from repro_torch.core import controller as ctl

    monkeypatch.setattr(ctl.Controller, "_vmap_round", lambda self, states, pending: (states, pending))
    out = _run(cell)
    assert out["correct"] is False and out["failed"] > 0


@pytest.mark.parametrize("cell", FLEETS)
def test_half_of_the_bucket_left_out(cell, monkeypatch):
    """The dispatch runs the first half of each bucket's lanes; the rest
    come back frozen at their start, reported done."""
    from repro_torch.core import controller as ctl

    call = ctl._JobMegaloop.__call__

    def half(self, states, pending, rounds, done, over, *rest):
        done = done.clone()
        done[(done.shape[0] + 1) // 2:] = True
        return call(self, states, pending, rounds, done, over, *rest)

    monkeypatch.setattr(ctl._JobMegaloop, "__call__", half)
    out = _run(cell)
    assert out["correct"] is False and out["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("cell", FLEETS)
def test_an_output_count_altered_where_it_is_read(cell, monkeypatch):
    from repro_torch.snn import topology

    real = topology.output_spike_counts

    def altered(states, meta):
        counts = real(states, meta)
        counts[0] += 1
        return counts

    monkeypatch.setattr(topology, "output_spike_counts", altered)
    out = _run(cell)
    assert out["correct"] is False and out["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("cell", SOLO)
def test_an_output_word_altered_where_it_is_read(cell, monkeypatch):
    from repro_torch.core import controller as ctl

    real = ctl.Controller.result_states

    def altered(self):
        states = real(self)
        dram = states["dram"]["data"].clone()
        dram += 1  # every word, O's among them
        return {**states, "dram": {**states["dram"], "data": dram}}

    monkeypatch.setattr(ctl.Controller, "result_states", altered)
    out = _run(cell)
    assert out["correct"] is False and out["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("cell", FLEETS + SOLO)
def test_the_control_is_judged_wrong_at_the_cells_size(cell):
    _, _, config, traffic = harness.load_cell(ROOT, cell)
    for seed in (2**31 + 1, 2**31 + 2, 7):
        checked, wrong = control.control_wrong(config, traffic, seed)
        assert checked == int(traffic.get("pool", 1)) and wrong > 0
