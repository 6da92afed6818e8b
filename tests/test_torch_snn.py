"""The port's spiking slice end to end against the JAX package: identical
jobs and oracles, identical built platforms under every placement, a full
``Controller.run`` on both backends equal to the reference (final trees,
``rounds_run``, output counts), byte-identical overflow messages, the GPU
default, the refusal of options outside the slice, and the import rule."""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import snn as jsnn
from repro.core.controller import Controller as JController
from repro_torch import snn
from repro_torch.core import channel as ch
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.vp import isa
from torch_parity import assert_tree_equal, cfg_fields

REPO = Path(__file__).resolve().parents[1]
SIZES = (40, 32, 24, 10)
QUANTUM = 32


def _job(pkg, sizes=SIZES, t_steps=6, rate=0.6, seed=3):
    return pkg.snn_inference_job(sizes, t_steps=t_steps, rate=rate, seed=seed)


def _build(pkg, job, strategy, n_segments=4, **kw):
    placement = None
    if strategy == "auto":
        descs, placement = pkg.auto_segmentation_for(job.layers, n_segments=n_segments)
    else:
        descs = pkg.segmentation_for(len(job.layers), strategy, n_segments=n_segments)
    return pkg.build_snn(job.layers, descs, job.raster, placement=placement, **kw)


def _meta_plain(meta):
    m = dict(meta)
    m["groups"] = [{"group": dataclasses.asdict(g["group"]), "units": g["units"]}
                   for g in meta["groups"]]
    return m


def test_job_and_oracle_match_jax():
    want, got = _job(jsnn), _job(snn)
    for wl, gl in zip(want.layers, got.layers):
        np.testing.assert_array_equal(wl.weights, gl.weights)
        assert dataclasses.asdict(wl.params) == dataclasses.asdict(gl.params)
    np.testing.assert_array_equal(want.raster, got.raster)
    np.testing.assert_array_equal(want.expected_counts, got.expected_counts)
    assert want.expected_total == got.expected_total


@pytest.mark.parametrize("strategy", ["uniform", "load_oriented", "auto"])
def test_build_snn_matches_jax(strategy):
    cfg_j, st_j, pen_j, meta_j = _build(jsnn, _job(jsnn), strategy, in_cap=512)
    cfg_t, st_t, pen_t, meta_t = _build(snn, _job(snn), strategy, in_cap=512,
                                        device="cpu")
    assert cfg_fields(cfg_t) == cfg_fields(cfg_j)
    assert_tree_equal(st_j, st_t, "states")
    assert_tree_equal(pen_j, pen_t, "pending")
    assert _meta_plain(meta_t) == _meta_plain(meta_j)


@pytest.fixture(scope="module")
def jax_run():
    """The reference run: the JAX package's default (fused) vmap backend."""
    job = _job(jsnn)
    cfg, states, pending, meta = _build(jsnn, job, "uniform", in_cap=512)
    ctl = JController(cfg, states, pending, backend="vmap", quantum=QUANTUM)
    ctl.run(max_rounds=400, check_every=2)
    st = jax.tree.map(np.asarray, ctl.result_states())
    pen = jax.tree.map(np.asarray, ctl._pending_stacked())
    return ctl.rounds_run, st, pen, jsnn.output_spike_counts(st, meta), job


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_full_run_matches_jax(jax_run, backend):
    rounds, st_j, pen_j, counts_j, job_j = jax_run
    job = _job(snn)
    cfg, states, pending, meta = _build(snn, job, "uniform", in_cap=512, device="cpu")
    ctl = Controller(cfg, states, pending, backend=backend, quantum=QUANTUM,
                     device="cpu")
    ctl.run(max_rounds=400, check_every=2)
    assert ctl.rounds_run == rounds
    assert_tree_equal(st_j, ctl.result_states(), "states")
    assert_tree_equal(pen_j, ctl._pending_stacked(), "pending")
    counts = snn.output_spike_counts(ctl.result_states(), meta)
    np.testing.assert_array_equal(counts, counts_j)
    np.testing.assert_array_equal(counts, job_j.expected_counts)
    # a finished controller does not run again
    assert ctl.run(max_rounds=400, check_every=2)[0] == rounds


BURST_SIZES = (8, 200, 8)  # 200-neuron middle layer -> 200-spike AER bursts


def _burst_sim(pkg, **caps):
    job = pkg.snn_inference_job(BURST_SIZES, t_steps=3, rate=0.9, seed=4)
    descs = pkg.segmentation_for(len(job.layers), "uniform", n_segments=2)
    return pkg.build_snn(job.layers, descs, job.raster, **caps)[:3]


@pytest.mark.parametrize("caps", [{"out_cap": 64}, {"in_cap": 80}],
                         ids=["out_cap", "in_cap"])
@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_overflow_message_matches_jax(caps, backend):
    ctl_j = JController(*_burst_sim(jsnn, **caps), backend="vmap", quantum=QUANTUM)
    with pytest.raises(RuntimeError) as want:
        ctl_j.run(max_rounds=300, check_every=2, fused=False)
    ctl = Controller(*_burst_sim(snn, device="cpu", **caps), backend=backend,
                     quantum=QUANTUM, device="cpu")
    with pytest.raises(RuntimeError) as got:
        ctl.run(max_rounds=300, check_every=2)
    assert str(got.value) == str(want.value)
    assert ctl.rounds_run == ctl_j.rounds_run


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = _job(snn)
    descs = snn.segmentation_for(len(job.layers), "uniform", n_segments=2)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        snn.build_snn(job.layers, descs, job.raster)
    cfg, states, pending, _ = snn.build_snn(job.layers, descs, job.raster,
                                            device="cpu")
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        Controller(cfg, states, pending)


def _outside_the_slice():
    job = _job(snn, sizes=(16, 12, 8))
    descs = snn.segmentation_for(len(job.layers), "uniform", n_segments=2)
    built = snn.build_snn(job.layers, descs, job.raster, device="cpu")[:3]
    ctl = lambda **kw: Controller(*built, device="cpu", **kw)
    spike_units = {0: {"mode": 1, "tick_period": 10_000}}

    def hybrid(kind, addr, live_cpu):
        # a hand-injected message turns on the full step with every CPU
        # halted; a COUNTS request or a live CPU makes a hybrid job (item 8)
        cfg, states, pending, _ = snn.build_snn(job.layers, descs, job.raster, device="cpu")
        for f, v in (("kind", kind), ("addr", addr), ("data", 3), ("t_avail", 0),
                     ("valid", True)):
            pending[f][0, -1] = v
        assert states["cpu"]["present"][0] and states["cpu"]["halted"][0]
        states["cpu"]["halted"][0] = not live_cpu
        return Controller(cfg, states, pending, device="cpu")

    return {
        "threads": lambda: ctl(backend="threads"),
        "shard_map": lambda: ctl(backend="shard_map"),
        "obs": lambda: ctl(obs=object()),
        # live CPUs beside spike-mode units: a hybrid job (ROADMAP item 8)
        "programs": lambda: sg.build(descs, programs={0: "halt"},
                                     cim_init=spike_units, device="cpu"),
        "traffic": lambda: snn.auto_segmentation_for(job.layers, traffic=np.eye(2)),
        "counts_request": lambda: hybrid(ch.MSG_W_CIM, isa.CIM_REG_COUNTS, False),
        "live_cpu": lambda: hybrid(ch.MSG_W_SCRATCH, 7, True),
    }


@pytest.mark.parametrize("option", ["threads", "shard_map", "obs", "programs", "traffic",
                                    "counts_request", "live_cpu"])
def test_options_outside_the_slice_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _outside_the_slice()[option]()


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 10 and not bad, bad
