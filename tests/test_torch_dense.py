"""The port's dense slice end to end against the JAX package: the paper's
VMM offload and RISC-V jobs built identically (programs, DRAM, crossbars,
scratch) and run to completion by ``Controller.run`` on both backends,
equal to the reference in final trees, ``rounds_run`` and ``O``; remote
DRAM reads and posted writes; the store-log and outbox overflow messages
byte for byte; and the hand-injected-MMIO fallback of a spiking
platform."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import snn as jsnn
from repro.core import channel as jch
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.vp import workloads as jwl
from repro_torch import snn
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.vp import workloads as wl
from torch_parity import assert_tree_equal, carry_across, cfg_fields

# (strategy, mode, layer (h, w, p), channel latency = quantum) -> the
# reference's rounds and per-segment instructions with check_every=2
JOBS = {
    "cim-uniform": ("uniform", "cim", (6, 6, 2), 500, 6, [697, 697]),
    "cim-load_oriented": ("load_oriented", "cim", (8, 8, 2), 1000, 8, [0, 2769, 0, 0]),
    "riscv-uniform": ("uniform", "riscv", (4, 4, 2), 500, 2, [498, 0]),
}


def _build(sg_mod, wl_mod, name, **kw):
    strategy, mode, hwp, latency, _, _ = JOBS[name]
    layer = wl_mod.Layer("x", "t", *hwp)
    if strategy == "uniform":
        descs, mgrs, ids = sg_mod.uniform(2, 2), [0, 1], {0: (0, 1), 1: (2, 3)}
    else:
        descs, mgrs, ids = sg_mod.load_oriented(), [1], {1: (0, 2)}
    if mode == "cim":
        job = wl_mod.cim_workload(layer, mgrs, ids,
                                  ordinals=sg_mod.mailbox_ordinals(descs))
        kw.update(crossbars=job["crossbars"], scratch_init=job["scratch"])
    else:
        job = wl_mod.riscv_workload(layer)
    built = sg_mod.build(descs, programs=job["programs"], dram_words=job["dram"],
                         channel_latency=latency, **kw)
    return built, job, layer


def _o(states, job, layer):
    data = np.asarray(states["dram"]["data"][0])
    return data[job["o_word"]: job["o_word"] + layer.h * layer.p].reshape(layer.h, layer.p)


@pytest.fixture(scope="module", params=list(JOBS))
def jax_run(request):
    """The reference run (vmap, per-round dispatch) of one job."""
    name = request.param
    (cfg, states, pending), job, layer = _build(jsg, jwl, name)
    quantum = JOBS[name][3]
    ctl = JController(cfg, states, pending, backend="vmap", quantum=quantum)
    ctl.run(max_rounds=400, check_every=2, fused=False)
    st = jax.tree.map(np.asarray, ctl.result_states())
    pen = jax.tree.map(np.asarray, ctl._pending_stacked())
    return name, (cfg, states, pending), ctl.rounds_run, st, pen


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_full_run_matches_jax(jax_run, backend):
    name, (cfg_j, st_j0, pen_j0), rounds, st_j, pen_j = jax_run
    _, _, _, quantum, want_rounds, want_instrs = JOBS[name]
    (cfg, states, pending), job, layer = _build(sg, wl, name, device="cpu")
    assert cfg_fields(cfg) == cfg_fields(cfg_j)
    assert_tree_equal(st_j0, states, "built states")
    assert_tree_equal(pen_j0, pending, "built pending")
    ctl = Controller(cfg, states, pending, backend=backend, quantum=quantum,
                     device="cpu")
    ctl.run(max_rounds=400, check_every=2)
    assert ctl.rounds_run == rounds == want_rounds
    st = ctl.result_states()
    assert st["stats"]["instrs"].tolist() == want_instrs
    assert_tree_equal(st_j, st, "states")
    assert_tree_equal(pen_j, ctl._pending_stacked(), "pending")
    np.testing.assert_array_equal(_o(st, job, layer), job["expected"])


# CPU1 has no local DRAM: two blocking remote loads (MSG_R_DRAM, the
# stall, MSG_R_RESP and its writeback), a posted remote store
# (MSG_W_DRAM) and scratch stores — paths no Table III job takes
REMOTE_PROG = """
    li t0, 4096
    lw t1, 0(t0)
    lw t2, 4(t0)
    add t3, t1, t2
    sw t3, 8(t0)
    li t4, 0x70000000
    sw t3, 0(t4)
    lw t5, 12(t0)
    sw t5, 4(t4)
    halt
"""


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_remote_reads_and_posted_writes_match_jax(backend):
    dram = np.arange(2048, dtype=np.int32) * 3 - 1000
    build = lambda m, **kw: m.build(m.uniform(2, 2), programs={1: REMOTE_PROG},
                                    dram_words=dram, channel_latency=300, **kw)
    ctl_j = JController(*build(jsg), backend="vmap", quantum=300)
    ctl_j.run(max_rounds=200, check_every=2, fused=False)
    ctl = Controller(*build(sg, device="cpu"), backend=backend, quantum=300, device="cpu")
    ctl.run(max_rounds=200, check_every=2)
    assert ctl.rounds_run == ctl_j.rounds_run
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), "states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), "pending")
    st = ctl.result_states()
    assert int(st["dram"]["data"][0, 1026]) == dram[1024] + dram[1025]
    assert st["scratch"][1, :2].tolist() == [dram[1024] + dram[1025], dram[1027]]


def _store_log_sim(pkg_sg, pkg_wl, **kw):
    # a RISC-V VMM writing its whole output matrix: store_log=2 overflows
    job = pkg_wl.riscv_workload(pkg_wl.Layer("conf", "t", 8, 8, 4))
    return pkg_sg.build([pkg_sg.SegmentDesc(cpu=True, dram=True)],
                        programs=job["programs"], dram_words=job["dram"],
                        store_log=2, **kw)


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_store_log_overflow_message_matches_jax(backend):
    ctl_j = JController(*_store_log_sim(jsg, jwl), backend="vmap", quantum=400)
    with pytest.raises(RuntimeError, match="store-log overflow") as want:
        ctl_j.run(max_rounds=100, check_every=2, fused=False)
    ctl = Controller(*_store_log_sim(sg, wl, device="cpu"), backend=backend,
                     quantum=400, device="cpu")
    with pytest.raises(RuntimeError) as got:
        ctl.run(max_rounds=100, check_every=2)
    assert str(got.value) == str(want.value)
    assert ctl.rounds_run == ctl_j.rounds_run
    # past-capacity semantics: what the clipped log or the truncated box
    # left behind is the reference's too
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), "states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), "pending")


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_outbox_overflow_message_matches_jax(backend):
    """out_cap=4 is past capacity while a CPU streams one unit's MMIO
    writes inside a quantum: the scan drops the appends and the watermark
    records the demand, as in the reference."""
    ctl_j = JController(*_build(jsg, jwl, "cim-uniform", out_cap=4)[0], backend="vmap",
                        quantum=500)
    with pytest.raises(RuntimeError, match="outbox overflow") as want:
        ctl_j.run(max_rounds=100, check_every=2, fused=False)
    ctl = Controller(*_build(sg, wl, "cim-uniform", out_cap=4, device="cpu")[0],
                     backend=backend, quantum=500, device="cpu")
    with pytest.raises(RuntimeError) as got:
        ctl.run(max_rounds=100, check_every=2)
    assert str(got.value) == str(want.value)
    assert ctl.rounds_run == ctl_j.rounds_run
    # past-capacity semantics: what the clipped log or the truncated box
    # left behind is the reference's too
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), "states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), "pending")


def test_mmio_fallback_runs_the_full_step():
    """A hand-injected scratch DMA in a spiking platform's initial inbox
    turns on the full step (tests/test_conformance.py's fallback case): the
    port equals the reference's fallback run, the word lands, and the spike
    results still match the oracle."""
    def injected(pkg, ch_mod, **kw):
        job = pkg.snn_inference_job((16, 12, 8), t_steps=6, rate=0.6, seed=5)
        descs = pkg.segmentation_for(2, "uniform", n_segments=2)
        cfg, states, pending, meta = pkg.build_snn(job.layers, descs, job.raster, **kw)
        assert not cfg.has_cpu
        pending = jax.tree.map(np.array, pending)
        for f, v in (("kind", ch_mod.MSG_W_SCRATCH), ("addr", 7), ("data", 1234),
                     ("t_avail", 0), ("valid", True)):
            pending[f][0, -1] = v
        return cfg, states, pending, meta, job

    cfg_j, st_j, pen_j, _, _ = injected(jsnn, jch)
    ctl_j = JController(cfg_j, st_j, pen_j, backend="vmap", quantum=32)
    assert ctl_j.cfg.has_cpu
    ctl_j.run(max_rounds=300, check_every=2, fused=False)

    cfg, states, pending, meta, job = injected(snn, jch, device="cpu")
    ctl = Controller(cfg, states, carry_across(pending), backend="vmap", quantum=32,
                     device="cpu")
    assert ctl.cfg.has_cpu and cfg_fields(ctl.cfg) == cfg_fields(ctl_j.cfg)
    ctl.run(max_rounds=300, check_every=2)
    assert ctl.rounds_run == ctl_j.rounds_run
    assert_tree_equal(ctl_j.result_states(), ctl.result_states(), "states")
    assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(), "pending")
    st = ctl.result_states()
    assert int(st["scratch"][0, 7]) == 1234
    np.testing.assert_array_equal(snn.output_spike_counts(st, meta), job.expected_counts)


def test_builder_rules_match_jax():
    """``has_cpu`` follows programmed CPUs, unprogrammed CPUs halt at build
    time, and hybrid jobs stay outside the slice."""
    descs = sg.uniform(2, 2)
    jdescs = jsg.uniform(2, 2)
    prog = {1: "    li t0, 5\n    halt"}
    for kw in ({}, {"programs": prog}):
        cfg, st, _ = sg.build(descs, device="cpu", **kw)
        cfg_j, st_j, _ = jsg.build(jdescs, **kw)
        assert cfg_fields(cfg) == cfg_fields(cfg_j)
        assert_tree_equal(st_j, st, "states")
    assert cfg.has_cpu and st["cpu"]["halted"].tolist() == [True, False]
    spike = {0: {"mode": 1, "tick_period": 10_000}}
    with pytest.raises(NotImplementedError, match="ROADMAP module item 8"):
        sg.build(descs, programs=prog, cim_init=spike, device="cpu")
    assert dataclasses.asdict(sg.SegmentDesc()) == dataclasses.asdict(jsg.SegmentDesc())
