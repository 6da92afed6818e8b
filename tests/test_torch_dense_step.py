"""The port's segment step with live RISC-V CPUs against repro.vp.platform,
started from JAX-built dense states carried across with ``tree.from_numpy``:
one step from mid-run points of the offload job under both segmentations,
of the RISC-V job, and of a spiking platform that takes the full step for
a hand-injected DMA (CPUs halted, LIF ticks), compared leaf by leaf —
states, outbox and pending — bit for bit.  On a card, the slot-scan kernel equals its plain
version."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import snn as jsnn
from repro.core import channel as jch
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.vp import platform as jpf
from repro.vp import workloads as jwl
from repro_torch import tree
from repro_torch.kernels.slot_scan import ops, ref
from repro_torch.vp import platform as pf
from torch_parity import assert_tree_equal, carry_across


def _dense(strategy, mode, layer, latency):
    if strategy == "uniform":
        descs, mgrs, ids = jsg.uniform(2, 2), [0, 1], {0: (0, 1), 1: (2, 3)}
    else:
        descs, mgrs, ids = jsg.load_oriented(), [1], {1: (0, 2)}
    if mode == "cim":
        job = jwl.cim_workload(layer, mgrs, ids, ordinals=jsg.mailbox_ordinals(descs))
        kw = dict(crossbars=job["crossbars"], scratch_init=job["scratch"])
    else:
        job, kw = jwl.riscv_workload(layer), {}
    return jsg.build(descs, programs=job["programs"], dram_words=job["dram"],
                     channel_latency=latency, **kw)


def _fallback():
    """A spiking platform with a scratch DMA hand-injected into its initial
    inbox: the step with CPUs (all halted) beside the LIF tick."""
    job = jsnn.snn_inference_job((16, 12, 8), t_steps=6, rate=0.5, seed=2)
    cfg, states, pending, _ = jsnn.build_snn(
        job.layers, jsnn.segmentation_for(2, "uniform", n_segments=2), job.raster)
    pending = dict(pending)
    for f, v in (("kind", jch.MSG_W_SCRATCH), ("addr", 7), ("data", 1234),
                 ("t_avail", 0), ("valid", True)):
        pending[f] = pending[f].at[0, -1].set(v)
    return dataclasses.replace(cfg, has_cpu=True), states, pending


# (name, builder, quantum, rounds to snapshot at): the small jobs of the
# parity suite, stepped from points where CPUs stream, poll, wait and halt
JOBS = {
    "cim-uniform": (lambda: _dense("uniform", "cim", jwl.Layer("x", "t", 6, 6, 2), 500),
                    500, (2, 4)),
    "cim-load_oriented": (lambda: _dense("load_oriented", "cim",
                                         jwl.Layer("x", "t", 8, 8, 2), 1000), 1000, (5,)),
    "riscv-uniform": (lambda: _dense("uniform", "riscv", jwl.Layer("x", "t", 4, 4, 2), 500),
                      500, (1,)),
    "snn-fallback": (_fallback, 32, (0, 3)),
}
CASES = [(name, r) for name, (_, _, rounds) in JOBS.items() for r in rounds]


def _snapshots(name):
    """[(states, pending, t_limit, want)] at the job's rounds of one JAX run
    on the sequential backend; ``want`` is the reference's step from there,
    the compiled one-segment step of that run applied segment by segment."""
    build, quantum, rounds = JOBS[name]
    cfg, states, pending = build()
    ctl = JController(cfg, states, pending, backend="sequential", quantum=quantum)
    stack = lambda xs: jax.tree.map(lambda *v: np.stack(v), *xs)
    snaps = []
    for r in range(max(rounds) + 1):
        if r in rounds:
            st, pen = jax.tree.map(np.asarray, (ctl._stacked(), ctl._pending_stacked()))
            lim = np.asarray(ctl._limits(st["time"]))
            take = lambda t, i: jax.tree.map(lambda x: x[i], t)
            want = stack([jax.tree.map(np.asarray, ctl._step_one(take(st, i), take(pen, i),
                                                                 lim[i]))
                          for i in range(cfg.n_segments)])
            snaps.append((st, pen, lim, want))
        ctl.round()
    return cfg, quantum, snaps


@pytest.fixture(scope="module")
def snapshots():
    return {name: _snapshots(name) for name in JOBS}


@pytest.mark.parametrize("name,k", [(n, i) for n, (_, _, rs) in JOBS.items()
                                    for i in range(len(rs))],
                         ids=[f"{n}-round{r}" for n, r in CASES])
def test_one_step_matches_jax(snapshots, name, k):
    cfg, quantum, snaps = snapshots[name]
    assert cfg.has_cpu
    st, pen, lim, want = snaps[k]
    tst, tpen, tlim = carry_across((st, pen, lim))
    got = pf.make_segment_step(cfg, quantum)(tst, tpen, tlim)
    for what, w, g in zip(("states", "outbox", "pending"), want, got):
        assert_tree_equal(w, g, what)


@pytest.mark.parametrize("name", ["cim-uniform", "snn-fallback"])
def test_termination_flags_match_jax(snapshots, name):
    cfg, _, snaps = snapshots[name]
    for st, pen, _, _ in snaps:
        for caps in ((cfg.in_cap, cfg.out_cap, cfg.store_log), (1, 1, 0)):
            want = [bool(x) for x in jpf.termination_flags(st, pen, *caps)]
            tst, tpen = carry_across((st, pen))
            assert [bool(x) for x in pf.termination_flags(tst, tpen, *caps)] == want


def _scan_inputs(cfg, st, lim, device):
    """The slot scan's inputs as the step hands them over: an empty outbox
    and the CIM wiring tables."""
    tst = tree.from_numpy(st, device)
    box = pf.ch.empty_box(cfg.out_cap, (tst["time"].shape[0],), device)
    wiring = [torch.tensor(x, dtype=torch.int32, device=device)
              for x in (cfg.cim_seg, cfg.cim_slot)]
    return tst, box, torch.from_numpy(lim).to(device), wiring


@pytest.mark.cuda
@pytest.mark.parametrize("name,k", [(n, i) for n, (_, _, rs) in JOBS.items()
                                    for i in range(len(rs))],
                         ids=[f"{n}-round{r}" for n, r in CASES])
def test_cuda_kernel_matches_plain(snapshots, name, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfg, quantum, snaps = snapshots[name]
    st, _, lim, _ = snaps[k]
    outs = []
    before = ops.slot_scan.launches
    for fn in (ops.slot_scan, ref.slot_scan):
        tst, box, tlim, wiring = _scan_inputs(cfg, st, lim, "cuda")
        outs.append(tree.to_numpy(fn(cfg, quantum, tst, box, tlim, *wiring)))
    assert ops.slot_scan.launches == before + 1
    for (path, g), (_, w) in zip(tree.leaves(outs[0][0]), tree.leaves(outs[1][0])):
        np.testing.assert_array_equal(g, w, err_msg=path)
    for (path, g), (_, w) in zip(tree.leaves(outs[0][1]), tree.leaves(outs[1][1])):
        np.testing.assert_array_equal(g, w, err_msg=path)
