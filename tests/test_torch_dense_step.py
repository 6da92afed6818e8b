"""The port's segment step with live RISC-V CPUs against repro.vp.platform,
started from JAX-built dense states carried across with ``tree.from_numpy``:
one step from mid-run points of the offload job under both segmentations,
of the RISC-V job, and of a spiking platform that takes the full step for
a hand-injected DMA (CPUs halted, LIF ticks), compared leaf by leaf —
states, outbox and pending — bit for bit.  On a card, the slot-scan kernel equals its plain
version, and fast-forwards slots where a manager CPU polls.  The kernel's
integer arguments carry the cache geometry as shifts and masks."""
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
                                         jwl.Layer("x", "t", 8, 8, 2), 1000), 1000, (2, 5)),
    "riscv-uniform": (lambda: _dense("uniform", "riscv", jwl.Layer("x", "t", 4, 4, 2), 500),
                      500, (1,)),
    "snn-fallback": (_fallback, 32, (0, 3)),
}
CASES = [(name, r) for name, (_, _, rounds) in JOBS.items() for r in rounds]
# snapshots where a manager CPU spins on a scratch flag for the whole quantum
POLLING = {("cim-uniform", 2), ("cim-load_oriented", 2)}


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
        if fn is ops.slot_scan:
            skipped = int(ops.slot_scan.skipped.sum())
    assert ops.slot_scan.launches == before + 1
    if (name, JOBS[name][2][k]) in POLLING:
        assert skipped > 0, "the fast-forward skipped no slot of a polling quantum"
    for (path, g), (_, w) in zip(tree.leaves(outs[0][0]), tree.leaves(outs[1][0])):
        np.testing.assert_array_equal(g, w, err_msg=path)
    for (path, g), (_, w) in zip(tree.leaves(outs[0][1]), tree.leaves(outs[1][1])):
        np.testing.assert_array_equal(g, w, err_msg=path)


def _platform_cfg():
    from repro_torch.core import segmentation as sg

    cfg, _, _ = sg.build(sg.uniform(2, 2), programs={0: "halt"},
                         dram_words=np.zeros(64, np.int32), device="cpu")
    return cfg


SIZES = dict(out_cap=8, isets=512, dsets=1024, dram_words=1 << 20, scratch_words=4096,
             prog_words=512)


def test_pack_ints_gives_shifts_and_masks():
    """The cache geometry reaches the kernel as a line shift and set masks."""
    cfg = _platform_cfg()
    ints = ops.pack_ints(cfg, 10_000, **SIZES)
    assert tuple(ints) == ops.INTS
    assert (ints["line_shift"], ints["iset_mask"], ints["dset_mask"]) == (3, 511, 1023)
    assert 1 << ints["line_shift"] == cfg.timing.line_words
    assert ints["quantum"] == 10_000 and ints["store_log"] == cfg.store_log
    t = dataclasses.replace(cfg.timing, line_words=1)
    ints = ops.pack_ints(dataclasses.replace(cfg, timing=t), 1, **dict(SIZES, isets=1))
    assert (ints["line_shift"], ints["iset_mask"]) == (0, 0)


@pytest.mark.parametrize("field,value", [("line_words", 6), ("line_words", 0),
                                         ("isets", 384), ("dsets", 1000), ("dsets", 0),
                                         ("dram_words", 3 << 18), ("prog_words", 500),
                                         ("store_log", 0)])
def test_pack_ints_refuses_what_is_not_a_power_of_two(field, value):
    cfg = _platform_cfg()
    sizes = dict(SIZES)
    if field == "line_words":
        cfg = dataclasses.replace(cfg, timing=dataclasses.replace(cfg.timing, line_words=value))
    elif field == "store_log":
        cfg = dataclasses.replace(cfg, store_log=value)
    else:
        sizes[field] = value
    with pytest.raises(ValueError, match="slot_scan"):
        ops.pack_ints(cfg, 100, **sizes)
