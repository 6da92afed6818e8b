"""The ``threads`` backend of the port against the JAX package: one host
thread per segment in a persistent ``vp-seg`` pool (the paper's literal
parallel mechanism), bit-identical to ``sequential`` and to the reference's
``threads`` run on the small feed-forward, recurrent, dense and hybrid jobs
(trees and ``rounds_run``); the pool's lifecycle (the counterpart of
tests/test_conformance.py's lifecycle test); a worker's exception reaching
the caller; and the kernels' shared set-ups and launch counters under many
threads."""
import gc
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro import snn as jsnn
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.vp import workloads as jwl
from repro_torch import kernels, snn, tree
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.vp import workloads as wl
from torch_parity import assert_tree_equal, single_torch_thread

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)


def _dense(pkg_sg, pkg_wl, **kw):
    layer = pkg_wl.Layer("conf", "t", 8, 8, 4)
    descs = pkg_sg.uniform(2, 2)
    job = pkg_wl.cim_workload(layer, mgr_segments=[0, 1], cim_ids_per_mgr={0: (0, 1), 1: (2, 3)},
                              ordinals=pkg_sg.mailbox_ordinals(descs))
    built = pkg_sg.build(descs, programs=job["programs"], dram_words=job["dram"],
                         crossbars=job["crossbars"], scratch_init=job["scratch"],
                         channel_latency=2000, **kw)
    return built, (job["o_word"], layer, job["expected"])


def _snn(pkg, job, **kw):
    descs = pkg.segmentation_for(job.layers, "uniform", n_segments=4, edges=job.edges)
    return pkg.build_snn(job.layers, descs, job.raster, edges=job.edges,
                         n_ticks=job.n_ticks, **kw)[:3]


# kind -> (build for one package, quantum): the small jobs of
# tests/test_conformance.py
KINDS = {
    "snn_ff": (lambda pkg, **kw: _snn(pkg, pkg.snn_inference_job(
        (32, 24, 10), t_steps=8, rate=0.5, seed=2), **kw), 32),
    "snn_recurrent": (lambda pkg, **kw: _snn(pkg, pkg.snn_recurrent_job(
        (32, 24, 8), t_steps=8, rate=0.5, seed=2), **kw), 32),
    "dense": (lambda pkg, **kw: _dense(jsg if pkg is jsnn else sg,
                                       jwl if pkg is jsnn else wl, **kw)[0], 1000),
    "hybrid": (lambda pkg, **kw: pkg.build_hybrid(pkg.hybrid_job(
        (16, 12, 8), t_steps=6, rate=0.5, seed=2), "split", channel_latency=2000, **kw)[:3],
        400),
}


def _workers(before=()):
    return [t for t in threading.enumerate()
            if t.name.startswith("vp-seg") and t not in before]


@pytest.mark.parametrize("kind", list(KINDS))
def test_threads_matches_sequential_and_jax(kind):
    build, quantum = KINDS[kind]
    ctl_j = JController(*build(jsnn), backend="threads", quantum=quantum)
    ctl_j.run(max_rounds=400, check_every=2)
    ctl_j.close()
    runs = {}
    for backend in ("threads", "sequential"):
        ctl = Controller(*build(snn, device="cpu"), backend=backend, quantum=quantum,
                         device="cpu")
        ctl.run(max_rounds=400, check_every=2)
        ctl.close()
        runs[backend] = ctl
        assert ctl.rounds_run == ctl_j.rounds_run, backend
        assert ctl.dispatches == 0
        assert_tree_equal(ctl_j.result_states(), ctl.result_states(), f"{kind}/{backend}")
        assert_tree_equal(ctl_j._pending_stacked(), ctl._pending_stacked(),
                          f"{kind}/{backend} pending")
    if kind == "dense":
        o_word, layer, expected = _dense(sg, wl, device="cpu")[1]
        dram = runs["threads"].result_states()["dram"]["data"][0].numpy()
        np.testing.assert_array_equal(
            dram[o_word:o_word + layer.h * layer.p].reshape(layer.h, layer.p), expected)


def _closed_message(ctl, call):
    with pytest.raises(RuntimeError, match="closed") as ei:
        call(ctl)
    return str(ei.value)


def test_threads_lifecycle_close_is_idempotent_and_leakless():
    build, quantum = KINDS["snn_ff"]
    before = set(threading.enumerate())
    ctl = Controller(*build(snn, device="cpu"), backend="threads", quantum=quantum,
                     device="cpu")
    ctl.run(max_rounds=300, check_every=2)
    job = snn.snn_inference_job((32, 24, 10), t_steps=8, rate=0.5, seed=2)
    assert snn.total_spikes(ctl.result_states()) == job.expected_total
    assert _workers(before), "the persistent pool must exist while the controller is open"
    assert len(_workers(before)) <= ctl.cfg.n_segments
    ctl.close()
    ctl.close()  # idempotent
    assert not _workers(before), f"threads backend leaked workers: {_workers(before)}"
    # results stay readable after close; running again does not
    assert snn.total_spikes(ctl.result_states()) == job.expected_total
    ctl_j = JController(*build(jsnn), backend="threads", quantum=quantum)
    ctl_j.close()
    for call in (lambda c: c.run(max_rounds=1), lambda c: c.round()):
        assert _closed_message(ctl, call) == _closed_message(ctl_j, call)


def test_pool_is_released_when_the_controller_is_dropped():
    build, quantum = KINDS["snn_ff"]
    before = set(threading.enumerate())
    ctl = Controller(*build(snn, device="cpu"), backend="threads", quantum=quantum,
                     device="cpu")
    ctl.round()
    workers = _workers(before)
    assert workers
    del ctl
    gc.collect()
    for t in workers:
        t.join(timeout=30)
        assert not t.is_alive(), f"{t.name} outlived its controller"


def test_a_workers_exception_reaches_the_caller(monkeypatch):
    build, quantum = KINDS["snn_ff"]
    ctl = Controller(*build(snn, device="cpu"), backend="threads", quantum=quantum,
                     device="cpu")
    step = ctl._step

    def failing(st, pending, t_limit):
        if int(st["seg_id"][0]) == 2:
            raise ValueError("segment 2 failed")
        return step(st, pending, t_limit)

    monkeypatch.setattr(ctl, "_step", failing)
    with pytest.raises(ValueError, match="segment 2 failed"):
        ctl.round()
    assert ctl.rounds_run == 0
    ctl.close()


def test_kernel_setups_and_counters_hold_under_many_threads():
    """The wrappers' launch counters and the card counts' first allocation
    are shared by the threads backend's workers: more threads than cores,
    with a short switch interval, lose no update and make one tensor."""
    def counted():
        pass

    counted.launches = counted.fault_launches = 0
    n_threads, n_iter = max(2 * (os.cpu_count() or 1), 16), 400
    made = []
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait(timeout=60)
        made.append(kernels.card_counts("stress test", torch.device("cpu")))
        for _ in range(n_iter):
            kernels.count_launch(counted, launches=1, fault_launches=2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        kernels._CARD_COUNTS.pop("stress test", None)
    assert not any(t.is_alive() for t in threads)
    assert counted.launches == n_threads * n_iter
    assert counted.fault_launches == 2 * n_threads * n_iter
    assert len(made) == n_threads and all(x is made[0] for x in made)


@pytest.mark.cuda
def test_cuda_threads_matches_sequential():
    """On the card each worker steps its segment on a stream of its own:
    the trees equal ``sequential``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    build, quantum = KINDS["hybrid"]
    trees = {}
    for backend in ("threads", "sequential"):
        ctl = Controller(*build(snn), backend=backend, quantum=quantum)
        ctl.run(max_rounds=400, check_every=2)
        ctl.close()
        trees[backend] = (ctl.rounds_run, ctl.result_states())
    assert trees["threads"][0] == trees["sequential"][0]
    leaves = [tree.leaves(tree.to_numpy(t[1])) for t in trees.values()]
    for (path, a), (_, b) in zip(*leaves):
        np.testing.assert_array_equal(a, b, err_msg=path)
