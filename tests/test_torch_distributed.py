"""The port's multi-device backends on ``torch.distributed`` against the JAX
package's ``shard_map``: one gloo world of 2 CPU processes
(``torch_parity.run_torch_world``) and one JAX subprocess with 2 fake devices
(``conftest.run_with_devices``) run the same jobs, and each writes its
results to an ``.npz``.

- ``Controller(backend="shard_map", mesh=...)``: the dense and SNN jobs of
  tests/test_distributed.py, fused (two dispatch shapes) and per-round:
  whole final trees leaf-equal, ``rounds_run`` and ``dispatches`` equal on
  both ranks, the SNN output equal to the oracle's; a traced run's events,
  ``stats()``/``metrics()`` and an inbox-overflow message equal;
- ``SnnServer(bucket_size=8, mesh=make_serve_mesh())`` over
  ``serve_fleet(6, (12, 10, 8), seed=11)``: every request equal to its solo
  run (tests/test_serve.py's ``test_shard_map_bucket_matches_solo``);
- one segment on a mesh of one (an in-process world): the reference's
  ``shard_map`` limit, ``2^30`` without the one-segment case (ROADMAP F6).
"""
import json

import numpy as np
import pytest

from conftest import run_with_devices
from torch_parity import run_torch_world

# the jobs, written once for both packages: ``DEV`` is {} for the JAX
# package and {"device": "cpu"} for the port
JOBS = '''
import json, os, sys
import numpy as np

def leaves(t, prefix=""):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in leaves(t[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(t))]

def build(kind, **caps):
    if kind == "dense":
        layer = wl.Layer("t", "t", 8, 8, 4)
        job = wl.cim_workload(layer, mgr_segments=[0, 1], cim_ids_per_mgr={0: (0, 1), 1: (2, 3)})
        cfg, states, pending = sg.build(
            sg.uniform(2, 2), programs=job["programs"], dram_words=job["dram"],
            crossbars=job["crossbars"], scratch_init=job["scratch"], channel_latency=2000,
            **caps, **DEV)
        return cfg, states, pending, None, 1000, dict(max_rounds=200, check_every=1)
    if kind == "burst":  # a 200-neuron layer's AER bursts (tests/test_snn.py)
        job = snn.snn_inference_job((8, 200, 8), t_steps=3, rate=0.9, seed=4)
    else:
        job = snn.snn_inference_job((16, 12, 8), t_steps=6, rate=0.6, seed=5)
    descs = snn.segmentation_for(len(job.layers), "uniform", n_segments=2)
    cfg, states, pending, meta = snn.build_snn(job.layers, descs, job.raster, **caps, **DEV)
    return cfg, states, pending, (job, meta), 32, dict(max_rounds=100, check_every=1)

CASES = {
    "dense-fused": ("dense", dict(fused=True)),
    "dense-fused-k3": ("dense", dict(fused=True, rounds_per_dispatch=3)),
    "dense-per_round": ("dense", dict(fused=False)),
    "snn-fused": ("snn", dict(fused=True)),
    "snn-fused-check2-k3": ("snn", dict(fused=True, check_every=2, rounds_per_dispatch=3)),
    "snn-per_round": ("snn", dict(fused=False)),
}

def run_cases(mesh, out):
    for name, (kind, kw) in CASES.items():
        cfg, states, pending, snn_job, quantum, run = build(kind)
        ctl = Controller(cfg, states, pending, backend="shard_map", mesh=mesh,
                         quantum=quantum, **DEV)
        ctl.run(**{**run, **kw})
        tree_ = {"states": ctl.result_states(), "pending": ctl._pending_stacked()}
        for p, x in leaves(tree_):
            out[f"{name}{p}"] = x
        out[f"{name}:rounds_dispatches"] = np.array([ctl.rounds_run, ctl.dispatches])
        if snn_job is not None:
            job, meta = snn_job
            st = ctl.result_states()
            counts = np.asarray(st["cims"]["spike_counts"])
            out[f"{name}:output"] = counts[meta["out_unit"][0], meta["out_unit"][1], :meta["n_out"]]
            out[f"{name}:oracle"] = np.asarray(job.expected_counts)
        if name == "snn-fused":
            for p, x in leaves({"stats": ctl.stats(), "metrics": ctl.metrics()}):
                out[f"dicts{p}"] = x
    # telemetry riding the shard_map dispatch
    cfg, states, pending, _, quantum, run = build("snn")
    ctl = Controller(cfg, states, pending, backend="shard_map", mesh=mesh, quantum=quantum,
                     obs=TraceConfig(capacity=64), **DEV)
    ctl.run(**run, rounds_per_dispatch=4)
    ev = ctl.trace_events()
    out["traced:events"] = np.frombuffer(ev.tobytes(), np.uint8)
    out["traced:counts"] = np.array([len(ev), ctl.trace_lost, ctl.rounds_run, ctl.dispatches])
    # an inbox past its cap: the watermark message on every rank
    messages = {}
    for fused in (True, False):
        cfg, states, pending, _, quantum, run = build("burst", in_cap=80)
        ctl = Controller(cfg, states, pending, backend="shard_map", mesh=mesh,
                         quantum=quantum, **DEV)
        try:
            ctl.run(max_rounds=300, check_every=2, fused=fused)
            messages[str(fused)] = None
        except RuntimeError as e:
            messages[str(fused)] = str(e)
    return messages
'''

JAX_SIDE = "DEV = {}\n" + JOBS + '''
from repro import compat, snn
from repro.core import segmentation as sg
from repro.core.controller import Controller
from repro.obs import TraceConfig
from repro.vp import workloads as wl

out = {}
messages = run_cases(compat.make_mesh((2,), ("segment",)), out)
np.savez(os.path.join(sys.argv[1], "jax.npz"), **out)
with open(os.path.join(sys.argv[1], "jax_messages.json"), "w") as f:
    json.dump(messages, f)
'''

TORCH_SIDE = 'DEV = {"device": "cpu"}\n' + JOBS + '''
import torch
torch.set_num_threads(1)
from repro_torch import snn
from repro_torch.core import segmentation as sg
from repro_torch.core.controller import Controller
from repro_torch.launch import mesh as M
from repro_torch.obs import TraceConfig
from repro_torch.serve.snn_serve import SnnServer
from repro_torch.vp import workloads as wl

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
M.init_world(os.environ["INIT_METHOD"], rank, world, device="cpu", timeout_s=120)
out = {}
messages = run_cases(M.make_mesh((world,), ("segment",), device="cpu"), out)

# sharded serving against solo runs (tests/test_serve.py)
from repro_torch.snn import workloads as swl
reqs = swl.serve_fleet(6, (12, 10, 8), seed=11, device="cpu")
srv = SnnServer(bucket_size=8, mesh=M.make_serve_mesh(device="cpu"), check_every=4,
                max_rounds=300)
tickets = [srv.submit(r) for r in reqs]
res = srv.flush()
for j, (t, req) in enumerate(zip(tickets, reqs)):
    r = res[t]
    out[f"served{j}:meta"] = np.array([r.ok, r.rounds] + list(r.output_counts()) +
                                      list(req.expected_counts))
    for p, x in leaves(r.states):
        out[f"served{j}{p}"] = x
    solo = Controller(req.cfg, req.states, req.pending, backend="vmap", quantum=10_000, **DEV)
    rounds, _ = solo.run(max_rounds=300, check_every=4)
    out[f"solo{j}:rounds"] = np.array([rounds])
    for p, x in leaves(solo.result_states()):
        out[f"solo{j}{p}"] = x
out["serve:dispatches"] = np.array([srv.dispatches, srv.dispatch_syncs, srv.served])
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), **out)
with open(os.path.join(os.environ["OUT"], f"rank{rank}_messages.json"), "w") as f:
    json.dump(messages, f)
torch.distributed.destroy_process_group()
'''

WORLD = 2
CASES = ["dense-fused", "dense-fused-k3", "dense-per_round", "snn-fused",
         "snn-fused-check2-k3", "snn-per_round"]
N_REQUESTS = 6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both sides' results: {"jax": ..., 0: rank 0's, 1: rank 1's}, each a
    dict of arrays and the overflow messages."""
    jdir = tmp_path_factory.mktemp("jax_shard_map")
    run_with_devices(JAX_SIDE.replace("sys.argv[1]", repr(str(jdir))), n_devices=WORLD,
                     timeout=600)
    tdir = tmp_path_factory.mktemp("torch_world")
    run_torch_world(TORCH_SIDE, WORLD, tdir)
    load = lambda d, name: (dict(np.load(d / f"{name}.npz")),
                            json.loads((d / f"{name}_messages.json").read_text()))
    got = {"jax": load(jdir, "jax")}
    for r in range(WORLD):
        got[r] = load(tdir, f"rank{r}")
    return got


def _case(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix + "/") or k.startswith(prefix + ":")}


def _assert_same(want, got, what):
    assert list(want) == list(got), f"{what}: keys {list(want)} vs {list(got)}"
    for k in want:
        assert want[k].dtype == got[k].dtype, f"{what}{k}: {want[k].dtype} vs {got[k].dtype}"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}{k}")


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("case", CASES)
def test_shard_map_run_equals_jax(results, case, rank):
    """The whole final tree (states and pending), ``rounds_run`` and
    ``dispatches`` of the port's ``shard_map`` equal the JAX package's."""
    want = _case(results["jax"][0], case)
    got = _case(results[rank][0], case)
    _assert_same(want, got, f"{case} rank {rank}")
    if case.startswith("snn"):
        np.testing.assert_array_equal(got[":output"], got[":oracle"])


@pytest.mark.parametrize("what", ["traced", "dicts"])
def test_telemetry_and_metrics_equal_jax(results, what):
    """A traced ``shard_map`` run's drained events (bytes), lost count,
    rounds and dispatches; ``stats()`` and ``metrics()`` after a fused run."""
    for r in range(WORLD):
        _assert_same(_case(results["jax"][0], what), _case(results[r][0], what),
                     f"{what} rank {r}")
    if what == "traced":
        assert results[0][0]["traced:counts"][0] > 0


def test_watermark_messages_equal_jax(results):
    want = results["jax"][1]
    assert want["True"] and want["True"].startswith("pending inbox overflow")
    for r in range(WORLD):
        assert results[r][1] == want


@pytest.mark.parametrize("j", range(N_REQUESTS))
def test_sharded_serving_equals_solo(results, j):
    """Request ``j`` of the fleet served over a 2-rank ``jobs`` mesh equals
    its solo fused run on both ranks, with the oracle's output counts."""
    for r in range(WORLD):
        arrays = results[r][0]
        meta = arrays[f"served{j}:meta"]
        ok, rounds, counts = meta[0], meta[1], meta[2:]
        assert ok == 1
        assert rounds == arrays[f"solo{j}:rounds"][0]
        n = len(counts) // 2
        np.testing.assert_array_equal(counts[:n], counts[n:])
        served = {k: v for k, v in _case(arrays, f"served{j}").items() if k != ":meta"}
        solo = {k: v for k, v in _case(arrays, f"solo{j}").items() if k != ":rounds"}
        _assert_same(solo, served, f"request {j} rank {r}")
    # one bucket of 8 lanes (6 requests, 2 inert): its dispatches on both ranks
    assert results[0][0]["serve:dispatches"].tolist() == results[1][0]["serve:dispatches"].tolist()
    assert results[0][0]["serve:dispatches"][2] == N_REQUESTS


def test_one_segment_shard_map_keeps_the_reference_limit(tmp_path):
    """ROADMAP F6: on one segment the reference's ``shard_map`` limit is
    2^30 (its ``vmap`` special-cases ``t + quantum``), so the passive clock
    advance takes ``time`` there and the job ends in 8 rounds, where
    ``vmap`` runs out of rounds.  The port on a mesh of one (an in-process
    gloo world) equals the JAX package's ``shard_map`` on its one device."""
    import torch.distributed as dist

    from repro import compat
    from repro import snn as jsnn
    from repro.core.controller import Controller as JController
    from repro_torch import snn, tree
    from repro_torch.core.controller import Controller
    from repro_torch.launch import mesh as M
    from torch_parity import assert_tree_equal

    job = jsnn.snn_inference_job((16, 12, 8), t_steps=6, rate=0.6, seed=5)
    descs = jsnn.segmentation_for(2, "uniform", n_segments=1)
    jc = JController(*jsnn.build_snn(job.layers, descs, job.raster)[:3], backend="shard_map",
                     mesh=compat.make_mesh((1,), ("segment",)), quantum=32)
    jc.run(max_rounds=100, check_every=1)
    assert jc.rounds_run == 8 and int(jc.sim_time()[0]) == 2**30

    M.init_world(f"file://{tmp_path / 'rendezvous'}", 0, 1, device="cpu", timeout_s=60)
    try:
        mesh = M.make_mesh((1,), ("segment",), device="cpu")
        assert M.chips(mesh) == 1
        tjob = snn.snn_inference_job((16, 12, 8), t_steps=6, rate=0.6, seed=5)
        built = snn.build_snn(tjob.layers, snn.segmentation_for(2, "uniform", n_segments=1),
                              tjob.raster, device="cpu")
        for fused in (True, False):
            c = Controller(*built[:3], backend="shard_map", mesh=mesh, quantum=32,
                           device="cpu")
            c.run(max_rounds=100, check_every=1, fused=fused)
            assert c.rounds_run == jc.rounds_run
            assert_tree_equal(jc.result_states(), c.result_states())
            assert_tree_equal(jc._pending_stacked(), c._pending_stacked())
            assert snn.output_spike_counts(c.result_states(), built[3]).tolist() == \
                list(job.expected_counts)
        v = Controller(*built[:3], backend="vmap", quantum=32, device="cpu")
        v.run(max_rounds=100, check_every=1)
        assert v.rounds_run == 100 and tree.to_numpy(v.result_states())["time"].tolist() == [3200]
    finally:
        dist.destroy_process_group()
