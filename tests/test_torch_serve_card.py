"""The fleet server's results step on a card, where a dispatch's outputs are
its captured graph's own buffers: a result holds its own copy, unchanged by
the next replay of the same graph, and a bucket's results span copies each
state leaf once.  Imports no JAX, so it runs on the card:
``PYTHONPATH=src python -m pytest -q tests/test_torch_serve_card.py``
(the CPU's counterparts are in tests/test_torch_serve.py)."""
import collections

import pytest
import torch

from repro_torch import tree
from repro_torch.core import controller as ctl
from repro_torch.obs import spans
from repro_torch.serve.snn_serve import SnnServer
from repro_torch.snn import workloads as wl

SIZES = (12, 10, 8)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dispatch replays a captured graph")


def _serve(srv, reqs):
    tickets = [srv.submit(r) for r in reqs]
    res = srv.flush()
    return [res[t] for t in tickets]


def _server():
    return SnnServer(quantum=10_000, check_every=4, max_rounds=300, bucket_size=4,
                     device="cuda")


def _graphs():
    return {key: id(entry[1]) for mega in ctl._JOB_FN_CACHE.values()
            for key, entry in mega._disp.items()}


@pytest.mark.cuda
def test_cuda_result_survives_the_next_replay():
    """A first bucket's results stay bit-unchanged while a second bucket of
    other requests replays the same width's graph into the same buffers."""
    _cuda()
    srv = _server()
    first = _serve(srv, wl.serve_fleet(4, SIZES, seed=3, device="cuda"))
    kept = [tree.tree_map(torch.clone, r.states) for r in first]
    graphs = _graphs()
    second = _serve(srv, wl.serve_fleet(4, SIZES, seed=4, device="cuda"))
    assert _graphs() == graphs, "the second bucket replays the first's graph"
    assert all(r.ok for r in first + second)
    for k, res in zip(kept, first):
        for (path, a), (_, b) in zip(tree.leaves(k), tree.leaves(res.states)):
            assert torch.equal(a, b), path
    assert any(not torch.equal(a, b) for res, k in zip(second, kept)
               for (_, a), (_, b) in zip(tree.leaves(k), tree.leaves(res.states)))


@pytest.mark.cuda
def test_cuda_results_span_copies_each_state_leaf_once():
    """Under the profiler a bucket's results span holds at most one clone and
    one copy a state leaf: no per-request copy, and none of pending."""
    _cuda()
    srv = _server()
    reqs = wl.serve_fleet(4, SIZES, seed=5, device="cuda")
    _serve(srv, reqs)  # captures the width's graph
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        got = _serve(srv, reqs)
    ops = collections.Counter()
    for e in prof.events():
        p = e.cpu_parent
        while p is not None and p.name != spans.RESULTS:
            p = p.cpu_parent
        if p is not None:
            ops[e.name] += 1
    leaves = len(tree.leaves(got[0].states))
    assert 0 < ops["aten::clone"] <= leaves and ops["aten::copy_"] <= leaves, ops
    assert srv.result_copies == 2 * leaves
