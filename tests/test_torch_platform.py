"""The port's CPU-free segment step and termination flags against
repro.vp.platform, started from JAX-built states carried across with
``tree.from_numpy``: one step from several points of a run, compared leaf
by leaf (states, outbox and pending), bit for bit."""
import jax
import numpy as np
import pytest

from repro import snn as jsnn
from repro.core.controller import Controller as JController
from repro.vp import platform as jpf
from repro_torch.vp import platform as pf
from torch_parity import assert_tree_equal, carry_across

QUANTUM = 32
ROUNDS = (0, 2, 5, 9, 40)  # 40: past termination (every flag settled)


@pytest.fixture(scope="module")
def snapshots():
    """(cfg, [(rounds, states, pending, t_limit)]) from one JAX run."""
    job = jsnn.snn_inference_job((24, 20, 12), t_steps=6, rate=0.6, seed=5)
    descs = jsnn.segmentation_for(len(job.layers), "uniform", n_segments=2)
    cfg, states, pending, _ = jsnn.build_snn(job.layers, descs, job.raster,
                                              in_cap=256, out_cap=128)
    ctl = JController(cfg, states, pending, backend="vmap", quantum=QUANTUM)
    out = []
    for r in range(max(ROUNDS) + 1):
        if r in ROUNDS:
            st, pen = jax.tree.map(np.asarray, (ctl.states, ctl.pending))
            lim = np.asarray(ctl._limits(ctl.states["time"]))
            out.append((r, st, pen, lim))
        ctl.round()
    assert not cfg.has_cpu and cfg.has_snn
    return cfg, out


@pytest.mark.parametrize("k", range(len(ROUNDS)), ids=[f"round{r}" for r in ROUNDS])
def test_one_step_matches_jax(snapshots, k):
    cfg, snaps = snapshots
    _, st, pen, lim = snaps[k]
    want = jax.jit(jax.vmap(jpf.make_segment_step(cfg, QUANTUM)))(st, pen, lim)
    tst, tpen, tlim = carry_across((st, pen, lim))
    got = pf.make_segment_step(cfg, QUANTUM)(tst, tpen, tlim)
    for name, w, g in zip(("states", "outbox", "pending"), want, got):
        assert_tree_equal(w, g, name)


@pytest.mark.parametrize("k", range(len(ROUNDS)), ids=[f"round{r}" for r in ROUNDS])
def test_termination_flags_match_jax(snapshots, k):
    cfg, snaps = snapshots
    _, st, pen, _ = snaps[k]
    caps = [(cfg.in_cap, cfg.out_cap, cfg.store_log), (1, 1, 0)]  # clean, tripped
    for in_cap, out_cap, store_log in caps:
        want = [bool(x) for x in jpf.termination_flags(st, pen, in_cap, out_cap, store_log)]
        tst, tpen = carry_across((st, pen))
        got = [bool(x) for x in pf.termination_flags(tst, tpen, in_cap, out_cap, store_log)]
        assert got == want


def test_segment_state_matches_jax(snapshots):
    cfg, _ = snapshots
    assert_tree_equal(jpf.segment_state(cfg), pf.segment_state(cfg), "segment_state")
