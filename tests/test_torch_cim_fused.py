"""The port's fused quantum-boundary steps against the JAX package's: the
plain versions of the fused tick (``kernels/lif_step/ops.snn_tick``) and the
fused completion (``kernels/crossbar_vmm/ops.finish_ops``), run on the CPU
here, equal ``repro.vp.cim.snn_tick``/``finish_ops`` on every returned leaf,
bit for bit, over numpy-seeded cims states with mixed ``present``, ``fire``
and ``done`` masks, reached tick limits, partial ``rows`` and each fault
input alone and all together; the CPU wrappers never launch; on a card each
fused kernel equals its plain version.  Also ``Controller.close()``: a
closed controller refuses ``run``/``round`` with the reference's message."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jflt
from repro import snn as jsnn
from repro.core.controller import Controller as JController
from repro.vp import cim as jcim
from repro_torch import snn
from repro_torch.core.controller import Controller
from repro_torch.kernels.crossbar_vmm import ops as xbar_ops
from repro_torch.kernels.crossbar_vmm import ref as xbar_ref
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step import ref as lif_ref
from repro_torch.vp import isa

N_SLOTS = 2
SEGMENTS = [1, 2, 4]
HIGH = jflt.FaultConfig(seed=3, p_stuck0=0.3, p_stuck1=0.2, p_bitflip=0.3,
                        p_dead=0.3, p_thresh_drift=0.5)
TICK_FAULTS = ["none", "f_and", "f_xor", "f_dead", "f_dth", "all"]
FINISH_FAULTS = ["none", "f_and", "f_xor", "all"]
# a reference state carries its crossbar masks in pairs: a lone mask's
# partner is neutral there and absent in the port's
NEUTRAL = {"f_and": lambda shape: np.full(shape, -1, np.int8),
           "f_xor": lambda shape: np.zeros(shape, np.int8)}


def _base(s):
    """A zero cims state of the reference's layout, (S, N_SLOTS, ...)."""
    return jax.tree.map(np.array, jax.vmap(lambda _: jcim.cim_state(N_SLOTS))(jnp.arange(s)))


def _faults(cims, seed, given):
    """Adds the fault inputs named by ``given`` ("none", one name, "all"),
    drawn by the reference's ``unit_masks`` at high rates.  Returns the
    port's state and the reference's (its masks paired)."""
    s = cims["present"].shape[0]
    names = {"none": (), "all": ("f_and", "f_xor", "f_dead", "f_dth")}.get(given, (given,))
    per = [jflt.unit_masks(HIGH, seed * 64 + u, 256, 256, 256) for u in range(s * N_SLOTS)]
    port = dict(cims)
    for f in names:
        port[f] = np.stack([m[f] for m in per]).reshape(s, N_SLOTS, *per[0][f].shape)
    ref = dict(port)
    for f, partner in (("f_and", "f_xor"), ("f_xor", "f_and")):
        if f in names and partner not in names:
            ref[partner] = NEUTRAL[partner](port[f].shape)
    return port, ref


def tick_state(s, seed):
    """A spiking cims state and its ``t_gate``: units fire, do not fire
    (absent, dense mode, no period, not due) or have reached their tick
    limit; partial ``rows``; saturating spike counts."""
    rng = np.random.default_rng(seed)
    c, sh = _base(s), (s, N_SLOTS)
    c["present"][:] = rng.random(sh) < 0.85
    c["mode"][:] = np.where(rng.random(sh) < 0.85, isa.CIM_MODE_SPIKE, isa.CIM_MODE_DENSE)
    c["tick_period"][:] = rng.choice([0, 8, 16], sh, p=[0.1, 0.45, 0.45])
    c["next_tick"][:] = rng.integers(0, 64, sh)
    c["tick_limit"][:] = rng.choice([0, 3, 5], sh)
    c["ticks"][:] = rng.integers(0, 6, sh)
    c["rows"][:] = rng.choice([256, 200, 17, 1], sh)
    c["thresh"][:] = rng.integers(1, 80, sh)
    c["leak"][:] = rng.integers(0, 6, sh)
    c["refrac_period"][:] = rng.integers(0, 4, sh)
    c["weights"][:] = rng.integers(-8, 8, c["weights"].shape)
    c["in_buf"][:] = rng.integers(0, 5, c["in_buf"].shape)
    c["in_buf"][..., :4] = rng.integers(-2000, 2000, (s, N_SLOTS, 4))  # past the fan-in clip
    c["v"][:] = rng.integers(0, 60, c["v"].shape)
    c["refrac"][:] = rng.integers(0, 3, c["refrac"].shape)
    c["spike_counts"][:] = rng.integers(0, 100, c["spike_counts"].shape)
    c["spikes_total"][:] = rng.integers(0, 1000, sh)
    t_gate = rng.integers(0, 96, s).astype(np.int32)
    # unit (0, 0) fires; unit (0, 1) would, but has reached its tick limit
    for slot, (ticks, limit) in enumerate(((0, 0), (3, 3))):
        for f, x in (("present", True), ("mode", isa.CIM_MODE_SPIKE), ("tick_period", 8),
                     ("next_tick", 0), ("ticks", ticks), ("tick_limit", limit)):
            c[f][0, slot] = x
    c["rows"][0, 0] = 200
    t_gate[0] = max(t_gate[0], 8)
    return c, t_gate


def finish_state(s, seed):
    """A dense cims state and its ``t_end``: units done, not yet due, absent
    or in another FSM state."""
    rng = np.random.default_rng(seed)
    c, sh = _base(s), (s, N_SLOTS)
    c["present"][:] = rng.random(sh) < 0.8
    c["state"][:] = rng.integers(0, 4, sh)
    c["busy_until"][:] = rng.integers(0, 200, sh)
    c["op_done_at"][:] = rng.integers(-1, 200, sh)
    c["ops"][:] = rng.integers(0, 10, sh)
    c["in_count"][:] = rng.integers(0, 256, sh)
    c["weights"][:] = rng.integers(-128, 128, c["weights"].shape)
    c["in_buf"][:] = rng.integers(-300, 300, c["in_buf"].shape)
    c["out_buf"][:] = rng.integers(-1000, 1000, c["out_buf"].shape)
    t_end = rng.integers(0, 200, s).astype(np.int32)
    # unit (0, 0) is done; unit (0, 1) runs its OP past the quantum's end
    for slot, busy in enumerate((0, int(t_end[0]) + 1)):
        c["present"][0, slot], c["state"][0, slot] = True, isa.CIM_ST_OP
        c["busy_until"][0, slot] = busy
    return c, t_end


def _torch(tree, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in tree.items()}


def _equal(got, want, name):
    got = got.cpu().numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


def _jax_tick(cims, t_gate):
    return jax.vmap(lambda c, t: jcim.snn_tick(c, t, False))(
        jax.tree.map(jnp.asarray, cims), jnp.asarray(t_gate))


def _jax_finish(cims, t_end):
    return jax.vmap(lambda c, t: jcim.finish_ops(c, t, False))(
        jax.tree.map(jnp.asarray, cims), jnp.asarray(t_end))


@pytest.mark.parametrize("given", TICK_FAULTS)
@pytest.mark.parametrize("s", SEGMENTS)
def test_plain_fused_tick_matches_jax(s, given):
    cims, t_gate = tick_state(s, 10 + s)
    port, ref = _faults(cims, s, given)
    inputs = _torch(port)
    kept = {k: v.clone() for k, v in inputs.items()}
    got = lif_ops.snn_tick(inputs, torch.from_numpy(t_gate))
    want = _jax_tick(ref, t_gate)
    assert set(got[0]) == set(port)
    for k in port:
        _equal(got[0][k], want[0][k], k)
    for g, w, name in zip(got[1:], want[1:], ("fired_rows", "fire", "tick_time")):
        _equal(g, w, name)
    fire = got[2].numpy()
    assert fire.any() and not fire.all() and got[1].any()
    assert got[0]["ticks"][0, 1] == got[0]["tick_limit"][0, 1] == 3  # no tick past the limit
    assert not got[1][0, 0, 200:].any()  # rows past ``rows`` emit nothing
    for k, v in kept.items():  # the input state stays valid
        assert torch.equal(inputs[k], v), k


@pytest.mark.parametrize("given", FINISH_FAULTS)
@pytest.mark.parametrize("s", SEGMENTS)
def test_plain_fused_finish_matches_jax(s, given):
    cims, t_end = finish_state(s, 20 + s)
    port, ref = _faults(cims, s, given)
    inputs = _torch(port)
    kept = {k: v.clone() for k, v in inputs.items()}
    got, got_done = xbar_ops.finish_ops(inputs, torch.from_numpy(t_end))
    want, want_done = _jax_finish(ref, t_end)
    _equal(got_done, want_done, "done")
    assert set(got) == set(port)
    for k in port:
        _equal(got[k], want[k], k)
    done = got_done.numpy()
    assert done.any() and not done.all()
    for k, v in kept.items():
        assert torch.equal(inputs[k], v), k


def test_plain_fused_steps_are_the_cim_steps():
    """``vp/cim`` calls the fused wrappers: on the CPU its steps are the
    plain versions, the grouped tick (column groups) included."""
    from repro_torch.vp import cim

    cims, t_gate = tick_state(2, 3)
    got = cim.snn_tick(_torch(cims), torch.from_numpy(t_gate))
    want = lif_ref.snn_tick(_torch(cims), torch.from_numpy(t_gate))
    for k in lif_ref.TICK_OUTPUTS:
        assert torch.equal(got[0][k], want[0][k]), k
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    cims["owner_slot"][:, 1] = 0  # slot 1 of each segment forwards its charge to slot 0
    got = cim.snn_tick(_torch(cims), torch.from_numpy(t_gate), grouped=True)
    want = lif_ref.snn_tick(_torch(cims), torch.from_numpy(t_gate), grouped=True)
    for k in lif_ref.TICK_OUTPUTS:
        assert torch.equal(got[0][k], want[0][k]), k
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    assert not got[0]["v"][:, 1].any()  # contributors hold no membrane state
    cims, t_end = finish_state(2, 3)
    got, done = cim.finish_ops(_torch(cims), torch.from_numpy(t_end))
    want, want_done = xbar_ref.finish_ops(_torch(cims), torch.from_numpy(t_end))
    assert torch.equal(done, want_done)
    assert all(torch.equal(got[k], want[k]) for k in xbar_ref.FINISH_OUTPUTS)


def test_cpu_fused_wrappers_never_launch():
    counters = lambda: (lif_ops.snn_tick.launches, lif_ops.snn_tick.fault_launches,
                        xbar_ops.finish_ops.launches, xbar_ops.finish_ops.fault_launches,
                        lif_ops.lif_step_units.launches,
                        xbar_ops.crossbar_vmm_batch.launches)
    before = counters()
    (tick, t_gate), (finish, t_end) = tick_state(2, 5), finish_state(2, 5)
    for given in ("none", "all"):
        lif_ops.snn_tick(_torch(_faults(tick, 5, given)[0]), torch.from_numpy(t_gate))
        xbar_ops.finish_ops(_torch(_faults(finish, 5, given)[0]), torch.from_numpy(t_end))
    assert counters() == before
    if not torch.cuda.is_available():
        assert before == (0,) * 6


# ---------------------------------------------------------------------------
# F1: close() closes


def _jax_closed_message():
    job = jsnn.snn_inference_job((24, 20, 12), t_steps=6, rate=0.6, seed=5)
    descs = jsnn.segmentation_for(len(job.layers), "uniform", n_segments=2)
    cfg, states, pending, _ = jsnn.build_snn(job.layers, descs, job.raster)
    ctl = JController(cfg, states, pending, backend="vmap", quantum=32)
    ctl.close()
    with pytest.raises(RuntimeError) as err:
        ctl.run(max_rounds=100)
    return str(err.value)


@pytest.mark.parametrize("backend", ["vmap", "sequential"])
def test_close_refuses_run_and_round_with_the_reference_message(backend):
    job = snn.snn_inference_job((24, 20, 12), t_steps=6, rate=0.6, seed=5)
    descs = snn.segmentation_for(len(job.layers), "uniform", n_segments=2)
    cfg, states, pending, meta = snn.build_snn(job.layers, descs, job.raster, device="cpu")
    ctl = Controller(cfg, states, pending, backend=backend, quantum=32, device="cpu")
    ctl.run(max_rounds=100, check_every=2)
    rounds = ctl.rounds_run
    counts = snn.output_spike_counts(ctl.result_states(), meta)
    ctl.close()
    ctl.close()  # idempotent
    want = _jax_closed_message()
    for call in (lambda: ctl.run(max_rounds=100), ctl.round):
        with pytest.raises(RuntimeError) as err:
            call()
        assert str(err.value) == want
    # results stay readable, and nothing ran after close()
    assert ctl.rounds_run == rounds
    np.testing.assert_array_equal(snn.output_spike_counts(ctl.result_states(), meta), counts)
    np.testing.assert_array_equal(counts, job.expected_counts)
    assert ctl.done() and ctl.sim_time().shape == (2,)


# ---------------------------------------------------------------------------
# on a card: the fused kernels against their plain versions


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("given", TICK_FAULTS)
@pytest.mark.parametrize("s", SEGMENTS)
def test_cuda_fused_tick_matches_plain(s, given):
    _cuda()
    cims, t_gate = tick_state(s, 10 + s)
    port, _ = _faults(cims, s, given)
    inputs, t_gate = _torch(port, "cuda"), torch.from_numpy(t_gate).cuda()
    kept = {k: v.clone() for k, v in inputs.items()}
    before = (lif_ops.snn_tick.launches, lif_ops.snn_tick.fault_launches)
    got = lif_ops.snn_tick(inputs, t_gate)
    torch.cuda.synchronize()
    assert (lif_ops.snn_tick.launches, lif_ops.snn_tick.fault_launches) == (
        before[0] + 1, before[1] + int(given != "none"))
    want = lif_ref.snn_tick(inputs, t_gate)
    for k in port:
        assert torch.equal(got[0][k], want[0][k]), k
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    assert all(torch.equal(inputs[k], v) for k, v in kept.items())


@pytest.mark.cuda
@pytest.mark.parametrize("given", FINISH_FAULTS)
@pytest.mark.parametrize("s", SEGMENTS)
def test_cuda_fused_finish_matches_plain(s, given):
    _cuda()
    cims, t_end = finish_state(s, 20 + s)
    port, _ = _faults(cims, s, given)
    inputs, t_end = _torch(port, "cuda"), torch.from_numpy(t_end).cuda()
    kept = {k: v.clone() for k, v in inputs.items()}
    before = (xbar_ops.finish_ops.launches, xbar_ops.finish_ops.fault_launches)
    got, done = xbar_ops.finish_ops(inputs, t_end)
    torch.cuda.synchronize()
    assert (xbar_ops.finish_ops.launches, xbar_ops.finish_ops.fault_launches) == (
        before[0] + 1, before[1] + int(given != "none"))
    want, want_done = xbar_ref.finish_ops(inputs, t_end)
    assert torch.equal(done, want_done)
    assert all(torch.equal(got[k], want[k]) for k in port)
    assert all(torch.equal(inputs[k], v) for k, v in kept.items())
