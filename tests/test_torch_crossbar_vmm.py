"""The port's crossbar VMM against the JAX package's: its plain version (run
on the CPU here) equals ``repro.kernels.crossbar_vmm.ref`` and the Pallas
kernel (interpret mode) bit for bit over the sweep of tests/test_kernels.py,
the CIM completion ``finish_ops`` equals the reference's, and on a card the
CUDA kernel equals the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.crossbar_vmm import ops as jax_ops
from repro.kernels.crossbar_vmm import ref as jax_ref
from repro.vp import cim as jcim
from repro_torch.kernels.crossbar_vmm import ops, ref
from repro_torch.vp import cim

# (U, R, C) x (in_res, out_res): the main path's unit counts and the
# ragged, narrow and saturating corners
SHAPES = [(4, 256, 256), (2, 224, 224), (3, 130, 17), (1, 8, 8)]
RES = [(8, 8), (4, 3), (1, 1), (8, 2)]


def _inputs(shape, seed, span=1 << 12):
    u, r, c = shape
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (u, r, c)).astype(np.int8),
            rng.integers(-span, span, (u, c)).astype(np.int32))


@settings(max_examples=12, deadline=None)
@given(
    r=st.integers(1, 300),
    c=st.integers(1, 300),
    in_res=st.sampled_from([2, 4, 8]),
    out_res=st.sampled_from([4, 8]),
    seed=st.integers(0, 2**31 - 1),
)
def test_plain_matches_jax_ref_and_pallas(r, c, in_res, out_res, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, (r, c)).astype(np.int8)
    x = rng.integers(-(1 << 12), 1 << 12, (c,)).astype(np.int32)  # exercises the DAC clamp
    got = ops.crossbar_vmm(torch.from_numpy(w), torch.from_numpy(x), in_res, out_res)
    assert got.dtype == torch.int32
    want = jax_ref.crossbar_vmm(jnp.asarray(w), jnp.asarray(x), in_res, out_res)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_ops.crossbar_vmm(jnp.asarray(w), jnp.asarray(x), in_res, out_res)))


@pytest.mark.parametrize("res", RES, ids=lambda r: f"in{r[0]}-out{r[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batch_matches_jax(shape, res):
    w, x = _inputs(shape, sum(shape))
    got = ops.crossbar_vmm_batch(torch.from_numpy(w), torch.from_numpy(x), *res)
    want = jax_ref.crossbar_vmm_batch(jnp.asarray(w), jnp.asarray(x), *res)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_equals_exact_int_math_and_saturates():
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (256, 256)).astype(np.int8)
    x = rng.integers(-100, 100, (256,)).astype(np.int32)
    got = ref.crossbar_vmm(torch.from_numpy(w), torch.from_numpy(x), 8, 8).numpy()
    exact = np.clip(w.astype(np.int64) @ np.clip(x, -128, 127), -(1 << 15), (1 << 15) - 1)
    np.testing.assert_array_equal(got, exact)
    full = ref.crossbar_vmm(torch.full((4, 256), 127, dtype=torch.int8),
                            torch.full((256,), 127, dtype=torch.int32), 8, 8)
    assert (full == (1 << 15) - 1).all()


def test_matmul_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.integers(-16, 16, (100, 70)).astype(np.int8)
    x = rng.integers(-50, 50, (70, 9)).astype(np.int32)
    got = ops.crossbar_matmul(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_ops.crossbar_matmul(jnp.asarray(w), jnp.asarray(x))))


def test_finish_ops_matches_jax():
    """Quantum-boundary completion over (S, n) units: only units whose OP is
    due land, on the reference's kernel and plain paths alike."""
    s, n = 3, 2
    rng = np.random.default_rng(7)
    cims = jax.tree.map(np.array, jax.vmap(lambda _: jcim.cim_state(n))(jnp.arange(s)))
    cims["present"][:] = rng.random((s, n)) < 0.8
    cims["state"][:] = rng.integers(0, 4, (s, n))
    cims["busy_until"][:] = rng.integers(0, 200, (s, n))
    cims["weights"][:] = rng.integers(-128, 128, cims["weights"].shape)
    cims["in_buf"][:] = rng.integers(-300, 300, cims["in_buf"].shape)
    cims["in_count"][:] = rng.integers(0, 256, (s, n))
    cims["present"][0, 0], cims["state"][0, 0], cims["busy_until"][0, 0] = True, 2, 0
    t_end = rng.integers(0, 200, s).astype(np.int32)
    tcims = {k: torch.from_numpy(np.array(v)) for k, v in cims.items()}
    got, got_done = cim.finish_ops(tcims, torch.from_numpy(t_end))
    for use_kernel in (False, True):
        want, want_done = jax.vmap(lambda c, t: jcim.finish_ops(c, t, use_kernel))(
            jax.tree.map(jnp.asarray, cims), jnp.asarray(t_end))
        np.testing.assert_array_equal(got_done.numpy(), np.asarray(want_done))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got_done.any() and not got_done.all()


@pytest.mark.parametrize("reg", ["config", "mode", "input", "start"])
def test_register_writes_match_jax(reg):
    """One CIM register write to the units ``pred`` selects, every unit of
    every segment at once, equals the reference's write applied to each
    selected unit in turn."""
    s, n = 3, 2
    rng = np.random.default_rng(11)
    cims = jax.tree.map(np.array, jax.vmap(lambda _: jcim.cim_state(n))(jnp.arange(s)))
    for f, hi in (("rows", 257), ("cols", 257), ("in_res", 9), ("out_res", 9),
                  ("in_count", 300)):
        cims[f][:] = rng.integers(1, hi, (s, n))
    pred = rng.random((s, n)) < 0.6
    value = rng.integers(-2**31, 2**31, (s, n), dtype=np.int64).astype(np.int32)
    if reg == "start":
        value = rng.integers(0, 1 << 20, (s, n)).astype(np.int32)
    jfn = {"config": lambda c, u, v: jcim.apply_config(c, u, v, 0),
           "mode": jcim.apply_mode, "input": jcim.apply_input,
           "start": jcim.apply_start}[reg]
    want = jax.tree.map(np.array, cims)
    for i, u in zip(*np.nonzero(pred)):
        new = jfn(jax.tree.map(lambda x: jnp.asarray(x[i]), want), int(u), value[i, u])
        for k in new:
            want[k][i] = np.asarray(new[k])
    got = getattr(cim, f"apply_{reg}")({k: torch.from_numpy(np.array(v)) for k, v in cims.items()},
                                       torch.from_numpy(pred), torch.from_numpy(value))
    assert pred.any() and not pred.all()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_cim_plain_vmm_matches_jax():
    w, x = _inputs((3, 200, 120), 5, span=1 << 10)
    for in_res, out_res in RES:
        got = cim.crossbar_vmm_ref(torch.from_numpy(w), torch.from_numpy(x), in_res, out_res)
        for u in range(3):
            np.testing.assert_array_equal(got[u].numpy(), np.asarray(jcim.crossbar_vmm_ref(
                jnp.asarray(w[u]), jnp.asarray(x[u]), in_res, out_res)))


def test_cpu_wrapper_never_launches_and_faults_are_out_of_the_slice():
    """The name is kept from the slice before fault masks were ported: the
    CPU wrapper now takes masks and equals the plain version over
    ``(w & f_and) ^ f_xor``, still without a launch."""
    w, x = _inputs((1, 8, 8), 0)
    rng = np.random.default_rng(1)
    f_and, f_xor = (torch.from_numpy(rng.integers(-128, 128, w.shape).astype(np.int8))
                    for _ in range(2))
    before = ops.crossbar_vmm_batch.launches
    ops.crossbar_vmm_batch(torch.from_numpy(w), torch.from_numpy(x))
    got = ops.crossbar_vmm_batch(torch.from_numpy(w), torch.from_numpy(x), 8, 8,
                                 f_and, f_xor)
    assert ops.crossbar_vmm_batch.launches == before
    masked = (torch.from_numpy(w) & f_and) ^ f_xor
    assert torch.equal(got, ref.crossbar_vmm_batch(masked, torch.from_numpy(x), 8, 8))
    assert not torch.equal(got, ref.crossbar_vmm_batch(torch.from_numpy(w),
                                                       torch.from_numpy(x), 8, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("res", RES, ids=lambda r: f"in{r[0]}-out{r[1]}")
@pytest.mark.parametrize("shape", SHAPES + [(8, 256, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain(shape, res):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    w, x = (torch.from_numpy(a).cuda() for a in _inputs(shape, 3, span=1 << 16))
    before = ops.crossbar_vmm_batch.launches
    got = ops.crossbar_vmm_batch(w, x, *res)
    torch.cuda.synchronize()
    assert ops.crossbar_vmm_batch.launches == before + 1
    assert torch.equal(got, ref.crossbar_vmm_batch(w, x, *res))
