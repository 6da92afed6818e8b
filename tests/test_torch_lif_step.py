"""The port's fused LIF step against the JAX package's: its plain version
(run on the CPU here) equals ``repro.kernels.lif_step.ref`` and the Pallas
kernel (interpret mode) bit for bit; on a card, the CUDA kernel equals the
plain version.  Inputs are drawn as tests/test_snn.py draws them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_step import ops as jax_ops
from repro.kernels.lif_step import ref as jax_ref
from repro_torch.kernels.lif_step import ops, ref

SHAPES = [((1, 8, 8), 0), ((2, 100, 64), 1), ((3, 256, 256), 2),
          ((4, 130, 17), 3)]


def _inputs(shape, seed, extra):
    u, r, c = shape
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-8, 8, (u, r, c)).astype(np.int8),
          rng.integers(0, 4, (u, c)).astype(np.int32),
          rng.integers(0, 60, (u, r)).astype(np.int32),
          rng.integers(0, 3, (u, r)).astype(np.int32),
          rng.integers(1, 80, (u,)).astype(np.int32),
          rng.integers(0, 6, (u,)).astype(np.int32),
          rng.integers(0, 4, (u,)).astype(np.int32)]
    return xs + [rng.integers(-40, 40, (u, r)).astype(np.int32) if extra else None]


def _saturated_inputs():
    rng = np.random.default_rng(9)
    one = np.ones((2,), np.int32)
    return [rng.integers(-128, 128, (2, 256, 256)).astype(np.int8),
            rng.integers(0, 100_000, (2, 256)).astype(np.int32),
            np.zeros((2, 256), np.int32), np.zeros((2, 256), np.int32),
            one * 50, one, one * 0, None]


def _cases():
    for shape, seed in SHAPES:
        for extra in (False, True):
            yield pytest.param(shape, seed, extra, id=f"{shape}-extra{int(extra)}")
    yield pytest.param(None, None, False, id="saturated-fanin")


def _torch(xs, device="cpu"):
    return [None if x is None else torch.from_numpy(x).to(device) for x in xs]


def _check(got, want):
    for g, w, name in zip(got, want, ("v", "refrac", "fired")):
        w = np.asarray(w)
        g = g.cpu().numpy()
        assert g.dtype == w.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("shape,seed,extra", _cases())
def test_plain_matches_jax_ref_and_pallas(shape, seed, extra):
    xs = _saturated_inputs() if shape is None else _inputs(shape, seed, extra)
    args = [None if x is None else jnp.asarray(x) for x in xs]
    got = ops.lif_step_units(*_torch(xs))  # a CPU tensor runs the plain version
    _check(got, jax_ref.lif_step_units(*args))
    _check(got, jax_ops.lif_step_units(*args))


def test_cpu_wrapper_never_launches():
    before = ops.lif_step_units.launches
    ops.lif_step_units(*_torch(_inputs((1, 8, 8), 0, False)))
    assert ops.lif_step_units.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed,extra", _cases())
def test_cuda_kernel_matches_plain(shape, seed, extra):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    xs = _saturated_inputs() if shape is None else _inputs(shape, seed, extra)
    before = ops.lif_step_units.launches
    got = ops.lif_step_units(*_torch(xs, "cuda"))
    torch.cuda.synchronize()
    assert ops.lif_step_units.launches == before + 1
    _check(got, ref.lif_step_units(*_torch(xs, "cuda")))
