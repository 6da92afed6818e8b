"""The port's selective scan against the JAX package's: its plain version
(run on the CPU here) against the Pallas ``ssm_scan`` in interpret mode and
against ``repro.kernels.ssm_scan.ref.selective_scan`` with a carried state,
the wrapper's dispatch and refusals, and on a card the CUDA kernel against
the plain version.

Tolerance against JAX: rtol = atol = 1e-5, as tests/test_kernels.py holds
the Pallas kernel to its ref (the plain version sums over N in a fixed
pairwise order, the JAX code in its einsum's).  The CUDA kernel rounds and
sums as the plain version does, so on the card the two are held equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.ssm_scan import ops as jax_ops
from repro.kernels.ssm_scan import ref as jax_ref
from repro_torch.kernels.ssm_scan import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, s, d, n, seed, lo=0.5, hi=0.999):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (b, s, d, n)).astype(np.float32),
            rng.normal(0, 0.2, (b, s, d, n)).astype(np.float32),
            rng.normal(0, 1.0, (b, s, n)).astype(np.float32),
            rng.normal(0, 1.0, (b, d, n)).astype(np.float32))


def _torch(xs, device="cpu"):
    return [torch.from_numpy(x).to(device) for x in xs]


@pytest.mark.parametrize("b,s,d,n", [(1, 64, 128, 8), (2, 128, 128, 16), (1, 192, 256, 16)])
def test_plain_matches_pallas_interpret(b, s, d, n):
    da, dbx, c, _ = _inputs(b, s, d, n, seed=b * s + d + n)
    want = jax_ops.ssm_scan(jnp.asarray(da), jnp.asarray(dbx), jnp.asarray(c))
    got = ops.ssm_scan(*_torch([da, dbx, c]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [1, 17, 64])
@pytest.mark.parametrize("n", [8, 16, 5])
def test_carried_state_matches_jax_ref(s, n):
    b, d = 2, 40
    da, dbx, c, h0 = _inputs(b, s, d, n, seed=s * 100 + n)
    y_want, h_want = jax_ref.selective_scan(*(jnp.asarray(x) for x in (da, dbx, c, h0)))
    y, h = ops.selective_scan(*_torch([da, dbx, c, h0]))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)


def test_chunked_scan_equals_one_scan():
    """Carrying h across chunks (models/ssm.py) is the same scan, bit for bit."""
    da, dbx, c, h0 = _torch(_inputs(2, 48, 24, 8, seed=5))
    y, h = ops.selective_scan(da, dbx, c, h0)
    y1, h1 = ops.selective_scan(da[:, :16].contiguous(), dbx[:, :16].contiguous(),
                                c[:, :16].contiguous(), h0)
    y2, h2 = ops.selective_scan(da[:, 16:].contiguous(), dbx[:, 16:].contiguous(),
                                c[:, 16:].contiguous(), h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_ssm_scan_is_zero_state():
    da, dbx, c, h0 = _torch(_inputs(1, 9, 12, 16, seed=6))
    y, _ = ops.selective_scan(da, dbx, c, torch.zeros_like(h0))
    assert torch.equal(ops.ssm_scan(da, dbx, c), y)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 64), seed=st.integers(0, 2**31 - 1))
def test_pairwise_sum_is_a_sum(n, seed):
    p = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, (3, n)).astype(np.float32))
    np.testing.assert_allclose(ref.pairwise_sum(p).numpy(),
                               p.double().sum(-1).numpy(), rtol=1e-5, atol=1e-5)


def test_slow_decay_matches_jax_ref():
    """da in [0.999, 1): the state barely decays, the worst case for
    accumulated rounding."""
    da, dbx, c, h0 = _inputs(1, 64, 128, 8, seed=7, lo=0.999, hi=1.0)
    y_want, h_want = jax_ref.selective_scan(*(jnp.asarray(x) for x in (da, dbx, c, h0)))
    y, h = ops.selective_scan(*_torch([da, dbx, c, h0]))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)


def test_cpu_wrapper_never_launches():
    before = ops.selective_scan.launches
    da, dbx, c, h0 = _torch(_inputs(1, 4, 8, 8, seed=8))
    ops.selective_scan(da, dbx, c, h0)
    ops.ssm_scan(da, dbx, c)
    assert ops.selective_scan.launches == before


def _bad_cases():
    da, dbx, c, h0 = _torch(_inputs(2, 4, 8, 8, seed=9))
    return {
        "float64": (da.double(), dbx.double(), c.double(), None),
        "c-shape": (da, dbx, c[:, :3], None),
        "dbx-shape": (da, dbx[:, :, :4], c, None),
        "h0-shape": (da, dbx, c, h0[:1]),
        "h0-dtype": (da, dbx, c, h0.double()),
        "three-dims": (da[0], dbx[0], c[0], None),
        "empty-seq": (da[:, :0], dbx[:, :0], c[:, :0], None),
        "empty-d": (da[:, :, :0], dbx[:, :, :0], c, h0[:, :0]),
        "n-over-64": (torch.zeros(1, 2, 3, 65), torch.zeros(1, 2, 3, 65),
                      torch.zeros(1, 2, 65), None),
        "not-contiguous": (da.transpose(2, 1), dbx.transpose(2, 1), c, None),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_bad_inputs_raise(case):
    with pytest.raises(ValueError, match="selective_scan"):
        ops.selective_scan(*_bad_cases()[case])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n", [(4, 256, 8192, 16), (4, 1, 8192, 16),
                                     (2, 64, 256, 16), (1, 17, 136, 8), (1, 5, 33, 5)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_cuda_kernel_matches_plain(b, s, d, n, with_h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    da, dbx, c, h0 = _torch(_inputs(b, s, d, n, seed=b + s + d + n), "cuda")
    h0 = h0 if with_h0 else None
    before = ops.selective_scan.launches
    y, h = ops.selective_scan(da, dbx, c, h0)
    y_want, h_want = ref.selective_scan(da, dbx, c, h0)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + 1
    assert torch.equal(y, y_want) and torch.equal(h, h_want)
