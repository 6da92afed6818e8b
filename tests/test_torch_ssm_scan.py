"""The port's selective scan against the JAX package's: its plain version
(run on the CPU here) against the Pallas ``ssm_scan`` in interpret mode and
against ``repro.kernels.ssm_scan.ref.selective_scan`` with a carried state,
the wrapper's dispatch and refusals, and on a card the CUDA kernel against
the plain version.  The fused scan of a Mamba-1 block (``selective_scan_fused``:
the ``da``/``dbx`` expansion inside the scan) is held against the JAX
package's expansion (``chunk_step`` of ``repro/models/ssm.py``) feeding its
reference scan and the Pallas kernel, and bit for bit against the port's
unfused plain path.

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


def _fused_inputs(b, s, d, n, seed, h0=True, d_skip=True):
    """dt (positive, as after softplus), x, b and c (slices of one
    projection, as in the model), a = -exp(a_log), h0 and d_skip."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.3, (b, s, d)).astype(np.float32)
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    proj = rng.normal(0, 1, (b, s, 3 + 2 * n)).astype(np.float32)
    a = -np.exp(rng.uniform(0, 2, (d, n))).astype(np.float32)
    return (dt, x, proj[..., 3:3 + n], proj[..., 3 + n:], a,
            rng.normal(0, 1, (b, d, n)).astype(np.float32) if h0 else None,
            rng.normal(0, 1, (d,)).astype(np.float32) if d_skip else None)


def _jax_fused(dt, x, b, c, a, h0, d_skip, scan="pallas"):
    """The JAX package's Mamba-1 expansion (``chunk_step``,
    repro/models/ssm.py) feeding the Pallas kernel (h0 = 0) or its
    reference scan, then ``y + x * d_skip``.  ``scan="ref"`` feeds the
    reference scan from a zero state where h0 is None."""
    dt, x, b, c, a = (jnp.asarray(v) for v in (dt, x, b, c, a))
    da = jnp.exp(dt[..., None] * a)
    dbx = (dt * x)[..., None] * b[:, :, None, :]
    if h0 is None and scan == "pallas":
        y, h = jax_ops.ssm_scan(da, dbx, c), None
    else:
        h0 = jnp.zeros(da.shape[:1] + da.shape[2:], jnp.float32) if h0 is None else h0
        y, h = jax_ref.selective_scan(da, dbx, c, jnp.asarray(h0))
    if d_skip is not None:
        y = y + x * jnp.asarray(d_skip)
    return np.asarray(y), None if h is None else np.asarray(h)


def _fused_torch(xs):
    return [None if v is None else torch.from_numpy(np.ascontiguousarray(v)) for v in xs]


_JAX_NUMERICS = ("jax_enable_x64", "jax_default_matmul_precision", "jax_numpy_dtype_promotion",
                 "jax_disable_jit", "jax_platforms")
_WRAPPER = ops.selective_scan


def _scan_state():
    """What in the process could move either side of the comparison: the
    live threads, torch's intra-op thread count and whether a
    ``torch.distributed`` group (a dry run's fake world) is open, the scan
    the wrapper calls and the JAX numerics."""
    import threading

    import jax
    import torch.distributed as dist

    scan = ops.selective_scan
    return dict(threads=sorted(t.name for t in threading.enumerate()),
                torch_threads=torch.get_num_threads(),
                process_group=dist.is_available() and dist.is_initialized(),
                selective_scan=getattr(scan, "__qualname__", repr(scan)),
                selective_scan_is_the_wrapper=scan is _WRAPPER,
                jax_interpret=jax_ops.INTERPRET, jax_devices=len(jax.devices()),
                **{k: getattr(jax.config, k) for k in _JAX_NUMERICS})


def _hold_three(tmp_path, xs, sides):
    """Hold each pair of ``sides`` (name -> y) to TOL.  If one pair fails,
    write the inputs and every output to ``tmp_path`` and name the pairs
    that failed, the first element that differs and the process state, so
    the side that moved can be told apart."""
    names = list(sides)
    bad = []
    for i, p in enumerate(names):
        for q in names[i + 1:]:
            off = ~np.isclose(sides[p], sides[q], **TOL)
            if off.any():
                first = np.unravel_index(np.argmax(off), off.shape)
                bad.append(f"{p} vs {q}: {off.mean():.1%} off, max "
                           f"{np.abs(sides[p] - sides[q]).max():.3g}, first at {first} "
                           f"({sides[p][first]!r} vs {sides[q][first]!r})")
    if bad:
        dump = tmp_path / "scan_mismatch.npz"
        np.savez(dump, **{f"in{i}": v for i, v in enumerate(xs) if v is not None},
                 **{f"y_{k}": v for k, v in sides.items()})
        raise AssertionError("; ".join(bad) + f"; state {_scan_state()}; dumped to {dump}")


@pytest.mark.parametrize("b,s,d,n,h0", [(1, 64, 128, 8, False), (2, 64, 128, 16, False),
                                        (2, 17, 40, 8, True), (2, 1, 40, 16, True),
                                        (1, 33, 24, 5, True), (3, 1, 8, 8, True)])
def test_fused_plain_matches_jax_expansion(b, s, d, n, h0, tmp_path):
    """h0 = 0 against the Pallas kernel in interpret mode and against the
    JAX reference scan from a zero state (and those two against each
    other), a given h0 (and S = 1, a decode step) against the JAX
    reference scan."""
    xs = _fused_inputs(b, s, d, n, seed=b * s + d + n, h0=h0, d_skip=n != 5)
    y_want, h_want = _jax_fused(*xs)
    tx = _fused_torch(xs)
    proj = torch.from_numpy(np.concatenate([xs[2], xs[3]], -1))
    bm, cm = torch.split(proj, [n, n], dim=-1)  # strided views, as the model passes them
    y, h = ops.selective_scan_fused(tx[0], tx[1], bm, cm, *tx[4:])
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, d)
    assert tuple(h.shape) == (b, d, n)
    sides = {"port": y.numpy(), "jax_pallas" if not h0 else "jax_ref": y_want}
    if not h0:
        sides["jax_ref"] = _jax_fused(*xs, scan="ref")[0]
    _hold_three(tmp_path, xs, sides)
    if h_want is not None:
        np.testing.assert_allclose(h.numpy(), h_want, **TOL)


@pytest.mark.parametrize("chunk", [None, 16, 48])
def test_fused_plain_is_the_unfused_plain_path(chunk):
    """The plain fused scan is the port's expansion, chunk by chunk, fed to
    the unfused scan, plus x * d_skip, bit for bit."""
    dt, x, b, c, a, h0, d_skip = _fused_torch(_fused_inputs(2, 48, 24, 16, seed=11))
    y, h = ops.selective_scan_fused(dt, x, b, c, a, h0, d_skip, chunk=chunk)
    step = chunk or 48
    ys, hh = [], h0
    for lo in range(0, 48, step):
        sl = slice(lo, lo + step)
        da = (dt[:, sl][..., None] * a).exp()
        dbx = (dt[:, sl] * x[:, sl])[..., None] * b[:, sl, None, :]
        y_c, hh = ops.selective_scan(da, dbx, c[:, sl].contiguous(), hh)
        ys.append(y_c)
    assert torch.equal(y, torch.cat(ys, 1) + x * d_skip) and torch.equal(h, hh)


def test_fused_cpu_wrapper_never_launches():
    before = (ops.selective_scan.launches, ops.selective_scan_fused.launches)
    ops.selective_scan_fused(*_fused_torch(_fused_inputs(1, 4, 8, 8, seed=12)))
    assert (ops.selective_scan.launches, ops.selective_scan_fused.launches) == before


def _bad_fused():
    dt, x, b, c, a, h0, d_skip = _fused_torch(_fused_inputs(2, 4, 8, 8, seed=13))
    ok = dict(dt=dt, x=x, b=b, c=c, a=a, h0=h0, d_skip=d_skip)
    big = _fused_torch(_fused_inputs(1, 2, 3, 65, seed=14))
    return {
        "dt-float64": dict(ok, dt=dt.double()),
        "dt-two-dims": dict(ok, dt=dt[0]),
        "x-shape": dict(ok, x=x[:, :3]),
        "x-not-contiguous": dict(ok, x=x.transpose(0, 1).contiguous().transpose(0, 1)),
        "b-shape": dict(ok, b=b[..., :4]),
        "c-dtype": dict(ok, c=c.half()),
        "a-shape": dict(ok, a=a[:4]),
        "h0-shape": dict(ok, h0=h0[:1]),
        "d_skip-shape": dict(ok, d_skip=d_skip[:3]),
        "empty-seq": dict(ok, dt=dt[:, :0], x=x[:, :0], b=b[:, :0], c=c[:, :0]),
        "n-over-64": dict(zip(ok, big)),
    }


@pytest.mark.parametrize("case", sorted(_bad_fused()))
def test_fused_bad_inputs_raise(case):
    with pytest.raises(ValueError, match="selective_scan_fused"):
        ops.selective_scan_fused(**_bad_fused()[case])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,h0", [(4, 512, 8192, 16, True), (4, 1, 8192, 16, True),
                                        (2, 64, 256, 16, False), (1, 17, 136, 8, True),
                                        (1, 5, 33, 5, True), (2, 9, 130, 64, True)])
def test_cuda_fused_kernel_matches_plain(b, s, d, n, h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs = [None if v is None else v.cuda()
          for v in _fused_torch(_fused_inputs(b, s, d, n, seed=b + s + d + n, h0=h0))]
    before = ops.selective_scan_fused.launches
    y, h = ops.selective_scan_fused(*xs)
    y_want, h_want = ref.selective_scan_fused(*xs, chunk=256)
    torch.cuda.synchronize()
    assert ops.selective_scan_fused.launches == before + 1
    assert torch.equal(y, y_want) and torch.equal(h, h_want)


# ---------------------------------------------------------------------------
# the backward kernel's buffers, launch arguments and finishing sums


def _bwd_inputs(b, s, d, n, seed, h0=True, dh=True):
    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    proj = f(rng.normal(0, 1, (b, s, 2 + 2 * n)))
    _, bm, cm = torch.split(proj, [2, n, n], dim=-1)
    return (f(rng.uniform(0.05, 0.6, (b, s, d))), f(rng.normal(0, 1, (b, s, d))), bm, cm,
            f(-rng.uniform(0.5, 1.5, (d, n))), f(rng.normal(0, 1, (b, d, n))) if h0 else None,
            f(rng.normal(0, 1, (d,))) if h0 else None, f(rng.normal(0, 1, (b, s, d))),
            f(rng.normal(0, 1, (b, d, n))) if dh else None)


def _kernel_layout(n):
    """``ssm_scan_bwd_layout``'s answer (csrc/ssm_scan.cu): a state saved
    every 32 steps, 256 threads a block over rows of n padded to a power of
    two >= 8 lanes, 4 lanes a thread."""
    lanes = max(8, 1 << (n - 1).bit_length())
    return 32, 256 // (lanes // 4), lanes


# (B, S, D, N): S = 1, S past the strides, D past a block of rows, N whose
# threads' lane groups are partly empty
BWD_SHAPES = [(2, 1, 9, 16), (1, 70, 70, 16), (2, 19, 33, 5), (1, 130, 65, 12),
              (2, 64, 140, 4), (1, 5, 20, 33)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("h0", [True, False])
def test_bwd_buffers_take_the_kernel_layout(shape, h0):
    b, s, d, n = shape
    stride, rows, lanes = _kernel_layout(n)
    buf = ops._bwd_buffers(b, s, d, n, (stride, rows, lanes), h0, "cpu")
    n_blk = -(-d // rows)
    want = {"states": (b, -(-s // stride), d, lanes), "d_dt": (b, s, d), "d_x": (b, s, d),
            "d_b": (b, s, n_blk, n), "d_c": (b, s, n_blk, n), "d_a": (b, d, n),
            "d_h0": (b, d, n) if h0 else None}
    assert {k: None if v is None else tuple(v.shape) for k, v in buf.items()} == want
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in buf.values()
               if v is not None)


@pytest.mark.parametrize("shape,h0,dh", [((2, 19, 33, 5), True, False),
                                         ((1, 70, 70, 16), False, True),
                                         ((1, 9, 8, 12), True, True)])
def test_bwd_arguments_follow_the_launch_signature(shape, h0, dh):
    b, s, d, n = shape
    args = _bwd_inputs(*shape, seed=sum(shape), h0=h0, dh=dh)
    buf = ops._bwd_buffers(b, s, d, n, _kernel_layout(n), h0, "cpu")
    got = ops._bwd_arguments(*args, buf)
    assert len(got) + 1 == len(ops._ARGTYPES["ssm_scan_fused_bwd_launch"])  # + the stream
    dt, x, bm, cm, a, h0_t, dsk, dy, dh_t = args
    assert got[:4] == (dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr())
    assert got[4:8] == (bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1))
    assert got[9:13] == tuple(None if t is None else t.data_ptr() for t in (h0_t, dsk, dy, dh_t))
    assert got[13] == buf["states"].data_ptr() and (got[19] is None) == (not h0)
    vec = n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (a, h0_t, dh_t) if t is not None)
    assert got[20:] == (b, s, d, n, int(vec))


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("h0", [True, False])
def test_bwd_finishing_sums_give_the_gradient(shape, h0):
    """What the kernel leaves in its buffers (per-step gradients, d_b and
    d_c summed over each block's rows, d_a over each batch row's steps),
    made here from the plain backward of each block's rows and batch row,
    and finished by ``_bwd_result``: the plain backward of the whole call."""
    b, s, d, n = shape
    args = _bwd_inputs(*shape, seed=7 + sum(shape), h0=h0)
    dt, x, bm, cm, a, h0_t, dsk, dy, dh = args
    want = ref.selective_scan_fused_bwd(*args)
    _, rows, _ = _kernel_layout(n)
    buf = ops._bwd_buffers(b, s, d, n, _kernel_layout(n), h0, "cpu")
    for blk in range(-(-d // rows)):
        sl = slice(blk * rows, min((blk + 1) * rows, d))
        part = ref.selective_scan_fused_bwd(
            dt[:, :, sl], x[:, :, sl], bm, cm, a[sl], None if h0_t is None else h0_t[:, sl],
            None if dsk is None else dsk[sl], dy[:, :, sl], None if dh is None else dh[:, sl])
        buf["d_dt"][:, :, sl], buf["d_x"][:, :, sl] = part[0], part[1]
        buf["d_b"][:, :, blk], buf["d_c"][:, :, blk] = part[2], part[3]
        if h0:
            buf["d_h0"][:, sl] = part[5]
    for i in range(b):
        one = lambda t: None if t is None else t[i:i + 1]
        buf["d_a"][i] = ref.selective_scan_fused_bwd(*map(one, (dt, x, bm, cm)), a, one(h0_t), dsk,
                                                     one(dy), one(dh))[4]
    got = ops._bwd_result(buf, x, dy, dsk)
    assert [g is None for g in got] == [w is None for w in want]
    for name, g, w in zip(["d_dt", "d_x", "d_b", "d_c", "d_a", "d_h0", "d_skip"], got, want):
        if w is not None:
            # sums over blocks and batch rows in another order than the whole call's
            assert g.shape == w.shape and g.is_contiguous(), name
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), name
