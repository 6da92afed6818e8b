"""The fault variants of the port's two kernels against the JAX package's:
the plain fault LIF step and the plain masked crossbar VMM (run on the CPU
here) equal ``repro.kernels.*.ref`` and the Pallas fault kernels (interpret
mode) bit for bit; neutral masks equal the clean functions; on a card, each
CUDA fault kernel equals its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jflt
from repro.kernels.crossbar_vmm import kernel as jax_xbar_kernel
from repro.kernels.crossbar_vmm import ref as jax_xbar_ref
from repro.kernels.lif_step import kernel as jax_lif_kernel
from repro.kernels.lif_step import ref as jax_lif_ref
from repro_torch.kernels.crossbar_vmm import ops as xbar_ops
from repro_torch.kernels.crossbar_vmm import ref as xbar_ref
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step import ref as lif_ref

HIGH = jflt.FaultConfig(seed=3, p_stuck0=0.3, p_stuck1=0.2, p_bitflip=0.3,
                        p_dead=0.3, p_thresh_drift=0.5)
LIF_SHAPES = [((1, 8, 8), 0), ((2, 100, 64), 1), ((3, 256, 256), 2), ((4, 130, 17), 3)]
XBAR_SHAPES = [(4, 256, 256), (2, 224, 224), (3, 130, 17), (1, 8, 8)]
RES = [(8, 8), (4, 3), (1, 1), (8, 2)]
FAULT_INPUTS = ("f_and", "f_xor", "dead", "dth")


def _masks(shape, seed):
    """Per-unit fault inputs drawn by the reference's ``unit_masks`` at high
    rates, cut to the shape: f_and/f_xor (U, R, C), dead/dth (U, R)."""
    u, r, c = shape
    per = [jflt.unit_masks(HIGH, seed * 16 + k, r, c, max(r, c)) for k in range(u)]
    cut = lambda f, *sl: np.stack([m[f][sl] for m in per])
    return {"f_and": cut("f_and", slice(r), slice(c)),
            "f_xor": cut("f_xor", slice(r), slice(c)),
            "dead": cut("f_dead", slice(r)), "dth": cut("f_dth", slice(r))}


def _lif_inputs(shape, seed, extra):
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


def _torch(x, device="cpu"):
    return None if x is None else torch.from_numpy(x).to(device)


def _lif_cases():
    for shape, seed in LIF_SHAPES:
        for extra in (False, True):
            yield pytest.param(shape, seed, extra, id=f"{shape}-extra{int(extra)}")


def _check(got, want):
    for g, w, name in zip(got, want, ("v", "refrac", "fired")):
        w = np.asarray(w)
        g = g.cpu().numpy()
        assert g.dtype == w.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("shape,seed,extra", _lif_cases())
def test_plain_fault_lif_matches_jax_ref_and_pallas(shape, seed, extra):
    xs, m = _lif_inputs(shape, seed, extra), _masks(shape, seed)
    got = lif_ops.lif_step_units(*map(_torch, xs), **{k: _torch(v) for k, v in m.items()})
    jx = [None if x is None else jnp.asarray(x) for x in xs]
    jm = {k: jnp.asarray(v) for k, v in m.items()}
    _check(got, jax_lif_ref.lif_step_units(*jx, **jm))
    _check(got, jax_lif_kernel.lif_step_tiles(*jx, **jm, interpret=True))
    assert m["dead"].any() and (m["dth"] != 0).any() and (m["f_and"] == 0).any()


@pytest.mark.parametrize("alone", FAULT_INPUTS)
def test_plain_fault_lif_each_input_alone_matches_pallas(alone):
    """One fault input given, the others absent: the Pallas wrapper puts
    neutral values in their place, the port leaves them out."""
    shape = (2, 100, 64)
    xs, m = _lif_inputs(shape, 5, True), _masks(shape, 5)
    got = lif_ops.lif_step_units(*map(_torch, xs), **{alone: _torch(m[alone])})
    jx = [jnp.asarray(x) for x in xs]
    if alone == "f_and":  # the reference's masks come in pairs
        pair = {"f_and": jnp.asarray(m["f_and"]), "f_xor": jnp.zeros(shape, jnp.int8)}
    elif alone == "f_xor":
        pair = {"f_and": jnp.full(shape, -1, jnp.int8), "f_xor": jnp.asarray(m["f_xor"])}
    else:
        pair = {alone: jnp.asarray(m[alone])}
    _check(got, jax_lif_kernel.lif_step_tiles(*jx, **pair, interpret=True))


@pytest.mark.parametrize("shape,seed,extra", _lif_cases())
def test_neutral_fault_inputs_equal_the_clean_lif(shape, seed, extra):
    u, r, c = shape
    xs = list(map(_torch, _lif_inputs(shape, seed, extra)))
    neutral = {"f_and": torch.full((u, r, c), -1, dtype=torch.int8),
               "f_xor": torch.zeros((u, r, c), dtype=torch.int8),
               "dead": torch.zeros((u, r), dtype=torch.bool),
               "dth": torch.zeros((u, r), dtype=torch.int32)}
    _check(lif_ref.lif_step_units(*xs, **neutral), lif_ref.lif_step_units(*xs))


def _xbar_inputs(shape, seed, span=1 << 12):
    u, r, c = shape
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (u, r, c)).astype(np.int8),
            rng.integers(-span, span, (u, c)).astype(np.int32))


@pytest.mark.parametrize("res", RES, ids=lambda r: f"in{r[0]}-out{r[1]}")
@pytest.mark.parametrize("shape", XBAR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_masked_vmm_matches_jax_ref_and_pallas(shape, res):
    w, x = _xbar_inputs(shape, 11)
    m = _masks(shape, 11)
    got = xbar_ops.crossbar_vmm_batch(_torch(w), _torch(x), *res,
                                      _torch(m["f_and"]), _torch(m["f_xor"]))
    want = jax_xbar_ref.crossbar_vmm_batch(jnp.asarray(w), jnp.asarray(x), *res,
                                           jnp.asarray(m["f_and"]), jnp.asarray(m["f_xor"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in range(shape[0]):  # the Pallas fault kernel, one crossbar per call
        pallas = jax_xbar_kernel.crossbar_vmm_tiles(
            jnp.asarray(x[k:k + 1]), jnp.asarray(w[k]), *res,
            jnp.asarray(m["f_and"][k]), jnp.asarray(m["f_xor"][k]), interpret=True)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(pallas)[0])


@pytest.mark.parametrize("shape", XBAR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_neutral_masks_equal_the_clean_vmm(shape):
    w, x = map(_torch, _xbar_inputs(shape, 12))
    neutral = (torch.full(w.shape, -1, dtype=torch.int8), torch.zeros_like(w))
    for res in RES:
        assert torch.equal(xbar_ref.crossbar_vmm_batch(w, x, *res, *neutral),
                           xbar_ref.crossbar_vmm_batch(w, x, *res))


def test_cpu_wrappers_never_launch_with_masks():
    shape = (2, 16, 16)
    xs, m = _lif_inputs(shape, 1, False), _masks(shape, 1)
    w, x = _xbar_inputs(shape, 1)
    before = (lif_ops.lif_step_units.launches, lif_ops.lif_step_units.fault_launches,
              xbar_ops.crossbar_vmm_batch.launches, xbar_ops.crossbar_vmm_batch.fault_launches)
    lif_ops.lif_step_units(*map(_torch, xs), **{k: _torch(v) for k, v in m.items()})
    xbar_ops.crossbar_vmm_batch(_torch(w), _torch(x), 8, 8, _torch(m["f_and"]),
                                _torch(m["f_xor"]))
    assert before == (lif_ops.lif_step_units.launches, lif_ops.lif_step_units.fault_launches,
                      xbar_ops.crossbar_vmm_batch.launches,
                      xbar_ops.crossbar_vmm_batch.fault_launches)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["all", *FAULT_INPUTS])
@pytest.mark.parametrize("shape,seed,extra", _lif_cases())
def test_cuda_fault_lif_matches_plain(shape, seed, extra, given):
    _cuda()
    xs = [_torch(v, "cuda") for v in _lif_inputs(shape, seed, extra)]
    m = {k: _torch(v, "cuda") for k, v in _masks(shape, seed).items()
         if given in ("all", k)}
    before = lif_ops.lif_step_units.fault_launches
    got = lif_ops.lif_step_units(*xs, **m)
    torch.cuda.synchronize()
    assert lif_ops.lif_step_units.fault_launches == before + 1
    _check(got, lif_ref.lif_step_units(*xs, **m))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed,extra", _lif_cases())
def test_cuda_fault_lif_neutral_equals_clean_kernel(shape, seed, extra):
    _cuda()
    u, r, c = shape
    xs = [_torch(v, "cuda") for v in _lif_inputs(shape, seed, extra)]
    neutral = {"f_and": torch.full((u, r, c), -1, dtype=torch.int8, device="cuda"),
               "f_xor": torch.zeros((u, r, c), dtype=torch.int8, device="cuda"),
               "dead": torch.zeros((u, r), dtype=torch.bool, device="cuda"),
               "dth": torch.zeros((u, r), dtype=torch.int32, device="cuda")}
    _check(lif_ops.lif_step_units(*xs, **neutral), lif_ops.lif_step_units(*xs))


@pytest.mark.cuda
@pytest.mark.parametrize("res", RES, ids=lambda r: f"in{r[0]}-out{r[1]}")
@pytest.mark.parametrize("shape", XBAR_SHAPES + [(8, 256, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_masked_vmm_matches_plain(shape, res):
    _cuda()
    w, x = (_torch(a, "cuda") for a in _xbar_inputs(shape, 13, span=1 << 16))
    m = _masks(shape, 13)
    fa, fx = _torch(m["f_and"], "cuda"), _torch(m["f_xor"], "cuda")
    before = xbar_ops.crossbar_vmm_batch.fault_launches
    got = xbar_ops.crossbar_vmm_batch(w, x, *res, fa, fx)
    torch.cuda.synchronize()
    assert xbar_ops.crossbar_vmm_batch.fault_launches == before + 1
    assert torch.equal(got, xbar_ref.crossbar_vmm_batch(w, x, *res, fa, fx))
    neutral = (torch.full_like(w, -1), torch.zeros_like(w))
    assert torch.equal(xbar_ops.crossbar_vmm_batch(w, x, *res, *neutral),
                       xbar_ops.crossbar_vmm_batch(w, x, *res))


def test_cim_plain_vmm_alias_takes_masks_as_jax():
    from repro.vp import cim as jcim
    from repro_torch.vp import cim

    w, x = _xbar_inputs((1, 200, 120), 14)
    m = _masks((1, 200, 120), 14)
    got = cim.crossbar_vmm_ref(_torch(w[0]), _torch(x[0]), 8, 8,
                               _torch(m["f_and"][0]), _torch(m["f_xor"][0]))
    want = jcim.crossbar_vmm_ref(jnp.asarray(w[0]), jnp.asarray(x[0]), 8, 8,
                                 jnp.asarray(m["f_and"][0]), jnp.asarray(m["f_xor"][0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
