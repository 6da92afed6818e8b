"""The port's training forward and gradients against the JAX package's, on
the smoke configurations with the same weights (``common.init_numpy``) and
inputs (numpy) fed to both: ``cross_entropy``; ``flash_attention_train``
(the custom VJP) against JAX's and against dense attention; the Mamba-1
scan's gradient (``SelectiveScanFused``: the plain reverse recurrence
against autograd through the plain forward, ``gradcheck`` in float64, and
``jax.grad`` through the JAX package's ``_mamba1_core``); ``Model.loss``
and every parameter's gradient for all ten architectures against
``jax.grad`` of the JAX package's ``model.loss``; remat changing no
value; bf16 parameters (kimi-k2's) getting bf16 gradients.

Tolerances (measured with one torch thread, torch 2.13 and jax 0.9 on a
CPU).  ``cross_entropy`` is float32 on both sides: 8.8e-8 relative (held
at 1e-6), its gradient 5.2e-8 absolute (held at atol 1e-7 / rtol 1e-5).
Flash attention in float32 against JAX's: output 3.6e-7 (held at atol
2e-5), gradients 2.0e-7 relative to their largest entry (held at 1e-5);
against dense attention as tests/test_perf_paths.py holds JAX's (atol
2e-5; gradients 4.7e-7, held at 1e-4).  The scan's plain backward equals
autograd through the plain forward exactly (held at rtol 1e-6 / atol
1e-7).  Against ``jax.grad`` of ``_mamba1_core`` (bf16 x-projection,
float32 scan): the loss within 5.1e-6 relative (held at 1e-5), every
gradient within 4.5e-7 of its largest entry (held at 1e-5).
``Model.loss``: loss and ce within 1.4e-6 relative of JAX's jitted loss,
aux 1.9e-9 (held at rtol 1e-5, aux at atol 1e-6); each parameter's
gradient within 2.2% of its largest entry (the bf16 GEMMs' backward,
rounded at other places than XLA's fusions), held at 5%, and its
direction (cosine similarity) at least 0.99987, held at 0.999."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.common import DTypePolicy as JaxPolicy
from repro.models import layers as jL
from repro.models import ssm as jssm
from repro.models.model import build as jax_build
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.common import DTypePolicy, init_numpy
from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.model import build, params_from_numpy
from torch_parity import jax_params, lm_batches, single_torch_thread

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

B, S = 2, 32


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# cross-entropy and flash attention


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    lg = rng.normal(0, 3, (2, 7, 50)).astype(np.float32)
    tgt = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    lt = torch.from_numpy(lg).requires_grad_(True)
    got = L.cross_entropy(lt, torch.from_numpy(tgt), None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(got, lt)
    jm = None if mask is None else jnp.asarray(mask)
    want, jg = jax.value_and_grad(lambda x: jL.cross_entropy(x, jnp.asarray(tgt), jm))(
        jnp.asarray(lg))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


def test_flash_train_matches_jax_and_dense():
    """(2, 512, 2, 32) in chunks of 128, as tests/test_perf_paths.py:11."""
    q, k, v = _qkv((2, 512, 2, 32), 0)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))

    def port(fn):
        o = fn(tq, tk, tv)
        return o, torch.autograd.grad((o * (tq + 1)).sum(), (tq, tk, tv))

    o_f, g_f = port(lambda q, k, v: L.flash_attention_train(q, k, v, 128, 128))
    o_d, g_d = port(lambda q, k, v: L.dense_attention(q, k, v, causal=True))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo = jL.flash_attention_train(jq, jk, jv, 128, 128)
    jg = jax.grad(lambda q, k, v: (jL.flash_attention_train(q, k, v, 128, 128) * (q + 1)).sum(),
                  argnums=(0, 1, 2))(jq, jk, jv)
    assert o_f.dtype == torch.float32 and tuple(o_f.shape) == (2, 512, 2, 32)
    np.testing.assert_allclose(_np(o_f), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(_np(o_f), _np(o_d), atol=2e-5)
    for name, a, jx, d in zip("qkv", g_f, jg, g_d):
        assert _rel(a, jx) < 1e-5, (name, _rel(a, jx))
        assert _rel(a, d) < 1e-4, (name, _rel(a, d))


def test_flash_in_model_matches_dense_in_model():
    """qwen3-1.7b-smoke's loss with ``attn_impl="flash"`` (S = 512) against
    dense, and against the JAX package's flash loss (tests/test_perf_paths.py:37)."""
    cfg = configs.get_smoke_config("qwen3-1.7b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 512)).astype(np.int32)
    weights = init_numpy(build(cfg).specs, seed=0)
    losses = {}
    for impl in ("dense", "flash"):
        model = build(dataclasses.replace(cfg, attn_impl=impl))
        losses[impl] = float(model.loss(params_from_numpy(model.specs, weights, "cpu"),
                                        {"tokens": torch.from_numpy(toks)})[0])
    jm = jax_build(dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"), attn_impl="flash"),
                   tp=1)
    jloss = float(jax.jit(jm.loss)(jax_params(weights), {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(losses["dense"], losses["flash"], rtol=2e-3)
    np.testing.assert_allclose(losses["flash"], jloss, rtol=1e-5)


# ---------------------------------------------------------------------------
# the Mamba-1 scan's gradient


def _scan_inputs(b, s, d, n, seed, h0=True, dtype=np.float32):
    rng = np.random.default_rng(seed)
    proj = rng.normal(0, 1, (b, s, 3 + 2 * n))
    out = [rng.uniform(0.05, 0.6, (b, s, d)), rng.normal(0, 1, (b, s, d)),
           proj[..., 3:3 + n], proj[..., 3 + n:], -rng.uniform(0.5, 1.5, (d, n)),
           rng.normal(0, 1, (b, d, n)) if h0 else None,
           rng.normal(0, 1, (d,)) if h0 else None]
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x).astype(dtype))
            for x in out]


@pytest.mark.parametrize("shape,chunk,h0,dh", [((1, 5, 7, 4), None, False, False),
                                               ((2, 37, 20, 16), 8, True, True),
                                               ((1, 16, 9, 5), 16, True, False),
                                               ((2, 9, 6, 8), 4, False, True),
                                               ((2, 1, 9, 16), None, True, True),  # S = 1
                                               # S a tile past two of the kernel's 32-step strides
                                               ((1, 72, 6, 12), 32, True, True)])
def test_plain_backward_matches_autograd(shape, chunk, h0, dh):
    args = _scan_inputs(*shape, seed=sum(shape), h0=h0)
    rng = np.random.default_rng(1)
    dy = torch.from_numpy(rng.normal(0, 1, shape[:3]).astype(np.float32))
    dh_last = (torch.from_numpy(rng.normal(0, 1, (shape[0], shape[2], shape[3]))
                                .astype(np.float32)) if dh else None)
    got = ref.selective_scan_fused_bwd(*args, dy, dh_last, chunk)
    ins = [None if x is None else x.clone().requires_grad_(True) for x in args]
    y, h_last = ref.selective_scan_fused(*ins, chunk=chunk)
    loss = (y * dy).sum() + (0 if dh_last is None else (h_last * dh_last).sum())
    want = torch.autograd.grad(loss, [x for x in ins if x is not None])
    assert [g is None for g in got] == [x is None for x in ins]
    for name, g, w in zip(["dt", "x", "b", "c", "a", "h0", "d_skip"],
                          [g for g in got if g is not None], want):
        assert g.shape == w.shape and g.is_contiguous(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
    # the wrapper's plain path is the same function
    got2 = ops.selective_scan_fused_bwd(*args, dy, dh_last, chunk)
    for g, g2 in zip(got, got2):
        assert (g is None and g2 is None) or torch.equal(g, g2)


def test_scan_gradcheck_float64(monkeypatch):
    """The Function's gradient against finite differences in float64; the
    wrapper of each chunk's scan takes float32 only, so the plain scan
    stands in for it here."""
    monkeypatch.setattr(ops, "selective_scan", ref.selective_scan)
    args = _scan_inputs(1, 5, 3, 2, seed=3, dtype=np.float64)
    ins = tuple(x.requires_grad_(True) for x in args)
    fn = lambda *xs: ops.SelectiveScanFused.apply(*xs, 2)
    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-7, rtol=1e-5)


def _count_saved(fn):
    n = [0]

    def pack(x):
        n[0] += 1
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = fn()
    return out, n[0]


def test_no_grad_call_is_todays():
    """Without a gradient wanted the call saves nothing and returns the
    plain version's values bit for bit; with one, the same values."""
    args = _scan_inputs(2, 24, 10, 8, seed=4)
    want = ref.selective_scan_fused(*args, chunk=8)
    (y, h), saved = _count_saved(lambda: ops.selective_scan_fused(*args, chunk=8))
    assert saved == 0 and y.grad_fn is None
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    with torch.no_grad():
        ins = [x.clone().requires_grad_(True) for x in args]
        (y2, h2), saved = _count_saved(lambda: ops.selective_scan_fused(*ins, chunk=8))
    assert saved == 0 and y2.grad_fn is None and torch.equal(y2, want[0])
    ins = [x.clone().requires_grad_(True) for x in args]
    (y3, h3), saved = _count_saved(lambda: ops.selective_scan_fused(*ins, chunk=8))
    assert saved == 7 and y3.grad_fn is not None
    assert torch.equal(y3.detach(), want[0]) and torch.equal(h3.detach(), want[1])


@pytest.mark.parametrize("seq,chunk,n,with_h0", [(48, 16, 8, False), (32, 32, 8, True),
                                                 (48, 16, 16, True), (16, 16, 16, False)])
def test_mamba1_core_grad_matches_jax(seq, chunk, n, with_h0):
    smoke = configs.get_smoke_config("falcon-mamba-7b")
    cfg = dataclasses.replace(smoke, ssm=dataclasses.replace(smoke.ssm, chunk=chunk, d_state=n))
    jsmoke = jconfigs.get_smoke_config("falcon-mamba-7b")
    jcfg = dataclasses.replace(jsmoke, ssm=dataclasses.replace(jsmoke.ssm, chunk=chunk, d_state=n))
    weights = init_numpy(ssm.mamba1_specs(cfg), seed=5)
    din = ssm._dinner(cfg)
    rng = np.random.default_rng(6)
    xin = rng.normal(0, 1, (B, seq, din)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, din, n)).astype(np.float32) if with_h0 else np.zeros(
        (B, din, n), np.float32)
    wy = rng.normal(0, 1, (B, seq, din)).astype(np.float32)
    wh = rng.normal(0, 1, (B, din, n)).astype(np.float32)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in weights.items()}
    tx, th = (torch.from_numpy(x.copy()).requires_grad_(True) for x in (xin, h0))
    y, h_last = ssm._mamba1_core(cfg, p, tx, th, DTypePolicy())
    loss = (y * torch.from_numpy(wy)).sum() + (h_last * torch.from_numpy(wh)).sum()
    names = ["a_log", "d_skip", "dt_bias", "dt_proj", "x_proj"]  # what the core reads
    got = torch.autograd.grad(loss, [p[k] for k in names] + [tx, th])

    def jloss(jp, x, h):
        y, hl = jssm._mamba1_core(jcfg, jp, x, h, JaxPolicy())
        return (y * wy).sum() + (hl * wh).sum()

    jp = {k: jnp.asarray(v) for k, v in weights.items()}
    jval, (jg, jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(xin),
                                                                       jnp.asarray(h0))
    np.testing.assert_allclose(float(loss), float(jval), rtol=1e-5)
    for name, g, w in zip(names + ["xin", "h0"], got, [jg[k] for k in names] + [jgx, jgh]):
        assert _rel(g, w) < 1e-5, (name, _rel(g, w))


@pytest.mark.cuda
def test_cuda_backward_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [None if x is None else x.cuda() for x in _scan_inputs(2, 37, 200, 16, seed=7)]
    dy = torch.randn((2, 37, 200), device="cuda")
    got = ops.selective_scan_fused_bwd(*args, dy)
    want = ref.selective_scan_fused_bwd(*args, dy)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu()) < 1e-5


# ---------------------------------------------------------------------------
# Model.loss and its gradients, all ten architectures


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(0, 1, (B, 4, cfg.d_model)).astype(np.float32)
        out["mrope_pos"] = np.stack([np.tile(np.arange(S, dtype=np.int32) // (1 + r), (B, 1))
                                     for r in range(3)])
    if cfg.family == "encdec":
        out["enc_feats"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    return out


def _port_loss_and_grads(model, params, batch):
    params = T.tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, metrics = model.loss(params, batch)
    paths, leaves = zip(*T.leaves(params))
    return loss, metrics, dict(zip(paths, torch.autograd.grad(loss, leaves)))


def _grads_close(grads, jg):
    jleaves = T.leaves(jg)
    assert list(grads) == [p for p, _ in jleaves]
    for path, w in jleaves:
        g = grads[path]
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32), path
        assert tuple(g.shape) == w.shape, path
        gn, wn = _np(g).ravel(), np.asarray(w, np.float32).ravel()
        assert _rel(gn, wn) < 0.05, (path, _rel(gn, wn))
        cos = float(gn @ wn / (np.linalg.norm(gn) * np.linalg.norm(wn) + 1e-30))
        assert cos > 0.999 or np.abs(wn).max() == 0, (path, cos)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_loss_and_grads_match_jax(arch):
    cfg = configs.get_smoke_config(arch)
    model = build(cfg)
    jm = jax_build(jconfigs.get_smoke_config(arch), tp=1)
    weights = init_numpy(model.specs, seed=0)
    tb, jb = lm_batches(_batch(cfg))
    loss, m, grads = _port_loss_and_grads(model, params_from_numpy(model.specs, weights, "cpu"),
                                          tb)
    (jloss, jm_), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jax_params(weights), jb)
    assert loss.shape == () and bool(torch.isfinite(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm_["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm_["aux"]), rtol=0, atol=1e-6)
    _grads_close(grads, jg)


def test_moe_dense_path_balances():
    cfg = configs.get_smoke_config("kimi-k2-1t-a32b")
    model = build(cfg)
    params = params_from_numpy(model.specs, init_numpy(model.specs, seed=0), "cpu")
    tb, _ = lm_batches(_batch(cfg, seed=3))
    _, metrics = model.loss(params, tb)
    assert float(metrics["aux"]) > 0


def test_bf16_params_get_bf16_grads():
    """kimi-k2's published parameters are bf16 (its smoke configuration's
    are float32): with bf16 parameters on both sides, every bf16 leaf's
    gradient is bf16, as JAX's, and close to JAX's."""
    arch = "kimi-k2-1t-a32b"
    cfg = dataclasses.replace(configs.get_smoke_config(arch), params_dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), params_dtype=jnp.bfloat16)
    model = build(cfg)
    weights = init_numpy(model.specs, seed=0)
    tb, jb = lm_batches(_batch(cfg))
    loss, _, grads = _port_loss_and_grads(model, params_from_numpy(model.specs, weights, "cpu"),
                                          tb)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jax_build(jcfg, tp=1).loss, has_aux=True))(
        jax_params(weights), jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sum(g.dtype == torch.bfloat16 for g in grads.values()) > 10
    _grads_close(grads, jg)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "kimi-k2-1t-a32b", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_remat_changes_no_value(arch):
    """Grads with remat "full" and "save_dots" equal those with "none", bit
    for bit."""
    base = configs.get_smoke_config(arch)
    weights = init_numpy(build(base).specs, seed=0)
    tb, _ = lm_batches(_batch(base))
    out = {}
    for remat in ("none", "full", "save_dots"):
        model = build(dataclasses.replace(base, remat=remat))
        loss, _, grads = _port_loss_and_grads(
            model, params_from_numpy(model.specs, weights, "cpu"), tb)
        out[remat] = (loss, grads)
    for remat in ("full", "save_dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for p, g in out["none"][1].items():
            assert torch.equal(out[remat][1][p], g), (remat, p)


def test_ssd_gradient_stays_finite_where_masked_decay_overflows():
    """Mamba-2's SSD above the causal diagonal: with a 128-step chunk and
    dt ~ 0.5-1 the masked decays exceed float32's exp range.  The reference's
    ``where(mask, exp(decay), 0)`` then has a NaN gradient (0 * inf); the
    port masks the exponent (ROADMAP F4): the same values, a finite
    gradient, equal to JAX's where that one is finite."""
    from repro.models import ssm as jssm

    smoke = configs.get_smoke_config("zamba2-2.7b")
    jsmoke = jconfigs.get_smoke_config("zamba2-2.7b")
    cfg = dataclasses.replace(smoke, ssm=dataclasses.replace(smoke.ssm, chunk=128))
    jcfg = dataclasses.replace(jsmoke, ssm=dataclasses.replace(jsmoke.ssm, chunk=128))
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    rng = np.random.default_rng(0)
    xh = rng.normal(0, 1, (1, 128, nh, s.head_dim)).astype(np.float32)
    bm, cm = (rng.normal(0, 1, (1, 128, s.d_state)).astype(np.float32) for _ in range(2))
    a_log = np.zeros((nh,), np.float32)
    h0 = np.zeros((1, nh, s.d_state, s.head_dim), np.float32)
    for lo, hi, overflows in ((0.5, 1.0, True), (0.001, 0.01, False)):
        dt = rng.uniform(lo, hi, (1, 128, nh)).astype(np.float32)
        t = torch.from_numpy(dt).requires_grad_(True)
        y, _ = ssm._ssd_core(cfg, *(torch.from_numpy(v) for v in (xh, bm, cm)), t,
                             torch.from_numpy(a_log), torch.from_numpy(h0))
        (g,) = torch.autograd.grad(y.sum(), t)
        jy, jg = jax.value_and_grad(lambda d: jssm._ssd_core(
            jcfg, *(jnp.asarray(v) for v in (xh, bm, cm)), d, jnp.asarray(a_log),
            jnp.asarray(h0))[0].sum())(jnp.asarray(dt))
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(float(y.sum()), float(jy), rtol=1e-5)
        assert bool(np.isfinite(np.asarray(jg)).all()) != overflows
        if not overflows:
            assert _rel(g, jg) < 1e-5, _rel(g, jg)
