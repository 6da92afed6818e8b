"""The port's falcon-mamba serving path against the JAX package's, on the
smoke configuration (2 layers, d_model 64, N 8, chunk 16) with the same
weights (``common.init_numpy``) fed to both: the Mamba-1 block in prefill
and decode, ``Model.prefill`` logits and cache, eight decode steps,
``greedy_generate``; the configs of all ten architectures, and this one's
spec trees and cache specs, field for field; the weight carry function's
refusals; the families the port does not build yet.

Tolerances.  Both packages run the matmuls in bf16 and keep the residual
stream, the conv state and the logits in bf16, rounding at different
places (XLA may keep a fused chain in float32; torch rounds each op), so a
bf16 value may differ by an ulp (2^-8 relative) here and there, and the
float32 ssm state inherits that through dt and x.  Largest differences
measured: logits 0.0039 (values up to 1.6), block outputs 4.9e-4 (values
up to 0.077), conv state 0.0156 (one ulp at 3.56), ssm state 1.7e-5
(values up to 6.2e-3), norms 0.  Held at rtol = 0.02 with atol 0.02
(logits, conv state, norms), 2e-3 (block outputs) and 1e-4 (ssm state):
four to six times the measured, and well inside tests/test_models.py's
rtol 0.2 / atol 0.3 for the same bf16 policy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import DTypePolicy as JaxPolicy
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import ssm as jax_ssm
from repro.models import layers as jax_layers
from repro.models.model import build as jax_build
from repro.models.model import cache_specs as jax_cache_specs
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro_torch import tree as T
from repro_torch.common import DTypePolicy, init_numpy, init_params
from repro_torch.configs import ARCH_IDS, base, get_config, get_smoke_config
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, ssm, transformer
from repro_torch.models.model import build, cache_specs, params_from_numpy
from repro_torch.serve.serve_step import greedy_generate, make_decode_step, make_prefill

ARCH = "falcon-mamba-7b"
BF16 = dict(rtol=0.02, atol=0.02)
BLOCK = dict(rtol=0.02, atol=2e-3)
STATE = dict(rtol=0.02, atol=1e-4)
B, S = 3, 48  # three chunks of 16


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    model, jmodel = build(cfg), jax_build(jax_get_smoke_config(ARCH), tp=1)
    weights = init_numpy(model.specs, seed=0)
    params = params_from_numpy(model.specs, weights, "cpu")
    jparams = jax.tree.map(jnp.asarray, weights)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, model, jmodel, params, jparams, tokens


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _bf16(shape, seed):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mamba1_block_matches_jax(setup, mode):
    cfg, model, _, params, jparams, _ = setup
    p = T.tree_map(lambda x: x[0], params["layers"]["ssm"])
    jp = jax.tree.map(lambda x: x[0], jparams["layers"]["ssm"])
    seq = S if mode == "prefill" else 1
    x, jx = _bf16((B, seq, cfg.d_model), seed=2)
    state = jstate = None
    if mode == "decode":
        conv, jconv = _bf16((B, cfg.ssm.d_conv - 1, 2 * cfg.d_model), seed=3)
        h = np.random.default_rng(4).normal(0, 0.01, (B, 2 * cfg.d_model, cfg.ssm.d_state))
        state = {"conv": conv, "ssm": torch.from_numpy(h.astype(np.float32))}
        jstate = {"conv": jconv, "ssm": jnp.asarray(h, jnp.float32)}
    out, st = ssm.mamba1_block(cfg, p, x, DTypePolicy(), state)
    jout, jst = jax_ssm.mamba1_block(jax_get_smoke_config(ARCH), jp, jx, JaxPolicy(), jstate)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, seq, cfg.d_model)
    _close(out, jout, BLOCK, "block output")
    _close(st["conv"], jst["conv"], BF16, "conv state")
    _close(st["ssm"], jst["ssm"], STATE, "ssm state")


def test_prefill_then_decode_matches_jax(setup):
    cfg, model, jmodel, params, jparams, tokens = setup
    prefill, decode_step = make_prefill(model), make_decode_step(model)
    cache, lg = prefill(params, {"tokens": torch.from_numpy(tokens)})
    jcache, jlg = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    assert lg.dtype == torch.bfloat16 and tuple(lg.shape) == (B, 1, cfg.vocab_size)
    _close(lg, jlg, BF16, "prefill logits")
    assert sorted(cache["layers"]) == sorted(jcache["layers"]) == ["conv", "ssm"]
    for k, tol in (("conv", BF16), ("ssm", STATE)):
        assert tuple(cache["layers"][k].shape) == jcache["layers"][k].shape
        _close(cache["layers"][k], jcache["layers"][k], tol, f"prefill cache {k}")
    rng = np.random.default_rng(5)
    for i in range(8):  # the same fed tokens on both sides
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        lg, cache = decode_step(params, cache, {"tokens": torch.from_numpy(tok)}, S + i)
        jlg, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(tok)}, S + i)
        _close(lg, jlg, BF16, f"decode step {i} logits")
    _close(cache["layers"]["ssm"], jcache["layers"]["ssm"], STATE, "ssm state after decode")


def test_greedy_generate_matches_jax_and_pad_to_is_a_noop(setup):
    _, model, jmodel, params, jparams, tokens = setup
    got = greedy_generate(model, params, {"tokens": torch.from_numpy(tokens)}, steps=6)
    padded = greedy_generate(model, params, {"tokens": torch.from_numpy(tokens)}, steps=6,
                             pad_to=S + 6)
    want = jax_greedy(jmodel, jparams, {"tokens": jnp.asarray(tokens)}, steps=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, padded)


def test_one_scan_per_chunk_and_decode_step(setup):
    """The scan goes through the wrapper once per chunk per layer (CPU: the
    plain version, no launch)."""
    cfg, model, _, params, _, tokens = setup
    calls = []
    real = scan_ops.selective_scan

    def counting(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    scan_ops.selective_scan = counting
    try:
        greedy_generate(model, params, {"tokens": torch.from_numpy(tokens)}, steps=3)
    finally:
        scan_ops.selective_scan = real
    din, n, chunk = 2 * cfg.d_model, cfg.ssm.d_state, cfg.ssm.chunk
    prefill = [(B, chunk, din, n)] * (cfg.n_layers * (S // chunk))
    assert calls == prefill + [(B, 1, din, n)] * (cfg.n_layers * 2)


def _config_fields(cfg, dtype_name):
    out = dataclasses.asdict(cfg)
    for k in ("params_dtype", "moments_dtype"):
        out[k] = dtype_name(out[k])
    return out


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_jax_field_for_field(arch, which):
    get, jget = ((get_config, jax_get_config) if which == "full"
                 else (get_smoke_config, jax_get_smoke_config))
    assert (_config_fields(get(arch), lambda d: str(d).removeprefix("torch."))
            == _config_fields(jget(arch), lambda d: np.dtype(d).name))


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_spec_tree_matches_jax(which):
    cfg = get_config(ARCH) if which == "full" else get_smoke_config(ARCH)
    jcfg = jax_get_config(ARCH) if which == "full" else jax_get_smoke_config(ARCH)
    want = [(p, tuple(s.shape), str(np.dtype(s.dtype)), s.init)
            for p, s in T.leaves(jax_build(jcfg, tp=1).specs)]
    got = [(p, s.shape, str(s.dtype).removeprefix("torch."), s.init)
           for p, s in T.leaves(build(cfg).specs)]
    assert got == want


def test_cache_specs_match_jax():
    cfg = get_config(ARCH)
    want = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                        jax_cache_specs(jax_get_config(ARCH), "decode_32k", tp=1)[0])
    got = T.tree_map(lambda s: (s.shape, str(s.dtype).removeprefix("torch.")),
                     cache_specs(cfg, "decode_32k"))
    assert got == want


def test_init_params_kinds_and_scales():
    cfg = get_smoke_config(ARCH)
    specs = build(cfg).specs
    a = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    b = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(T.leaves(a), T.leaves(b)))
    lay = a["layers"]["ssm"]
    assert torch.equal(lay["a_log"], torch.ones_like(lay["a_log"]))
    assert torch.equal(lay["conv_b"], torch.zeros_like(lay["conv_b"]))
    assert abs(float(a["embed"]["table"].std()) - 0.02) < 0.002  # "small"
    fan_in = cfg.d_model
    assert abs(float(lay["in_proj"].std()) * fan_in ** 0.5 - 1) < 0.05  # 1/sqrt(fan_in)
    np_w = init_numpy(specs, seed=0)
    assert [p for p, _ in T.leaves(np_w)] == [p for p, _ in T.leaves(a)]
    assert all(x.dtype == np.float32 for _, x in T.leaves(np_w))


def _bad_trees():
    specs = build(get_smoke_config(ARCH)).specs
    good = init_numpy(specs, seed=0)

    def edit(fn):
        tree = T.tree_map(lambda x: x, good)
        fn(tree)
        return tree

    return specs, {
        "shape": edit(lambda t: t["layers"]["ssm"].update(a_log=t["layers"]["ssm"]["a_log"][:, :, :4])),
        "dtype": edit(lambda t: t["embed"].update(table=t["embed"]["table"].astype(np.float64))),
        "missing": edit(lambda t: t["final_norm"].pop("scale")),
        "extra": edit(lambda t: t.update(w=np.zeros((64, 512), np.float32))),
        "not-numpy": edit(lambda t: t["final_norm"].update(scale=[1.0] * 64)),
    }


@pytest.mark.parametrize("case", ["shape", "dtype", "missing", "extra", "not-numpy"])
def test_params_from_numpy_refuses_mismatch(case):
    specs, trees = _bad_trees()
    with pytest.raises(ValueError, match="params_from_numpy"):
        params_from_numpy(specs, trees[case], "cpu")


def test_unported_paths_raise():
    cfg = get_smoke_config(ARCH)
    mamba2 = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, version=2))
    for fn in (lambda: ssm.mamba2_specs(mamba2), lambda: ssm.ssm_state_shape(mamba2, 1),
               lambda: build(mamba2),
               lambda: transformer.forward(cfg, {}, {}, DTypePolicy(), mode="train")):
        with pytest.raises(NotImplementedError, match="module item 13"):
            fn()
    # each family the port does not build names its step of ROADMAP item 13b
    steps = {"moe": "13b step 3", "hybrid": "13b step 4", "vlm": "13b step 5",
             "encdec": "13b step 6"}
    for arch in ARCH_IDS:
        other = get_smoke_config(arch)
        if other.family not in steps:
            continue
        for fn in (lambda: build(other), lambda: cache_specs(other, "decode_32k"),
                   lambda: transformer.forward(other, {}, {}, DTypePolicy(), mode="prefill")):
            with pytest.raises(NotImplementedError, match=f"module item {steps[other.family]}"):
                fn()
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    assert base.PORTED == {"ssm", "dense"}


@pytest.mark.parametrize("norm,fast", [("rmsnorm", False), ("rmsnorm", True),
                                       ("layernorm", False)])
def test_apply_norm_matches_jax(norm, fast):
    cfg = dataclasses.replace(get_smoke_config(ARCH), norm=norm, fast_norm=fast)
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), norm=norm, fast_norm=fast)
    rng = np.random.default_rng(6)
    p = {k: rng.normal(1, 0.1, (cfg.d_model,)).astype(np.float32)
         for k in layers.norm_specs(cfg)}
    x, jx = _bf16((2, 5, cfg.d_model), seed=7)
    got = layers.apply_norm(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, x)
    want = jax_layers.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jx)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16, f"{norm} fast={fast}")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", ARCH])  # the default, and the ssm family
def test_launch_serve_runs_on_the_cpu(capsys, arch):
    args = ["--device", "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "4"]
    toks = launch_serve.main(args + ([] if arch == "qwen3-1.7b" else ["--arch", arch]))
    assert tuple(toks.shape) == (2, 4) and toks.device.type == "cpu"
    assert f"{arch}-smoke" in capsys.readouterr().out
