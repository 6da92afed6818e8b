"""The port's MoE family (llama4-scout-17b-a16e: top-1 of 4 experts with a
shared expert; kimi-k2-1t-a32b: top-2 of 8, one leading dense layer)
against the JAX package's, on the smoke configurations with the same
weights (``common.init_numpy``) fed to both: the router (gates, experts,
the load-balance loss, lax.top_k's tie order), ``_positions_in_expert``,
``_capacity`` on both sides of its 4096 threshold, ``_expert_ffn``,
``dense_moe``; ``Model.prefill`` logits, KV cache and ``aux``, eight
decode steps, ``greedy_generate(pad_to=)``, the teacher-forcing property;
the spec trees and cache specs; kimi-k2's bf16 parameters carried across
bit for bit.

Tolerances.  The router is float32 on both sides and agrees to float32
rounding (gates 6.0e-8 at values up to 1, aux 1.9e-9 at 0.020, experts
equal); held at rtol 1e-5 / atol 1e-6.  The expert GEMMs are bf16 with the
reference's per-op bf16 logistic, so equal inputs give equal outputs but
for a bf16 sum taken in another order: ``_expert_ffn`` 0 (values up to
4.1), ``dense_moe`` 0.0039 (3.5), prefill logits 0.0078 (3.7), decode
logits 9.5e-7 (4.0), the KV cache 0.0156 (22.75), kimi-k2 on bf16 weights
0 (measured with one torch thread, torch 2.13 and jax 0.9 on a CPU).
Held at the dense family's rtol 0.02 / atol 0.0625 (logits, block outputs;
the largest uses 9% of it) and rtol 0.02 / atol 0.25 (cache); the
teacher-forcing property at tests/test_models.py's bound, which tolerates
2% of logits past rtol 0.2 / atol 0.3 for a MoE (a borderline token may
pick another expert between the cached and the full forward).  Greedy
tokens are compared where the JAX package's top-1/top-2 margin exceeds
0.015625."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.common import DTypePolicy as JaxPolicy
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models.model import build as jax_build
from repro.models.model import cache_specs as jax_cache_specs
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.common import DTypePolicy, bf16_bits, init_numpy, init_params
from repro_torch.models import moe, transformer
from repro_torch.models.model import build, cache_specs, params_from_numpy
from repro_torch.serve.serve_step import _pad_seq, greedy_generate
from torch_parity import (close, decode_batch, jax_greedy_margins, jax_params, pad_jax_cache,
                          same_tokens, single_torch_thread, to_np)

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

MOE = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
ROUTER = dict(rtol=1e-5, atol=1e-6)
LOGITS = dict(rtol=0.02, atol=0.0625)
CACHE = dict(rtol=0.02, atol=0.25)
MARGIN = 0.015625
B, S, STEPS = 2, 32, 8


def _pair(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in MOE:
        cfg = configs.get_smoke_config(arch)
        model, jmodel = build(cfg), jax_build(jconfigs.get_smoke_config(arch), tp=1)
        weights = init_numpy(model.specs, seed=0)
        out[arch] = (cfg, model, jmodel, params_from_numpy(model.specs, weights, "cpu"),
                     jax_params(weights))
    return out


def _moe_params(models, arch):
    cfg, _, _, params, jparams = models[arch]
    return (cfg, T.tree_map(lambda x: x[0], params["layers"]["moe"]),
            jax.tree.map(lambda x: x[0], jparams["layers"]["moe"]))


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


# ---------------------------------------------------------------------------
# the MoE block's functions on equal inputs


@pytest.mark.parametrize("arch", MOE)
def test_route_matches_jax(models, arch):
    cfg, p, jp = _moe_params(models, arch)
    x, jx = _pair((B * S, cfg.d_model), seed=2)
    gates, experts, aux = moe._route(cfg, p, x)
    jgates, jexperts, jaux = jax_moe._route(jconfigs.get_smoke_config(arch), jp, jx)
    assert gates.dtype == torch.float32 and experts.dtype == torch.int32
    assert tuple(gates.shape) == jgates.shape == (B * S, cfg.moe.top_k)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(jexperts))
    close(gates, jgates, ROUTER, "gates")
    assert aux.dtype == torch.float32 and aux.shape == ()
    close(aux, jaux, ROUTER, "aux")


def test_top_k_breaks_ties_as_lax():
    """Equal probabilities go to the lower expert index first, as
    ``lax.top_k`` orders them: a zero router row gives every expert the
    same probability, and rows with pairs of equal maxima."""
    cfg = configs.get_smoke_config("kimi-k2-1t-a32b")
    probs = np.full((4, 8), 0.125, np.float32)
    probs[1] = [0.1, 0.2, 0.05, 0.2, 0.1, 0.1, 0.2, 0.05]
    probs[2] = [0.3, 0.0, 0.3, 0.0, 0.1, 0.1, 0.1, 0.1]
    probs[3] = [0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.5]
    for k in (1, 2, 3, 8):
        vals, idx = moe._top_k(torch.from_numpy(probs), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    # the router on a zero row: all experts tie, the first top_k win
    p = {"router": torch.zeros((cfg.d_model, cfg.moe.n_experts))}
    _, experts, _ = moe._route(cfg, p, torch.ones((3, cfg.d_model)))
    assert experts.tolist() == [[0, 1]] * 3


def test_positions_in_expert_matches_jax():
    for t, k, e, seed in [(64, 2, 8, 3), (33, 1, 4, 4), (128, 8, 16, 5)]:
        experts = np.random.default_rng(seed).integers(0, e, (t, k)).astype(np.int32)
        got = moe._positions_in_expert(torch.from_numpy(experts), e)
        want = np.asarray(jax_moe._positions_in_expert(jnp.asarray(experts), e))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE)
def test_capacity_matches_jax(arch):
    """Dropless up to top_k * T = 4096, GShard capacity past it."""
    for which in (configs.get_smoke_config, configs.get_config):
        cfg = which(arch)
        jcfg = (jconfigs.get_smoke_config if which is configs.get_smoke_config
                else jconfigs.get_config)(arch)
        edge = 4096 // cfg.moe.top_k
        for t in (1, 7, edge - 1, edge, edge + 1, 3 * edge, 100_000):
            assert moe._capacity(cfg, t) == jax_moe._capacity(jcfg, t), (arch, t)
        assert moe._capacity(cfg, edge) == 4096
        assert moe._capacity(cfg, edge + 1) < cfg.moe.top_k * (edge + 1)


@pytest.mark.parametrize("arch", MOE)
def test_expert_ffn_matches_jax(models, arch):
    cfg, p, jp = _moe_params(models, arch)
    buf, jbuf = _pair((cfg.moe.n_experts, 12, cfg.d_model), seed=6)
    got = moe._expert_ffn(cfg, p["w_in"], p["w_gate"], p["w_out"], buf, torch.bfloat16)
    want = jax_moe._expert_ffn(None, jp["w_in"], jp["w_gate"], jp["w_out"], jbuf, jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    close(got, want, LOGITS, "expert ffn")


@pytest.mark.parametrize("arch", MOE)
def test_dense_moe_matches_jax(models, arch):
    cfg, p, jp = _moe_params(models, arch)
    x, jx = _pair((B, S, cfg.d_model), seed=7)
    y, aux = moe.apply_moe(cfg, p, x, DTypePolicy())
    jy, jaux = jax_moe.apply_moe(jconfigs.get_smoke_config(arch), jp, jx, JaxPolicy())
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == jy.shape
    close(y, jy, LOGITS, "dense_moe")
    close(aux, jaux, ROUTER, "aux")


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_decode_matches_jax(models, arch):
    cfg, model, jmodel, params, jparams = models[arch]
    tokens = _tokens(cfg, S + STEPS)
    batch, jbatch = {"tokens": torch.from_numpy(tokens[:, :S])}, {"tokens": jnp.asarray(tokens[:, :S])}
    cache, lg = model.prefill(params, batch)
    jcache, jlg = jmodel.prefill(jparams, jbatch)
    assert lg.dtype == torch.bfloat16 and tuple(lg.shape) == (B, 1, cfg.vocab_size)
    close(lg, jlg, LOGITS, "prefill logits")
    assert [p for p, _ in T.leaves(cache)] == [p for p, _ in T.leaves(jcache)]
    for (path, c), (_, jc) in zip(T.leaves(cache), T.leaves(jcache)):
        assert tuple(c.shape) == jc.shape and c.dtype == torch.bfloat16, path
        close(c, jc, CACHE, f"prefill cache {path}")
    # the summed load-balance loss of the MoE layers
    _, _, aux = transformer.forward(cfg, params, batch, DTypePolicy(), mode="prefill")
    _, _, jaux = jax_tf.forward(jmodel.cfg, jparams, jbatch, JaxPolicy(), mode="prefill")
    assert float(aux) > 0
    close(aux, jaux, ROUTER, "aux")
    cache = _pad_seq(cfg, cache, S, B, S + STEPS)
    jcache = pad_jax_cache(jmodel.cfg, jcache, S, B, S + STEPS)
    step = jax.jit(jmodel.decode_step)
    for i in range(STEPS):
        db, jdb = decode_batch(cfg, tokens[:, S + i:S + i + 1], S + i)
        lg, cache = model.decode_step(params, cache, db, S + i)
        jlg, jcache = step(jparams, jcache, jdb, jnp.int32(S + i))
        close(lg, jlg, LOGITS, f"decode step {i} logits")
    for (path, c), jc in zip(T.leaves(cache), jax.tree.leaves(jcache)):
        close(c, jc, CACHE, f"cache {path} after decode")


@pytest.mark.parametrize("arch", MOE)
def test_greedy_generate_with_pad_to_matches_jax(models, arch):
    cfg, model, jmodel, params, jparams = models[arch]
    tokens = _tokens(cfg, S)
    got = greedy_generate(model, params, {"tokens": torch.from_numpy(tokens)}, steps=STEPS,
                          pad_to=S + STEPS)
    want = np.asarray(jax_greedy(jmodel, jparams, {"tokens": jnp.asarray(tokens)},
                                 steps=STEPS, pad_to=S + STEPS))
    ref, margins = jax_greedy_margins(jmodel, jparams, {"tokens": jnp.asarray(tokens)}, STEPS,
                                      S + STEPS)
    np.testing.assert_array_equal(ref, want)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, STEPS)
    same_tokens(got.numpy(), want, margins, MARGIN)
    assert torch.equal(got, greedy_generate(model, params, {"tokens": torch.from_numpy(tokens)},
                                            steps=STEPS, pad_to=S + STEPS + 5))


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_jax_teacher_forcing(arch):
    """prefill(x[:16]) + decode steps against the JAX package's train-mode
    ``forward`` of the whole sequence (tests/test_models.py's property and
    its MoE bound: under 2% of logits past rtol 0.2 / atol 0.3), on its
    weights (``init(PRNGKey(0))`` carried across) and tokens."""
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jmodel, model = jax_build(jcfg, tp=1), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(model.specs, jax.tree.map(np.array, jparams), "cpu")
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(2), (B, 32), 0, cfg.vocab_size),
                      np.int32)
    h, _, _ = jax_tf.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, JaxPolicy(),
                             mode="train")
    full = to_np(jax_tf.lm_logits(jcfg, jparams, h, JaxPolicy()))
    cache, lg = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :16])})
    got = [to_np(lg[:, 0])]
    cache = _pad_seq(cfg, cache, 16, B, 32)
    for t in range(16, 32):
        lg, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(
            tokens[:, t:t + 1])}, t)
        got.append(to_np(lg[:, 0]))
    for t, g in zip(range(15, 32), got):
        bad = np.abs(g - full[:, t]) > 0.3 + 0.2 * np.abs(full[:, t])
        assert bad.mean() < 0.02, f"{arch} t={t}: {bad.mean():.3%} mismatched"


def test_aux_loss_is_active():
    """tests/test_models.py's ``test_moe_dense_path_balances_and_routes``:
    kimi-k2's load-balance loss is above 0, on the JAX package's weights and
    batch, and equal to the JAX package's forward's."""
    jcfg, cfg = jconfigs.get_smoke_config("kimi-k2-1t-a32b"), configs.get_smoke_config(
        "kimi-k2-1t-a32b")
    jmodel, model = jax_build(jcfg, tp=1), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(model.specs, jax.tree.map(np.array, jparams), "cpu")
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(3), (B, 32), 0, cfg.vocab_size),
                      np.int32)
    _, _, aux = transformer.forward(cfg, params, {"tokens": torch.from_numpy(tokens)},
                                    DTypePolicy(), mode="prefill")
    _, _, jaux = jax_tf.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, JaxPolicy(),
                                mode="prefill")
    assert float(aux) > 0
    close(aux, jaux, ROUTER, "aux")


# ---------------------------------------------------------------------------
# bf16 parameters (kimi-k2 stores its weights in bf16)


def _bf16_kimi():
    """kimi-k2's smoke config with the full config's bf16 parameters."""
    full = configs.get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(configs.get_smoke_config("kimi-k2-1t-a32b"),
                              params_dtype=full.params_dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("kimi-k2-1t-a32b"),
                               params_dtype=jconfigs.get_config("kimi-k2-1t-a32b").params_dtype)
    return cfg, jcfg


def test_bf16_leaves_carry_across_bit_for_bit():
    """The JAX package's bf16 leaves, as their uint16 bits, become the
    port's bf16 tensors bit for bit; the router and the norms stay float32;
    and ``init_numpy``'s bf16 leaves are the JAX package's cast of the same
    float32 draw."""
    cfg, jcfg = _bf16_kimi()
    model, jmodel = build(cfg), jax_build(jcfg, tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    bits = jax.tree.map(lambda x: np.asarray(x).view(np.uint16) if x.dtype == jnp.bfloat16
                        else np.asarray(x), jparams)
    params = params_from_numpy(model.specs, bits, "cpu")
    dtypes = {p: x.dtype for p, x in T.leaves(params)}
    assert dtypes["/layers/moe/router"] == dtypes["/final_norm/scale"] == torch.float32
    assert dtypes["/layers/moe/w_in"] == dtypes["/embed/table"] == torch.bfloat16
    n16 = sum(s.dtype == torch.bfloat16 for _, s in T.leaves(model.specs))
    assert sum(d == torch.bfloat16 for d in dtypes.values()) == n16 == 19
    for (path, x), (_, want) in zip(T.leaves(params), T.leaves(bits)):
        got = x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
        np.testing.assert_array_equal(got, want, err_msg=path)
    # init_numpy: the bf16 bits of the float32 draw, rounded as JAX casts
    w16 = init_numpy(model.specs, seed=0)
    w32 = init_numpy(build(configs.get_smoke_config("kimi-k2-1t-a32b")).specs, seed=0)
    for (path, x16), (_, x32) in zip(T.leaves(w16), T.leaves(w32)):
        if x16.dtype == np.uint16:
            want = np.asarray(jnp.asarray(x32).astype(jnp.bfloat16)).view(np.uint16)
            np.testing.assert_array_equal(x16, want, err_msg=path)
            np.testing.assert_array_equal(bf16_bits(x32), want, err_msg=path)
        else:
            np.testing.assert_array_equal(x16, x32, err_msg=path)
    # the model on bf16 weights: the JAX package's logits
    tokens = _tokens(cfg, S)
    _, lg = model.prefill(params_from_numpy(model.specs, w16, "cpu"),
                          {"tokens": torch.from_numpy(tokens)})
    _, jlg = jmodel.prefill(jax_params(w16), {"tokens": jnp.asarray(tokens)})
    close(lg, jlg, LOGITS, "bf16 prefill logits")


def test_init_params_draws_bf16_leaves_in_slices(monkeypatch):
    """A bf16 leaf is drawn in float32 slices cast into place (no float32
    copy of the whole leaf): the same kinds and scales as a float32 leaf,
    and a float32 leaf's draw is unchanged."""
    from repro_torch import common

    cfg, _ = _bf16_kimi()
    specs = build(cfg).specs
    monkeypatch.setattr(common, "_DRAW_SLICE", 1000)
    a = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    w = a["layers"]["moe"]["w_in"]
    assert w.dtype == torch.bfloat16 and w.numel() > 10 * 1000
    assert abs(float(w.float().std()) * cfg.d_model ** 0.5 - 1) < 0.05  # 1/sqrt(fan_in)
    assert a["layers"]["moe"]["router"].dtype == torch.float32
    assert abs(float(a["embed"]["table"].float().std()) - 0.02) < 0.002  # "small"
    f32 = init_params({"x": common.ParamSpec((64, 32))}, torch.Generator().manual_seed(5), "cpu")
    want = torch.randn((64, 32), generator=torch.Generator().manual_seed(5)) / 64 ** 0.5
    assert torch.equal(f32["x"], want)


# ---------------------------------------------------------------------------
# specs


@pytest.mark.parametrize("arch", MOE)
def test_cache_specs_match_jax(arch):
    for shape in ("decode_32k", "prefill_32k"):
        want = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                            jax_cache_specs(jconfigs.get_config(arch), shape, tp=1)[0])
        got = T.tree_map(lambda s: (s.shape, str(s.dtype).removeprefix("torch.")),
                         cache_specs(configs.get_config(arch), shape)[0])
        assert got == want


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", MOE)
def test_spec_tree_matches_jax(arch, which):
    get, jget = ((configs.get_config, jconfigs.get_config) if which == "full"
                 else (configs.get_smoke_config, jconfigs.get_smoke_config))
    want = [(p, tuple(s.shape), str(np.dtype(s.dtype)), s.init)
            for p, s in T.leaves(jax_build(jget(arch), tp=1).specs)]
    got = [(p, s.shape, str(s.dtype).removeprefix("torch."), s.init)
           for p, s in T.leaves(build(get(arch)).specs)]
    assert got == want
