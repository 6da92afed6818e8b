"""The port's Mamba-2 (SSD) blocks and the hybrid family (zamba2-2.7b: one
shared attention block before each group of ``attn_every`` Mamba-2
layers) against the JAX package's, on the smoke configuration (4 layers in
2 groups, d_model 64, N 16, head_dim 16, chunk 16) with the same weights
(``common.init_numpy``) fed to both: ``_ssd_core`` over several chunks, one
chunk and a decode step from a given state; ``mamba2_block`` with and
without a state; ``Model.prefill`` logits and its ``groups`` cache, eight
decode steps, ``greedy_generate`` with ``pad_to`` (the shared attention's
KV cache padded, the Mamba-2 states not), the teacher-forcing property;
the decode-state shapes, cache specs and spec trees.

Tolerances.  The SSD core is float32 on both sides; the (B, i, j, H)
decay's ``exp``, the cumulative sum and the three-operand einsums round
differently (XLA's ``exp`` is not torch's, and the contraction order
differs), so on equal inputs its outputs agree to a few float32 ulps: y
6.7e-6 at values up to 39, the state 2.4e-6 at 5.6; held at rtol 1e-5 /
atol 1e-4 (y) and rtol 1e-5 / atol 2e-5 (state).  The block is held
against the JAX block as it runs inside the model, jitted: XLA drops the
rounding of ``silu(xin)``'s product to bf16 there (its only use is a cast
to float32), and the port computes that product in float32 too (eager JAX
rounds it and differs from jitted JAX in half the outputs).  Measured:
block outputs and conv states 0, the block's ssm state 1.8e-9 at 2.4e-3;
through the model, logits 0 (prefill) and 1.9e-6 (decode) at values up to
4.2, the shared attention's KV cache 0.031 at 18.6 after decode, ssm
states 2.0e-9 at 4.6e-3, conv states 1.9e-6.  Held at rtol 0.02 with atol
0.0625 (logits, block outputs, conv states), 0.25 (the KV cache) and 1e-4
(ssm states), as the dense and Mamba-1 tests hold theirs; the
teacher-forcing property at tests/test_models.py's rtol 0.2 / atol 0.3.
Greedy tokens are compared where the JAX package's top-1/top-2 margin
exceeds 0.015625 (measured with one torch thread, torch 2.13 and jax 0.9
on a CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.common import DTypePolicy as JaxPolicy
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.models.model import build as jax_build
from repro.models.model import cache_specs as jax_cache_specs
from repro.serve.serve_step import cache_seq_axes as jax_cache_seq_axes
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.common import DTypePolicy, init_numpy
from repro_torch.models import ssm
from repro_torch.models.model import build, cache_specs, params_from_numpy
from repro_torch.serve.serve_step import _pad_seq, cache_seq_axes, greedy_generate
from torch_parity import (close, decode_batch, jax_greedy_margins, jax_params, pad_jax_cache,
                          same_tokens, single_torch_thread, to_np)

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

ARCH = "zamba2-2.7b"
SSD_Y = dict(rtol=1e-5, atol=1e-4)
SSD_H = dict(rtol=1e-5, atol=2e-5)
LOGITS = dict(rtol=0.02, atol=0.0625)  # logits, block outputs, conv states
CACHE = dict(rtol=0.02, atol=0.25)  # the shared attention's KV cache
STATE = dict(rtol=0.02, atol=1e-4)  # ssm states
TEACHER = dict(rtol=0.2, atol=0.3)
MARGIN = 0.015625
B, S, STEPS = 2, 32, 8


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config(ARCH)
    jcfg = jconfigs.get_smoke_config(ARCH)
    model, jmodel = build(cfg), jax_build(jcfg, tp=1)
    weights = init_numpy(model.specs, seed=0)
    return (cfg, jcfg, model, jmodel, params_from_numpy(model.specs, weights, "cpu"),
            jax_params(weights))


def _ssd_inputs(cfg, seq, seed):
    """xh (B,S,H,P), bmat/cmat (B,S,N), dt (B,S,H) > 0, a_log (H,), h0."""
    rng = np.random.default_rng(seed)
    s = cfg.ssm
    nh, pd, n = s.expand * cfg.d_model // s.head_dim, s.head_dim, s.d_state
    return [rng.normal(0, 1, (B, seq, nh, pd)).astype(np.float32),
            rng.normal(0, 1, (B, seq, n)).astype(np.float32),
            rng.normal(0, 1, (B, seq, n)).astype(np.float32),
            np.abs(rng.normal(0.5, 0.3, (B, seq, nh))).astype(np.float32),
            rng.normal(0, 0.5, (nh,)).astype(np.float32),
            rng.normal(0, 1, (B, nh, n, pd)).astype(np.float32)]


@pytest.mark.parametrize("seq", [48, 16, 1])  # three chunks, one chunk, a decode step
def test_ssd_core_matches_jax(setup, seq):
    cfg, jcfg = setup[:2]
    args = _ssd_inputs(cfg, seq, seed=seq)
    y, h = ssm._ssd_core(cfg, *map(torch.from_numpy, args))
    jy, jh = jax_ssm._ssd_core(jcfg, *map(jnp.asarray, args))
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == jy.shape and tuple(h.shape) == jh.shape
    close(y, jy, SSD_Y, f"ssd y S={seq}")
    close(h, jh, SSD_H, f"ssd h S={seq}")
    with pytest.raises(AssertionError):  # the reference's seq % chunk == 0 refusal
        ssm._ssd_core(cfg, *map(torch.from_numpy, _ssd_inputs(cfg, 24, seed=0)))


def _block_params(setup):
    params, jparams = setup[4:]
    return (T.tree_map(lambda x: x[0, 0], params["layers"]["ssm"]),
            jax.tree.map(lambda x: x[0, 0], jparams["layers"]["ssm"]))


def test_mamba2_block_matches_jax(setup):
    """Prefill (no state) over two chunks, then a decode step from the JAX
    package's state carried across; the JAX block jitted, as it runs inside
    the model's ``lax.scan``."""
    cfg, jcfg = setup[:2]
    p, jp = _block_params(setup)
    x = np.random.default_rng(3).normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    tx, jx = torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    out, st = ssm.mamba2_block(cfg, p, tx, DTypePolicy())
    block = jax.jit(lambda p, x, st: jax_ssm.mamba2_block(jcfg, p, x, JaxPolicy(), state=st))
    jout, jst = block(jp, jx, None)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == jout.shape
    close(out, jout, LOGITS, "prefill block out")
    for k in ("conv_x", "conv_bc"):
        assert st[k].dtype == torch.bfloat16
        close(st[k], jst[k], LOGITS, f"prefill {k}")
    close(st["ssm"], jst["ssm"], STATE, "prefill ssm state")
    shapes = ssm.ssm_state_shape(cfg, B)
    assert {k: (tuple(v.shape), v.dtype) for k, v in st.items()} == \
        {k: (s.shape, s.dtype) for k, s in shapes.items()}
    # decode: seq 1 from the JAX package's state
    state = T.tree_map(lambda a: torch.from_numpy(to_np(a)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32), jst)
    out, st = ssm.mamba2_block(cfg, p, tx[:, :1], DTypePolicy(), state=state)
    jout, jst = block(jp, jx[:, :1], jst)
    close(out, jout, LOGITS, "decode block out")
    close(st["ssm"], jst["ssm"], STATE, "decode ssm state")
    for k in ("conv_x", "conv_bc"):
        close(st[k], jst[k], LOGITS, f"decode {k}")


def test_ssm_state_shape_matches_jax():
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        for arch in (ARCH, "falcon-mamba-7b"):
            got = {k: (s.shape, str(s.dtype).removeprefix("torch."))
                   for k, s in ssm.ssm_state_shape(get(arch), 3).items()}
            want = {k: (s.shape, str(s.dtype))
                    for k, s in jax_ssm.ssm_state_shape(jget(arch), 3).items()}
            assert got == want


# ---------------------------------------------------------------------------
# the model


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _tol(path):
    return CACHE if "/attn/" in path else STATE if path.endswith("/ssm") else LOGITS


def test_prefill_then_decode_matches_jax(setup):
    cfg, jcfg, model, jmodel, params, jparams = setup
    tokens = _tokens(cfg, S + STEPS)
    cache, lg = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :S])})
    jcache, jlg = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    close(lg, jlg, LOGITS, "prefill logits")
    assert [p for p, _ in T.leaves(cache)] == [p for p, _ in T.leaves(jcache)] == [
        "/groups/attn/0", "/groups/attn/1", "/groups/ssm/conv_bc", "/groups/ssm/conv_x",
        "/groups/ssm/ssm"]
    g, e = cfg.n_layers // cfg.attn_every, cfg.attn_every
    assert tuple(cache["groups"]["attn"][0].shape) == (g, B, S, cfg.n_kv_heads, cfg.head_dim)
    assert tuple(cache["groups"]["ssm"]["ssm"].shape[:2]) == (g, e)
    for (path, c), (_, jc) in zip(T.leaves(cache), T.leaves(jcache)):
        assert tuple(c.shape) == jc.shape and str(c.dtype).removeprefix("torch.") == str(
            jc.dtype), path
        close(c, jc, _tol(path), f"prefill cache {path}")
    cache = _pad_seq(cfg, cache, S, B, S + STEPS)
    jcache = pad_jax_cache(jcfg, jcache, S, B, S + STEPS)
    step = jax.jit(jmodel.decode_step)
    for i in range(STEPS):
        db, jdb = decode_batch(cfg, tokens[:, S + i:S + i + 1], S + i)
        lg, cache = model.decode_step(params, cache, db, S + i)
        jlg, jcache = step(jparams, jcache, jdb, jnp.int32(S + i))
        close(lg, jlg, LOGITS, f"decode step {i} logits")
    for (path, c), (_, jc) in zip(T.leaves(cache), T.leaves(jcache)):
        close(c, jc, _tol(path), f"cache {path} after decode")


def test_pad_to_pads_only_the_attention_cache(setup):
    """``cache_seq_axes`` finds the sequence axis of the shared attention's
    KV cache and none in the Mamba-2 states, as the JAX package's does;
    the greedy tokens are the JAX package's and do not depend on how much
    room the padding gives."""
    cfg, jcfg, model, jmodel, params, jparams = setup
    n = 16  # batch == seq, the collision tests/test_serve.py pins
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (n, n)).astype(np.int32)
    cache, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    axes = cache_seq_axes(cfg, cache, n, n)
    jcache, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    assert axes == jax_cache_seq_axes(jcfg, jcache, n, n) == [2, 2, None, None, None]
    padded = _pad_seq(cfg, cache, n, n, n + 5)
    for (path, c), (_, pc), ax in zip(T.leaves(cache), T.leaves(padded), axes):
        if ax is None:
            assert pc is c, path
        else:
            assert pc.shape[ax] == n + 5 and torch.equal(pc.narrow(ax, 0, n), c), path
    tokens = _tokens(cfg, S)
    got = greedy_generate(model, params, {"tokens": torch.from_numpy(tokens)}, steps=STEPS,
                          pad_to=S + STEPS)
    want = np.asarray(jax_greedy(jmodel, jparams, {"tokens": jnp.asarray(tokens)},
                                 steps=STEPS, pad_to=S + STEPS))
    ref, margins = jax_greedy_margins(jmodel, jparams, {"tokens": jnp.asarray(tokens)}, STEPS,
                                      S + STEPS)
    np.testing.assert_array_equal(ref, want)
    same_tokens(got.numpy(), want, margins, MARGIN)
    assert torch.equal(got, greedy_generate(model, params, {"tokens": torch.from_numpy(tokens)},
                                            steps=STEPS, pad_to=S + STEPS + 9))


def test_decode_matches_jax_teacher_forcing():
    """prefill(x[:16]) + decode steps reproduce the JAX package's train-mode
    ``forward`` of the whole sequence (tests/test_models.py's property), on
    its weights (``init(PRNGKey(0))`` carried across) and tokens."""
    jcfg, cfg = jconfigs.get_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    jmodel, model = jax_build(jcfg, tp=1), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(model.specs, jax.tree.map(np.array, jparams), "cpu")
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(2), (B, 32), 0, cfg.vocab_size),
                      np.int32)
    h, _, _ = jax_tf.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, JaxPolicy(),
                             mode="train")
    full = jax_tf.lm_logits(jcfg, jparams, h, JaxPolicy())
    cache, lg = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :16])})
    close(lg[:, 0], full[:, 15], TEACHER, "prefill vs teacher forcing")
    cache = _pad_seq(cfg, cache, 16, B, 32)
    for t in range(16, 32):
        lg, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(
            tokens[:, t:t + 1])}, t)
        close(lg[:, 0], full[:, t], TEACHER, f"decode t={t}")


# ---------------------------------------------------------------------------
# specs


def test_cache_specs_match_jax():
    for shape in ("decode_32k", "long_500k"):
        want = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                            jax_cache_specs(jconfigs.get_config(ARCH), shape, tp=1)[0])
        got = T.tree_map(lambda s: (s.shape, str(s.dtype).removeprefix("torch.")),
                         cache_specs(configs.get_config(ARCH), shape)[0])
        assert got == want


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_spec_tree_matches_jax(which):
    get, jget = ((configs.get_config, jconfigs.get_config) if which == "full"
                 else (configs.get_smoke_config, jconfigs.get_smoke_config))
    want = [(p, tuple(s.shape), str(np.dtype(s.dtype)), s.init)
            for p, s in T.leaves(jax_build(jget(ARCH), tp=1).specs)]
    got = [(p, s.shape, str(s.dtype).removeprefix("torch."), s.init)
           for p, s in T.leaves(build(get(ARCH)).specs)]
    assert got == want
