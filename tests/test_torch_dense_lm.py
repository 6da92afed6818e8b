"""The port's dense LM family (qwen3-1.7b, internlm2-1.8b, stablelm-12b,
granite-34b) against the JAX package's, on the smoke configurations with
the same weights (``common.init_numpy``) fed to both: RoPE, qk-norm, the
QKV projection, the chunked prefill attention, grouped decode attention
and the MLP; ``Model.prefill`` logits and KV cache, eight decode steps,
``greedy_generate`` with ``pad_to`` and without (the reference's clamped
decode write), the teacher-forcing property against the JAX package's
train-mode ``forward``; ``cache_seq_axes``, the cache specs, the spec
trees of all four in full and smoke form, the shape cells, and
``vp/workloads.from_arch`` with the VP build of one of its tiles.

Tolerances.  Both packages run the matmuls in bf16 and round in the same
places (the port mirrors the reference's casts, its per-op bf16 logistic
and tanh-GELU, its bf16 embedding scale and, in ``dense_layer``, the
float32 residual sum that XLA feeds to ``ln2``), so with equal inputs most
functions agree bit for bit.  What remains is a bf16 product whose float32
sum was accumulated in another order, and XLA's ``rsqrt``, which differs
from torch's by an ulp of float32 now and then: a rare one-ulp flip that
the next layers carry on.  Largest differences measured (B = 2, S = 32,
one torch thread, torch 2.13 and jax 0.9 on a CPU): prefill logits 0.0039
(values up to 3.6), decode logits 0.0156, KV cache 0.0625 (half a bf16 ulp
at values up to 34), function outputs on equal inputs 0 but for the QKV
projection's k (1.2e-4), RoPE angles 0.  Held at logits and function
outputs rtol 0.02 / atol 0.0625, cache rtol 0.02 / atol 0.25 (four times
the measured), angles rtol 1e-6 / atol 1e-5; the teacher-forcing property
at the JAX test's rtol 0.2 / atol 0.3.

Greedy tokens are compared where the JAX package's top-1/top-2 margin is
above 0.015625, the largest logit difference measured: a token whose
margin is a bf16 ulp or two (qwen3-1.7b's tied logits stay below 0.6, so
its margins are often that small) is a coin flip between equal
computations.  A row whose token differs at such a position is not
compared past it (its later inputs differ).  Every case here compares at
least half of its positions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.common import DTypePolicy as JaxPolicy
from repro.core import segmentation as jsg
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.models.model import build as jax_build
from repro.models.model import cache_specs as jax_cache_specs
from repro.serve.serve_step import cache_seq_axes as jax_cache_seq_axes
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro.vp import workloads as jwl
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.common import DTypePolicy, init_numpy, pad_to
from repro_torch.core import segmentation as sg
from repro_torch.models import layers, transformer
from repro_torch.models.model import build, cache_specs, params_from_numpy
from repro_torch.serve.serve_step import _pad_seq, cache_seq_axes, greedy_generate
from repro_torch.vp import workloads as wl
from torch_parity import assert_tree_equal, cfg_fields, single_torch_thread

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

DENSE = ["qwen3-1.7b", "internlm2-1.8b", "stablelm-12b", "granite-34b"]
LOGITS = dict(rtol=0.02, atol=0.0625)
CACHE = dict(rtol=0.02, atol=0.25)
ANGLES = dict(rtol=1e-6, atol=1e-5)
TEACHER = dict(rtol=0.2, atol=0.3)  # tests/test_models.py's
MARGIN = 0.015625  # greedy tokens compared where the JAX top-1/top-2 margin exceeds it
B, S, STEPS = 2, 32, 8


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _pair(shape, seed, dtype=jnp.bfloat16, scale=1.0):
    """The same numbers as a torch and a JAX array of ``dtype``."""
    x = (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, dtype)


@pytest.fixture(scope="module")
def models():
    """Built models and weights of the four dense smoke configs, by arch."""
    out = {}
    for arch in DENSE:
        cfg = configs.get_smoke_config(arch)
        model, jmodel = build(cfg), jax_build(jconfigs.get_smoke_config(arch), tp=1)
        weights = init_numpy(model.specs, seed=0)
        out[arch] = (cfg, model, jmodel, params_from_numpy(model.specs, weights, "cpu"),
                     jax.tree.map(jnp.asarray, weights))
    return out


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers on equal inputs


@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (160, 1e4)])
def test_rope_matches_jax(head_dim, theta):
    pos = np.arange(40, dtype=np.int32)[None].repeat(B, 0) + np.array([[0], [1000]], np.int32)
    ang = layers.rope_angles(torch.from_numpy(pos), head_dim, theta)
    jang = jax_layers.rope_angles(jnp.asarray(pos), head_dim, theta)
    assert ang.dtype == torch.float32 and tuple(ang.shape) == jang.shape
    _close(ang, jang, ANGLES, "angles")
    x, jx = _pair((B, 40, 3, head_dim), seed=2)
    got = layers.apply_rope(x, torch.from_numpy(np.array(jang)))
    want = jax_layers.apply_rope(jx, jang)
    assert got.dtype == torch.bfloat16
    _close(got, want, LOGITS, "rotated")


def test_rms_head_norm_matches_jax():
    x, jx = _pair((B, 8, 4, 16), seed=3, scale=5.0)
    s = np.random.default_rng(4).normal(1, 0.1, (16,)).astype(np.float32)
    got = layers.rms_head_norm(x, torch.from_numpy(s))
    want = jax_layers.rms_head_norm(jx, jnp.asarray(s))
    assert got.dtype == torch.bfloat16
    _close(got, want, LOGITS, "qk-norm")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internlm2-1.8b"])  # qk-norm on, off
def test_qkv_project_matches_jax(models, arch):
    cfg, _, _, params, jparams = models[arch]
    p = T.tree_map(lambda x: x[0], params["layers"]["attn"])
    jp = jax.tree.map(lambda x: x[0], jparams["layers"]["attn"])
    x, jx = _pair((B, S, cfg.d_model), seed=5)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    jang = jax_layers.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    got = layers.qkv_project(cfg, p, x, DTypePolicy(), angles=torch.from_numpy(np.array(jang)))
    want = jax_layers.qkv_project(jconfigs.get_smoke_config(arch), jp, jx, JaxPolicy(),
                                  angles=jang)
    for name, g, w in zip("qkv", got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16, name
        _close(g, w, LOGITS, name)


@pytest.mark.parametrize("seq", [16, 32, 48])
def test_flash_prefill_attention_matches_jax(seq):
    """Chunks of 16: one, three and six pairs of the triangular loop."""
    q, jq = _pair((B, seq, 4, 16), seed=6, scale=2.0)
    k, jk = _pair((B, seq, 4, 16), seed=7, scale=2.0)
    v, jv = _pair((B, seq, 4, 16), seed=8)
    got = layers.flash_prefill_attention(q, k, v, chunk_q=16, chunk_k=16)
    want = jax_layers.flash_prefill_attention(jq, jk, jv, chunk_q=16, chunk_k=16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want, LOGITS, f"flash S={seq}")
    dense = jax_layers.dense_attention(jq, jk, jv, causal=True)
    _close(layers.dense_attention(q, k, v, causal=True), dense, LOGITS, "dense")
    r, _ = _pair((B, seq + 8, 4, 16), seed=9)
    with pytest.raises(AssertionError):  # the reference's sq % cq == 0 refusal
        layers.flash_prefill_attention(r, r, r, chunk_q=16, chunk_k=16)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])  # G = 1, 2, 4 (MQA)
def test_grouped_decode_attention_matches_jax(hq, hkv):
    """Against a cache longer than ``length`` (positions past it masked), and
    ``decode_attention`` over the kv heads expanded by ``expand_kv``."""
    q, jq = _pair((B, 1, hq, 16), seed=9, scale=2.0)
    k, jk = _pair((B, 24, hkv, 16), seed=10, scale=2.0)
    v, jv = _pair((B, 24, hkv, 16), seed=11)
    got = transformer._grouped_decode_attention(q, k, v, 19)
    want = jax_tf._grouped_decode_attention(jq, jk, jv, 19)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want, LOGITS, "grouped")
    ke, ve = layers.expand_kv(k, hq), layers.expand_kv(v, hq)
    np.testing.assert_array_equal(_np(ke), _np(jax_layers.expand_kv(jk, hq)))
    _close(layers.decode_attention(q, ke, ve, 19),
           jax_layers.decode_attention(jq, jax_layers.expand_kv(jk, hq),
                                       jax_layers.expand_kv(jv, hq), 19), LOGITS, "expanded")


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp_matches_jax(act):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-1.7b"), act=act)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"), act=act)
    specs = layers.mlp_specs(cfg)
    w = init_numpy(specs, seed=12)
    x, jx = _pair((B, S, cfg.d_model), seed=13)
    got = layers.apply_mlp(cfg, params_from_numpy(specs, w, "cpu"), x, DTypePolicy())
    want = jax_layers.apply_mlp(jcfg, jax.tree.map(jnp.asarray, w), jx, JaxPolicy())
    assert sorted(w) == sorted(jax_layers.mlp_specs(jcfg, 1))
    _close(got, want, LOGITS, act)


def test_padded_heads_and_masking():
    for arch in configs.ARCH_IDS:
        for tp in (1, 16):
            assert layers.padded_heads(configs.get_config(arch), tp) == \
                jax_layers.padded_heads(jconfigs.get_config(arch), tp), (arch, tp)
    cfg = configs.get_smoke_config("qwen3-1.7b")
    o, jo = _pair((B, 3, 6, 16), seed=14)
    np.testing.assert_array_equal(_np(layers.mask_pad_heads(cfg, o)),
                                  _np(jax_layers.mask_pad_heads(
                                      jconfigs.get_smoke_config("qwen3-1.7b"), jo)))
    assert [pad_to(x, 8) for x in (0, 1, 8, 9)] == [0, 8, 8, 16]


# ---------------------------------------------------------------------------
# the model


def _feed_decode(model, params, cache, toks, start):
    out = []
    for i in range(toks.shape[1]):
        lg, cache = model.decode_step(params, cache, {"tokens": toks[:, i:i + 1]}, start + i)
        out.append(lg)
    return out, cache


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_jax(models, arch):
    cfg, model, jmodel, params, jparams = models[arch]
    tokens = _tokens(cfg, S + STEPS)
    cache, lg = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :S])})
    jcache, jlg = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    assert lg.dtype == torch.bfloat16 and tuple(lg.shape) == (B, 1, cfg.vocab_size)
    _close(lg, jlg, LOGITS, "prefill logits")
    kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    for name, c, jc in zip("kv", cache["layers"], jcache["layers"]):
        assert tuple(c.shape) == jc.shape == kv and c.dtype == torch.bfloat16
        _close(c, jc, CACHE, f"prefill cache {name}")
    # eight decode steps, the same fed tokens on both sides, into padded caches
    cache = _pad_seq(cfg, cache, S, B, S + STEPS)
    jcache = jax.tree.map(lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]),
                          jcache)
    step = jax.jit(jmodel.decode_step)
    lgs, cache = _feed_decode(model, params, cache, torch.from_numpy(tokens[:, S:]), S)
    for i, lg in enumerate(lgs):
        jlg, jcache = step(jparams, jcache, {"tokens": jnp.asarray(tokens[:, S + i:S + i + 1])},
                           jnp.int32(S + i))
        _close(lg, jlg, LOGITS, f"decode step {i} logits")
    for name, c, jc in zip("kv", cache["layers"], jcache["layers"]):
        _close(c, jc, CACHE, f"cache {name} after decode")


def _margins(jmodel, jparams, tokens, steps, pad):
    """The JAX package's greedy tokens and the top-1/top-2 logit margin at
    each position, from its own loop (the same as ``greedy_generate``)."""
    cache, lg = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    if pad:
        cache = jax.tree.map(lambda x: jnp.pad(
            x, [(0, 0), (0, 0), (0, pad - x.shape[2]), (0, 0), (0, 0)]), cache)
    step = jax.jit(jmodel.decode_step)
    toks, margins = [], []
    for i in range(steps):
        last = np.asarray(lg[:, -1], np.float32)
        top2 = np.sort(last, axis=-1)[:, -2:]
        toks.append(np.argmax(last, axis=-1).astype(np.int32))
        margins.append(top2[:, 1] - top2[:, 0])
        if i < steps - 1:
            lg, cache = step(jparams, cache, {"tokens": jnp.asarray(toks[-1][:, None])},
                             jnp.int32(tokens.shape[1] + i))
    return np.stack(toks, 1), np.stack(margins, 1)


def _same_tokens(got, want, margins, tol):
    """Tokens equal wherever the JAX margin exceeds ``tol``; a row is not
    compared past a position where they differ.  Returns the count compared."""
    compared = 0
    for r in range(want.shape[0]):
        for i in range(want.shape[1]):
            if margins[r, i] <= tol:
                if got[r, i] != want[r, i]:
                    break
                continue
            assert got[r, i] == want[r, i], (r, i, got[r], want[r], margins[r])
            compared += 1
    assert compared >= want.size // 2, (compared, margins)
    return compared


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_with_pad_to_matches_jax(models, arch):
    cfg, model, jmodel, params, jparams = models[arch]
    tokens = _tokens(cfg, S)
    batch = {"tokens": torch.from_numpy(tokens)}
    got = greedy_generate(model, params, batch, steps=STEPS, pad_to=S + STEPS)
    want = np.asarray(jax_greedy(jmodel, jparams, {"tokens": jnp.asarray(tokens)}, steps=STEPS,
                                 pad_to=S + STEPS))
    ref, margins = _margins(jmodel, jparams, tokens, STEPS, S + STEPS)
    np.testing.assert_array_equal(ref, want)  # the margins' loop is greedy_generate's
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, STEPS)
    _same_tokens(got.numpy(), want, margins, MARGIN)
    # padding is inert: more room gives the same tokens
    assert torch.equal(got, greedy_generate(model, params, batch, steps=STEPS,
                                            pad_to=S + STEPS + 5))


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_without_pad_to_clamps_as_jax(models, arch):
    """No ``pad_to``: the cache is as long as the prompt, every decode write
    lands on its last position (the reference's clamped
    ``dynamic_update_slice``), and the tokens are the JAX package's clamped
    ones, not the padded run's."""
    cfg, model, jmodel, params, jparams = models[arch]
    tokens = _tokens(cfg, S)
    batch = {"tokens": torch.from_numpy(tokens)}
    got = greedy_generate(model, params, batch, steps=STEPS)
    want = np.asarray(jax_greedy(jmodel, jparams, {"tokens": jnp.asarray(tokens)}, steps=STEPS))
    ref, margins = _margins(jmodel, jparams, tokens, STEPS, None)
    np.testing.assert_array_equal(ref, want)
    _same_tokens(got.numpy(), want, margins, MARGIN)
    # one clamped step against the reference's: the cache keeps its length
    cache, lg = model.prefill(params, batch)
    jcache, jlg = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tok = want[:, :1].copy()
    lg, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(tok)}, S)
    jlg, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(tok)}, S)
    assert tuple(cache["layers"][0].shape) == jcache["layers"][0].shape
    assert jcache["layers"][0].shape[2] == S
    _close(lg, jlg, LOGITS, "clamped decode logits")
    for name, c, jc in zip("kv", cache["layers"], jcache["layers"]):
        _close(c, jc, CACHE, f"clamped cache {name}")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_jax_teacher_forcing(arch):
    """prefill(x[:16]) + decode steps reproduce the JAX package's train-mode
    ``forward`` logits of the whole sequence: tests/test_models.py's
    property on its own inputs (weights ``model.init(PRNGKey(0))`` carried
    across, tokens ``randint(PRNGKey(2))``), held across the two packages.
    (With ``init_numpy(seed=0)`` weights and other tokens the JAX package's
    own prefill and decode miss this bound on granite-34b by 0.15, as the
    port's do.)"""
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jmodel, model = jax_build(jcfg, tp=1), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(model.specs, jax.tree.map(np.array, jparams), "cpu")
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(2), (B, 32), 0, cfg.vocab_size),
                      np.int32)
    h, _, _ = jax_tf.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, JaxPolicy(),
                             mode="train")
    full = jax_tf.lm_logits(jcfg, jparams, h, JaxPolicy())
    cache, lg = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :16])})
    _close(lg[:, 0], full[:, 15], TEACHER, "prefill vs teacher forcing")
    cache = _pad_seq(cfg, cache, 16, B, 32)
    lgs, _ = _feed_decode(model, params, cache, torch.from_numpy(tokens[:, 16:]), 16)
    for i, lg in enumerate(lgs):
        _close(lg[:, 0], full[:, 16 + i], TEACHER, f"decode t={16 + i}")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b"])
def test_cache_seq_axes_at_batch_equal_seq(arch):
    """batch == seq: the sequence axis comes from the specs, not from
    matching sizes (an ssm cell's batch axis sits where a KV cell keeps its
    sequence axis), as the reference's tests/test_serve.py pins."""
    cfg = configs.get_smoke_config(arch)
    model = build(cfg)
    params = params_from_numpy(model.specs, init_numpy(model.specs, seed=0), "cpu")
    n = 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (n, n)).astype(np.int32)
    cache, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    axes = cache_seq_axes(cfg, cache, n, n)
    jcfg = jconfigs.get_smoke_config(arch)
    jcache = jax_tree_of(cache)
    assert axes == jax_cache_seq_axes(jcfg, jcache, n, n)
    if cfg.family == "dense":
        assert axes == [x.dim() - 3 for _, x in T.leaves(cache)]
    else:
        assert axes == [None] * len(T.leaves(cache))
    batch = {"tokens": torch.from_numpy(tokens[:4])}
    assert torch.equal(greedy_generate(model, params, batch, steps=4, pad_to=n + 4),
                       greedy_generate(model, params, batch, steps=4, pad_to=n + 9))


def jax_tree_of(tree):
    return T.tree_map(lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)
                      if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy()), tree)


@pytest.mark.parametrize("arch", DENSE)
def test_cache_specs_match_jax(arch):
    want = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                        jax_cache_specs(jconfigs.get_config(arch), "decode_32k", tp=1)[0])
    got = T.tree_map(lambda s: (s.shape, str(s.dtype).removeprefix("torch.")),
                     cache_specs(configs.get_config(arch), "decode_32k")[0])
    assert got == want


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", DENSE)
def test_spec_tree_matches_jax(arch, which):
    get, jget = ((configs.get_config, jconfigs.get_config) if which == "full"
                 else (configs.get_smoke_config, jconfigs.get_smoke_config))
    want = [(p, tuple(s.shape), str(np.dtype(s.dtype)), s.init)
            for p, s in T.leaves(jax_build(jget(arch), tp=1).specs)]
    got = [(p, s.shape, str(s.dtype).removeprefix("torch."), s.init)
           for p, s in T.leaves(build(get(arch)).specs)]
    assert got == want


def test_shape_cells_match_jax():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.all_cells() == jconfigs.all_cells()
    assert configs.skipped_cells() == jconfigs.skipped_cells()
    assert [configs.cells(a) for a in configs.ARCH_IDS] == \
        [jconfigs.cells(a) for a in jconfigs.ARCH_IDS]
    assert len(configs.all_cells()) == 32 and len(configs.skipped_cells()) == 8


# ---------------------------------------------------------------------------
# from_arch: the LM configs' FFN GEMMs tiled onto the VP's crossbars


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_from_arch_matches_jax(arch):
    for max_tiles in (8, 3):
        got = [dataclasses.astuple(t) for t in wl.from_arch(arch, max_tiles=max_tiles)]
        want = [dataclasses.astuple(t) for t in jwl.from_arch(arch, max_tiles=max_tiles)]
        assert got == want
    tiles = wl.from_arch(arch)
    assert len(tiles) == 8 and all((t.h, t.w, t.p) == (256, 256, 8) for t in tiles)


def test_from_arch_tile_builds_as_jax():
    """One qwen3-1.7b tile as the dense benchmark builds it (uniform
    offload, two manager CPUs driving two units each, latency 10,000): the
    built trees equal the JAX package's bit for bit, and the tiles share
    one job (``layer_data`` seeds from 0)."""
    tiles, jtiles = wl.from_arch("qwen3-1.7b"), jwl.from_arch("qwen3-1.7b")
    built = []
    for sg_mod, wl_mod, layer in ((jsg, jwl, jtiles[0]), (sg, wl, tiles[0])):
        descs = sg_mod.uniform(2, 2)
        job = wl_mod.cim_workload(layer, [0, 1], {0: (0, 1), 1: (2, 3)},
                                  ordinals=sg_mod.mailbox_ordinals(descs))
        kw = {"device": "cpu"} if sg_mod is sg else {}
        built.append((sg_mod.build(descs, programs=job["programs"], dram_words=job["dram"],
                                   channel_latency=10_000, crossbars=job["crossbars"],
                                   scratch_init=job["scratch"], **kw), job))
    ((jcfg, jst, jpen), jjob), ((cfg, st, pen), job) = built
    assert cfg_fields(cfg) == cfg_fields(jcfg)
    assert_tree_equal(jst, st, "built states")
    assert_tree_equal(jpen, pen, "built pending")
    np.testing.assert_array_equal(job["expected"], jjob["expected"])
    for t in tiles[1:]:
        np.testing.assert_array_equal(wl.layer_data(t)[2], job["expected"])
