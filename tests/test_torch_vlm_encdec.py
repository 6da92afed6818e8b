"""The port's VLM family (qwen2-vl-72b: vision embeddings merged at the
leading positions, M-RoPE) and encoder-decoder family (whisper-tiny:
sinusoidal encoder positions, bidirectional encoder, learned decoder
positions, cached cross-attention K/V) against the JAX package's, on the
smoke configurations with the same weights (``common.init_numpy``) and
inputs fed to both: ``mrope_angles`` with three different position rows,
qwen2-vl's prefill with ``vision_embeds`` and Qwen2-VL-style positions,
its decode and greedy tokens; ``sinusoidal_positions``, ``encode``,
``cross_kv``, whisper's prefill, decode and greedy tokens, the cross cache
left unpadded by ``pad_to``; the teacher-forcing property of both; the
spec trees and cache specs.

Tolerances.  qwen2-vl agrees bit for bit or nearly: logits 0 at values up
to 3.9, the KV cache 0.0156 at 23.75, angles 0.  whisper's sinusoidal
positions are float32 ``exp``, ``sin`` and ``cos`` of angles up to 1500:
XLA's functions are not torch's and the frequencies differ by an ulp at
57 of 192 entries, so positions differ by up to 1.2e-4 (held at atol
5e-4).  The JAX package itself computes them two ways: op by op in an
eager ``Model.prefill`` and fused in a jitted one (40 of the 192
frequencies differ between the two), and a bf16 ulp flip in the encoder
runs on through bidirectional attention, so the JAX package's eager and
jitted prefill logits differ by 0.098 (values up to 0.52).  whisper is
held to the jitted prefill, which the port matches (logits 0, the cross
cache 4.8e-7 at 16, the encoder's memory 0.0156 at 3.7 against a jitted
``encode``, cross K/V of equal memory 1.9e-6), and to the
eager one at a tolerance that covers the JAX package's own spread
(measured: logits 0.077, memory 0.133, the cross cache 0.34 at 16).
Held at rtol 0.02 with atol 0.0625 (logits, memory), 0.25 (the KV cache;
against eager JAX) and greedy tokens where the JAX margin exceeds
0.015625; the teacher-forcing property at tests/test_models.py's rtol
0.2 / atol 0.3 (measured with one torch thread, torch 2.13 and jax 0.9 on
a CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.common import DTypePolicy as JaxPolicy
from repro.models import encdec as jax_ed
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.models.model import build as jax_build
from repro.models.model import cache_specs as jax_cache_specs
from repro.serve.serve_step import cache_seq_axes as jax_cache_seq_axes
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.common import DTypePolicy, init_numpy
from repro_torch.models import encdec, layers, transformer
from repro_torch.models.model import build, cache_specs, params_from_numpy
from repro_torch.serve.serve_step import _pad_seq, cache_seq_axes, greedy_generate
from torch_parity import (close, decode_batch, jax_greedy_margins, jax_params, lm_batches,
                          pad_jax_cache, same_tokens, single_torch_thread, to_np)

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

VLM, ENCDEC = "qwen2-vl-72b", "whisper-tiny"
ANGLES = dict(rtol=1e-6, atol=1e-5)
POSITIONS = dict(rtol=0, atol=5e-4)
LOGITS = dict(rtol=0.02, atol=0.0625)
EAGER = dict(rtol=0.02, atol=0.25)  # whisper against eager JAX
CACHE = dict(rtol=0.02, atol=0.25)
TEACHER = dict(rtol=0.2, atol=0.3)
B, S, STEPS = 2, 32, 8
N_VISION, GRID = 8, (2, 2, 2)  # the smoke config's patches on a (t, h, w) grid
N_FRAMES = 48


def qwen2_vl_positions(b, seq, grid):
    """Qwen2-VL's M-RoPE positions (3, B, S): the patches at the leading
    positions on a (t, h, w) grid, one row each, and the text after them
    on all three rows from the grid's largest position plus one."""
    t, h, w = grid
    nv = t * h * w
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    vis = np.stack([tt.ravel(), hh.ravel(), ww.ravel()])  # (3, nv)
    text = np.arange(seq - nv) + vis.max() + 1
    pos = np.concatenate([vis, np.broadcast_to(text, (3, seq - nv))], axis=1)
    return np.broadcast_to(pos[:, None], (3, b, seq)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in (VLM, ENCDEC):
        cfg = configs.get_smoke_config(arch)
        model, jmodel = build(cfg), jax_build(jconfigs.get_smoke_config(arch), tp=1)
        weights = init_numpy(model.specs, seed=0)
        out[arch] = (cfg, model, jmodel, params_from_numpy(model.specs, weights, "cpu"),
                     jax_params(weights))
    return out


def _batch(cfg, n, seed=1):
    """Tokens, and the family's extra inputs: vision embeddings and M-RoPE
    positions (vlm), frame embeddings (encdec)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(0, 1, (B, N_VISION, cfg.d_model)).astype(np.float32)
        batch["mrope_pos"] = qwen2_vl_positions(B, n, GRID)
    if cfg.family == "encdec":
        batch["enc_feats"] = rng.normal(0, 1, (B, N_FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def _prompt(batch, n):
    out = dict(batch, tokens=batch["tokens"][:, :n])
    if "mrope_pos" in batch:
        out["mrope_pos"] = np.ascontiguousarray(batch["mrope_pos"][:, :, :n])
    return out


# ---------------------------------------------------------------------------
# M-RoPE and the vision merge


@pytest.mark.parametrize("sections,theta", [((2, 3, 3), 1e6), ((16, 24, 24), 1e6),
                                            ((4, 2, 2), 1e4)])
def test_mrope_angles_matches_jax(sections, theta):
    """Three different rows (time, height, width): a mix-up of sections
    would show.  The rows agree with ``rope_angles`` of each row on its own
    section."""
    half = sum(sections)
    pos = qwen2_vl_positions(B, 40, (2, 3, 4))
    pos = pos + np.array([0, 100, 7000], np.int32)[:, None, None]
    assert len({pos[i].tobytes() for i in range(3)}) == 3
    got = layers.mrope_angles(torch.from_numpy(pos), 2 * half, theta, sections)
    want = jax_layers.mrope_angles(jnp.asarray(pos), 2 * half, theta, sections)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (B, 40, half)
    close(got, want, ANGLES, "mrope angles")
    off = 0
    for i, sec in enumerate(sections):
        row = layers.rope_angles(torch.from_numpy(pos[i]), 2 * half, theta)[..., off:off + sec]
        assert torch.equal(got[..., off:off + sec], row)
        off += sec


def test_vision_embeds_merge_and_mrope_reach_the_model(models):
    """The merge writes the vision embeddings over the leading positions,
    and M-RoPE is taken only when the batch has ``mrope_pos`` (plain RoPE
    otherwise), on both sides."""
    cfg, _, jmodel, params, jparams = models[VLM]
    batch = _batch(cfg, S)
    ours, theirs = lm_batches(batch)
    for drop in ((), ("mrope_pos",), ("vision_embeds",)):
        b = {k: v for k, v in ours.items() if k not in drop}
        jb = {k: v for k, v in theirs.items() if k not in drop}
        h, ang = transformer._embed_and_angles(cfg, params, b, DTypePolicy(), "prefill", None)
        jh, jang = jax_tf._embed_and_angles(jmodel.cfg, jparams, jb, JaxPolicy(), "prefill", None)
        close(h, jh, LOGITS, f"embeddings without {drop}")
        close(ang, jang, ANGLES, f"angles without {drop}")
        if "vision_embeds" not in drop:
            assert torch.equal(h[:, :N_VISION], ours["vision_embeds"])


# ---------------------------------------------------------------------------
# the encoder


@pytest.mark.parametrize("seq,d", [(N_FRAMES, 64), (1500, 384)])  # smoke; whisper-tiny's
def test_sinusoidal_positions_matches_jax(seq, d):
    got = layers.sinusoidal_positions(seq, d)
    want = jax_layers.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (seq, d)
    close(got, want, POSITIONS, "sinusoidal positions")
    # in bf16, as the encoder adds them, they differ by at most one ulp
    d16 = np.abs(to_np(got.to(torch.bfloat16)) - to_np(want.astype(jnp.bfloat16)))
    assert (d16 <= 2 ** -8 * np.maximum(np.abs(to_np(want)), 1)).all()


def test_encode_and_cross_kv_match_jax(models):
    cfg, _, jmodel, params, jparams = models[ENCDEC]
    feats, jfeats = lm_batches({"f": _batch(cfg, S)["enc_feats"]})
    mem = encdec.encode(cfg, params, feats["f"], DTypePolicy())
    encode = lambda p, x: jax_ed.encode(jmodel.cfg, p, x, JaxPolicy())  # noqa: E731
    jmem = jax.jit(encode)(jparams, jfeats["f"])
    assert mem.dtype == torch.bfloat16 and tuple(mem.shape) == jmem.shape
    close(mem, jmem, LOGITS, "memory")
    close(mem, encode(jparams, jfeats["f"]), EAGER, "memory (eager JAX)")
    # cross K/V of the same memory: every decoder layer's, stacked
    same = torch.from_numpy(to_np(jmem)).to(torch.bfloat16)
    kv = encdec.cross_kv(cfg, params, same, DTypePolicy())
    jkv = jax_ed.cross_kv(jmodel.cfg, jparams, jmem, JaxPolicy())
    for name, c, jc in zip("kv", kv, jkv):
        assert tuple(c.shape) == jc.shape == (cfg.n_layers, B, N_FRAMES, cfg.n_kv_heads,
                                              cfg.head_dim)
        close(c, jc, LOGITS, f"cross {name}")


# ---------------------------------------------------------------------------
# the model


def _jax_prefill(jmodel, arch):
    """The JAX package's prefill as the port is held to it: jitted for
    whisper (see the module's docstring), as it is for qwen2-vl."""
    return jax.jit(jmodel.prefill) if arch == ENCDEC else jmodel.prefill


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_prefill_then_decode_matches_jax(models, arch):
    cfg, model, jmodel, params, jparams = models[arch]
    batch = _batch(cfg, S + STEPS)
    ours, theirs = lm_batches(_prompt(batch, S))
    cache, lg = model.prefill(params, ours)
    jcache, jlg = _jax_prefill(jmodel, arch)(jparams, theirs)
    assert lg.dtype == torch.bfloat16 and tuple(lg.shape) == (B, 1, cfg.vocab_size)
    close(lg, jlg, LOGITS, "prefill logits")
    close(lg, jmodel.prefill(jparams, theirs)[1], EAGER, "prefill logits (eager JAX)")
    assert [p for p, _ in T.leaves(cache)] == [p for p, _ in T.leaves(jcache)]
    for (path, c), (_, jc) in zip(T.leaves(cache), T.leaves(jcache)):
        assert tuple(c.shape) == jc.shape and c.dtype == torch.bfloat16, path
        close(c, jc, CACHE, f"prefill cache {path}")
    cache = _pad_seq(cfg, cache, S, B, S + STEPS)
    jcache = pad_jax_cache(jmodel.cfg, jcache, S, B, S + STEPS)
    step = jax.jit(jmodel.decode_step)
    for i in range(STEPS):
        db, jdb = decode_batch(cfg, batch["tokens"][:, S + i:S + i + 1], S + i)
        lg, cache = model.decode_step(params, cache, db, S + i)
        jlg, jcache = step(jparams, jcache, jdb, jnp.int32(S + i))
        close(lg, jlg, LOGITS, f"decode step {i} logits")
    for (path, c), (_, jc) in zip(T.leaves(cache), T.leaves(jcache)):
        close(c, jc, CACHE, f"cache {path} after decode")


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_greedy_generate_with_pad_to_matches_jax(models, arch):
    """Against the JAX package's greedy loop (``greedy_generate``'s, the
    prefill jitted for whisper); qwen2-vl's also against ``greedy_generate``
    itself."""
    cfg, model, jmodel, params, jparams = models[arch]
    ours, theirs = lm_batches(_batch(cfg, S))
    got = greedy_generate(model, params, ours, steps=STEPS, pad_to=S + STEPS)
    want, margins = jax_greedy_margins(jmodel, jparams, theirs, STEPS, S + STEPS,
                                       prefill=_jax_prefill(jmodel, arch))
    if arch == VLM:
        np.testing.assert_array_equal(want, np.asarray(jax_greedy(
            jmodel, jparams, theirs, steps=STEPS, pad_to=S + STEPS)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, STEPS)
    same_tokens(got.numpy(), want, margins, 0.015625)
    assert torch.equal(got, greedy_generate(model, params, ours, steps=STEPS,
                                            pad_to=S + STEPS + 5))


def test_pad_to_leaves_the_cross_cache_unpadded(models):
    """tests/test_serve.py's ``test_pad_to_encdec_cross_cache_stays_unpadded``:
    at batch == seq the self cache's sequence axis is found and padded, the
    cross cache (fixed-length memory) is left as it is, and the tokens do
    not depend on the padding."""
    cfg, model, jmodel, params, jparams = models[ENCDEC]
    n = 16
    rng = np.random.default_rng(5)
    ours, theirs = lm_batches({
        "tokens": rng.integers(0, cfg.vocab_size, (n, n)).astype(np.int32),
        "enc_feats": rng.normal(0, 1, (n, n, cfg.d_model)).astype(np.float32)})
    cache, _ = model.prefill(params, ours)
    jcache, _ = jmodel.prefill(jparams, theirs)
    axes = cache_seq_axes(cfg, cache, n, n)
    assert axes == jax_cache_seq_axes(jmodel.cfg, jcache, n, n) == [None, None, 2, 2]
    padded = _pad_seq(cfg, cache, n, n, n + 4)
    assert all(x is y for x, y in zip(padded["cross"], cache["cross"]))
    assert all(x.shape[2] == n + 4 for x in padded["self"])
    t1 = greedy_generate(model, params, ours, steps=4, pad_to=n + 4)
    t2 = greedy_generate(model, params, ours, steps=4, pad_to=n + 9)
    assert torch.equal(t1, t2)


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_decode_matches_jax_teacher_forcing(arch):
    """prefill(x[:16]) + decode steps reproduce the JAX package's train-mode
    forward of the whole sequence (tests/test_models.py's property, its
    ``make_batch``: for the vlm four vision embeddings and positions, here
    three different rows; for whisper frame embeddings as long as the
    tokens), on its weights (``init(PRNGKey(0))`` carried across)."""
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jmodel, model = jax_build(jcfg, tp=1), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(model.specs, jax.tree.map(np.array, jparams), "cpu")
    key = jax.random.PRNGKey(2)
    batch = {"tokens": np.array(jax.random.randint(key, (B, 32), 0, cfg.vocab_size), np.int32)}
    if arch == VLM:
        batch["vision_embeds"] = np.array(jax.random.normal(key, (B, 4, cfg.d_model)),
                                          np.float32)
        batch["mrope_pos"] = qwen2_vl_positions(B, 32, (1, 2, 2))
    else:
        batch["enc_feats"] = np.array(jax.random.normal(key, (B, 32, cfg.d_model)), np.float32)
    ours, theirs = lm_batches(batch)
    if arch == ENCDEC:
        h = jax_ed.encdec_loss_forward(jcfg, jparams, theirs, JaxPolicy())
    else:
        h, _, _ = jax_tf.forward(jcfg, jparams, theirs, JaxPolicy(), mode="train")
    full = jax_tf.lm_logits(jcfg, jparams, h, JaxPolicy())
    pre, _ = lm_batches(_prompt(batch, 16))
    cache, lg = model.prefill(params, pre)
    close(lg[:, 0], full[:, 15], TEACHER, "prefill vs teacher forcing")
    cache = _pad_seq(cfg, cache, 16, B, 32)
    for t in range(16, 32):
        db = {"tokens": ours["tokens"][:, t:t + 1]}
        if cfg.mrope:
            db["mrope_pos"] = ours["mrope_pos"][:, :, t:t + 1]
        lg, cache = model.decode_step(params, cache, db, t)
        close(lg[:, 0], full[:, t], TEACHER, f"decode t={t}")


# ---------------------------------------------------------------------------
# specs


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_cache_specs_match_jax(arch):
    for shape in ("decode_32k", "prefill_32k"):  # whisper's cross length depends on the kind
        want = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                            jax_cache_specs(jconfigs.get_config(arch), shape, tp=1)[0])
        got = T.tree_map(lambda s: (s.shape, str(s.dtype).removeprefix("torch.")),
                         cache_specs(configs.get_config(arch), shape)[0])
        assert got == want


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_spec_tree_matches_jax(arch, which):
    get, jget = ((configs.get_config, jconfigs.get_config) if which == "full"
                 else (configs.get_smoke_config, jconfigs.get_smoke_config))
    want = [(p, tuple(s.shape), str(np.dtype(s.dtype)), s.init)
            for p, s in T.leaves(jax_build(jget(arch), tp=1).specs)]
    got = [(p, s.shape, str(s.dtype).removeprefix("torch."), s.init)
           for p, s in T.leaves(build(get(arch)).specs)]
    assert got == want
    assert encdec.MAX_DEC_POS == jax_ed.MAX_DEC_POS
