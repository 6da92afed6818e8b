"""The JAX package's numbers for ``chip_smoke.py`` phase 13a: the moe,
vlm, hybrid and encdec families at full width.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_families_targets.py [ARCH ...]

Each of llama4-scout-17b-a16e (depth cut to 1 layer: one MoE layer),
qwen2-vl-72b (depth 2), zamba2-2.7b (depth 12: two groups, so the shared
attention block runs twice) and whisper-tiny (all 4 + 4 layers) at full
width, weights from ``repro_torch.common.init_numpy(specs, seed=0)``, B = 2,
a 256-token prompt from ``np.random.default_rng(1)``,
``greedy_generate(steps=8, pad_to=264)``.  qwen2-vl's batch adds 128
vision embeddings (normal, from ``default_rng(3)``) and Qwen2-VL-style
M-RoPE positions: the patches on a (2, 8, 8) (t, h, w) grid, the text on
from the grid's largest position plus one, so the three rows differ.
whisper's adds 1500 frames of encoder embeddings (normal, from
``default_rng(3)``); its prefill is jitted (the port matches the JAX
package's jitted prefill; the eager one computes the encoder's sinusoidal
positions op by op and differs from the jitted one by itself).  The
targets: the greedy tokens, the top-1/top-2 logit margin at each
generated position, and the logits of the prefill and of the last decode
step (fed the JAX package's tokens) at a fixed sample of vocab indices;
for whisper also its sinusoidal positions and its first encoder layer's
output at samples (``encoder_targets`` says why its logits are not held).
Then the port runs on the CPU from the same weights and prints how far its
logits and tokens are from the JAX package's: what the tolerance in
``chip_smoke.py`` is set against.  One architecture is held at a time:
``jnp.asarray`` of a numpy array on the CPU does not copy, so the numpy,
JAX and torch weights are one copy (llama4-scout at depth 1: 4.27 B float32
parameters, 17.1 GB).

Prints the ``FAMILIES_TARGET`` constant for ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import pprint
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.common import DTypePolicy
from repro.configs import get_config as jax_get_config
from repro.models import encdec as jax_ed
from repro.models import layers as jax_layers
from repro.models.model import build as jax_build
from repro.serve.serve_step import cache_seq_axes as jax_cache_seq_axes
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro_torch.common import init_numpy
from repro_torch.configs import get_config
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.serve_step import _pad_seq, greedy_generate

DEPTHS = {"llama4-scout-17b-a16e": 1, "qwen2-vl-72b": 2, "zamba2-2.7b": 12,
          "whisper-tiny": None}  # None: the config's own depth
BATCH, PROMPT, STEPS, PAD_TO = 2, 256, 8, 264
WEIGHT_SEED, PROMPT_SEED, SAMPLE_SEED, INPUT_SEED, N_SAMPLE = 0, 1, 2, 3, 32
VISION_GRID = (2, 8, 8)  # 128 patches
N_FRAMES = 1500
N_POSITIONS, N_LAYER_SAMPLE = 64, 512  # whisper's sampled positions and layer-0 outputs


def qwen2_vl_positions(b, seq, grid):
    """M-RoPE positions (3, B, S): the patches at the leading positions on a
    (t, h, w) grid, one coordinate per row, then the text on all three rows
    from the grid's largest position plus one."""
    t, h, w = grid
    nv = t * h * w
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    vis = np.stack([tt.ravel(), hh.ravel(), ww.ravel()])
    text = np.arange(seq - nv) + vis.max() + 1
    pos = np.concatenate([vis, np.broadcast_to(text, (3, seq - nv))], axis=1)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, seq)).astype(np.int32))


def make_batch(cfg):
    """The prompt and the family's extra inputs, as numpy (float32 inputs
    enter both packages in bf16)."""
    batch = {"tokens": np.random.default_rng(PROMPT_SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)}
    rng = np.random.default_rng(INPUT_SEED)
    if cfg.family == "vlm":
        nv = int(np.prod(VISION_GRID))
        batch["vision_embeds"] = rng.standard_normal((BATCH, nv, cfg.d_model), np.float32)
        batch["mrope_pos"] = qwen2_vl_positions(BATCH, PROMPT, VISION_GRID)
    if cfg.family == "encdec":
        batch["enc_feats"] = rng.standard_normal((BATCH, N_FRAMES, cfg.d_model), np.float32)
    return batch


def margins(lg):
    """top-1 minus top-2 of (B, V) logits, in float32."""
    top2 = np.sort(np.asarray(lg, np.float32), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def pad_cache(jcfg, cache):
    """The JAX package's ``pad_to`` padding of a cache: each leaf's sequence
    axis (``cache_seq_axes``) zero-padded to PAD_TO."""
    axes = jax_cache_seq_axes(jcfg, cache, PROMPT, BATCH)
    flat, treedef = jax.tree.flatten(cache)

    def pad(x, ax):
        if ax is None:
            return x
        width = [(0, 0)] * x.ndim
        width[ax] = (0, PAD_TO - x.shape[ax])
        return jnp.pad(x, width)

    return jax.tree.unflatten(treedef, [pad(x, ax) for x, ax in zip(flat, axes)])


def decode_batch(cfg, toks, pos):
    db = {"tokens": toks[:, None].astype(np.int32)}
    if cfg.mrope:  # every row at the text position, as greedy_generate builds it
        db["mrope_pos"] = np.full((3, BATCH, 1), pos, np.int32)
    return db


def encoder_targets(jcfg, jm, weights, jbatch, jit_first):
    """whisper's encoder, where a full-width comparison can hold: its
    sinusoidal positions and its first layer on the JAX package's own
    input, at samples.  (At full width the model's logits cannot be held:
    the reference's init scales wq/wk by 1/sqrt(heads), so attention scores
    reach |s| ~ 100 and softmax rows are one-hot; an ulp anywhere flips
    near-tied rows, and over 1500 frames and four bidirectional layers every
    output moves.  The JAX package's eager and jitted prefills, which differ
    only in how the positions round, give logits this far apart.)"""
    jp = jax.tree.map(jnp.asarray, weights)
    rng = np.random.default_rng(SAMPLE_SEED)
    pos = np.asarray(jax_layers.sinusoidal_positions(N_FRAMES, jcfg.d_model))
    pos_idx = np.sort(rng.choice(pos.size, N_POSITIONS, replace=False))
    h0 = jbatch["enc_feats"] + jnp.asarray(pos).astype(jnp.bfloat16)[None]
    lp = jax.tree.map(lambda x: x[0], jp["enc_layers"])

    def layer(lp, x):  # the body of encode's scan
        a = jax_ed._bidir_attn(jcfg, lp["attn"], jax_layers.apply_norm(jcfg, lp["ln1"], x),
                               DTypePolicy())
        x = x + a
        return x + jax_layers.apply_mlp(jcfg, lp["mlp"],
                                        jax_layers.apply_norm(jcfg, lp["ln2"], x), DTypePolicy())

    out = np.asarray(jax.jit(layer)(lp, h0), np.float32)
    out_idx = np.sort(rng.choice(out.size, N_LAYER_SAMPLE, replace=False))
    _, eager = jm.prefill(jp, jbatch)
    spread = float(np.abs(np.asarray(eager[:, -1], np.float32) - jit_first).max())
    print(f"{jcfg.name}: the JAX package's eager and jitted prefill logits differ by "
          f"{spread} (|logits| up to {np.abs(jit_first).max()})", flush=True)
    return {"positions_idx": pos_idx.tolist(), "positions": pos.ravel()[pos_idx].tolist(),
            "layer0_idx": out_idx.tolist(), "layer0": out.ravel()[out_idx].tolist(),
            "jax_spread": spread}


def encoder_distance(cfg, params, batch, target):
    """The port's whisper positions and first encoder layer at the samples,
    against the targets: what POSITIONS_TOL and LAYER_TOL are set against."""
    from repro_torch.common import DTypePolicy as TorchPolicy
    from repro_torch.models import encdec, layers
    from repro_torch.tree import tree_map

    pos = layers.sinusoidal_positions(N_FRAMES, cfg.d_model).flatten()
    pos_err = np.abs(pos[target["positions_idx"]].numpy() - np.array(target["positions"]))
    h0 = encdec.encoder_input(cfg, batch["enc_feats"], TorchPolicy())
    out = encdec.enc_layer(cfg, tree_map(lambda x: x[0], params["enc_layers"]), h0,
                           TorchPolicy()).float().flatten()[target["layer0_idx"]].numpy()
    ref = np.array(target["layer0"])
    past = np.abs(out - ref) > 0.0625 + 0.02 * np.abs(ref)
    print(f"{cfg.name}: port on the CPU, positions off by {pos_err.max()} at the sample; "
          f"first encoder layer: {past.mean():.4%} of the sample past rtol 0.02 / atol 0.0625, "
          f"median |diff| {np.median(np.abs(out - ref))}", flush=True)


def lm_target(arch):
    cfg = get_config(arch)
    if DEPTHS[arch] is not None:
        cfg = dataclasses.replace(cfg, n_layers=DEPTHS[arch])
    jcfg = dataclasses.replace(jax_get_config(arch), n_layers=cfg.n_layers)
    model = build(cfg)
    t0 = time.time()
    weights = init_numpy(model.specs, seed=WEIGHT_SEED)
    batch = make_batch(cfg)
    sample = np.sort(np.random.default_rng(SAMPLE_SEED).choice(
        cfg.vocab_size, N_SAMPLE, replace=False))
    n_params = sum(x.size for x in jax.tree.leaves(weights))
    print(f"{arch} depth {cfg.n_layers}: {n_params} parameters, weights and inputs made in "
          f"{time.time() - t0:.1f} s", flush=True)

    jm = jax_build(jcfg, tp=1)
    jp = jax.tree.map(jnp.asarray, weights)  # no copy on the CPU
    jbatch = {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32 else jnp.asarray(v)
              for k, v in batch.items()}
    t0 = time.time()
    prefill = jax.jit(jm.prefill) if cfg.family == "encdec" else jm.prefill
    cache, lg = prefill(jp, jbatch)
    cache = pad_cache(jcfg, cache)
    first = np.asarray(lg[:, -1], np.float32)
    toks, marg = [np.argmax(first, axis=-1)], [margins(first)]
    step = jax.jit(jm.decode_step)
    last = first
    for i in range(STEPS - 1):
        db = {k: jnp.asarray(v) for k, v in decode_batch(cfg, toks[-1], PROMPT + i).items()}
        lg, cache = step(jp, cache, db, jnp.int32(PROMPT + i))
        last = np.asarray(lg[:, -1], np.float32)
        toks.append(np.argmax(last, axis=-1))
        marg.append(margins(last))
    toks, marg = np.stack(toks, 1).astype(np.int32), np.stack(marg, 1)
    if cfg.family != "encdec":  # the same loop as greedy_generate
        greedy = np.asarray(jax_greedy(jm, jp, jbatch, steps=STEPS, pad_to=PAD_TO))
        assert (greedy == toks).all(), (greedy, toks)
    print(f"{arch}: JAX package, prefill + {STEPS - 1} decode steps in "
          f"{time.time() - t0:.1f} s", flush=True)
    del jp, cache, step, lg
    gc.collect()
    target = {"tokens": toks.tolist(), "margins": marg.tolist(), "sample": sample.tolist(),
              "prefill_logits": first[:, sample].tolist(),
              "last_logits": last[:, sample].tolist()}
    if cfg.family == "encdec":
        target.update(encoder_targets(jcfg, jm, weights, jbatch, first))

    # the port on the CPU from the same weights: the distance the tolerance covers
    t0 = time.time()
    params = params_from_numpy(model.specs, weights, "cpu")
    tb = {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
          else torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        port_toks = greedy_generate(model, params, tb, steps=STEPS, pad_to=PAD_TO).numpy()
        pcache, plg = model.prefill(params, tb)
        err = np.abs(plg[:, -1].float().numpy() - first)
        pcache = _pad_seq(cfg, pcache, PROMPT, BATCH, PAD_TO)
        for i in range(STEPS - 1):  # fed the JAX package's tokens
            db = {k: torch.from_numpy(v) for k, v in decode_batch(cfg, toks[:, i],
                                                                  PROMPT + i).items()}
            plg, pcache = model.decode_step(params, pcache, db, PROMPT + i)
        if cfg.family == "encdec":
            encoder_distance(cfg, params, tb, target)
    last_err = np.abs(plg[:, -1].float().numpy() - last)
    print(f"{arch}: port on the CPU ({time.time() - t0:.1f} s): logits max |diff| "
          f"{err.max()} (prefill) and {last_err.max()} (last decode step) over the whole "
          f"vocab, mean {err.mean()} and {last_err.mean()}; {err[:, sample].max()} and "
          f"{last_err[:, sample].max()} at the sample, mean {err[:, sample].mean()} and "
          f"{last_err[:, sample].mean()} (|logits| up to {np.abs(first).max()}); tokens equal "
          f"at {int((port_toks == toks).sum())} of {toks.size} positions; JAX margins "
          f"{marg.min()} at the smallest", flush=True)
    return target


def main(archs):
    target = {}
    for arch in archs or DEPTHS:
        target[arch] = lm_target(arch)
        gc.collect()
    print("FAMILIES_TARGET = ", end="")
    pprint.pprint(target, width=100, compact=True)


if __name__ == "__main__":
    main(sys.argv[1:])
