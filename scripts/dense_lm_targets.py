"""The JAX package's numbers for ``chip_smoke.py`` phase 12: the dense LM
family and ``vp/workloads.from_arch``'s crossbar tiles.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/dense_lm_targets.py

12a: each of qwen3-1.7b, internlm2-1.8b, stablelm-12b and granite-34b at
full width with depth cut to 2 layers, weights from
``repro_torch.common.init_numpy(specs, seed=0)``, B = 2, a 256-token prompt
from ``np.random.default_rng(1)``, ``greedy_generate(steps=8, pad_to=264)``:
the greedy tokens, the top-1/top-2 logit margin at each generated
position, and the logits of the prefill and of the last decode step (fed
the JAX package's tokens) at a fixed sample of vocab indices.  Then the
port runs on the CPU from the same weights and prints how far its logits
and tokens are from the JAX package's: what the tolerance in
``chip_smoke.py`` is set against.  One architecture's numpy, JAX and torch
weights are held at a time (granite-34b at depth 2: 1.36 B float32
parameters, 5.4 GB a copy).

12c: each of ``from_arch("qwen3-1.7b")``'s eight 256x256x8 tiles as the
dense benchmark builds it (uniform offload, cim mode, quantum = channel
latency = 10,000, ``check_every=2``, the ``vmap`` backend): rounds,
simulated cycles, instructions per segment and CIM ops.

Prints the ``DENSE_TARGET`` constant for ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import pprint
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.core import segmentation as jsg
from repro.core.controller import Controller as JController
from repro.models.model import build as jax_build
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro.vp import workloads as jwl
from repro_torch.common import init_numpy
from repro_torch.configs import get_config
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.serve_step import _pad_seq, greedy_generate

ARCHS = ["qwen3-1.7b", "internlm2-1.8b", "stablelm-12b", "granite-34b"]
LAYERS, BATCH, PROMPT, STEPS, PAD_TO = 2, 2, 256, 8, 264
WEIGHT_SEED, PROMPT_SEED, SAMPLE_SEED, N_SAMPLE = 0, 1, 2, 32
TILE_ARCH, QUANTUM = "qwen3-1.7b", 10_000


def margins(lg):
    """top-1 minus top-2 of (B, V) logits, in float32."""
    top2 = np.sort(np.asarray(lg, np.float32), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def pad_cache(cache):
    """The JAX package's ``pad_to`` padding of a dense KV cache (L, B, S, H, D)."""
    return jax.tree.map(lambda x: jnp.pad(
        x, [(0, 0), (0, 0), (0, PAD_TO - x.shape[2]), (0, 0), (0, 0)]), cache)


def lm_target(arch):
    cfg = dataclasses.replace(get_config(arch), n_layers=LAYERS)
    model = build(cfg)
    t0 = time.time()
    weights = init_numpy(model.specs, seed=WEIGHT_SEED)
    tokens = np.random.default_rng(PROMPT_SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    sample = np.sort(np.random.default_rng(SAMPLE_SEED).choice(
        cfg.vocab_size, N_SAMPLE, replace=False))
    print(f"{arch}: weights and prompt made in {time.time() - t0:.1f} s", flush=True)

    jm = jax_build(dataclasses.replace(jax_get_config(arch), n_layers=LAYERS), tp=1)
    jp = jax.tree.map(jnp.asarray, weights)
    t0 = time.time()
    cache, lg = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    cache = pad_cache(cache)
    prefill = np.asarray(lg[:, -1], np.float32)
    toks, marg = [np.argmax(prefill, axis=-1)], [margins(prefill)]
    step = jax.jit(jm.decode_step)
    for i in range(STEPS - 1):
        lg, cache = step(jp, cache, {"tokens": jnp.asarray(toks[-1][:, None], jnp.int32)},
                         jnp.int32(PROMPT + i))
        last = np.asarray(lg[:, -1], np.float32)
        toks.append(np.argmax(last, axis=-1))
        marg.append(margins(last))
    toks, marg = np.stack(toks, 1), np.stack(marg, 1)
    greedy = np.asarray(jax_greedy(jm, jp, {"tokens": jnp.asarray(tokens)}, steps=STEPS,
                                   pad_to=PAD_TO))
    assert (greedy == toks).all(), (greedy, toks)  # the same loop as greedy_generate
    print(f"{arch}: JAX package, prefill + {STEPS - 1} decode steps, twice, in "
          f"{time.time() - t0:.1f} s", flush=True)
    del jp, cache, step, greedy
    gc.collect()
    target = {"tokens": toks.tolist(), "margins": marg.tolist(), "sample": sample.tolist(),
              "prefill_logits": prefill[:, sample].tolist(),
              "last_logits": last[:, sample].tolist()}

    # the port on the CPU from the same weights: the distance the tolerance covers
    t0 = time.time()
    params = params_from_numpy(model.specs, weights, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    port_toks = greedy_generate(model, params, batch, steps=STEPS, pad_to=PAD_TO).numpy()
    pcache, plg = model.prefill(params, batch)
    err = np.abs(plg[:, -1].float().numpy() - prefill)
    pcache = _pad_seq(cfg, pcache, PROMPT, BATCH, PAD_TO)
    for i in range(STEPS - 1):  # fed the JAX package's tokens
        plg, pcache = model.decode_step(
            params, pcache, {"tokens": torch.from_numpy(toks[:, i:i + 1]).int()}, PROMPT + i)
    last_err = np.abs(plg[:, -1].float().numpy() - last)
    print(f"{arch}: port on the CPU ({time.time() - t0:.1f} s): logits max |diff| "
          f"{err.max()} (prefill) and {last_err.max()} (last decode step) over the whole "
          f"vocab, mean {err.mean()} and {last_err.mean()}; {err[:, sample].max()} and "
          f"{last_err[:, sample].max()} at the sample, mean {err[:, sample].mean()} and "
          f"{last_err[:, sample].mean()} (|logits| up to {np.abs(prefill).max()}); tokens equal at "
          f"{int((port_toks == toks).sum())} of {toks.size} positions; smallest JAX "
          f"margin {marg.min()}", flush=True)
    return target


def tile_targets():
    """rounds, max sim_time, instrs per segment, CIM ops of each tile."""
    out = []
    for layer in jwl.from_arch(TILE_ARCH):
        t0 = time.time()
        descs = jsg.uniform(2, 2)
        job = jwl.cim_workload(layer, mgr_segments=[0, 1], cim_ids_per_mgr={0: (0, 1), 1: (2, 3)},
                               ordinals=jsg.mailbox_ordinals(descs))
        cfg, states, pending = jsg.build(descs, programs=job["programs"], dram_words=job["dram"],
                                         channel_latency=QUANTUM, crossbars=job["crossbars"],
                                         scratch_init=job["scratch"])
        ctl = JController(cfg, states, pending, backend="vmap", quantum=QUANTUM)
        ctl.run(max_rounds=2000, check_every=2)
        st = jax.tree.map(np.asarray, ctl.result_states())
        o = st["dram"]["data"][0][job["o_word"]: job["o_word"] + layer.h * layer.p]
        assert np.array_equal(o.reshape(layer.h, layer.p), job["expected"]), layer.name
        got = [layer.layer, ctl.rounds_run, int(st["time"].max()),
               [int(x) for x in st["stats"]["instrs"]], int(st["cims"]["ops"].sum())]
        print(f"{layer.name}: {got[1:]} in {time.time() - t0:.1f} s", flush=True)
        out.append(got)
    return out


def main():
    target = {arch: lm_target(arch) for arch in ARCHS}
    gc.collect()
    target["from_arch"] = tile_targets()
    print("DENSE_TARGET = ", end="")
    pprint.pprint(target, width=100, compact=True)


if __name__ == "__main__":
    main()
