"""The JAX package's numbers for ``chip_smoke.py`` phase 8b: falcon-mamba-7b
at full width with depth cut to 2 layers, weights from
``repro_torch.common.init_numpy(specs, seed=0)``, B = 2, a 256-token prompt
from ``np.random.default_rng(1)``, ``greedy_generate(steps=8)``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/falcon_mamba_targets.py

Prints the ``FALCON_TARGET`` constant for ``chip_smoke.py``: the JAX
package's greedy tokens, the top-1/top-2 logit margin at each generated
position, and the logits of the prefill and of the last decode step at a
fixed sample of vocab indices.  Then
it runs the port on the CPU from the same weights and prints how far its
logits and tokens are from the JAX package's, which is what the tolerance
in ``chip_smoke.py`` is set against.  Needs about 10 GB of host memory.
"""
from __future__ import annotations

import dataclasses
import pprint
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build as jax_build
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro_torch.common import init_numpy
from repro_torch.configs import get_config
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.serve_step import greedy_generate

ARCH = "falcon-mamba-7b"
LAYERS, BATCH, PROMPT, STEPS = 2, 2, 256, 8
WEIGHT_SEED, PROMPT_SEED, SAMPLE_SEED, N_SAMPLE = 0, 1, 2, 32


def margins(lg):
    """top-1 minus top-2 of (B, V) logits, in float32."""
    top2 = np.sort(np.asarray(lg, np.float32), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def main():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    model = build(cfg)
    t0 = time.time()
    weights = init_numpy(model.specs, seed=WEIGHT_SEED)
    tokens = np.random.default_rng(PROMPT_SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    sample = np.sort(np.random.default_rng(SAMPLE_SEED).choice(
        cfg.vocab_size, N_SAMPLE, replace=False))
    print(f"weights and prompt made in {time.time() - t0:.1f} s", flush=True)

    jcfg = dataclasses.replace(jax_get_config(ARCH), n_layers=LAYERS)
    jm = jax_build(jcfg, tp=1)
    jp = jax.tree.map(jnp.asarray, weights)
    t0 = time.time()
    cache, lg = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
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
    greedy = np.asarray(jax_greedy(jm, jp, {"tokens": jnp.asarray(tokens)}, steps=STEPS))
    assert (greedy == toks).all(), (greedy, toks)  # the same loop as greedy_generate
    print(f"JAX package: prefill + {STEPS - 1} decode steps, twice, in "
          f"{time.time() - t0:.1f} s", flush=True)
    del jp, cache, step

    target = {"tokens": toks.tolist(), "margins": marg.tolist(),
              "sample": sample.tolist(), "prefill_logits": prefill[:, sample].tolist(),
              "last_logits": last[:, sample].tolist()}
    print("FALCON_TARGET = ", end="")
    pprint.pprint(target, width=100, compact=True)

    # the port on the CPU from the same weights: the distance the tolerance covers
    params = params_from_numpy(model.specs, weights, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    port_toks = greedy_generate(model, params, batch, steps=STEPS).numpy()
    pcache, plg = model.prefill(params, batch)
    err = np.abs(plg[:, -1].float().numpy() - prefill)
    for i in range(STEPS - 1):  # fed the JAX package's tokens
        plg, pcache = model.decode_step(
            params, pcache, {"tokens": torch.from_numpy(toks[:, i:i + 1]).int()}, PROMPT + i)
    last_err = np.abs(plg[:, -1].float().numpy() - last)
    print(f"port on the CPU: logits max |diff| {err.max()} (prefill) and "
          f"{last_err.max()} (last decode step) over the whole vocab, "
          f"{err[:, sample].max()} and {last_err[:, sample].max()} at the sample; "
          f"tokens equal at "
          f"{int((port_toks == toks).sum())} of {toks.size} positions; "
          f"smallest JAX margin {marg.min()}")


if __name__ == "__main__":
    main()
