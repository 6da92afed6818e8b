"""The JAX package's numbers for ``chip_smoke.py`` phase 16a: llama4-scout's
expert-parallel serving on a mesh of one device, the mesh one H100 gives.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_mesh_targets.py

llama4-scout-17b-a16e at full width, depth cut to 1 (one MoE layer of 16
experts, top-1), the weights, prompt and vocab sample of phase 13a
(``scripts/lm_families_targets.py``): ``repro_torch.common.init_numpy(specs,
seed=0)``, B = 2, a 256-token prompt from ``np.random.default_rng(1)``, 32
vocab indices from ``default_rng(2)``.  The JAX package serves it on a
one-device ("data", "model") mesh: its prefill takes ``ep_moe`` (512 routed
tokens, dropless) and its decode steps ``ep_moe_decode``; 4 greedy steps,
the cache padded to 264.  The targets: the greedy tokens, the top-1/top-2
logit margins, and the logits at the sample of the prefill and of the last
decode step (fed the JAX package's tokens).  Then two distances, for the
tolerance in ``chip_smoke.py``: the JAX package's own, between these logits
and its no-mesh (``dense_moe``) run's; and the port's on the CPU, serving on
a mesh of one (an in-process gloo world of 1) from the same weights.  The
numpy, JAX and torch weights are one copy (``jnp.asarray`` and
``torch.from_numpy`` of a numpy array do not copy on the CPU): 4.27 B float32
parameters, 17.1 GB; about 2 minutes.

Prints the ``LM_MESH_TARGET`` constant.
"""
from __future__ import annotations

import dataclasses
import pprint
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.models.model import build as jax_build
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro_torch.common import init_numpy
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.serve_step import _pad_seq, decode_batch

ARCH = "llama4-scout-17b-a16e"
DEPTH, BATCH, PROMPT, STEPS, PAD_TO = 1, 2, 256, 4, 264
WEIGHT_SEED, PROMPT_SEED, SAMPLE_SEED, N_SAMPLE = 0, 1, 2, 32


def margins(lg):
    top2 = np.sort(np.asarray(lg, np.float32), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def pad_cache(jcfg, cache):
    from repro.serve.serve_step import cache_seq_axes

    axes = cache_seq_axes(jcfg, cache, PROMPT, BATCH)
    flat, treedef = jax.tree.flatten(cache)

    def pad(x, ax):
        if ax is None:
            return x
        width = [(0, 0)] * x.ndim
        width[ax] = (0, PAD_TO - x.shape[ax])
        return jnp.pad(x, width)

    return jax.tree.unflatten(treedef, [pad(x, ax) for x, ax in zip(flat, axes)])


def jax_serve(jm, jp, tokens, mesh):
    """Greedy tokens, margins and the prefill's and last decode step's
    logits (B, V), float32; ``mesh`` None for the no-mesh run."""
    cache, lg = jm.prefill(jp, {"tokens": tokens}, mesh=mesh)
    cache = pad_cache(jm.cfg, cache)
    first = np.asarray(lg[:, -1], np.float32)
    toks, marg, last = [np.argmax(first, axis=-1)], [margins(first)], first
    step = jax.jit(lambda p, c, b, pos: jm.decode_step(p, c, b, pos, mesh=mesh))
    for i in range(STEPS - 1):
        lg, cache = step(jp, cache, {"tokens": jnp.asarray(toks[-1][:, None], jnp.int32)},
                         jnp.int32(PROMPT + i))
        last = np.asarray(lg[:, -1], np.float32)
        toks.append(np.argmax(last, axis=-1))
        marg.append(margins(last))
    return np.stack(toks, 1).astype(np.int32), np.stack(marg, 1), first, last


def main():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=DEPTH)
    jcfg = dataclasses.replace(jax_get_config(ARCH), n_layers=DEPTH)
    model = build(cfg)
    t0 = time.time()
    weights = init_numpy(model.specs, seed=WEIGHT_SEED)
    tokens = np.random.default_rng(PROMPT_SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    sample = np.sort(np.random.default_rng(SAMPLE_SEED).choice(
        cfg.vocab_size, N_SAMPLE, replace=False))
    print(f"{ARCH} depth {DEPTH}: weights and prompt made in {time.time() - t0:.1f} s",
          flush=True)

    jm = jax_build(jcfg, tp=1)
    jp = jax.tree.map(jnp.asarray, weights)
    jmesh = compat.make_mesh((1, 1), ("data", "model"))
    t0 = time.time()
    with compat.set_mesh(jmesh):
        toks, marg, first, last = jax_serve(jm, jp, jnp.asarray(tokens), jmesh)
        greedy = np.asarray(jax_greedy(jm, jp, {"tokens": jnp.asarray(tokens)}, steps=STEPS,
                                       mesh=jmesh, pad_to=PAD_TO))
    assert (greedy == toks).all(), (greedy, toks)
    print(f"JAX package on its one-device mesh: prefill + {STEPS - 1} decode steps in "
          f"{time.time() - t0:.1f} s", flush=True)
    dtoks, _, dfirst, dlast = jax_serve(jm, jp, jnp.asarray(tokens), None)
    own = [np.abs(first - dfirst), np.abs(last - dlast)]
    print(f"the JAX package's own mesh against no-mesh (dense_moe) logits: max |diff| "
          f"{own[0].max()} (prefill) and {own[1].max()} (last decode step), mean "
          f"{own[0].mean()} and {own[1].mean()}; at the sample {own[0][:, sample].max()} and "
          f"{own[1][:, sample].max()}; tokens equal at {int((dtoks == toks).sum())} of "
          f"{toks.size} (|logits| up to {np.abs(first).max()}; margins {marg.min()} at the "
          f"smallest)", flush=True)
    del jp
    target = {"tokens": toks.tolist(), "margins": marg.tolist(), "sample": sample.tolist(),
              "prefill_logits": first[:, sample].tolist(),
              "last_logits": last[:, sample].tolist(),
              "jax_own": [float(own[0][:, sample].max()), float(own[1][:, sample].max())]}

    # the port on the CPU, on a mesh of one: the distance the tolerance covers
    t0 = time.time()
    params = params_from_numpy(model.specs, weights, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        M.init_world(f"file://{tmp}/rendezvous", 0, 1, device="cpu")
        try:
            mesh = M.make_test_mesh(1, 1, device="cpu")
            with torch.no_grad():
                tb = {"tokens": torch.from_numpy(tokens)}
                pcache, plg = model.prefill(params, tb, mesh=mesh)
                err = np.abs(plg[:, -1].float().numpy() - first)
                pcache = _pad_seq(cfg, pcache, PROMPT, BATCH, PAD_TO)
                for i in range(STEPS - 1):  # fed the JAX package's tokens
                    db = decode_batch(cfg, torch.from_numpy(toks[:, i:i + 1]), PROMPT + i)
                    plg, pcache = model.decode_step(params, pcache, db, PROMPT + i, mesh=mesh)
        finally:
            dist.destroy_process_group()
    last_err = np.abs(plg[:, -1].float().numpy() - last)
    print(f"the port on the CPU on a mesh of one ({time.time() - t0:.1f} s): logits max |diff| "
          f"{err.max()} (prefill) and {last_err.max()} (last decode step), mean {err.mean()} "
          f"and {last_err.mean()}; at the sample {err[:, sample].max()} and "
          f"{last_err[:, sample].max()}", flush=True)
    target["port_cpu"] = [float(err[:, sample].max()), float(last_err[:, sample].max())]
    print("LM_MESH_TARGET = ", end="")
    pprint.pprint(target, width=100, compact=True)


if __name__ == "__main__":
    main()
