"""The JAX package's training numbers for ``chip_smoke.py`` phase 14b.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_targets.py [ARCH ...]

qwen3-1.7b and falcon-mamba-7b at full width with depth cut to 2 layers,
weights from ``repro_torch.common.init_numpy(specs, seed=0)``, a batch of
B = 2 sequences of 256 tokens (``train.data.batch_at`` at step 0, seed 7,
the launcher's data): ``jax.value_and_grad`` of ``model.loss`` gives the
loss, ce and the gradient at fixed entries of a few leaves; one jitted
``make_train_step`` step (AdamW, ``OPT``) gives grad_norm, lr and the same
entries of the params after the step.  The entries: per leaf, SAMPLE
flat indices from ``np.random.default_rng(2)``; for the embedding table
its rows of the batch's first tokens, since the other rows' gradient is
zero.  Then the port runs the same on the CPU from the same weights and
prints how far it is from the JAX package: what the tolerances in
``chip_smoke.py`` (``TRAIN_TOL``) are set against.  One architecture is
held at a time (falcon at depth 2: 0.48 B float32 parameters; with
gradients and moments on both sides ~15 GB).

Prints the ``TRAIN_TARGET`` constant for ``chip_smoke.py``.
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

from repro.common import init_params as jax_init_params
from repro.configs import get_config as jax_get_config
from repro.models.model import build as jax_build
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import tree as T
from repro_torch.common import init_numpy, init_params
from repro_torch.configs import get_config
from repro_torch.models.model import build, params_from_numpy
from repro_torch.train import optimizer, train_step
from repro_torch.train.data import DataConfig, batch_at

ARCHS = ["qwen3-1.7b", "falcon-mamba-7b"]
LAYERS, BATCH, SEQ, WEIGHT_SEED, DATA_SEED, SAMPLE = 2, 2, 256, 0, 7, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
LEAVES = {"qwen3-1.7b": ["/embed/table", "/layers/attn/wq", "/layers/attn/wo",
                         "/layers/mlp/w_gate", "/layers/ln1/scale", "/final_norm/scale"],
          "falcon-mamba-7b": ["/embed/table", "/layers/ssm/in_proj", "/layers/ssm/x_proj",
                              "/layers/ssm/dt_proj", "/layers/ssm/a_log",
                              "/layers/ssm/d_skip", "/layers/ssm/conv_w"]}


def sample_indices(shape, path, tokens):
    """Fixed flat indices into a leaf of ``shape`` (see the module doc)."""
    rng = np.random.default_rng(2)
    if path == "/embed/table":
        rows = tokens[0, :SAMPLE].astype(np.int64)
        return rows * shape[1] + rng.integers(0, shape[1], SAMPLE)
    return rng.choice(int(np.prod(shape)), SAMPLE, replace=False)


def pick(x, idx):
    return np.asarray(x, np.float32).reshape(-1)[idx]


def arch_target(arch):
    cfg = dataclasses.replace(get_config(arch), n_layers=LAYERS)
    model = build(cfg)
    t0 = time.time()
    weights = init_numpy(model.specs, seed=WEIGHT_SEED)
    tokens = batch_at(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=DATA_SEED), 0)["tokens"].numpy()
    shapes = {p: s.shape for p, s in T.leaves(model.specs)}
    idx = {p: sample_indices(shapes[p], p, tokens) for p in LEAVES[arch]}
    print(f"{arch}: weights and batch made in {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    jm = jax_build(dataclasses.replace(jax_get_config(arch), n_layers=LAYERS), tp=1)
    jp = jax.tree.map(jnp.asarray, T.tree_map(np.copy, weights))
    jb = {"tokens": jnp.asarray(tokens)}
    (loss, met), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    jgrads = dict(T.leaves(grads))
    target = {"loss": float(loss), "ce": float(met["ce"]), "indices": {},
              "grads": {}, "params_after": {}}
    for p in LEAVES[arch]:
        target["indices"][p] = [int(i) for i in idx[p]]
        target["grads"][p] = pick(jgrads[p], idx[p]).tolist()
    del grads, jgrads
    joc = jopt.OptConfig(**OPT)
    jstate = {"params": jp, "opt": jax_init_params(jax.random.PRNGKey(1),
                                                   jts.state_specs(jm, joc)["opt"])}
    jstate, jmet = jax.jit(jts.make_train_step(jm, joc))(jstate, jb)
    target["grad_norm"], target["lr"] = float(jmet["grad_norm"]), float(jmet["lr"])
    assert abs(float(jmet["loss"]) - target["loss"]) <= 1e-6 * abs(target["loss"])
    jafter = dict(T.leaves(jstate["params"]))
    for p in LEAVES[arch]:
        target["params_after"][p] = pick(jafter[p], idx[p]).tolist()
    print(f"{arch}: JAX package, value_and_grad and one train step in {time.time() - t0:.1f} s; "
          f"loss {target['loss']}, grad_norm {target['grad_norm']}", flush=True)
    del jp, jstate, jafter
    gc.collect()

    # the port on the CPU from the same weights: the distance the tolerance covers
    t0 = time.time()
    oc = optimizer.OptConfig(**OPT)
    state = {"params": params_from_numpy(model.specs, weights, "cpu"),
             "opt": init_params(train_step.state_specs(model, oc)["opt"], torch.Generator(),
                                "cpu")}
    _, _, pgrads = train_step._value_and_grad(model, state["params"],
                                              {"tokens": torch.from_numpy(tokens)})
    pgrads = dict(T.leaves(pgrads))
    state, m = train_step.make_train_step(model, oc)(state, {"tokens": torch.from_numpy(tokens)})
    after = dict(T.leaves(state["params"]))
    dist = {"loss": abs(float(m["loss"]) - target["loss"]) / abs(target["loss"]),
            "ce": abs(float(m["ce"]) - target["ce"]) / abs(target["ce"]),
            "grad_norm": abs(float(m["grad_norm"]) - target["grad_norm"]) / target["grad_norm"],
            "grads": {}, "params_after": {}}
    for p in LEAVES[arch]:
        want = np.array(target["grads"][p])
        got = pick(pgrads[p].float(), idx[p])
        dist["grads"][p] = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))
        want = np.array(target["params_after"][p])
        got = pick(after[p].float(), idx[p])
        dist["params_after"][p] = float(np.abs(got - want).max() / target["lr"])
    print(f"{arch}: port on the CPU ({time.time() - t0:.1f} s): loss, ce, grad_norm "
          f"relative distance {dist['loss']}, {dist['ce']}, {dist['grad_norm']}; sampled "
          f"gradients, max |diff| over the sample's largest |grad|: {dist['grads']}; params "
          f"after the step, max |diff| in units of lr: {dist['params_after']}", flush=True)
    target["port_cpu_distance"] = dist
    return target


def main(argv):
    out = {}
    for arch in argv or ARCHS:
        out[arch] = arch_target(arch)
        gc.collect()
    print("TRAIN_TARGET = ", end="")
    pprint.pprint(out, width=100, compact=True)


if __name__ == "__main__":
    main(sys.argv[1:])
