"""Decoder-only LM assembly, the ssm family (counterpart of
``repro/models/transformer.py``).

Parameters keep the JAX package's stacked layout (a leading layer axis on
every leaf of ``params["layers"]``), and ``forward`` walks that axis with a
Python loop where the JAX code runs ``lax.scan``.  The cache is stacked the
same way: ``{"layers": {"conv": (L, B, K-1, d_inner), "ssm": (L, B,
d_inner, N)}}``.  Modes ``prefill`` and ``decode``; training and every
other family (dense, MoE, hybrid, VLM) are ROADMAP module item 13.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as T
from repro_torch.common import ParamSpec, spec_map
from repro_torch.models import layers as L
from repro_torch.models.ssm import mamba1_specs, mamba2_specs, ssm_block


def _family_missing(what):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP module item 13 "
                               "(LM stack); the port runs the ssm family's prefill "
                               "and decode")


def stack_specs(tree, n: int):
    """Prepend a layer axis of size n to every spec in the tree."""
    return spec_map(lambda s: ParamSpec((n,) + s.shape, s.dtype, init=s.init), tree)


def _ssm_layer_specs(cfg):
    sfn = mamba1_specs if cfg.ssm.version == 1 else mamba2_specs
    return {"ln": L.norm_specs(cfg), "ssm": sfn(cfg)}


def decoder_specs(cfg):
    if cfg.family != "ssm":
        raise _family_missing(f"the {cfg.family} family")
    s = {"embed": L.embed_specs(cfg), "final_norm": L.norm_specs(cfg)}
    s.update(L.logits_specs(cfg))  # adds "w" unless tied
    s["layers"] = stack_specs(_ssm_layer_specs(cfg), cfg.n_layers)
    return s


def ssm_layer(cfg, p, x, policy, state=None):
    y, new_state = ssm_block(cfg, p["ssm"], L.apply_norm(cfg, p["ln"], x), policy,
                             state=state)
    return x + y, new_state


def _embed_and_angles(cfg, params, batch, policy, mode, pos):
    if not cfg.attn_free:
        raise _family_missing("rotary angles (attention families)")
    h = L.embed(params["embed"], batch["tokens"], policy) * math.sqrt(cfg.d_model)
    return h, None


def forward(cfg, params, batch, policy, *, mode, cache=None, pos=None):
    """Core forward.  Returns (hidden, new_cache, aux_loss)."""
    if cfg.family != "ssm":
        raise _family_missing(f"the {cfg.family} family")
    if mode not in ("prefill", "decode"):
        raise _family_missing(f"mode {mode!r} (training, train/*)")
    h, _ = _embed_and_angles(cfg, params, batch, policy, mode, pos)
    states = []
    for i in range(cfg.n_layers):
        lp = T.tree_map(lambda x: x[i], params["layers"])
        st = None if cache is None else T.tree_map(lambda x: x[i], cache["layers"])
        h, st_out = ssm_layer(cfg, lp, h, policy, state=st)
        states.append(st_out)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _finish(cfg, params, h), {"layers": T.stack(states)}, aux


def _finish(cfg, params, h):
    return L.apply_norm(cfg, params["final_norm"], h)


def lm_logits(cfg, params, h, policy):
    head = {"w": params["w"]} if "w" in params else {}
    return L.logits(cfg, head, params["embed"], h, policy)
