"""Decoder-only LM assembly, the ssm and dense families (counterpart of
``repro/models/transformer.py``).

Parameters keep the JAX package's stacked layout (a leading layer axis on
every leaf of ``params["layers"]``), and ``forward`` walks that axis with a
Python loop where the JAX code runs ``lax.scan``.  The cache is stacked the
same way:
  ssm:   ``{"layers": {"conv": (L, B, K-1, d_inner), "ssm": (L, B, d_inner, N)}}``
  dense: ``{"layers": (k, v)}``, each (L, B, S, Hkv, Dh) bf16.
Modes ``prefill`` (chunked flash attention, returns the KV entries) and
``decode`` (grouped-query attention against the cache).  Training is
ROADMAP module item 13c; the moe, hybrid and vlm families are item 13b's
steps 3-5.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as T
from repro_torch.common import ParamSpec, spec_map
from repro_torch.configs.base import PORTED
from repro_torch.models import layers as L
from repro_torch.models.ssm import mamba1_specs, mamba2_specs, ssm_block

_F32 = torch.float32
# the ROADMAP step that brings each family the port does not build
FAMILY_STEPS = {"moe": "13b step 3 (models/moe.py)",
                "hybrid": "13b step 4 (Mamba-2/SSD)",
                "vlm": "13b step 5 (M-RoPE)",
                "encdec": "13b step 6 (models/encdec.py)"}


def family_missing(family, what=None):
    step = FAMILY_STEPS.get(family, "13b")
    return NotImplementedError(f"{what or f'the {family} family'} is not ported yet: "
                               f"ROADMAP module item {step}; the port runs the ssm "
                               "(Mamba-1) and dense families' prefill and decode")


def stack_specs(tree, n: int):
    """Prepend a layer axis of size n to every spec in the tree."""
    return spec_map(lambda s: ParamSpec((n,) + s.shape, s.dtype, init=s.init), tree)


def _dense_layer_specs(cfg):
    return {
        "ln1": L.norm_specs(cfg),
        "attn": L.attn_specs(cfg),
        "ln2": L.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg),
    }


def _ssm_layer_specs(cfg):
    sfn = mamba1_specs if cfg.ssm.version == 1 else mamba2_specs
    return {"ln": L.norm_specs(cfg), "ssm": sfn(cfg)}


def decoder_specs(cfg):
    if cfg.family not in PORTED:
        raise family_missing(cfg.family)
    s = {"embed": L.embed_specs(cfg), "final_norm": L.norm_specs(cfg)}
    s.update(L.logits_specs(cfg))  # adds "w" unless tied
    if cfg.family == "dense":
        s["layers"] = stack_specs(_dense_layer_specs(cfg), cfg.n_layers)
    else:
        s["layers"] = stack_specs(_ssm_layer_specs(cfg), cfg.n_layers)
    return s


# ---------------------------------------------------------------------------
# sub-block applications


def _grouped_decode_attention(q, k_cache, v_cache, length):
    """q (B,1,Hq,Dh) vs cache (B,Smax,Hkv,Dh); no kv expansion (GQA grouped:
    q head h = kv head h // G, member h % G)."""
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, dh)
    s = L.scores(qg, k_cache, "bqhgd,bkhd->bhgqk")
    mask = torch.arange(k_cache.shape[1], device=q.device)[None, None, None, None, :] < length
    s = torch.where(mask, s, -torch.inf)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache)
    return o.reshape(b, 1, hq, dh)


def attn_apply(cfg, p, x, policy, *, mode, angles, cache=None, pos=None):
    """Attention sub-block body. Returns (out, new_cache): the (k, v) new
    entries for prefill, the updated (k_cache, v_cache) for decode.

    The decode write goes to ``min(pos, Smax - 1)``: the reference's
    ``dynamic_update_slice`` clamps its start so the update fits, so a
    cache with no room left (no ``pad_to``) has its last position
    overwritten while attention reads ``pos + 1`` positions (all of them)."""
    q, k, v = L.qkv_project(cfg, p["attn"], x, policy, angles=angles)
    nh = q.shape[2]
    if mode == "prefill":
        o = L.flash_prefill_attention(q, L.expand_kv(k, nh), L.expand_kv(v, nh))
        return L.attn_out(p["attn"], L.mask_pad_heads(cfg, o), policy), (k, v)
    if mode == "decode":
        k_cache, v_cache = cache
        start = min(pos, k_cache.shape[1] - 1)
        k_cache, v_cache = k_cache.clone(), v_cache.clone()
        k_cache[:, start:start + 1] = k.to(k_cache.dtype)
        v_cache[:, start:start + 1] = v.to(v_cache.dtype)
        o = _grouped_decode_attention(q, k_cache, v_cache, pos + 1)
        return L.attn_out(p["attn"], L.mask_pad_heads(cfg, o), policy), (k_cache, v_cache)
    raise ValueError(mode)


def dense_layer(cfg, p, x, policy, *, mode, angles, cache=None, pos=None):
    """Pre-norm attention and MLP, each added to the residual stream.

    ``ln2`` reads the first residual sum in float32, before its rounding to
    the stream's dtype, as the reference computes it: XLA fuses the bf16
    add into the norm's float32 reduction and drops the round trip through
    bf16 there, while the second residual add reads the rounded sum."""
    a, new_cache = attn_apply(cfg, p, L.apply_norm(cfg, p["ln1"], x), policy,
                              mode=mode, angles=angles, cache=cache, pos=pos)
    h = x.to(_F32) + a.to(_F32)
    x = h.to(x.dtype)
    y = L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], h).to(x.dtype), policy)
    return x + y, new_cache


def ssm_layer(cfg, p, x, policy, state=None):
    y, new_state = ssm_block(cfg, p["ssm"], L.apply_norm(cfg, p["ln"], x), policy,
                             state=state)
    return x + y, new_state


# ---------------------------------------------------------------------------
# forward


def _embed_and_angles(cfg, params, batch, policy, mode, pos):
    tokens = batch["tokens"]
    h = L.embed(params["embed"], tokens, policy) * L.as_constant(math.sqrt(cfg.d_model),
                                                                 policy.compute)
    if cfg.attn_free:
        return h, None
    if cfg.mrope:
        raise family_missing("vlm", "M-RoPE angles")
    b, s = tokens.shape
    if mode == "decode":
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    return h, L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def forward(cfg, params, batch, policy, *, mode, cache=None, pos=None):
    """Core forward.  Returns (hidden, new_cache, aux_loss).  For decode,
    ``cache`` is the stacked cache of the layout above and ``pos`` the
    position written (an int)."""
    if cfg.family not in PORTED:
        raise family_missing(cfg.family)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} (training, train/*) is not ported yet: "
                                  "ROADMAP module item 13c")
    h, angles = _embed_and_angles(cfg, params, batch, policy, mode, pos)
    outs = []
    for i in range(cfg.n_layers):
        lp = T.tree_map(lambda x: x[i], params["layers"])
        c = None if cache is None else T.tree_map(lambda x: x[i], cache["layers"])
        if cfg.family == "dense":
            h, c_out = dense_layer(cfg, lp, h, policy, mode=mode, angles=angles,
                                   cache=c if mode == "decode" else None,
                                   pos=0 if mode == "prefill" else pos)
        else:
            h, c_out = ssm_layer(cfg, lp, h, policy, state=c)
        outs.append(c_out)
    aux = torch.zeros((), dtype=_F32, device=h.device)
    return _finish(cfg, params, h), {"layers": T.stack(outs)}, aux


def _finish(cfg, params, h):
    return L.apply_norm(cfg, params["final_norm"], h)


def lm_logits(cfg, params, h, policy):
    head = {"w": params["w"]} if "w" in params else {}
    return L.logits(cfg, head, params["embed"], h, policy)
