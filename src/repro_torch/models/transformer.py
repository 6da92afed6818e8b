"""Decoder-only LM assembly: the dense, moe, ssm, hybrid and vlm families
(counterpart of ``repro/models/transformer.py``).

Parameters keep the JAX package's stacked layout (a leading layer axis on
every leaf of ``params["layers"]``), and ``forward`` walks that axis with a
Python loop where the JAX code runs ``lax.scan``:
  - moe: ``first_k_dense`` dense layers (``params["dense_layers"]``), then
    the MoE layers;
  - hybrid: groups of (the one shared attention block, then ``attn_every``
    Mamba-2 layers), ``params["layers"]`` stacked (G, attn_every);
  - vlm: dense layers, the vision embeddings merged at the leading
    positions and M-RoPE angles when the batch has ``mrope_pos``.
The cache is stacked the same way:
  ssm:       ``{"layers": {"conv": (L, B, K-1, d_inner), "ssm": (L, B, d_inner, N)}}``
  dense/vlm: ``{"layers": (k, v)}``, each (L, B, S, Hkv, Dh) bf16
  moe:       ``{"dense_layers": (k, v), "layers": (k, v)}``
  hybrid:    ``{"groups": {"attn": (k, v), "ssm": state}}``, (G, ...) / (G, E, ...)
Modes ``train`` (causal dense attention, or ``flash_attention_train``
when ``cfg.attn_impl == "flash"`` and S >= 512; no cache; each layer, or
each hybrid group, under ``torch.utils.checkpoint`` as ``cfg.remat``
says), ``prefill`` (chunked flash attention, returns the KV entries) and
``decode`` (grouped-query attention against the cache).

Over a mesh (``forward(mesh=)``) the batch is this rank's block of the
batch axes and every weight is this rank's block of its partition spec
(``model.run_pspecs``): the MoE layers take the expert-parallel paths on
their expert blocks (``moe.apply_moe``); attention runs on the rank's head
block, the MLP on its ff block and the Mamba blocks on its ``d_inner``
channels, each summed over 'model' after its row-parallel projection
(``layers``, ``ssm``); the embedding and the logits on its vocab block.  A
KV cache holds the rank's kv-head block where 'model' divides the kv heads,
every kv head where it does not (the query heads then read the ones they
need, ``layers.Heads``); an ssm state holds the rank's channels.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import tree as T
from repro_torch.common import P, ParamSpec, spec_map, with_sharding
from repro_torch.models import layers as L
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.ssm import mamba1_specs, mamba2_specs, ssm_block, ssm_state_shape

_F32 = torch.float32


def stack_specs(tree, n: int):
    """Prepend a layer axis of size n to every spec in the tree (not sharded)."""
    return spec_map(lambda s: ParamSpec((n,) + s.shape, s.dtype, P(None, *s.pspec),
                                        init=s.init), tree)


def _attn_block_specs(cfg, tp):
    return {"ln": L.norm_specs(cfg), "attn": L.attn_specs(cfg, tp)}


def _dense_layer_specs(cfg, tp, d_ff=None):
    return {
        "ln1": L.norm_specs(cfg),
        "attn": L.attn_specs(cfg, tp),
        "ln2": L.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg, tp, d_ff=d_ff),
    }


def _moe_layer_specs(cfg, tp, fsdp):
    return {
        "ln1": L.norm_specs(cfg),
        "attn": L.attn_specs(cfg, tp),
        "ln2": L.norm_specs(cfg),
        "moe": moe_specs(cfg, tp, fsdp=fsdp),
    }


def _ssm_layer_specs(cfg, tp):
    sfn = mamba1_specs if cfg.ssm.version == 1 else mamba2_specs
    return {"ln": L.norm_specs(cfg), "ssm": sfn(cfg, tp)}


def n_groups(cfg):
    return cfg.n_layers // cfg.attn_every


def decoder_specs(cfg, tp: int = L.TP, fsdp: bool = False):
    s = {"embed": L.embed_specs(cfg, tp), "final_norm": L.norm_specs(cfg)}
    s.update(L.logits_specs(cfg, tp))  # adds "w" unless tied
    fam = cfg.family
    if fam in ("dense", "vlm"):
        s["layers"] = stack_specs(_dense_layer_specs(cfg, tp), cfg.n_layers)
    elif fam == "moe":
        m = cfg.moe
        if m.first_k_dense:
            s["dense_layers"] = stack_specs(_dense_layer_specs(cfg, tp, d_ff=m.d_ff_dense),
                                            m.first_k_dense)
        s["layers"] = stack_specs(_moe_layer_specs(cfg, tp, fsdp), cfg.n_layers - m.first_k_dense)
    elif fam == "ssm":
        s["layers"] = stack_specs(_ssm_layer_specs(cfg, tp), cfg.n_layers)
    elif fam == "hybrid":
        s["shared_attn"] = _attn_block_specs(cfg, tp)
        s["layers"] = stack_specs(stack_specs(_ssm_layer_specs(cfg, tp), cfg.attn_every),
                                  n_groups(cfg))
    else:
        raise ValueError(fam)
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


def attn_apply(cfg, p, x, policy, *, mode, angles, cache=None, pos=None, mesh=None):
    """Attention sub-block body. Returns (out, new_cache): None for train,
    the (k, v) new entries for prefill, the updated (k_cache, v_cache) for
    decode.  Over ``mesh``, on this rank's heads (``layers.heads``), the
    output summed over 'model'; the cache holds this rank's kv heads.

    The decode write goes to ``min(pos, Smax - 1)``: the reference's
    ``dynamic_update_slice`` clamps its start so the update fits, so a
    cache with no room left (no ``pad_to``) has its last position
    overwritten while attention reads ``pos + 1`` positions (all of them)."""
    q, k, v = L.qkv_project(cfg, p["attn"], x, policy, angles=angles, mesh=mesh)
    hd = L.heads(cfg, p["attn"], mesh)
    nh = q.shape[2]

    def out(o):
        o = L.mask_pad_heads(cfg, o, hd.lo, hd.total)
        return L.model_sum(L.attn_out(p["attn"], o, policy), mesh, hd.split)

    if mode == "train":
        ke, ve = (L.expand_kv(L.select_kv(t, hd), nh) for t in (k, v))
        if cfg.attn_impl == "flash" and q.shape[1] >= 512:
            o = L.flash_attention_train(q, ke, ve)
        else:
            o = L.dense_attention(q, ke, ve, causal=True)
        return out(o), None
    if mode == "prefill":
        o = L.flash_prefill_attention(q, *(L.expand_kv(L.select_kv(t, hd), nh) for t in (k, v)))
        return out(o), (k, v)
    if mode == "decode":
        k_cache, v_cache = cache
        start = min(pos, k_cache.shape[1] - 1)
        k_cache, v_cache = k_cache.clone(), v_cache.clone()
        k_cache[:, start:start + 1] = k.to(k_cache.dtype)
        v_cache[:, start:start + 1] = v.to(v_cache.dtype)
        o = _grouped_decode_attention(q, L.select_kv(k_cache, hd), L.select_kv(v_cache, hd),
                                      pos + 1)
        return out(o), (k_cache, v_cache)
    raise ValueError(mode)


def residual(x, a):
    """The residual add ``x + a`` as the reference's next norm reads it:
    returns the sum rounded to x's dtype and the float32 sum.  XLA fuses the
    bf16 add into the following norm's float32 reduction and drops the
    round trip through bf16 there, while the next residual add reads the
    rounded sum."""
    h = x.to(_F32) + a.to(_F32)
    return h.to(x.dtype), h


def dense_layer(cfg, p, x, policy, *, mode, angles, cache=None, pos=None, mesh=None):
    """Pre-norm attention and MLP, each added to the residual stream;
    ``ln2`` reads the first sum in float32 (``residual``)."""
    a, new_cache = attn_apply(cfg, p, L.apply_norm(cfg, p["ln1"], x), policy,
                              mode=mode, angles=angles, cache=cache, pos=pos, mesh=mesh)
    x, h = residual(x, a)
    y = L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], h).to(x.dtype), policy,
                    mesh=mesh)
    return x + y, new_cache


def moe_layer(cfg, p, x, policy, *, mode, angles, cache=None, pos=None, mesh=None,
              fsdp=False):
    """``dense_layer`` with the MoE block in the MLP's place (over ``mesh``
    an expert-parallel path, ``ep_moe_decode`` in decode mode).  Returns (x,
    new_cache, aux)."""
    a, new_cache = attn_apply(cfg, p, L.apply_norm(cfg, p["ln1"], x), policy,
                              mode=mode, angles=angles, cache=cache, pos=pos, mesh=mesh)
    x, h = residual(x, a)
    y, aux = apply_moe(cfg, p["moe"], L.apply_norm(cfg, p["ln2"], h).to(x.dtype), policy,
                       mesh=mesh, fsdp=fsdp, decode=(mode == "decode"))
    return x + y, new_cache, aux


def ssm_layer(cfg, p, x, policy, state=None, mesh=None):
    y, new_state = ssm_block(cfg, p["ssm"], L.apply_norm(cfg, p["ln"], x), policy,
                             state=state, mesh=mesh)
    return x + y, new_state


# ---------------------------------------------------------------------------
# forward


def _embed_and_angles(cfg, params, batch, policy, mode, pos, mesh=None):
    tokens = batch["tokens"]
    h = L.embed(params["embed"], tokens, policy, mesh=mesh, vocab=cfg.vocab_size)
    h = h * L.as_constant(math.sqrt(cfg.d_model), policy.compute)
    if cfg.family == "vlm" and "vision_embeds" in batch and mode != "decode":
        nv = batch["vision_embeds"].shape[1]
        h = torch.cat([batch["vision_embeds"].to(h.dtype), h[:, nv:]], dim=1)
    if cfg.attn_free:
        return h, None
    if cfg.mrope and "mrope_pos" in batch:
        return h, L.mrope_angles(batch["mrope_pos"], cfg.head_dim, cfg.rope_theta,
                                 cfg.mrope_sections)
    b, s = tokens.shape
    if mode == "decode":
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    return h, L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _layer(tree, i):
    return T.tree_map(lambda x: x[i], tree)


def _layers(tree):
    """The per-layer trees of a stacked parameter tree, as views: ``unbind``
    along the layer axis, whose backward stacks the layers' gradients in one
    copy (indexing layer by layer would give each layer's gradient a
    zero-filled tensor of the whole stack, all of them summed)."""
    if isinstance(tree, dict):
        parts = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


# matmul ops whose outputs ``remat="save_dots"`` keeps: the reference's
# dots_with_no_batch_dims_saveable (a bmm counts when its batch is 1)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn, *args):
    """``fn(*args)`` under the train path's remat policy: ``"none"`` keeps
    every activation, ``"full"`` only the inputs (the body is recomputed in
    the backward), ``"save_dots"`` the matmul outputs too.  Non-reentrant
    checkpoints: tensors reached through closures get their gradients."""
    if cfg.remat == "none":
        return fn(*args)
    kw = {}
    if cfg.remat == "save_dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: none, full or save_dots")
    # nothing on the path draws random numbers: no RNG state to keep
    return ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def forward(cfg, params, batch, policy, *, mode, mesh=None, fsdp=False, cache=None, pos=None):
    """Core forward.  Returns (hidden, new_cache, aux_loss): aux sums the MoE
    layers' load-balance losses (zero for the other families).  For decode,
    ``cache`` is the stacked cache of the layout above and ``pos`` the
    position written (an int); train returns no cache (None) and runs each
    layer (hybrid: each group) through ``_remat``.  Over ``mesh`` the batch
    and cache are this rank's blocks of the batch axes (and of the kv heads
    and ssm channels over 'model') and ``params`` hold this rank's blocks
    (``model.run_pspecs``)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    h, angles = _embed_and_angles(cfg, params, batch, policy, mode, pos, mesh)
    h = with_sharding(h, mesh, L.batch_pspec(None, None))
    aux = torch.zeros((), dtype=_F32, device=h.device)
    decode, train = mode == "decode", mode == "train"
    kw = dict(mode=mode, angles=angles, pos=pos if decode else 0)
    run = functools.partial(_remat, cfg) if train else (lambda fn, *args: fn(*args))
    fam = cfg.family
    new_cache = {}
    if fam in ("dense", "vlm", "moe"):
        stacks = ["layers"]
        if fam == "moe" and cfg.moe.first_k_dense:
            stacks = ["dense_layers", "layers"]
        for name in stacks:
            outs = []
            for i, lp in enumerate(_layers(params[name])):
                c = _layer(cache[name], i) if decode else None
                if fam == "moe" and name == "layers":
                    h, c_out, a = run(lambda lp, h, c: moe_layer(cfg, lp, h, policy, cache=c,
                                                                 mesh=mesh, fsdp=fsdp, **kw),
                                      lp, h, c)
                    aux = aux + a
                else:
                    h, c_out = run(lambda lp, h, c: dense_layer(cfg, lp, h, policy, cache=c,
                                                                mesh=mesh, **kw), lp, h, c)
                outs.append(c_out)
            new_cache[name] = None if train else T.stack(outs)
    elif fam == "ssm":
        outs = []
        for i, lp in enumerate(_layers(params["layers"])):
            c = None if cache is None else _layer(cache["layers"], i)
            h, c_out = run(lambda lp, h, c: ssm_layer(cfg, lp, h, policy, state=c, mesh=mesh),
                           lp, h, c)
            outs.append(c_out)
        new_cache["layers"] = None if train else T.stack(outs)
    elif fam == "hybrid":
        h, new_cache["groups"] = _hybrid_groups(cfg, params, h, policy, cache, kw, run, mesh)
    else:
        raise ValueError(fam)
    return _finish(cfg, params, h), (None if train else new_cache), aux


def _hybrid_groups(cfg, params, h, policy, cache, kw, run, mesh=None):
    """The hybrid walk: before each group of ``attn_every`` Mamba-2 layers
    the one shared attention block, its KV cache per group.  Prefill and
    train start the Mamba-2 layers from zero states (this rank's heads and
    channels over ``mesh``), as the reference does; train keeps no cache and
    runs each group through ``run``."""
    shared = params["shared_attn"]
    if cache is not None:
        gc_in = cache["groups"]
    else:
        gc_in = {"attn": None, "ssm": _zero_ssm_states(cfg, h.shape[0], n_groups(cfg),
                                                       inner=cfg.attn_every,
                                                       device=h.device, tp=L.tp_size(mesh))}

    def group(gp, h, attn_c, states_in):
        a, attn_c = attn_apply(cfg, shared, L.apply_norm(cfg, shared["ln"], h), policy,
                               cache=attn_c, mesh=mesh, **kw)
        h = h + a
        states = []
        for j, lp in enumerate(_layers(gp)):
            h, st = ssm_layer(cfg, lp, h, policy, state=_layer(states_in, j), mesh=mesh)
            states.append(st)
        return h, attn_c, states

    outs = []
    for g, gp in enumerate(_layers(params["layers"])):
        attn_c = None if gc_in["attn"] is None else _layer(gc_in["attn"], g)
        h, attn_c, states = run(group, gp, h, attn_c, _layer(gc_in["ssm"], g))
        if kw["mode"] != "train":
            outs.append({"attn": attn_c, "ssm": T.stack(states)})
    return h, (T.stack(outs) if outs else None)


def _zero_ssm_states(cfg, batch, n, inner=None, device=None, tp=1):
    lead = (n,) if inner is None else (n, inner)
    return {k: torch.zeros(lead + s.shape, dtype=s.dtype, device=device)
            for k, s in ssm_state_shape(cfg, batch, tp).items()}


def _finish(cfg, params, h):
    return L.apply_norm(cfg, params["final_norm"], h)


def lm_logits(cfg, params, h, policy, mesh=None):
    """Logits: over ``mesh``, this rank's vocab block (``layers.logits``)."""
    head = {"w": params["w"]} if "w" in params else {}
    return L.logits(cfg, head, params["embed"], h, policy, mesh=mesh)
