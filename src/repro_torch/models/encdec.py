"""Whisper-style encoder-decoder backbone (counterpart of
``repro/models/encdec.py``).

The audio conv frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``enc_feats (B, S_enc, d_model)``.  The
encoder adds fixed sinusoidal positions and runs bidirectional attention;
the decoder adds learned positions and runs causal self-attention and
cross-attention to the encoded memory, whose K/V are computed once at
prefill and cached beside the self-attention cache.  Training
(``encdec_loss_forward``) encodes, computes the cross K/V and runs the
decoder in ``train`` mode (no cache), without remat, as the reference
does.  ``encode`` and ``decode_forward`` take the reference's ``mesh=``
and mark its layout sites (``common.with_sharding``, which changes no
value): the encoder over the batch axes and, where the head count does not
divide 16 and the frames do (whisper: 6 heads), over 'model' along the
sequence.  Under the port's explicit SPMD the batch is this rank's block,
the activations are whole over 'model' (a layout the reference leaves to
GSPMD, so the port's to choose) and the weights are this rank's blocks:
encoder and decoder attention on its head block, the MLPs on its ff block,
each summed over 'model'; ``cross_kv`` gives the rank's kv-head block; the
embedding and the tied logits on its vocab block where the vocab divides
(whisper-tiny's 51865 does not: it stays whole).
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as T
from repro_torch.common import P, ParamSpec, with_sharding
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_grouped_decode_attention, _layer, _layers,
                                            attn_apply, residual, stack_specs)

MAX_DEC_POS = 32768  # decode_32k needs 32k learned decoder positions


def _enc_layer_specs(cfg, tp):
    return {
        "ln1": L.norm_specs(cfg),
        "attn": L.attn_specs(cfg, tp),
        "ln2": L.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg, tp),
    }


def _dec_layer_specs(cfg, tp):
    return {
        "ln1": L.norm_specs(cfg),
        "attn": L.attn_specs(cfg, tp),
        "ln_x": L.norm_specs(cfg),
        "xattn": L.attn_specs(cfg, tp),
        "ln2": L.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg, tp),
    }


def encdec_specs(cfg, tp: int = L.TP, fsdp: bool = False):
    return {
        "embed": L.embed_specs(cfg, tp),
        "dec_pos": ParamSpec((MAX_DEC_POS, cfg.d_model), cfg.params_dtype, P(), init="small"),
        "enc_layers": stack_specs(_enc_layer_specs(cfg, tp), cfg.n_enc_layers),
        "enc_norm": L.norm_specs(cfg),
        "dec_layers": stack_specs(_dec_layer_specs(cfg, tp), cfg.n_layers),
        "final_norm": L.norm_specs(cfg),
    }


def _bidir_attn(cfg, p, x, policy, x_kv=None, mesh=None):
    q, k, v = L.qkv_project(cfg, p, x, policy, angles=None, x_kv=x_kv, mesh=mesh)
    hd = L.heads(cfg, p, mesh)
    o = L.dense_attention(q, *(L.expand_kv(L.select_kv(t, hd), hd.n) for t in (k, v)),
                          causal=False)
    return L.model_sum(L.attn_out(p, o, policy), mesh, hd.split)


def enc_layer(cfg, lp, x, policy, mesh=None):
    """One encoder layer: pre-norm bidirectional attention and MLP, each
    added to the residual stream; ``ln2`` reads the first sum in float32
    (``transformer.residual``)."""
    a = _bidir_attn(cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], x), policy, mesh=mesh)
    x, xf = residual(x, a)
    return x + L.apply_mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], xf).to(x.dtype), policy,
                           mesh=mesh)


def encoder_input(cfg, enc_feats, policy):
    """The frame embeddings in the compute dtype plus the sinusoidal
    positions."""
    h = enc_feats.to(policy.compute)
    return h + L.sinusoidal_positions(h.shape[1], cfg.d_model, h.device).to(h.dtype)[None]


def encode(cfg, params, enc_feats, policy, mesh=None):
    """enc_feats (B, S_enc, d) -> memory (B, S_enc, d).  The reference's
    layout: batch over the data axes, the sequence over 'model' where the
    head count does not divide 16 and the frames do (``seq_ax``)."""
    seq_ax = "model" if (cfg.n_heads % 16 and enc_feats.shape[1] % 16 == 0) else None
    h = with_sharding(encoder_input(cfg, enc_feats, policy), mesh,
                      L.batch_pspec(seq_ax, None))
    for lp in _layers(params["enc_layers"]):
        h = with_sharding(enc_layer(cfg, lp, h, policy, mesh), mesh, L.batch_pspec(seq_ax, None))
    return L.apply_norm(cfg, params["enc_norm"], h)


def cross_kv(cfg, params, memory, policy, mesh=None):
    """Each decoder layer's cross K/V of the encoder memory, stacked:
    (k, v), each (L_dec, B, S_enc, Hkv, Dh) — part of the cache (the kv
    heads of this rank's ``wk``/``wv`` blocks)."""
    cdt = policy.compute
    xattn = params["dec_layers"]["xattn"]
    m = L.model_input(memory.to(cdt), mesh, L.heads(cfg, xattn, mesh).split)
    ks = [torch.einsum("bsd,dhk->bshk", m, w.to(cdt)) for w in xattn["wk"].unbind(0)]
    vs = [torch.einsum("bsd,dhk->bshk", m, w.to(cdt)) for w in xattn["wv"].unbind(0)]
    return torch.stack(ks), torch.stack(vs)


def _dec_layer(cfg, lp, x, policy, *, mode, cache, xkv, pos, mesh=None):
    a, self_c = attn_apply(cfg, lp, L.apply_norm(cfg, lp["ln1"], x), policy,
                           mode=mode, angles=None, cache=cache, pos=pos, mesh=mesh)
    x, xf = residual(x, a)
    # cross attention against the fixed memory K/V
    cdt = policy.compute
    xq = L.apply_norm(cfg, lp["ln_x"], xf).to(x.dtype)
    hd = L.heads(cfg, lp["xattn"], mesh)
    xq = L.model_input(xq.to(cdt), mesh, hd.split)
    q = torch.einsum("bsd,dhk->bshk", xq, lp["xattn"]["wq"].to(cdt))
    xk, xv = (L.select_kv(t, hd) for t in xkv)
    if q.shape[1] == 1:
        o = _grouped_decode_attention(q, xk, xv, xk.shape[1])
    else:
        o = L.dense_attention(q, L.expand_kv(xk, hd.n), L.expand_kv(xv, hd.n), causal=False)
    x, xf = residual(x, L.model_sum(L.attn_out(lp["xattn"], o, policy), mesh, hd.split))
    x = x + L.apply_mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], xf).to(x.dtype), policy,
                        mesh=mesh)
    return x, self_c


def decode_forward(cfg, params, tokens, policy, *, mode, cache=None, xkv=None, pos=0,
                   mesh=None):
    """The decoder stack. tokens (B, S_dec); mode train|prefill|decode.
    ``cache`` is the stacked self-attention (k, v) for decode, ``xkv`` the
    stacked cross (k, v).  Returns (hidden, the self-attention cache; None
    for train)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    s = tokens.shape[1]
    h = L.embed(params["embed"], tokens, policy, mesh=mesh, vocab=cfg.vocab_size)
    h = h * L.as_constant(math.sqrt(cfg.d_model), policy.compute)
    # the reference's dynamic_slice clamps its start so the slice fits
    start = min(pos if mode == "decode" else 0, MAX_DEC_POS - s)
    h = h + params["dec_pos"][start:start + s].to(h.dtype)[None]
    h = with_sharding(h, mesh, L.batch_pspec(None, None))
    outs = []
    for i, lp in enumerate(_layers(params["dec_layers"])):
        c = _layer(cache, i) if mode == "decode" else None
        h, c_out = _dec_layer(cfg, lp, h, policy, mode=mode, cache=c, xkv=_layer(xkv, i),
                              pos=pos, mesh=mesh)
        h = with_sharding(h, mesh, L.batch_pspec(None, None))
        outs.append(c_out)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return h, (None if mode == "train" else T.stack(outs))


def encdec_loss_forward(cfg, params, batch, policy, mesh=None):
    """Training forward: the final decoder hidden states (B, S_dec, d)."""
    memory = encode(cfg, params, batch["enc_feats"], policy, mesh=mesh)
    xkv = cross_kv(cfg, params, memory, policy, mesh)
    return decode_forward(cfg, params, batch["tokens"], policy, mode="train", xkv=xkv,
                          mesh=mesh)[0]
