"""Model building blocks: norms, RoPE and M-RoPE, sinusoidal positions, GQA
attention, the MLP, embeddings, logits (counterpart of the same functions
in ``repro/models/layers.py``).

Params are nested dicts; ``<module>_specs(cfg, tp)`` returns a ``ParamSpec``
tree and the apply functions take tensors.  Activations are (batch, seq,
d_model), attention heads (B, S, H, Dh); matmuls run in ``policy.compute``
(bf16), softmax and reductions in float32, and every cast sits where the
JAX code has its ``astype``: attention scores leave their bf16 product
before they are scaled in float32, softmax weights go back to bf16 before
the product with V (not in the chunked prefill, whose float32 weights meet
a float32 V), RoPE's cos/sin are cast to the activation dtype before the
multiply.  ``torch.nn.functional.scaled_dot_product_attention`` rounds at
none of these places, so attention is written out as the reference's.

The specs are the reference's at any ``tp`` (the model-axis size that
decides the layout): the same shapes, dtypes and partition specs, query
heads padded to a ``tp`` multiple where the reference pads them
(``padded_heads``, ROADMAP F8).  ``TP`` = 1 is the port's default, as the
reference's launchers build at tp = 1.  Training adds ``cross_entropy`` and ``flash_attention_train``
(the reference's custom VJP as a ``torch.autograd.Function``); the train
path's dense attention is ``dense_attention(causal=True)``, differentiated
by autograd.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import P, ParamSpec

_F32 = torch.float32
TP = 1  # the model-axis size the port builds at by default
DATA_AXES = ("data", "pod")  # batch shards over both; 'pod' absent on 1-pod meshes


def batch_pspec(*rest):
    return P(DATA_AXES, *rest)


def norm_specs(cfg, d=None):
    d = d or cfg.d_model
    s = {"scale": ParamSpec((d,), _F32, P(), init="ones")}
    if cfg.norm == "layernorm":
        s["bias"] = ParamSpec((d,), _F32, P(), init="zeros")
    return s


def apply_norm(cfg, p, x, eps=1e-5):
    if getattr(cfg, "fast_norm", False) and cfg.norm == "rmsnorm":
        # stats in float32, the normalising multiply in the activation dtype
        var = (x.to(_F32) ** 2).mean(-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * p["scale"].to(x.dtype)
    xf = x.to(_F32)
    if cfg.norm == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    if cfg.norm == "layernorm":
        y = y + p["bias"]
    return y.to(x.dtype)


def rms_head_norm(x, scale, eps=1e-6):
    """qk-norm: RMS-normalize the last (head) dim."""
    xf = x.to(_F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def _inv_freq(head_dim, theta, device):
    """RoPE's frequencies ``theta ** (-i / half)``: float32 powers rounded
    correctly (from float64), as XLA's float32 ``pow`` gives them; torch's
    float32 ``pow`` is an ulp off for some."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=_F32, device=device) / half
    return (theta ** expo.to(torch.float64)).to(_F32)


def rope_angles(positions, head_dim, theta):
    """positions (..., S) int -> angles (..., S, head_dim//2) float32."""
    return positions[..., None].to(_F32) * _inv_freq(head_dim, theta, positions.device)


def mrope_angles(positions3, head_dim, theta, sections):
    """M-RoPE (Qwen2-VL): positions3 (3, B, S) -> angles (B, S, head_dim//2),
    the frequency axis split into ``sections``, section i rotated by the
    positions of row i (time, height, width)."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    ang = positions3[..., None].to(_F32) * _inv_freq(head_dim, theta, positions3.device)
    parts, off = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang[i, ..., off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


def apply_rope(x, angles):
    """x (B, S, H, Dh); angles (B, S, Dh//2). Half-split (NeoX) convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(seq, d_model, device=None):
    """Whisper-style fixed sinusoidal embeddings (seq, d_model) float32: the
    reference's ``exp``, product, ``sin`` and ``cos`` in float32."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=_F32, device=device)
                     / (half - 1))
    ang = torch.arange(seq, dtype=_F32, device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention


def padded_heads(cfg, tp: int) -> int:
    """Q heads padded up to a TP multiple so attention always shards; the
    padding engages only when pad/real <= 1.5 and the padded count is a
    multiple of the KV heads (the reference's policy).  The pad heads' outputs
    are masked (``mask_pad_heads``), but ``expand_kv`` then repeats each KV
    head ``padded // Hkv`` times, so the query heads' grouping moves (ROADMAP
    F8: llama4-scout's 40 heads at tp = 16 read KV head h // 6, not h // 5);
    the port keeps the reference's model."""
    hq = cfg.n_heads
    if hq % tp == 0:
        return hq
    pad = -(-hq // tp) * tp
    return pad if pad <= hq * 1.5 and pad % cfg.n_kv_heads == 0 else hq


def attn_specs(cfg, tp: int = TP, dtype=None):
    """QKV/out projections. Heads shard over 'model' (padded if needed)."""
    dtype = dtype or cfg.params_dtype
    d, hkv, dh = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    hq = padded_heads(cfg, tp)
    hq_ax = "model" if hq % tp == 0 else None
    hkv_ax = "model" if hkv % tp == 0 else None
    s = {
        "wq": ParamSpec((d, hq, dh), dtype, P(None, hq_ax, None)),
        "wk": ParamSpec((d, hkv, dh), dtype, P(None, hkv_ax, None)),
        "wv": ParamSpec((d, hkv, dh), dtype, P(None, hkv_ax, None)),
        "wo": ParamSpec((hq, dh, d), dtype, P(hq_ax, None, None)),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((dh,), _F32, P(), init="ones")
        s["k_norm"] = ParamSpec((dh,), _F32, P(), init="ones")
    return s


def mask_pad_heads(cfg, o):
    """Zero the padded heads' attention output (B, S, Hpad, Dh)."""
    hpad = o.shape[2]
    if hpad == cfg.n_heads:
        return o
    mask = (torch.arange(hpad, device=o.device) < cfg.n_heads).to(o.dtype)
    return o * mask[None, None, :, None]


def qkv_project(cfg, p, x, policy, angles=None, x_kv=None):
    """q (B,Sq,Hq,Dh) from x and k/v (B,Skv,Hkv,Dh) from ``x_kv`` (x itself
    unless given); qk-norm before RoPE."""
    cdt = policy.compute
    xq = x.to(cdt)
    xkv = (x if x_kv is None else x_kv).to(cdt)
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"].to(cdt))
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def expand_kv(k, n_heads):
    """(B,S,Hkv,Dh) -> (B,S,Hq,Dh): q head h reads kv head h // G."""
    g = n_heads // k.shape[2]
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def attn_out(p, o, policy):
    cdt = policy.compute
    return torch.einsum("bshk,hkd->bsd", o.to(cdt), p["wo"].to(cdt))


def scores(q, k, spec):
    """The bf16 product of q and k, then float32 and the 1/sqrt(Dh) scale."""
    return torch.einsum(spec, q, k).to(_F32) * (1.0 / math.sqrt(q.shape[-1]))


def dense_attention(q, k, v, *, causal):
    """Reference/dense path. q (B,Sq,H,Dh), k/v (B,Skv,H,Dh)."""
    s = scores(q, k, "bqhd,bkhd->bhqk")
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, -torch.inf)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def decode_attention(q, k_cache, v_cache, length):
    """Single-step decode vs a (possibly longer-than-``length``) cache.
    q (B,1,H,Dh); caches (B,Smax,H,Dh); positions >= length are masked out."""
    s = scores(q, k_cache, "bqhd,bkhd->bhqk")
    mask = torch.arange(k_cache.shape[1], device=q.device)[None, None, None, :] < length
    s = torch.where(mask, s, -torch.inf)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_cache)


def _flash_fwd_core(q, k, v, cq, ck):
    """The reference's triangular chunk-pair loop (pairs (i, j <= i), i
    outer) with an online softmax per query chunk.  Returns (o float32
    (B, H, Sq, Dh), lse float32 (B, H, Sq))."""
    b, sq, h, dh = q.shape
    dev = q.device
    outs, lses = [], []
    for i in range(sq // cq):
        qc = q[:, i * cq:(i + 1) * cq]
        qpos = i * cq + torch.arange(cq, device=dev)[:, None]
        acc = torch.zeros((b, h, cq, dh), dtype=_F32, device=dev)
        m = torch.full((b, h, cq), -torch.inf, dtype=_F32, device=dev)
        l = torch.zeros((b, h, cq), dtype=_F32, device=dev)
        for j in range((i + 1) * cq // ck):
            kc, vc = k[:, j * ck:(j + 1) * ck], v[:, j * ck:(j + 1) * ck]
            s = scores(qc, kc, "bqhd,bkhd->bhqk")
            kpos = j * ck + torch.arange(ck, device=dev)[None, :]
            s = torch.where(qpos >= kpos, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", pexp, vc.to(_F32))
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


class FlashAttentionTrain(torch.autograd.Function):
    """The reference's ``flash_attention_train`` custom VJP: the forward
    saves (q, k, v, o, lse); the backward recomputes each (i, j) tile's
    scores and accumulates dq, dk, dv in float32 (``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, cq, ck):
        o, lse = _flash_fwd_core(q, k, v, cq, ck)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.chunks = (cq, ck)
        return o.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        cq, ck = ctx.chunks
        dev = q.device
        scale = 1.0 / math.sqrt(q.shape[-1])
        do_f = do.to(_F32).transpose(1, 2)  # (B, H, S, Dh)
        delta = (do_f * o).sum(-1)  # (B, H, S)
        dq = torch.zeros(q.shape, dtype=_F32, device=dev)
        dk = torch.zeros(k.shape, dtype=_F32, device=dev)
        dv = torch.zeros(v.shape, dtype=_F32, device=dev)
        for i in range(q.shape[1] // cq):
            qs = slice(i * cq, (i + 1) * cq)
            qc, lse_c, dlt_c, do_c = q[:, qs], lse[:, :, qs], delta[:, :, qs], do_f[:, :, qs]
            qpos = i * cq + torch.arange(cq, device=dev)[:, None]
            for j in range((i + 1) * cq // ck):
                ks = slice(j * ck, (j + 1) * ck)
                kc, vc = k[:, ks], v[:, ks]
                s = scores(qc, kc, "bqhd,bkhd->bhqk")
                kpos = j * ck + torch.arange(ck, device=dev)[None, :]
                p = torch.where(qpos >= kpos, torch.exp(s - lse_c[..., None]), 0.0)
                dv[:, ks] += torch.einsum("bhqk,bhqd->bkhd", p, do_c)
                dp = torch.einsum("bhqd,bkhd->bhqk", do_c, vc.to(_F32))
                ds = p * (dp - dlt_c[..., None]) * scale
                dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd", ds, kc.to(_F32))
                dk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", ds, qc.to(_F32))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_prefill_attention(q, k, v, *, chunk_q=512, chunk_k=512):
    """Causal chunked-flash attention for long prefill: the reference's
    triangular (i, j) chunk-pair online softmax (``_flash_fwd_core``), with
    no gradient path."""
    sq, sk = q.shape[1], k.shape[1]
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    assert sq % cq == 0 and sk % ck == 0
    return _flash_fwd_core(q, k, v, cq, ck)[0].transpose(1, 2).to(q.dtype)


def flash_attention_train(q, k, v, chunk_q=512, chunk_k=512):
    """Causal flash attention with a flash backward, q/k/v (B, S, H, Dh):
    forward and backward stream (chunk_q, chunk_k) tiles of the causal
    triangle, O(S * Dh) saved besides the inputs."""
    return FlashAttentionTrain.apply(q, k, v, min(chunk_q, q.shape[1]),
                                     min(chunk_k, k.shape[1]))


def cross_entropy(lg, targets, mask=None):
    """Mean next-token cross-entropy of (B, S, V) logits in float32
    (logsumexp minus the target's logit); with ``mask``, its weighted mean."""
    lg = lg.to(_F32)
    nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, targets[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


# ---------------------------------------------------------------------------
# MLP


def mlp_specs(cfg, tp: int = TP, d_ff=None, dtype=None, fsdp=False):
    dtype = dtype or cfg.params_dtype
    d, f = cfg.d_model, d_ff or cfg.d_ff
    in_sp = P("data" if fsdp else None, "model")
    out_sp = P("model", "data" if fsdp else None)
    s = {"w_in": ParamSpec((d, f), dtype, in_sp), "w_out": ParamSpec((f, d), dtype, out_sp)}
    if cfg.act == "swiglu":
        s["w_gate"] = ParamSpec((d, f), dtype, in_sp)
    return s


def as_constant(v: float, dtype) -> float:
    """A Python float rounded to ``dtype``: a weak-typed float meets a bf16
    array as a bf16 constant in the reference, where torch would compute
    with the float itself."""
    return float(torch.tensor(v, dtype=dtype))


def logistic(x):
    """``jax.nn.sigmoid`` as the reference computes it: ``1 / (1 + exp(-x))``,
    every op rounded to x's dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu`` as the reference computes it: ``x * logistic(x)``,
    every op rounded to x's dtype (``F.silu`` rounds once)."""
    return x * logistic(x)


def gelu(x):
    """``jax.nn.gelu``'s default tanh approximation, every op rounded to x's
    dtype and its constants too (``F.gelu`` is exact, or rounds once)."""
    k = as_constant(math.sqrt(2 / math.pi), x.dtype)
    c = as_constant(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(k * (x + c * (x * x * x)))))


def apply_mlp(cfg, p, x, policy):
    cdt = policy.compute
    xc = x.to(cdt)
    h = xc @ p["w_in"].to(cdt)
    if cfg.act == "swiglu":
        h = silu(xc @ p["w_gate"].to(cdt)) * h
    else:
        h = gelu(h)
    return h @ p["w_out"].to(cdt)


# ---------------------------------------------------------------------------
# embeddings / logits


def embed_specs(cfg, tp: int = TP):
    vocab_ax = "model" if cfg.vocab_size % tp == 0 else None
    return {"table": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.params_dtype,
                               P(vocab_ax, None), init="small")}


def embed(p, tokens, policy):
    return p["table"][tokens].to(policy.compute)


def logits_specs(cfg, tp: int = TP):
    if cfg.tie_embeddings:
        return {}
    vocab_ax = "model" if cfg.vocab_size % tp == 0 else None
    return {"w": ParamSpec((cfg.d_model, cfg.vocab_size), cfg.params_dtype, P(None, vocab_ax))}


def logits(cfg, p_lm, p_embed, x, policy):
    cdt = policy.compute
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x.to(cdt), p_embed["table"].to(cdt))
    return x.to(cdt) @ p_lm["w"].to(cdt)
