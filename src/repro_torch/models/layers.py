"""Model building blocks of the ssm and dense families: norms, RoPE, GQA
attention, the MLP, embeddings, logits (counterpart of the same functions
in ``repro/models/layers.py``).

Params are nested dicts; ``<module>_specs(cfg)`` returns a ``ParamSpec``
tree and the apply functions take tensors.  Activations are (batch, seq,
d_model), attention heads (B, S, H, Dh); matmuls run in ``policy.compute``
(bf16), softmax and reductions in float32, and every cast sits where the
JAX code has its ``astype``: attention scores leave their bf16 product
before they are scaled in float32, softmax weights go back to bf16 before
the product with V (not in the chunked prefill, whose float32 weights meet
a float32 V), RoPE's cos/sin are cast to the activation dtype before the
multiply.  ``torch.nn.functional.scaled_dot_product_attention`` rounds at
none of these places, so attention is written out as the reference's.

The specs are the reference's at tp = 1 (one card): no head padding, no
sharding.  M-RoPE, sinusoidal positions and the training flash attention
are not ported (ROADMAP module item 13b steps 5-6, 13c).
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import ParamSpec

_F32 = torch.float32
TP = 1  # the port's model-axis size: one card


def norm_specs(cfg, d=None):
    d = d or cfg.d_model
    s = {"scale": ParamSpec((d,), _F32, init="ones")}
    if cfg.norm == "layernorm":
        s["bias"] = ParamSpec((d,), _F32, init="zeros")
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


def rope_angles(positions, head_dim, theta):
    """positions (..., S) int -> angles (..., S, head_dim//2) float32.  The
    frequencies are float32 powers rounded correctly (from float64), as
    XLA's float32 ``pow`` gives them; torch's float32 ``pow`` is an ulp off
    for some."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=_F32, device=positions.device) / half
    inv = (theta ** expo.to(torch.float64)).to(_F32)
    return positions[..., None].to(_F32) * inv


def apply_rope(x, angles):
    """x (B, S, H, Dh); angles (B, S, Dh//2). Half-split (NeoX) convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# attention


def padded_heads(cfg, tp: int) -> int:
    """Q heads padded up to a TP multiple so attention always shards; the
    padding engages only when pad/real <= 1.5 (the reference's policy).  At
    the port's tp = 1 every head count divides."""
    hq = cfg.n_heads
    if hq % tp == 0:
        return hq
    pad = -(-hq // tp) * tp
    return pad if pad <= hq * 1.5 and pad % cfg.n_kv_heads == 0 else hq


def attn_specs(cfg):
    """QKV/out projections (the reference's tree at tp = 1)."""
    d, hkv, dh, dtype = cfg.d_model, cfg.n_kv_heads, cfg.head_dim, cfg.params_dtype
    hq = padded_heads(cfg, TP)
    s = {
        "wq": ParamSpec((d, hq, dh), dtype),
        "wk": ParamSpec((d, hkv, dh), dtype),
        "wv": ParamSpec((d, hkv, dh), dtype),
        "wo": ParamSpec((hq, dh, d), dtype),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((dh,), _F32, init="ones")
        s["k_norm"] = ParamSpec((dh,), _F32, init="ones")
    return s


def mask_pad_heads(cfg, o):
    """Zero the padded heads' attention output (B, S, Hpad, Dh)."""
    hpad = o.shape[2]
    if hpad == cfg.n_heads:
        return o
    mask = (torch.arange(hpad, device=o.device) < cfg.n_heads).to(o.dtype)
    return o * mask[None, None, :, None]


def qkv_project(cfg, p, x, policy, angles=None):
    """Self-attention's q (B,S,Hq,Dh) and k/v (B,S,Hkv,Dh); qk-norm before
    RoPE.  (The reference's cross-attention form, ``x_kv``, comes with the
    encdec family.)"""
    cdt = policy.compute
    x = x.to(cdt)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
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


def flash_prefill_attention(q, k, v, *, chunk_q=512, chunk_k=512):
    """Causal chunked-flash attention for long prefill: the reference's
    triangular (i, j) chunk-pair online softmax, pairs in its order (i
    outer), each query chunk's running max, sum and float32 accumulator
    carried across its key chunks."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    assert sq % cq == 0 and sk % ck == 0
    dev = q.device
    out = []
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
        out.append(acc / torch.clamp(l[..., None], min=1e-30))
    return torch.cat(out, dim=2).transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP


def mlp_specs(cfg):
    d, f, dtype = cfg.d_model, cfg.d_ff, cfg.params_dtype
    s = {"w_in": ParamSpec((d, f), dtype), "w_out": ParamSpec((f, d), dtype)}
    if cfg.act == "swiglu":
        s["w_gate"] = ParamSpec((d, f), dtype)
    return s


def as_constant(v: float, dtype) -> float:
    """A Python float rounded to ``dtype``: a weak-typed float meets a bf16
    array as a bf16 constant in the reference, where torch would compute
    with the float itself."""
    return float(torch.tensor(v, dtype=dtype))


def silu(x):
    """``jax.nn.silu`` as the reference computes it: ``x * logistic(x)``,
    the logistic expanded to ``1 / (1 + exp(-x))``, every op rounded to x's
    dtype (``F.silu`` rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


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


def embed_specs(cfg):
    return {"table": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.params_dtype,
                               init="small")}


def embed(p, tokens, policy):
    return p["table"][tokens].to(policy.compute)


def logits_specs(cfg):
    if cfg.tie_embeddings:
        return {}
    return {"w": ParamSpec((cfg.d_model, cfg.vocab_size), cfg.params_dtype)}


def logits(cfg, p_lm, p_embed, x, policy):
    cdt = policy.compute
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x.to(cdt), p_embed["table"].to(cdt))
    return x.to(cdt) @ p_lm["w"].to(cdt)
