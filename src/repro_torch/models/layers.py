"""Model building blocks the ssm family needs: norms, embeddings, logits
(counterpart of the same functions in ``repro/models/layers.py``).

Params are nested dicts; ``<module>_specs(cfg)`` returns a ``ParamSpec``
tree and the apply functions take tensors.  Activations are (batch, seq,
d_model); matmuls run in ``policy.compute`` (bf16), reductions in float32,
and every cast sits where the JAX code has its ``astype``.
"""
from __future__ import annotations

import torch

from repro_torch.common import ParamSpec

_F32 = torch.float32


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
