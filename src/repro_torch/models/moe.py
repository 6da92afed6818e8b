"""Token-choice top-k Mixture-of-Experts (counterpart of
``repro/models/moe.py``) on one card.

``apply_moe`` takes the reference's single-device path, ``dense_moe``:
every token through every expert, each expert's output weighted by the
token's gate for it (zero where the router did not pick it), so routing
drops nothing.  At top-1 of 16 experts (llama4-scout) that is 16 times the
expert FLOPs that routing needs; the reference's single-device path pays
the same.  The expert-parallel paths (``ep_moe``, ``ep_moe_decode``) shard
experts over a mesh and are ROADMAP module item 12; ``_positions_in_expert``
and ``_capacity``, which only they use, are ported for them.

The router is float32; the expert GEMMs run in ``policy.compute`` (bf16)
with the reference's per-op bf16 logistic.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import ParamSpec
from repro_torch.models.layers import apply_mlp, silu

_F32 = torch.float32


def moe_specs(cfg):
    """Router, stacked expert weights and the shared expert (the reference's
    tree at tp = 1)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    dt = cfg.params_dtype
    s = {
        "router": ParamSpec((d, e), _F32, init="small"),
        "w_in": ParamSpec((e, d, f), dt),
        "w_gate": ParamSpec((e, d, f), dt),
        "w_out": ParamSpec((e, f, d), dt),
    }
    if m.n_shared:
        fs = f * m.n_shared
        s["shared"] = {
            "w_in": ParamSpec((d, fs), dt),
            "w_gate": ParamSpec((d, fs), dt),
            "w_out": ParamSpec((fs, d), dt),
        }
    return s


def _top_k(probs, k):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort keeps equal values in index order;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _count(idx, n):
    """``jnp.bincount(idx, length=n)`` in int32, by a scatter-add (no host
    sync: ``torch.bincount`` reads the largest index back to size its
    output)."""
    counts = torch.zeros((n,), dtype=torch.int32, device=idx.device)
    return counts.scatter_add_(0, idx.long(), torch.ones_like(idx, dtype=torch.int32))


def _route(cfg, p, x2d):
    """x2d (T, d) -> gates (T, k) float32, experts (T, k) int32, and the
    Switch-style load-balance loss ``E * sum_e f_e * p_e * coef``."""
    m = cfg.moe
    logits = x2d.to(_F32) @ p["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, m.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    f_e = torch.zeros((m.n_experts,), dtype=_F32, device=x2d.device)
    for k in range(m.top_k):
        f_e = f_e + _count(experts[:, k], m.n_experts).to(_F32)
    f_e = f_e / (x2d.shape[0] * m.top_k)
    aux = m.n_experts * torch.sum(f_e * probs.mean(0)) * m.router_aux_coef
    return gates, experts, aux


def _positions_in_expert(experts, n_experts):
    """Each (token, k)'s slot within its expert: token-major, k-minor
    arrival order, by a cumulative sum of one-hot rows (no sort)."""
    t, kk = experts.shape
    base = torch.zeros((n_experts,), dtype=torch.int32, device=experts.device)
    pos = []
    for k in range(kk):
        oh = F.one_hot(experts[:, k].long(), n_experts).to(torch.int32)  # (T, E)
        within = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1
        pos.append(((within * oh).sum(-1) + base[experts[:, k].long()]).to(torch.int32))
        base = base + oh.sum(0, dtype=torch.int32)
    return torch.stack(pos, dim=1)  # (T, k)


def _capacity(cfg, t_local: int) -> int:
    """Slots per expert: dropless (``top_k * T``) up to 4096 routed tokens,
    else ``ceil(top_k * T * cf / E)`` rounded up to a multiple of 8."""
    m = cfg.moe
    if m.top_k * t_local <= 4096:
        return m.top_k * t_local
    c = math.ceil(m.top_k * t_local * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)


def _expert_ffn(cfg, w_in, w_gate, w_out, buf, cdt):
    """SwiGLU of each expert's rows: buf (E, C, d) -> (E, C, d)."""
    h_in = torch.einsum("ecd,edf->ecf", buf, w_in.to(cdt))
    h = silu(torch.einsum("ecd,edf->ecf", buf, w_gate.to(cdt))) * h_in
    return torch.einsum("ecf,efd->ecd", h, w_out.to(cdt))


def dense_moe(cfg, p, x, policy):
    """Every token through every expert, weighted by its gates (zero for the
    experts it was not routed to); no capacity, nothing dropped.  Returns
    (y (B, S, d), aux)."""
    m = cfg.moe
    cdt = policy.compute
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    gates, experts, aux = _route(cfg, p, x2)
    # the reference's sum over k of one_hot(experts[:, k]) * gates[:, k]: a
    # token's k experts differ, so each entry is one gate or 0 (a scatter,
    # where ``F.one_hot`` would read its input's range back to the host)
    weight = torch.zeros((b * s, m.n_experts), dtype=_F32, device=x.device)
    weight = weight.scatter_(1, experts.long(), gates)
    xc = x2.to(cdt)
    h_in = torch.einsum("td,edf->tef", xc, p["w_in"].to(cdt))
    h = silu(torch.einsum("td,edf->tef", xc, p["w_gate"].to(cdt))) * h_in
    y_e = torch.einsum("tef,efd->ted", h, p["w_out"].to(cdt))
    y = torch.einsum("ted,te->td", y_e, weight.to(cdt))
    if m.n_shared:
        y = y + apply_mlp(cfg, p["shared"], x2, policy)
    return y.reshape(b, s, d), aux


def apply_moe(cfg, p, x, policy, mesh=None):
    """The MoE block: ``dense_moe`` on one card.  A mesh (the reference's
    expert-parallel ``ep_moe``/``ep_moe_decode``) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError("expert-parallel MoE over a mesh (ep_moe, ep_moe_decode) "
                                  "is not ported yet: ROADMAP module item 12")
    return dense_moe(cfg, p, x, policy)
