"""Token-choice top-k Mixture-of-Experts with expert parallelism
(counterpart of ``repro/models/moe.py``).

Three paths, routed by ``apply_moe`` as the reference routes them:

- ``dense_moe`` (no mesh, or an expert count the 'model' axis does not
  divide): every token through every expert, each expert's output weighted
  by the token's gate for it (zero where the router did not pick it), so
  routing drops nothing.  At top-1 of 16 experts (llama4-scout) that is 16
  times the expert FLOPs that routing needs; the reference pays the same.
- ``ep_moe`` over a mesh: the reference's ``shard_map`` region as explicit
  SPMD on this rank's blocks.  Tokens are this rank's batch block
  (replicated over 'model'), experts this rank's block over 'model'; the
  rank routes its tokens, scatters those assigned to its experts into an
  (E_local, C, d) bf16 buffer (cumsum dispatch, no sort), runs the expert
  GEMMs, gathers each (token, k)'s row back weighted by its gate, adds the
  shared expert's partial product (its ff axis is over 'model', and
  ``apply_mlp`` without a mesh leaves it a partial) and sums over 'model':
  one all-reduce a layer, the shared expert's included once.  With ``fsdp`` the experts' ff axis
  is also over 'data' and is all-gathered first.
- ``ep_moe_decode`` (decode shapes): the tokens are all-gathered over
  'data' instead, every rank computes its (experts x resident ff slice)
  contribution, the sum runs over ('data', 'model') and each rank keeps its
  rows.  Its capacity is 8x the balanced expectation; an assignment past it
  is dropped, as its docstring and ``ep_moe``'s own mask say.  The
  reference's ``ep_moe_decode`` does not mask it, and the overflowing token
  lands in the next expert's rows (ROADMAP F7); the port masks it.

``ep_pspecs`` gives the blocks the two expert-parallel paths take (the
reference's ``in_specs``).  The collectives are ``launch.mesh``'s
differentiable ``psum``/``pmean``/``all_gather``, so both paths train.
The router is float32; the expert GEMMs run in ``policy.compute`` (bf16)
with the reference's per-op bf16 logistic.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import P, ParamSpec, spec_map
from repro_torch.launch import mesh as M
from repro_torch.models.layers import DATA_AXES, apply_mlp, silu, split_over_model

_F32 = torch.float32


def moe_specs(cfg, tp: int = 1, fsdp: bool = False):
    """Router, stacked expert weights (over 'model'; with ``fsdp`` their ff
    axis over 'data') and the shared expert (its ff axis over 'model')."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    dt = cfg.params_dtype
    ff_ax = "data" if fsdp else None
    s = {
        "router": ParamSpec((d, e), _F32, P(), init="small"),
        "w_in": ParamSpec((e, d, f), dt, P("model", None, ff_ax)),
        "w_gate": ParamSpec((e, d, f), dt, P("model", None, ff_ax)),
        "w_out": ParamSpec((e, f, d), dt, P("model", ff_ax, None)),
    }
    if m.n_shared:
        fs = f * m.n_shared
        s["shared"] = {
            "w_in": ParamSpec((d, fs), dt, P(None, "model")),
            "w_gate": ParamSpec((d, fs), dt, P(None, "model")),
            "w_out": ParamSpec((fs, d), dt, P("model", None)),
        }
    return s


def ep_pspecs(cfg, fsdp: bool = False):
    """The blocks ``ep_moe`` and ``ep_moe_decode`` take (the reference's
    ``in_specs``): the experts over 'model' (and their ff axis over 'data'
    with ``fsdp``), the shared expert's ff axis over 'model', the router
    whole."""
    return spec_map(lambda s: s.pspec, moe_specs(cfg, fsdp=fsdp))


def expert_parallel(cfg, mesh) -> bool:
    """Whether ``apply_moe`` takes an expert-parallel path on ``mesh``: a
    'model' axis whose size divides the expert count (else ``dense_moe``,
    as the reference)."""
    return (mesh is not None and "model" in mesh.mesh_dim_names
            and cfg.moe.n_experts % M.axis_size(mesh, "model") == 0)


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
    arrival order, by a cumulative sum of one-hot rows (no sort).  The rows
    are a comparison with the expert ids, where ``F.one_hot`` would read
    its input's range back to the host (and take another path on fake
    tensors than on real ones)."""
    t, kk = experts.shape
    base = torch.zeros((n_experts,), dtype=torch.int32, device=experts.device)
    ids = torch.arange(n_experts, device=experts.device)
    pos = []
    for k in range(kk):
        oh = (experts[:, k, None].long() == ids).to(torch.int32)  # (T, E)
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


def dense_moe(cfg, p, x, policy, mesh=None):
    """Every token through every expert, weighted by its gates (zero for the
    experts it was not routed to); no capacity, nothing dropped.  Returns
    (y (B, S, d), aux).  Over ``mesh`` the experts are whole (a 'model' axis
    that does not divide them cannot hold their spec's blocks); the shared
    expert runs on its ff block, summed over 'model', where it is held as
    one (``layers.split_over_model``), else whole."""
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
        split = split_over_model(mesh, p["shared"]["w_in"].shape[-1], m.d_ff_expert * m.n_shared)
        y = y + apply_mlp(cfg, p["shared"], x2, policy, mesh=mesh if split else None)
    return y.reshape(b, s, d), aux


def _present(mesh, axes):
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def _dispatch(x_rows, slot, take, n_rows, cdt, top_k):
    """The (n_rows + 1, d) bf16 buffer of the taken (token, k) rows at their
    slots, the last row the dummy that collects the rest."""
    buf = torch.zeros((n_rows + 1, x_rows.shape[1]), dtype=cdt, device=x_rows.device)
    xc = x_rows.to(cdt)
    for k in range(top_k):
        buf = buf.index_add(0, slot[:, k].long(), torch.where(take[:, k, None], xc, 0))
    return buf


def _combine(out_rows, slot, take, gates, cdt, top_k):
    """Each token's sum over k of its row times its gate (0 where not taken)."""
    out_rows = torch.cat([out_rows, out_rows.new_zeros((1, out_rows.shape[1]))], dim=0)
    y = out_rows.new_zeros((slot.shape[0], out_rows.shape[1]))
    for k in range(top_k):
        y = y + out_rows[slot[:, k].long()] * (gates[:, k, None].to(cdt) * take[:, k, None])
    return y


def ep_moe(cfg, p, x, policy, mesh, fsdp: bool = False):
    """Expert-parallel MoE on this rank's blocks (``ep_pspecs``): ``x`` (b, s,
    d) is this rank's batch block.  Returns (y (b, s, d), aux): aux is the
    mean over the whole mesh of each rank's Switch loss of its own tokens, as
    the reference's ``pmean``."""
    m = cfg.moe
    cdt = policy.compute
    e_total = m.n_experts
    tp = M.axis_size(mesh, "model")
    assert e_total % tp == 0, (e_total, tp)
    e_loc = e_total // tp
    b, s, d = x.shape
    t = b * s
    x2 = M.mean_grad(x.reshape(t, d), mesh, "model")  # whole on every 'model' rank
    gates, experts, aux = _route(cfg, p, x2)
    cap = _capacity(cfg, t)
    pos = _positions_in_expert(experts, e_total)  # (T, k)
    e_lo = M.axis_index(mesh, "model") * e_loc
    local = (experts >= e_lo) & (experts < e_lo + e_loc) & (pos < cap)
    slot = torch.where(local, (experts - e_lo) * cap + pos, e_loc * cap)  # dummy row
    buf = _dispatch(x2, slot, local, e_loc * cap, cdt, m.top_k)
    w_in, w_gate, w_out = p["w_in"], p["w_gate"], p["w_out"]
    if fsdp:  # gather the data-sharded ff axis of this layer's experts
        w_in = M.all_gather(w_in, mesh, "data", 2)
        w_gate = M.all_gather(w_gate, mesh, "data", 2)
        w_out = M.all_gather(w_out, mesh, "data", 1)
    out_rows = _expert_ffn(cfg, w_in, w_gate, w_out, buf[:-1].reshape(e_loc, cap, d),
                           cdt).reshape(e_loc * cap, d)
    y = _combine(out_rows, slot, local, gates, cdt, m.top_k)
    if m.n_shared:
        y = y + apply_mlp(cfg, p["shared"], x2, policy)  # partial over ff shards
    y = M.psum(y, mesh, "model")
    aux = M.pmean(aux, mesh, _present(mesh, ("pod", "data", "model")))
    return y.reshape(b, s, d), aux


def ep_moe_decode(cfg, p, x, policy, mesh, fsdp: bool):
    """Decode-shape MoE on this rank's blocks: the (b, s, d) tokens
    all-gathered over 'data', each rank's (expert subset x resident ff slice)
    contribution summed over ('data', 'model'), this rank's rows kept.
    Without ``fsdp`` every data rank holds the experts' whole ff axis, so its
    rows are divided by dp before the sum, as the shared expert's.
    Capacity: ``min(k T, max(32, 8 ceil(k T / E)))`` slots an expert; an
    assignment past it is dropped (ROADMAP F7)."""
    m = cfg.moe
    cdt = policy.compute
    tp = M.axis_size(mesh, "model")
    dp = M.axis_size(mesh, "data") if "data" in mesh.mesh_dim_names else 1
    e_loc = m.n_experts // tp
    b, s, d = x.shape
    x2 = M.mean_grad(x.reshape(b * s, d), mesh, "model")  # whole on every 'model' rank
    x_all = M.all_gather(x2, mesh, "data", 0) if dp > 1 else x2  # (T_pod, d)
    t_all = x_all.shape[0]
    gates, experts, aux = _route(cfg, p, x_all)
    expected = -(-m.top_k * t_all // m.n_experts)
    cap = min(m.top_k * t_all, max(32, 8 * expected))
    pos = _positions_in_expert(experts, m.n_experts)
    e_lo = M.axis_index(mesh, "model") * e_loc
    mine = (experts >= e_lo) & (experts < e_lo + e_loc) & (pos < cap)
    slot = torch.where(mine, (experts - e_lo) * cap + pos, e_loc * cap)
    buf = _dispatch(x_all, slot, mine, e_loc * cap, cdt, m.top_k)[:-1].reshape(e_loc, cap, d)
    out_rows = _expert_ffn(cfg, p["w_in"], p["w_gate"], p["w_out"], buf,
                           cdt).reshape(e_loc * cap, d)
    if not fsdp and dp > 1:
        out_rows = out_rows / dp  # full-f replicas would be summed dp times
    y = _combine(out_rows, slot, mine, gates, cdt, m.top_k)
    if m.n_shared:
        ysh = apply_mlp(cfg, p["shared"], x_all, policy)  # partial over model-ff
        y = y + (ysh / dp if dp > 1 else ysh)
    y = M.psum(y, mesh, ("data", "model") if dp > 1 else ("model",))
    rank_d = M.axis_index(mesh, "data") if dp > 1 else 0
    y_loc = y[rank_d * b * s:(rank_d + 1) * b * s]
    aux = M.pmean(aux, mesh, _present(mesh, ("pod", "data", "model")))
    return y_loc.reshape(b, s, d), aux


def apply_moe(cfg, p, x, policy, mesh=None, fsdp=False, decode=False):
    """The MoE block, routed as the reference's: over a mesh whose 'model'
    size divides the expert count, ``ep_moe_decode`` at decode shapes of at
    most 4096 tokens (global: this rank's block times the batch axes' size)
    and ``ep_moe`` otherwise, each on this rank's blocks (``ep_pspecs``);
    else ``dense_moe`` on whole weights.  Returns (y, aux)."""
    if expert_parallel(cfg, mesh):
        if decode and x.shape[0] * x.shape[1] * M.axis_size(
                mesh, _present(mesh, DATA_AXES)) <= 4096:
            return ep_moe_decode(cfg, p, x, policy, mesh, fsdp=fsdp)
        return ep_moe(cfg, p, x, policy, mesh, fsdp=fsdp)
    return dense_moe(cfg, p, x, policy, mesh)
