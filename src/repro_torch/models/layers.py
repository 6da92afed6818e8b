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

Tensor parallelism over 'model' (``mesh=``): each rank holds its block of
every weight whose spec names 'model' and runs the Megatron layout on it,
with the collectives GSPMD inserts for the reference written out
(``launch/mesh.py``).  Attention runs on the rank's head block (``Heads``:
the global index of its first query head, F8's padded count, the kv heads
each query head reads), its output row-parallel through ``wo`` and summed
over 'model'; the MLP is column-parallel through ``w_in``/``w_gate`` and
row-parallel through ``w_out``, then summed; the embedding gathers the
rank's vocab rows (zero rows for tokens outside them) and sums; ``logits``
returns the rank's vocab block, never gathered; ``cross_entropy`` takes its
max and its sum of exponentials over 'model' and the target's logit from
the block that holds it.  Where a tensor whole on every rank enters a
split computation (``model_input``), its cotangents are averaged over
'model' in the backward (``mesh.mean_grad``), where the reference's
transposes all-reduce them.  Whether a dim is split is read off the
block's size (``split_over_model``); on a 'model' axis of one every block
is the whole and every collective is skipped, so the arithmetic is the
single device's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis.roofline import _ByteCounter, register_byte_formula
from repro_torch.common import P, ParamSpec, dispatch_mode_on, entry_axes
from repro_torch.launch import mesh as M

_F32 = torch.float32
TP = 1  # the model-axis size the port builds at by default
DATA_AXES = ("data", "pod")  # batch shards over both; 'pod' absent on 1-pod meshes


def batch_pspec(*rest):
    return P(DATA_AXES, *rest)


# ---------------------------------------------------------------------------
# the 'model' axis


def has_model(mesh) -> bool:
    return mesh is not None and "model" in mesh.mesh_dim_names


def tp_size(mesh) -> int:
    """The 'model' axis size of ``mesh`` (1 without a mesh or the axis)."""
    return M.axis_size(mesh, "model") if has_model(mesh) else 1


def tp_index(mesh) -> int:
    """This rank's block index along 'model' (0 without a mesh or the axis)."""
    return M.axis_index(mesh, "model") if has_model(mesh) else 0


def split_over_model(mesh, local: int, whole: int) -> bool:
    """Whether a dim of ``whole`` entries held as ``local`` of them is split
    over 'model': a smaller block, or any block on a 'model' axis of one (its
    one block: the collectives are called and skipped)."""
    return has_model(mesh) and (local < whole or tp_size(mesh) == 1)


def model_sum(x, mesh, split: bool):
    """A row-parallel partial summed over 'model' (``x`` where not split)."""
    return M.psum(x, mesh, "model") if split else x


def model_input(x, mesh, split: bool):
    """``x``, whole on every 'model' rank, entering a computation split over
    'model': its cotangents averaged over 'model' in the backward
    (``mesh.mean_grad``; ``x`` where not split)."""
    return M.mean_grad(x, mesh, "model") if split else x


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


def mask_pad_heads(cfg, o, lo: int = 0, total: int | None = None):
    """Zero the padded heads' attention output (B, S, H, Dh): heads ``lo``
    to ``lo + H`` of ``total`` (H: the whole) padded heads."""
    total = o.shape[2] if total is None else total
    if total == cfg.n_heads:
        return o
    mask = (lo + torch.arange(o.shape[2], device=o.device) < cfg.n_heads).to(o.dtype)
    return o * mask[None, None, :, None]


@dataclasses.dataclass(frozen=True)
class Heads:
    """This rank's query heads: ``lo`` (the global index of its first) to
    ``lo + n`` of ``total`` (padded) heads; ``kv``: None where its kv block
    is grouped as ``expand_kv`` groups it, else the index (into the whole kv
    heads, replicated when 'model' does not divide them) of the kv head each
    of its query heads reads: ``(lo + j) // (total // Hkv)``, F8's grouping;
    ``split``: whether the heads are split over 'model' (the output
    projection gives a partial sum)."""

    lo: int
    n: int
    total: int
    kv: torch.Tensor | None
    split: bool


def heads(cfg, p, mesh=None) -> Heads:
    """``Heads`` of the attention weights ``p`` (this rank's blocks)."""
    hq, hkv = p["wq"].shape[-2], p["wk"].shape[-2]
    if not split_over_model(mesh, hq, cfg.n_heads):
        return Heads(0, hq, hq, None, False)
    tp = tp_size(mesh)
    lo, total = tp_index(mesh) * hq, hq * tp
    kv = None
    if hkv == cfg.n_kv_heads and tp > 1:  # kv heads whole: take the ones read
        kv = (lo + torch.arange(hq, device=p["wk"].device)) // (total // hkv)
    return Heads(lo, hq, total, kv, True)


def select_kv(k, hd: Heads):
    """k (B, S, Hkv, Dh) as the kv heads this rank's query heads read:
    (B, S, n, Dh) where ``hd.kv`` picks them, else ``k`` itself."""
    return k if hd.kv is None else k.index_select(2, hd.kv)


def qkv_project(cfg, p, x, policy, angles=None, x_kv=None, mesh=None):
    """q (B,Sq,Hq,Dh) from x and k/v (B,Skv,Hkv,Dh) from ``x_kv`` (x itself
    unless given); qk-norm before RoPE.  With ``mesh``, x (and ``x_kv``)
    enter this rank's heads (``model_input``) where they are split."""
    if heads(cfg, p, mesh).split:
        x = model_input(x, mesh, True)
        x_kv = None if x_kv is None else model_input(x_kv, mesh, True)
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


# ---------------------------------------------------------------------------
# split-KV decode: one decode query against one block of the cache's
# positions, and the combine of the blocks' partial softmaxes


def row_axes(mesh) -> tuple[str, ...]:
    """The mesh axes a decode batch's rows are split over: the reference's
    batch axes ("pod" major), as ``cache_specs`` splits a batch of 16 or
    more."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


class KVLayout(NamedTuple):
    """One attention layer's decode layout: ``spec`` the (B, S, Hkv, Dh)
    pspec of its k or v, ``rows`` the axes the step's batch is split over
    (() where every rank holds the whole batch)."""

    spec: P
    rows: tuple[str, ...]


def kv_spec(entry, batch: P) -> KVLayout:
    """One layer's ``KVLayout`` from a stacked attention cache entry's
    pspec pair (its batch, sequence, kv-head and head-dim entries; the
    stacking axes dropped) and the decode layout's "batch" pspec (the
    step's rows, ``model.decode_layout``)."""
    return KVLayout(P(*list(entry[0])[-4:]), entry_axes(batch[0]))


def block_scores(q, k_block, offset: int, length):
    """q (B, 1, Hq, Dh) against a block of the cache (B, Sb, Hkv, Dh) that
    holds global positions ``offset`` to ``offset + Sb``, grouped as
    ``transformer._grouped_decode_attention`` groups the heads: (the float32
    scores (B, Hkv, G, 1, Sb), -inf at positions >= ``length``; their max
    over the block (B, Hkv, G, 1, 1), -inf where the block is wholly
    masked)."""
    b, _, hq, dh = q.shape
    hkv = k_block.shape[2]
    s = scores(q.reshape(b, 1, hkv, hq // hkv, dh), k_block, "bqhgd,bkhd->bhgqk")
    mask = offset + torch.arange(k_block.shape[1], device=q.device) < length
    s = torch.where(mask, s, -torch.inf)
    return s, s.amax(-1, keepdim=True)


def block_weights(s, m, gmax):
    """(the block's softmax of its scores ``s``, float32; its share of the
    global denominator, ``sum(exp(s - m)) * exp(m - gmax)`` with ``gmax``
    the max over every block).  A wholly masked block (``m`` = -inf) gives 0
    for both, not the NaN of ``-inf - -inf``."""
    live = m > -torch.inf
    w = torch.where(live, torch.softmax(s, dim=-1), 0.0)
    t = torch.where(live, torch.exp(s - m).sum(-1, keepdim=True) * torch.exp(m - gmax), 0.0)
    return w, t


def block_output(w, t, total, v_block, dtype):
    """The block's partial output (B, 1, Hq, Dh) in ``dtype``: its weights
    scaled by its share ``t / total`` of the global denominator, cast to
    ``dtype`` as the reference casts its float32 softmax, times the block's
    V.  With one block ``t / total`` is exactly 1, so the weights are
    ``torch.softmax``'s bit for bit."""
    w = (w * (t / total)).to(dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v_block)
    return o.reshape(o.shape[0], 1, -1, o.shape[-1])


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
    no gradient path.  Under a dispatch mode (``common.dispatch_mode_on``)
    the loop runs inside one custom op (``torch.ops.repro_torch.flash_prefill``):
    a counter sees one op whose FLOPs are the loop's two products per chunk
    pair (``_flash_prefill_flops``) and whose bytes are the loop's
    (``_flash_prefill_bytes``: the port has no fused prefill kernel), and
    under fake tensors (``launch/dryrun.py``) it is traced as one op, not as
    the 2080 chunk pairs of a 32k prompt.  With no mode on the loop runs
    directly."""
    sq, sk = q.shape[1], k.shape[1]
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    assert sq % cq == 0 and sk % ck == 0
    if dispatch_mode_on():
        return _flash_prefill(q, k, v, cq, ck)
    return _flash_prefill_run(q, k, v, cq, ck)


def _flash_prefill_run(q, k, v, cq, ck):
    return _flash_fwd_core(q, k, v, cq, ck)[0].transpose(1, 2).to(q.dtype)


@torch.library.custom_op("repro_torch::flash_prefill", mutates_args=())
def _flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cq: int,
                   ck: int) -> torch.Tensor:
    return _flash_prefill_run(q, k, v, cq, ck)


@_flash_prefill.register_fake
def _(q, k, v, cq, ck):
    b, sq, h, dh = q.shape
    return q.new_empty((b, h, sq, dh)).transpose(1, 2)


def _flash_pairs(rows, cq, ck) -> int:
    """The chunk pairs ``_flash_fwd_core`` visits for ``rows`` query chunks."""
    return sum((i + 1) * cq // ck for i in range(rows))


@register_flop_formula(torch.ops.repro_torch.flash_prefill)
def _flash_prefill_flops(q_shape, k_shape, v_shape, cq, ck, *args, **kwargs) -> int:
    """Two (cq x Dh) by (Dh x ck) products per chunk pair and head, as
    ``FlopCounterMode`` counts the loop's einsums."""
    b, sq, h, dh = q_shape
    return _flash_pairs(sq // cq, cq, ck) * 2 * (2 * b * h * cq * ck * dh)


@register_byte_formula(torch.ops.repro_torch.flash_prefill)
def _flash_prefill_bytes(q, k, v, cq, ck) -> int:
    """The bytes the loop's ops move, as ``roofline``'s byte counter counts
    them: its (B, H, cq, ck) float32 score tiles and their elementwise
    passes, each chunk pair's, as the eager loop writes them to memory."""
    layout = tuple((tuple(t.shape), tuple(t.stride()), t.dtype) for t in (q, k, v))
    return _flash_loop_bytes(layout, cq, ck)


@functools.lru_cache(maxsize=None)
def _flash_loop_bytes(layout, cq, ck) -> int:
    """``_flash_prefill_bytes`` for q, k, v of these (shape, stride, dtype)s.
    Every chunk pair runs the same ops on tiles of the same shapes, and so
    does every query chunk outside its pairs (its accumulators, its
    normalisation, its share of the concatenation and the cast), so the
    bytes are c + rows r + pairs p: the loop is counted on fake tensors of
    the same strides cut to 1, 2 and 3 query chunks (or whole, if it has no
    more), and c, r and p solved for.  It is counted on a thread of its
    own, where no dispatch mode or handler is on: inside a mode's handler
    (where the formula is called) the dispatcher would not decompose the
    composite ops (``einsum``, ``where``) that a call of the loop runs
    through."""
    import concurrent.futures

    assert cq % ck == 0, (cq, ck)
    rows = layout[0][0][1] // cq
    counts = (rows,) if rows <= 3 else (1, 2, 3)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        totals = pool.submit(_count_flash_loop, layout, cq, ck, counts).result()
    if rows <= 3:
        return totals[0]
    t1, t2, t3 = totals
    p1, p2, p3 = (_flash_pairs(n, cq, ck) for n in counts)
    p = ((t3 - t2) - (t2 - t1)) // ((p3 - p2) - (p2 - p1))
    r = (t2 - t1) - (p2 - p1) * p
    return t1 - r - p1 * p + rows * r + _flash_pairs(rows, cq, ck) * p


def _count_flash_loop(layout, cq, ck, counts) -> list[int]:
    """The bytes of ``_flash_prefill_run`` on fake q, k, v of ``layout`` cut
    to each of ``counts`` query chunks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    totals = []
    with FakeTensorMode():
        q, k, v = (torch.empty_strided(shape, stride, dtype=dtype)
                   for shape, stride, dtype in layout)
        for n in counts:
            with _ByteCounter() as moved:
                _flash_prefill_run(*(t[:, :n * cq] for t in (q, k, v)), cq, ck)
            totals.append(moved.bytes)
    return totals


def flash_attention_train(q, k, v, chunk_q=512, chunk_k=512):
    """Causal flash attention with a flash backward, q/k/v (B, S, H, Dh):
    forward and backward stream (chunk_q, chunk_k) tiles of the causal
    triangle, O(S * Dh) saved besides the inputs."""
    return FlashAttentionTrain.apply(q, k, v, min(chunk_q, q.shape[1]),
                                     min(chunk_k, k.shape[1]))


class _VocabLogsumexp(torch.autograd.Function):
    """logsumexp over the last dim of logits split over 'model': the max
    and the sum of exponentials all-reduced, each written as
    ``torch.logsumexp`` computes them (the max of an infinite row taken as
    0), so one block of the whole gives its values bit for bit.  Backward
    as ``torch.logsumexp``'s, ``g * exp(x - lse)``, with ``g`` first summed
    over 'model': every rank's loss reads the same lse."""

    @staticmethod
    def forward(ctx, x, mesh):
        m = M.pmax(torch.amax(x, dim=-1, keepdim=True), mesh, "model")
        m = m.masked_fill(m.abs() == torch.inf, 0)
        s = M.all_reduce(torch.sum(torch.exp(x - m), dim=-1), mesh, "model")
        lse = torch.log(s) + m[..., 0]
        ctx.save_for_backward(x, lse)
        ctx.mesh = mesh
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        g = M.all_reduce(g, ctx.mesh, "model")
        return g[..., None] * torch.exp(x - lse[..., None]), None


def cross_entropy(lg, targets, mask=None, mesh=None, vocab=None):
    """Mean next-token cross-entropy of (B, S, V) logits in float32
    (logsumexp minus the target's logit); with ``mask``, its weighted mean.
    With ``mesh`` and ``vocab`` (the whole vocab), ``lg`` may be this rank's
    block of the vocab over 'model' (``logits``): the logsumexp over the
    blocks (``_VocabLogsumexp``) and the target's logit from the rank that
    holds it, summed over 'model'."""
    lg = lg.to(_F32)
    v = lg.shape[-1]
    if vocab is not None and split_over_model(mesh, v, vocab):
        lo = tp_index(mesh) * v
        local = targets.long() - lo
        inside = (local >= 0) & (local < v)
        tgt = lg.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
        tgt = M.psum(torch.where(inside, tgt, 0.0), mesh, "model")
        nll = _VocabLogsumexp.apply(lg, mesh) - tgt
    else:
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


def apply_mlp(cfg, p, x, policy, mesh=None):
    """The MLP on ``p``'s blocks: with ``mesh`` (a 'model' axis) the ff
    axis is this rank's block (its spec always names 'model') and the
    output is summed over 'model'; without, a partial sum where the blocks
    are (``moe.ep_moe``'s shared expert joins its own all-reduce)."""
    cdt = policy.compute
    split = has_model(mesh)
    xc = model_input(x.to(cdt), mesh, split)
    h = xc @ p["w_in"].to(cdt)
    if cfg.act == "swiglu":
        h = silu(xc @ p["w_gate"].to(cdt)) * h
    else:
        h = gelu(h)
    return model_sum(h @ p["w_out"].to(cdt), mesh, split)


# ---------------------------------------------------------------------------
# embeddings / logits


def embed_specs(cfg, tp: int = TP):
    vocab_ax = "model" if cfg.vocab_size % tp == 0 else None
    return {"table": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.params_dtype,
                               P(vocab_ax, None), init="small")}


def embed(p, tokens, policy, mesh=None, vocab=None):
    """The tokens' rows of the table in the compute dtype.  With ``mesh``
    and ``vocab`` the table may be this rank's vocab block: tokens outside
    it give zero rows and the rows are summed over 'model' (exact: one
    nonzero a token) before the cast."""
    table = p["table"]
    v = table.shape[0]
    if vocab is None or not split_over_model(mesh, v, vocab):
        return table[tokens].to(policy.compute)
    if v == vocab:
        rows = table[tokens]
    else:
        local = tokens.long() - tp_index(mesh) * v
        inside = (local >= 0) & (local < v)
        rows = torch.where(inside[..., None], table[local.clamp(0, v - 1)], 0)
    return M.psum(rows, mesh, "model").to(policy.compute)


def logits_specs(cfg, tp: int = TP):
    if cfg.tie_embeddings:
        return {}
    vocab_ax = "model" if cfg.vocab_size % tp == 0 else None
    return {"w": ParamSpec((cfg.d_model, cfg.vocab_size), cfg.params_dtype, P(None, vocab_ax))}


def logits(cfg, p_lm, p_embed, x, policy, mesh=None):
    """Logits of the vocab rows ``p_lm``/``p_embed`` hold: this rank's vocab
    block over 'model' where the vocab is split (never gathered, as the
    reference's)."""
    cdt = policy.compute
    v = p_embed["table"].shape[0] if cfg.tie_embeddings else p_lm["w"].shape[-1]
    x = model_input(x, mesh, split_over_model(mesh, v, cfg.vocab_size))
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x.to(cdt), p_embed["table"].to(cdt))
    return x.to(cdt) @ p_lm["w"].to(cdt)
