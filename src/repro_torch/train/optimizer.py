"""AdamW with a global gradient clip, ZeRO-1 sharded moments and optional
int8 moments (counterpart of ``repro/train/optimizer.py``).

ZeRO-1: a moment gets an extra split over 'data' on the largest axis its
parameter's spec leaves free (``zero1_pspec``), so its memory a device
drops by the data degree.  Over a mesh ``adamw_update`` takes this rank's
blocks of p, g, m and v in one layout (``layout``): each leaf's sum of
squares is taken on its block and summed over the axes the block is split
on, so the global norm counts every entry once; an int8 moment's row
maximum is taken over the ranks that split its last axis.

int8 moments (``moments_dtype=torch.int8``, kimi-k2's): blockwise
symmetric quantization along the last axis (a float32 scale per row),
dequantized transiently inside the update, so a moment costs one byte per
parameter (ROADMAP F5: small entries of v round to 0, as the reference's).

The update is the reference's formula written out in float32 torch ops,
leaf by leaf (a large leaf in slabs along its leading axis, which bounds
the float32 temporaries and changes no value), with the step, the learning rate and the clip factor as
device tensors, so a step reads nothing back to the host.  It writes the
new parameters and moments into the state's own tensors: the counterpart
of the reference's donated state, which at qwen3-1.7b's full width saves
a second copy of 27 GB.  ``torch.optim.AdamW`` is not used: it rounds its
weight decay differently and has neither the int8 moments nor the global
clip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.common import P, ParamSpec, entry_axes, spec_map
from repro_torch.launch import mesh as M

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moments_dtype: Any = torch.float32


def schedule(oc: OptConfig, step):
    """Linear warmup -> cosine decay; ``step`` an int32 tensor (or an int)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1),
                    0.0, 1.0)
    return oc.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def zero1_pspec(spec: ParamSpec) -> P:
    """Add 'data' sharding on the largest axis the param pspec leaves free
    (of a size divisible by 16; skipped when the pspec already uses the
    data axis, e.g. FSDP weights)."""
    entries = list(spec.pspec) + [None] * (len(spec.shape) - len(spec.pspec))
    used = {a for e in entries for a in entry_axes(e)}
    if "data" in used:
        return P(*entries)
    best, best_size = None, 0
    for i, (e, n) in enumerate(zip(entries, spec.shape)):
        if e is None and n % 16 == 0 and n > best_size:
            best, best_size = i, n
    if best is None:
        return P(*entries)
    entries[best] = "data"
    return P(*entries)


def _moment_specs(param_specs, oc: OptConfig):
    def one(s: ParamSpec):
        zp = zero1_pspec(s)
        if oc.moments_dtype == torch.int8:
            return {"q": ParamSpec(s.shape, torch.int8, zp, init="zeros"),
                    "scale": ParamSpec(s.shape[:-1], _F32, P(*zp[:-1]), init="zeros")}
        return ParamSpec(s.shape, _F32, zp, init="zeros")

    return spec_map(one, param_specs)


def opt_specs(param_specs, oc: OptConfig):
    """The optimizer state's spec tree: the reference's keys, shapes, dtypes
    and partition specs."""
    return {
        "m": _moment_specs(param_specs, oc),
        "v": _moment_specs(param_specs, oc),
        "step": ParamSpec((), torch.int32, P(), init="zeros"),
    }


def _is_moment(x):
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def moment_leaves(tree):
    """A moment tree's leaves in the reference's order, an int8 moment's
    ``{"q", "scale"}`` dict as one leaf."""
    if _is_moment(tree) or not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in moment_leaves(tree[k])]


def _dequant(mom):
    if _is_moment(mom):
        return mom["q"].to(_F32) * mom["scale"][..., None]
    return mom


def _requant(val, like, row_max=None):
    """``val`` in ``like``'s form: an int8 moment's rows rescaled to their
    largest magnitude and rounded half to even (as ``jnp.round``).
    ``row_max`` turns each row's local maximum into the row's maximum over
    the ranks that hold its other blocks."""
    if _is_moment(like):
        top = torch.amax(torch.abs(val), dim=-1)
        scale = (top if row_max is None else row_max(top)) / 127.0 + 1e-12
        return {"q": torch.round(val / scale[..., None]).to(torch.int8), "scale": scale}
    return val


def _store(mom, val, row_max=None):
    if _is_moment(mom):
        new = _requant(val, mom, row_max)
        mom["q"].copy_(new["q"])
        mom["scale"].copy_(new["scale"])
    else:
        mom.copy_(val)


_SLAB = 1 << 27  # elements of a leaf updated at a time


def _slabs(p):
    """Slices of ``p`` along its leading axis of at most about ``_SLAB``
    elements each (whole rows of the last axis, as the int8 moments'
    scales need); [None] for a leaf taken whole."""
    if p.dim() < 2 or p.numel() <= _SLAB:
        return [None]  # the whole leaf
    step = max(1, _SLAB // (p.numel() // p.shape[0]))
    return [slice(i, i + step) for i in range(0, p.shape[0], step)]


def _at(x, sl):
    """``x`` (a tensor or an int8 moment) at the slab ``sl`` (None: whole)."""
    if sl is None:
        return x
    if _is_moment(x):
        return {"q": x["q"][sl], "scale": x["scale"][sl]}
    return x[sl]


def global_norm(tree, mesh=None, layout=None):
    """sqrt of the sum over leaves of each leaf's float32 sum of squares; over
    ``mesh`` each leaf's sum taken on its block and summed over the axes its
    ``layout`` entry splits it on."""
    total = 0
    spans = dict(T.leaves(layout)) if mesh is not None else {}
    for path, x in T.leaves(tree):
        ss = torch.sum(torch.square(x.to(_F32)))
        axes = _split_axes(spans.get(path, P()))
        if axes:
            ss = M.all_reduce(ss, mesh, axes)
        total = total + ss
    return torch.sqrt(total)


def _split_axes(pspec) -> tuple[str, ...]:
    return tuple(a for e in pspec for a in entry_axes(e))


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, opt_state, mesh=None, layout=None):
    """One AdamW step: writes the new parameters into ``params`` and the new
    moments and step into ``opt_state`` (in place) and returns (params,
    opt_state, {"grad_norm", "lr"}), the metrics as device tensors.  Over
    ``mesh``, every leaf of params, grads and moments is this rank's block
    of the layout ``layout`` gives it (a tree like params of partition
    specs; an int8 moment's scale is split as its ``q`` without the last
    axis)."""
    step = opt_state["step"] + 1
    lr = schedule(oc, step)
    gnorm = global_norm(grads, mesh, layout)
    clip = torch.clamp(oc.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(_F32)
    corr1, corr2 = 1 - oc.b1 ** stepf, 1 - oc.b2 ** stepf
    flat_m, flat_v = moment_leaves(opt_state["m"]), moment_leaves(opt_state["v"])
    spans = dict(T.leaves(layout)) if mesh is not None else {}
    for (path, p), (_, g), m, v in zip(T.leaves(params), T.leaves(grads), flat_m, flat_v):
        row_max = None
        ps = spans.get(path, P())
        last = entry_axes(ps[p.dim() - 1]) if len(ps) >= p.dim() > 0 else ()
        if last:
            def row_max(top, axes=last):
                return M.all_reduce(top, mesh, axes, dist.ReduceOp.MAX)
        for sl in _slabs(p):  # elementwise: slabs only bound the float32 temporaries
            pp, gg, mm, vv = (_at(x, sl) for x in (p, g, m, v))
            gg = gg.to(_F32) * clip
            m_new = oc.b1 * _dequant(mm) + (1 - oc.b1) * gg
            v_new = oc.b2 * _dequant(vv) + (1 - oc.b2) * gg * gg
            mhat = m_new / corr1
            vhat = v_new / corr2
            delta = mhat / (torch.sqrt(vhat) + oc.eps) + oc.weight_decay * pp.to(_F32)
            pp.copy_((pp.to(_F32) - lr * delta).to(p.dtype))
            _store(mm, m_new, row_max)
            _store(vv, v_new, row_max)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
