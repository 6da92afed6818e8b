"""Train step (counterpart of ``repro/train/train_step.py``): gradient
accumulation over microbatches, the global clip and AdamW, on one card or
over a mesh with ZeRO-1 sharded gradients and moments.

``make_train_step(model, oc, accum_steps, mesh)`` returns ``train_step(state,
batch) -> (state, metrics)``.  The gradient is ``torch.autograd.grad`` of
``model.loss`` with respect to the parameters (detached leaves that share
the state's storage); with ``accum_steps > 1`` the batch is split along
axis 0 (axis 1 for ``mrope_pos``), the microbatches' gradients summed in
float32 and divided by ``accum_steps``, and the metrics are the
microbatches' means, as the reference's ``lax.scan``.  The update writes
into the state's tensors (``optimizer.adamw_update``), and the metrics
stay device tensors: a step needs no host sync, and the caller fetches
them only when it logs.

Over a mesh (explicit SPMD: every rank runs the step on its blocks) the
state is held in ``state_shardings``' layout and the batch is this rank's
block of the batch axes.  Each rank:
- gathers the weights into the layout the forward takes
  (``model.run_pspecs``): a leaf whose spec names 'data' (FSDP) is held as
  its block and gathered for the whole step, the MoE layers' experts stay
  in their expert-parallel blocks;
- takes its local loss and its gradient; each microbatch's gradient is
  summed over the ranks that share the block (reduce-scattered over 'data'
  into ``grad_pspecs``' blocks), divided by the mesh size and added into a
  float32 accumulator of those blocks, as the reference's
  ``constrain_grads`` places it;
- runs AdamW on the blocks and all-gathers each updated block back into its
  leaf's held layout.
The metrics are the means over the mesh, as the reference's global ones;
``aux`` is the mean of each rank's Switch loss of its own tokens, as the
reference's ``pmean``.  With ``accum_steps > 1`` a microbatch is the
reference's: rows ``[j B/a, (j+1) B/a)`` of the global batch, each rank
its block of them (the batch is all-gathered over the batch axes first).
Held layouts: every leaf as its partition spec says, except that a leaf
outside the MoE layers is whole over 'model' (tensor parallelism of those
weights is ROADMAP module item 14); ``shardings`` of the specs still gives
the reference's full layout.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.common import (NamedSharding, P, entry_axes, filter_pspec, shard, spec_map)
from repro_torch.launch import mesh as M
from repro_torch.models.layers import DATA_AXES
from repro_torch.train.optimizer import OptConfig, adamw_update, opt_specs, zero1_pspec

_F32 = torch.float32


def state_specs(model, oc: OptConfig):
    """Spec tree for the full train state {params, opt}."""
    return {"params": model.specs, "opt": opt_specs(model.specs, oc)}


def grad_pspecs(model):
    """The gradient accumulators' layout: each parameter's ZeRO-1 spec."""
    return spec_map(zero1_pspec, model.specs)


def _split(batch, accum_steps):
    """The batch as ``accum_steps`` microbatches (views)."""
    out = [{} for _ in range(accum_steps)]
    for k, x in batch.items():
        ax = 1 if k == "mrope_pos" else 0
        if x.shape[ax] % accum_steps:
            raise ValueError(f"{k}: batch axis {x.shape[ax]} is not a multiple of "
                             f"accum_steps {accum_steps}")
        for i, part in enumerate(torch.chunk(x, accum_steps, dim=ax)):
            out[i][k] = part
    return out


def _value_and_grad(model, params, batch, mesh=None):
    """(loss, metrics, grads): grads a tree like ``params``, in its dtypes
    (zeros for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    tree = T.tree_map(lambda x: x.detach().requires_grad_(True), params)
    paths, leaves = zip(*T.leaves(tree))
    with torch.enable_grad():
        loss, metrics = model.loss(tree, batch, mesh=mesh) if mesh is not None else \
            model.loss(tree, batch)
        grads = dict(zip(paths, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                    materialize_grads=True)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            T.map_with_path(lambda path, _: grads[path], params))


# ---------------------------------------------------------------------------
# layouts over a mesh


def _held(path, pspec, moe_ep):
    """A leaf's held spec: as given, without 'model' outside the MoE layers
    (or everywhere when the experts do not run expert-parallel)."""
    if moe_ep and "/moe/" in path:
        return pspec

    def drop(e):
        kept = tuple(a for a in entry_axes(e) if a != "model")
        return None if not kept else kept[0] if len(kept) == 1 else kept

    return P(*(drop(e) for e in pspec))


def _layouts(model, oc, mesh):
    """{"params", "grads", "opt"}: pspec trees (filtered to the mesh) of the
    state's held layout and of the gradient accumulators."""
    from repro_torch.models import moe as MOE

    ep = model.cfg.family == "moe" and MOE.expert_parallel(model.cfg, mesh)

    def held(tree):
        return T.map_with_path(lambda path, ps: filter_pspec(_held(path, ps, ep), mesh), tree)

    pspec_tree = lambda specs: spec_map(lambda s: s.pspec, specs)
    opt = opt_specs(model.specs, oc)
    return {"params": held(pspec_tree(model.specs)), "grads": held(grad_pspecs(model)),
            "opt": {"m": held(pspec_tree(opt["m"])), "v": held(pspec_tree(opt["v"])),
                    "step": P()}}


def state_shardings(model, oc: OptConfig, mesh):
    """The layout ``make_train_step(mesh=)`` holds each leaf of the state in:
    a tree like ``state_specs`` of ``NamedSharding`` records.  Place a global
    state with ``common.shard`` leaf by leaf (``checkpoint.restore(
    shardings=)`` does), fetch it with ``common.unshard``."""
    lay = _layouts(model, oc, mesh)
    return T.tree_map(lambda ps: NamedSharding(mesh, ps),
                      {"params": lay["params"], "opt": lay["opt"]})


def reshard(x, mesh, src: P, dst: P):
    """This rank's block of layout ``dst`` from its block ``x`` of layout
    ``src`` (no gradient): dims that ``src`` splits and ``dst`` does not (or
    splits otherwise) are all-gathered, then dims ``dst`` splits are cut.
    Returns ``x`` itself where the two layouts agree."""
    n = x.dim()
    a = [entry_axes(src[i]) if i < len(src) else () for i in range(n)]
    b = [entry_axes(dst[i]) if i < len(dst) else () for i in range(n)]
    for i in range(n):
        if a[i] and a[i] != b[i]:
            x = M.gather(x, mesh, a[i], i)
    for i in range(n):
        if b[i] and a[i] != b[i]:
            size = x.shape[i] // M.axis_size(mesh, b[i])
            x = x.narrow(i, M.axis_index(mesh, b[i]) * size, size).contiguous()
    return x


def _reduce_grad(g, mesh, run: P, dst: P, n_ranks: int):
    """The sum over the whole mesh of every rank's gradient ``g`` of its
    block of ``run``, cut to this rank's block of ``dst`` and divided by
    ``n_ranks``, in float32: summed over the axes ``run`` does not split (a
    reduce-scatter along each dim ``dst`` splits over such axes alone, an
    all-reduce over the rest), then resharded.  A result of ``g``'s shape
    keeps ``g``'s strides, so the norm's sum over it runs in the order the
    single-device step's does (a mesh of one is bit-equal to it)."""
    like = g
    g = g.to(_F32)
    if not g.is_contiguous() or g._base is not None:
        g = g.clone(memory_format=torch.contiguous_format)
    n = g.dim()
    used = {ax for e in run for ax in entry_axes(e)}
    rest = [ax for ax in mesh.mesh_dim_names if ax not in used]
    scatter = []
    for i in range(n):
        axes = entry_axes(dst[i]) if i < len(dst) else ()
        r = entry_axes(run[i]) if i < len(run) else ()
        if axes and not r and all(ax in rest for ax in axes):
            scatter.append((i, axes))
            rest = [ax for ax in rest if ax not in axes]
    if rest:  # in place: ``g`` is this step's own gradient (or a copy of it)
        M.all_reduce(g, mesh, tuple(rest), inplace=True)
    mid = list(run) + [None] * (n - len(run))
    for i, axes in scatter:
        g = M.reduce_scatter(g, mesh, axes, i)
        mid[i] = axes
    g = reshard(g, mesh, P(*mid), dst)
    if g.shape == like.shape and g.stride() != like.stride():
        g = torch.empty_like(like, dtype=_F32).copy_(g)
    return g / n_ranks if n_ranks > 1 else g


def _global_batch(batch, mesh):
    """The batch's blocks all-gathered over the batch axes (``mrope_pos``
    along its axis 1)."""
    axes = tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)
    if not axes:
        return batch
    return {k: M.gather(x, mesh, axes, 1 if k == "mrope_pos" else 0) for k, x in batch.items()}


def _local_microbatches(batch, accum_steps, mesh):
    """The reference's microbatches (rows [j B/a, (j+1) B/a) of the global
    batch), each as this rank's block of the batch axes."""
    axes = tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)
    out = []
    for mb in _split(_global_batch(batch, mesh), accum_steps):
        out.append({k: shard(x, NamedSharding(mesh, P(None, axes) if k == "mrope_pos"
                                              else P(axes)))
                    for k, x in mb.items()})
    return out


def _check_batch(batch):
    """A local batch block: every key's batch axis as long as the tokens'."""
    b = batch["tokens"].shape[0]
    for k, x in batch.items():
        if k == "mrope_pos" and (x.shape[0] != 3 or x.shape[1] != b):
            raise ValueError(
                f"mrope_pos block of shape {tuple(x.shape)}: the step takes (3, {b}, S), this "
                "rank's block of the batch axis; the reference's device_batch_at splits its "
                "axis 0 instead (ROADMAP F9)")
        if k != "mrope_pos" and x.shape[0] != b:
            raise ValueError(f"{k}: batch block {x.shape[0]} rows, the tokens' {b}")


def make_train_step(model, oc: OptConfig, accum_steps: int = 1, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``state``
    is updated in place and returned.  batch leaves have a leading
    global-batch axis (``mrope_pos``: axis 1), divisible by
    ``accum_steps``.  Over ``mesh``: ``state`` in ``state_shardings``'
    layout and ``batch`` this rank's block of the batch axes (the module's
    docstring)."""
    if mesh is not None:
        return _make_mesh_step(model, oc, accum_steps, mesh)

    def train_step(state, batch):
        params = state["params"]
        if accum_steps == 1:
            loss, metrics, grads = _value_and_grad(model, params, batch)
        else:
            grads = T.tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device),
                               params)
            loss_sum = torch.zeros((), dtype=_F32, device=batch["tokens"].device)
            per_mb = []
            for mb in _split(batch, accum_steps):
                l, m, g = _value_and_grad(model, params, mb)
                T.tree_map(lambda acc, x: acc.add_(x.to(_F32)), grads, g)
                loss_sum = loss_sum + l
                per_mb.append(m)
                del g
            grads = T.tree_map(lambda g: g / accum_steps, grads)
            loss = loss_sum / accum_steps
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        _, _, opt_metrics = adamw_update(oc, params, grads, state["opt"])
        return state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def _make_mesh_step(model, oc, accum_steps, mesh):
    from repro_torch.models.model import run_pspecs

    lay = _layouts(model, oc, mesh)
    held, gl = dict(T.leaves(lay["params"])), dict(T.leaves(lay["grads"]))
    run = dict(T.leaves(run_pspecs(model, mesh)))
    n_ranks = M.chips(mesh)
    all_axes = tuple(mesh.mesh_dim_names)

    def reduce(path, g):
        return _reduce_grad(g, mesh, run[path], gl[path], n_ranks)

    def train_step(state, batch):
        _check_batch(batch)
        params = state["params"]
        run_params = T.map_with_path(lambda path, x: reshard(x, mesh, held[path], run[path]),
                                     params)
        if accum_steps == 1:
            loss, metrics, grads = _value_and_grad(model, run_params, batch, mesh)
            _reduce_tree(grads, reduce)
        else:
            grads = T.map_with_path(lambda path, x: torch.zeros(
                _block_shape(x.shape, mesh, held[path], gl[path]), dtype=_F32,
                device=x.device), params)
            loss = torch.zeros((), dtype=_F32, device=batch["tokens"].device)
            per_mb = []
            for mb in _local_microbatches(batch, accum_steps, mesh):
                l, m, g = _value_and_grad(model, run_params, mb, mesh)
                T.tree_map(lambda acc, x: acc.add_(x), grads, _reduce_tree(g, reduce))
                del g
                loss = loss + l
                per_mb.append(m)
            grads = T.tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        del run_params
        # the metrics' means over the mesh: one all-reduce
        names = ["loss"] + sorted(metrics)
        vals = torch.stack([loss] + [metrics[k] for k in names[1:]])
        vals = M.all_reduce(vals, mesh, all_axes)
        if n_ranks > 1:
            vals = vals / n_ranks
        out = dict(zip(names, vals.unbind(0)))
        # AdamW on the gradient blocks, then each block back into its held leaf
        blocks = T.map_with_path(lambda path, x: reshard(x, mesh, held[path], gl[path]), params)
        _, _, opt_metrics = adamw_update(oc, blocks, grads, state["opt"], mesh=mesh,
                                         layout=lay["grads"])
        for (path, x), (_, blk) in zip(T.leaves(params), T.leaves(blocks)):
            if blk is not x:
                x.copy_(reshard(blk, mesh, gl[path], held[path]))
        return state, {**out, **opt_metrics}

    return train_step


def _reduce_tree(tree, fn, prefix=""):
    """Replace each leaf of the dict tree ``tree`` by ``fn(path, leaf)`` in
    place, so a leaf's old tensor is freed before the next is reduced;
    returns ``tree``."""
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            _reduce_tree(v, fn, path)
        else:
            tree[k] = None
            tree[k] = fn(path, v)
    return tree


def _block_shape(shape, mesh, src: P, dst: P):
    """The shape of a block of layout ``dst`` cut from a block of ``src``."""
    out = list(shape)
    for i in range(len(out)):
        a = entry_axes(src[i]) if i < len(src) else ()
        b = entry_axes(dst[i]) if i < len(dst) else ()
        if a != b:
            out[i] = out[i] * M.axis_size(mesh, a) // M.axis_size(mesh, b)
    return tuple(out)
