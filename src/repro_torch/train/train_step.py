"""Train step (counterpart of ``repro/train/train_step.py``): gradient
accumulation over microbatches, the global clip and AdamW, on one card.

``make_train_step(model, oc, accum_steps)`` returns ``train_step(state,
batch) -> (state, metrics)``.  The gradient is ``torch.autograd.grad`` of
``model.loss`` with respect to the parameters (detached leaves that share
the state's storage); with ``accum_steps > 1`` the batch is split along
axis 0 (axis 1 for ``mrope_pos``), the microbatches' gradients summed in
float32 and divided by ``accum_steps``, and the metrics are the
microbatches' means, as the reference's ``lax.scan``.  The update writes
into the state's tensors (``optimizer.adamw_update``), and the metrics
stay device tensors: a step needs no host sync, and the caller fetches
them only when it logs.  The reference's sharded accumulators
(``grad_pspecs``, ``mesh=``) are ROADMAP module item 12.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.train.optimizer import OptConfig, adamw_update, opt_specs

_F32 = torch.float32


def state_specs(model, oc: OptConfig):
    """Spec tree for the full train state {params, opt}."""
    return {"params": model.specs, "opt": opt_specs(model.specs, oc)}


def grad_pspecs(model):
    raise NotImplementedError("sharded gradient accumulators over a mesh are not ported "
                              "yet: ROADMAP module item 12")


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


def _value_and_grad(model, params, batch):
    """(loss, metrics, grads): grads a tree like ``params``, in its dtypes
    (zeros for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    tree = T.tree_map(lambda x: x.detach().requires_grad_(True), params)
    paths, leaves = zip(*T.leaves(tree))
    with torch.enable_grad():
        loss, metrics = model.loss(tree, batch)
        grads = dict(zip(paths, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                    materialize_grads=True)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            T.map_with_path(lambda path, _: grads[path], params))


def make_train_step(model, oc: OptConfig, accum_steps: int = 1, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``state``
    is updated in place and returned.  batch leaves have a leading
    global-batch axis (``mrope_pos``: axis 1), divisible by
    ``accum_steps``."""
    if mesh is not None:
        raise NotImplementedError("a train step over a mesh is not ported yet: "
                                  "ROADMAP module item 12")

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
