"""Time-decoupled data parallelism across pods (counterpart of
``repro/train/decoupled.py``): each pod runs ``quantum`` local optimizer
steps, then an outer synchronization averages the pods' parameter deltas
with outer momentum (DiLoCo-style), the quantum bounding the parameters'
staleness as the channel latency bounds simulated-time skew.

The reference vmaps the inner loop over the pod axis of the stacked inner
states; on one card the port loops over that axis, each pod's inner steps
updating its slice of the stacked tensors in place.  The outer sync is the
reference's arithmetic in float32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as T
from repro_torch.common import spec_map
from repro_torch.train.optimizer import OptConfig

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DecoupledConfig:
    quantum: int = 8  # inner steps per outer sync (the paper's N)
    outer_lr: float = 0.7
    outer_momentum: float = 0.9


def outer_state_specs(model):
    """The outer momentum buffer: the param tree's shapes, float32 zeros."""
    return spec_map(lambda s: dataclasses.replace(s, init="zeros", dtype=_F32), model.specs)


def make_decoupled_round(model, oc: OptConfig, dc_cfg: DecoupledConfig, inner_step,
                         n_pods: int):
    """Returns ``round(inner_states, outer, batches) -> (inner_states, outer,
    metrics)``.  inner_states: a train state whose leaves are stacked over
    the pod axis (leading dim ``n_pods``); outer: {"params", "momentum"};
    batches: leaves (n_pods, quantum, per-pod batch...).  The inner and
    outer states are updated in place and returned."""

    def round(inner_states, outer, batches):
        losses = []
        for pod in range(n_pods):
            state = T.tree_map(lambda x: x[pod], inner_states)  # views: updated in place
            pod_losses = []
            for q in range(dc_cfg.quantum):
                state, metrics = inner_step(state, {k: v[pod, q] for k, v in batches.items()})
                pod_losses.append(metrics["loss"])
            losses.append(torch.stack(pod_losses).mean())
        losses = torch.stack(losses)
        params0, inner = outer["params"], inner_states["params"]
        delta = T.tree_map(lambda p0, ps: (ps.to(_F32) - p0.to(_F32)).mean(0), params0, inner)
        mom = T.tree_map(lambda m, d: dc_cfg.outer_momentum * m + d, outer["momentum"], delta)
        new_params = T.tree_map(lambda p, m: (p.to(_F32) + dc_cfg.outer_lr * m).to(p.dtype),
                                params0, mom)
        T.tree_map(lambda ps, p: ps.copy_(p.expand_as(ps)), inner, new_params)
        outer = {"params": new_params, "momentum": mom}
        return inner_states, outer, {"loss": losses.mean(), "pod_losses": losses}

    return round
