"""Vectorized LIF neuron-pool state and the pure tick update (counterpart of
``repro/snn/neuron.py``).  The update delegates to the plain fused step in
``kernels/lif_step/ref.py``; everything is int32-exact.

Semantics per tick (positive-saturating LIF):
  v'      = max(v + W·s - leak, 0)
  fired   = (refrac == 0) & (v' >= thresh)
  v''     = 0 where fired
  refrac' = refrac_period where fired, else max(refrac - 1, 0)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.lif_step import ref as lif_ref

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class LIFParams:
    thresh: int = 64  # firing threshold (>= 1: termination + pad-lane safety)
    leak: int = 1  # subtractive leak per tick (>= 0: idle pools stay idle)
    refrac_period: int = 0  # ticks a neuron is silent after firing

    def __post_init__(self):
        if self.thresh < 1:
            raise ValueError("thresh must be >= 1")
        if self.leak < 0:
            raise ValueError("leak must be >= 0 (negative leak never settles)")
        if not 0 <= self.refrac_period < 16:
            raise ValueError("refrac packs into 4 register bits")


def pool_state(n: int, device=None):
    """Zero membrane state for a pool of ``n`` neurons."""
    return {
        "v": torch.zeros((n,), dtype=_I32, device=device),
        "refrac": torch.zeros((n,), dtype=_I32, device=device),
    }


def _params(params: LIFParams, device):
    return tuple(torch.tensor(x, dtype=_I32, device=device)
                 for x in (params.thresh, params.leak, params.refrac_period))


def lif_step(state, weights, spikes_in, params: LIFParams):
    """One tick: (state, int8 (R, C) synapses, int32 (C,) spike counts) ->
    (state', fired int32 (R,))."""
    v2, refrac2, fired = lif_ref.lif_step(
        weights, spikes_in, state["v"], state["refrac"],
        *_params(params, state["v"].device))
    return {"v": v2, "refrac": refrac2}, fired


def lif_step_multi(state, weight_blocks, spike_blocks, params: LIFParams):
    """One tick with multi-source fan-in: per-edge synapse blocks
    ``[(R, C_e) int8, ...]`` and matching spike vectors ``[(C_e,) int32,
    ...]``, contracted per edge and summed (bit-identical to one contraction
    of the concatenated matrix: the fan-in clip is element-wise)."""
    if not (len(weight_blocks) == len(spike_blocks) and weight_blocks):
        raise ValueError("one spike vector per weight block, at least one")
    syn = sum(lif_ref.syn_charge(w, s) for w, s in zip(weight_blocks, spike_blocks))
    v2, refrac2, fired = lif_ref.lif_update(
        syn, state["v"], state["refrac"], *_params(params, state["v"].device))
    return {"v": v2, "refrac": refrac2}, fired
