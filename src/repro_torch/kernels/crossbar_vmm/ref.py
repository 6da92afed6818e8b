"""Plain-PyTorch bit-sliced crossbar VMM (counterpart of
``repro/kernels/crossbar_vmm/ref.py``) — the CPU path of the wrappers in
``ops.py`` and the reference the CUDA kernel is held to on the card.

Semantics (paper Fig. 1b/1c, CIM-Unit calculator):
  1. DAC: clamp the input vector to ``in_res`` signed bits, then split it
     into ``in_res`` bit-serial slices (sign-magnitude: the sign is applied
     after magnitude accumulation, matching differential crossbar pairs);
  2. crossbar MAC: each slice drives the memristor array -> int matvec
     against int8 conductances;
  3. S+H / shift-add: partial results accumulate weighted by 2^k;
  4. ADC: saturate to ``out_res`` signed bits + log2(C) accumulation
     headroom (fixed full-scale).

All arithmetic is int32.  The contraction is an int32 elementwise product
summed in int32: an int32 ``matmul`` runs on the CPU but not on CUDA, and
this version has to run on both.

``finish_ops`` is the quantum-boundary completion of ``vp/cim.finish_ops``
around the batched VMM: the eager ``done`` gate, one VMM over every unit,
then the selects.  It is the plain version of the fused completion kernel.
"""
from __future__ import annotations

import torch

from repro_torch.vp import isa

_I32 = torch.int32


def quantize_dac(x, in_res: int):
    lo = -(1 << (in_res - 1))
    hi = (1 << (in_res - 1)) - 1
    return torch.clamp(x, lo, hi)


def bit_slices(mag, in_res: int):
    """Unsigned magnitude -> list of 0/1 planes, LSB first."""
    return [(mag >> k) & 1 for k in range(in_res)]


def adc_saturate(acc, out_res: int, headroom_bits: int = 8):
    hi = (1 << (out_res - 1 + headroom_bits)) - 1
    return torch.clamp(acc, -hi - 1, hi)


def crossbar_vmm_batch(weights, x, in_res: int = 8, out_res: int = 8,
                       f_and=None, f_xor=None):
    """weights (..., R, C) int8; x (..., C) int32 -> (..., R) int32.

    Bit-exact model of the analog pipeline: the same result as
    ``clip(W @ clip(x))``, because the bit-serial accumulation is exact;
    the decomposition is kept so the structure matches the reference.
    ``f_and``/``f_xor`` (int8, the weights' shape, optional): crossbar
    fault masks — the array drives ``(w & f_and) ^ f_xor`` (either mask
    alone is the other one neutral).
    """
    if f_and is not None:
        weights = weights & f_and
    if f_xor is not None:
        weights = weights ^ f_xor
    xq = quantize_dac(x.to(_I32), in_res)
    sign = torch.sign(xq)
    w = weights.to(_I32)
    acc = torch.zeros(w.shape[:-1], dtype=_I32, device=w.device)
    for k, plane in enumerate(bit_slices(xq.abs(), in_res)):
        acc = acc + ((w * (plane * sign).unsqueeze(-2)).sum(-1, dtype=_I32) << k)
    return adc_saturate(acc, out_res)


def crossbar_vmm(weights, x, in_res: int = 8, out_res: int = 8,
                 f_and=None, f_xor=None):
    """weights int8 (R, C); x int32 (C,) -> int32 (R,)."""
    return crossbar_vmm_batch(weights, x, in_res, out_res, f_and, f_xor)


def crossbar_matmul(weights, x, in_res: int = 8, out_res: int = 8):
    """Tiled matrix version: weights (R, C) int8, x (C, N) int32 -> (R, N)."""
    return crossbar_vmm_batch(weights.unsqueeze(0), x.t(), in_res, out_res).t()


# the fields of a cims state the completion writes
FINISH_OUTPUTS = ("out_buf", "state", "op_done_at", "ops", "in_count")


def finish_ops(cims, t_end):
    """Quantum-boundary completion: every unit whose OP finishes by ``t_end``
    (S,) int32 computes its VMM at the Table II resolution (8-bit in and
    out) and returns to IDLE.  cims fields are ``(S, n, ...)``; the VMM runs
    every unit, and ``done`` selects which results land.
    The crossbar fault masks ``f_and``/``f_xor`` are read from ``cims``
    where present.

    Returns (cims', done bool (S, n)), ``cims'`` a new dict whose
    ``FINISH_OUTPUTS`` are new tensors."""
    done = (
        cims["present"]
        & (cims["state"] == isa.CIM_ST_OP)
        & (cims["busy_until"] <= t_end.unsqueeze(-1))
    )
    lead = done.shape  # (S, n)
    w = cims["weights"]
    units = lambda f: None if f not in cims else cims[f].reshape(-1, *w.shape[-2:])
    outs = crossbar_vmm_batch(units("weights"), cims["in_buf"].reshape(-1, w.shape[-1]),
                              8, 8, units("f_and"), units("f_xor")).reshape(*lead, -1)
    cims = dict(cims)
    cims["out_buf"] = torch.where(done.unsqueeze(-1), outs, cims["out_buf"])
    # outputs ship by DMA in the same boundary step, so OUT completes at
    # once and the FSM returns to IDLE (OUT cycles are inside busy_until)
    cims["state"] = torch.where(done, isa.CIM_ST_IDLE, cims["state"])
    cims["op_done_at"] = torch.where(done, cims["busy_until"], cims["op_done_at"])
    cims["ops"] = cims["ops"] + done.to(_I32)
    cims["in_count"] = torch.where(done, 0, cims["in_count"])
    return cims, done
