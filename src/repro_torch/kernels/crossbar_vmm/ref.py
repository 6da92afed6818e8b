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
"""
from __future__ import annotations

import torch

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
    ``f_and``/``f_xor`` (crossbar fault masks) come with ROADMAP module
    item 9.
    """
    if f_and is not None or f_xor is not None:
        raise NotImplementedError(
            "crossbar fault masks (f_and/f_xor) come with ROADMAP module item 9")
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
