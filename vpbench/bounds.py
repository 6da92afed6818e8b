"""The card's peaks and the least time a piece of work needs on it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
``tick_bytes`` is the fused LIF tick's byte count as ``chip_smoke.py``'s
``tick_bound_ms`` counts it, copied so that the yardstick does not move
with the program: each unit's scalars (41 bytes), its input spikes,
membranes, refractory counters and spike counts read once (4 x 256 int32),
the weights of the units that fire (256 x 256 int8), the seven fields,
the fired rows and the fire flag written once (4 x 256 x 4 + 12 + 256 +
1), and one int32 time per segment.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_INT8_OPS_PER_S = 1979e12  # int8 tensor cores, dense

XBAR = 256  # a crossbar's rows and columns
UNIT_READ = 41 + 4 * XBAR * 4
UNIT_WRITE = 4 * XBAR * 4 + 12 + XBAR + 1
WEIGHTS = XBAR * XBAR


def tick_bytes(units: int, segments: int, firing: int) -> int:
    """Bytes of one fused tick over ``units`` unit slots on ``segments``
    segments, ``firing`` of them firing."""
    return units * (UNIT_READ + UNIT_WRITE) + 4 * segments + firing * WEIGHTS


def unit_tick_s(rows: int, cols: int) -> float:
    """Least time of one unit's tick of necessary work: its weights and
    state bytes at peak bandwidth or its 2 R C int8 operations at peak
    rate, whichever is larger."""
    t_bytes = (UNIT_READ + UNIT_WRITE + rows * cols) / PEAK_BYTES_PER_S
    t_ops = 2 * rows * cols / PEAK_INT8_OPS_PER_S
    return max(t_bytes, t_ops)
