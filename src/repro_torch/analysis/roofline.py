"""Roofline terms of a step on one H100 (counterpart of
``repro/analysis/roofline.py``).

Two terms (seconds, per step), H100 SXM constants at 700 W:

  compute = counted FLOPs / peak FLOP/s        (989 TFLOP/s bf16 dense)
  memory  = counted bytes / HBM bandwidth      (3.35 TB/s)

One card has no collective term: ``coll_bytes`` stays 0, no link bandwidth
is assumed, and ``bottleneck`` chooses between compute and memory.

``from_step`` counts one eager call: FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions and
attention; elementwise work counts nothing, as in XLA's FLOP count), bytes
with a dispatch mode that sums every aten op's tensor inputs and outputs
(views move nothing), the analogue of XLA's "bytes accessed".  Neither sees
the port's hand-written CUDA kernels (``ssm_scan`` and its backward, the
VP kernels), which are launched outside the aten dispatcher: their work is
elementwise, so the FLOP count misses nothing that 6·N·D counts, but their
bytes are not in the memory term.

``active_params`` and ``model_flops`` are the reference's arithmetic over
the model the port builds (tp = 1).  The reference builds at tp = 16, which
pads llama4-scout's 40 query heads to 48; the port has no padded heads, so
its count is the reference's at tp = 1.

No counterpart: ``hlo_cost.py``, ``collective_bytes`` and ``from_compiled``
parse XLA HLO text, and ``launch/dryrun.py`` lowers onto 512 placeholder
devices; neither has a meaning for eager torch on one card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (H100 SXM, 700 W)
PEAK_FLOPS_FP32 = 67e12  # float32 outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s


@dataclass
class Roofline:
    flops: float  # one card
    bytes_accessed: float  # one card
    coll_bytes: float = 0.0  # one card moves nothing over a link
    coll_detail: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.coll_bytes:
            raise ValueError("one card has no collective term: coll_bytes must be 0")

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self):
        return 0.0

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        return max(terms, key=terms.get)

    @property
    def t_bound(self):
        return max(self.t_compute, self.t_memory)

    def to_dict(self):
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "coll_bytes_per_chip": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "coll_detail": self.coll_detail,
        }


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs; a view
    (its output aliases its input) moves nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            leaves = tree_flatten((args, kwargs))[0] + tree_flatten(out)[0]
            self.bytes += sum(x.numel() * x.element_size()
                              for x in leaves if isinstance(x, torch.Tensor))
            self.ops += 1
        return out


def from_step(fn, *args, **kwargs) -> Roofline:
    """The roofline of one call ``fn(*args, **kwargs)``, counted as it runs
    (see the module docstring for what is and is not counted).  The call's
    result is dropped; ``coll_detail`` holds the number of aten ops
    counted."""
    flops = FlopCounterMode(display=False)
    moved = _ByteCounter()
    with flops, moved:
        fn(*args, **kwargs)
    return Roofline(flops=float(flops.get_total_flops()), bytes_accessed=float(moved.bytes),
                    coll_detail={"aten_ops": moved.ops})


def active_params(cfg) -> int:
    """Active parameters per token (for MODEL_FLOPS = 6·N_active·D): every
    parameter of the model the port builds, less the experts a token does
    not reach."""
    from repro_torch.common import param_count
    from repro_torch.models.model import build

    total = param_count(build(cfg).specs)
    if cfg.moe is None:
        return total
    mo = cfg.moe
    n_moe_layers = cfg.n_layers - mo.first_k_dense
    per_expert = 3 * cfg.d_model * mo.d_ff_expert
    total_expert = n_moe_layers * mo.n_experts * per_expert
    active_expert = n_moe_layers * mo.top_k * per_expert
    return total - total_expert + active_expert


def model_flops(cfg, shape, kind: str) -> float:
    """6·N_active·D for a training step, 2·N_active·D for a forward pass,
    where D is the tokens the step processes (one per sequence in decode)."""
    n = active_params(cfg)
    if kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
