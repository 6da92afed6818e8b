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
(views move nothing), the analogue of XLA's "bytes accessed".  Under these
modes the Mamba-1 scan and its backward are one custom op each
(``kernels/ssm_scan/ops.py``), and so is the chunked prefill attention
(``layers.flash_prefill_attention``).  A scan counts as its kernel: 0 FLOPs
(elementwise, as XLA counts it; the reference's HLO holds the scan's
contraction with C as a dot, 2·B·S·D·N a layer), each input read once and
each output written once.  The attention counts as its eager loop: its
products' FLOPs and the bytes of its ops (a registered byte formula,
``register_byte_formula``).  The VP kernels are launched outside the
dispatcher and are not seen.

``active_params`` and ``model_flops`` are the reference's arithmetic over
the model the port builds (tp = 1).  The reference builds at tp = 16, which
pads llama4-scout's 40 query heads to 48; the port has no padded heads, so
its count is the reference's at tp = 1.

Over a mesh, ``MeshRoofline`` adds the third term beside the two:

  collective = per-device collective bytes / link bandwidth, summed over
               the groups of axes the collectives run over

where a group whose ranks all lie within one 8-GPU node uses NVLink
(``NVLINK_BW``) and any other group InfiniBand (``IB_BW``): a group runs
at its slowest link.  On the production meshes ((16, 16) and (2, 16, 16),
ranks in row-major order, eight to a node) every axis crosses nodes.
``from_trace`` (the counterpart of the reference's ``from_compiled``)
counts one rank's step as it runs, on real or fake tensors: FLOPs and
bytes as ``from_step``, the collectives and the live bytes with
``analysis.comm_cost``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import mesh as M

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (H100 SXM, 700 W)
PEAK_FLOPS_FP32 = 67e12  # float32 outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s
# NVLink 4 between the GPUs of one HGX H100 node: 900 GB/s both ways per GPU
# (NVIDIA H100 SXM datasheet), 450 GB/s a direction
NVLINK_BW = 450e9
# InfiniBand NDR across nodes: one 400 Gb/s ConnectX-7 port per GPU (NVIDIA
# DGX H100 user guide), 50 GB/s a direction
IB_BW = 50e9
NODE_GPUS = 8  # GPUs of one node, joined by NVLink


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


_BYTE_FORMULAS = {}


def register_byte_formula(op):
    """Register ``fn(*args, **kwargs)``, the bytes a call of the custom
    ``op`` moves, for ``_ByteCounter`` to count in place of its inputs and
    outputs: for an op that stands for a loop of ops whose traffic no fused
    kernel takes away (``layers.flash_prefill_attention``)."""
    def register(fn):
        _BYTE_FORMULAS[op] = fn
        return fn

    return register


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs; a view
    (its output aliases its input) moves nothing, and nor does a query of
    a tensor's metadata (``prim.device``, which fake tensors dispatch).  A
    custom op with a registered byte formula counts what the formula says."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        formula = _BYTE_FORMULAS.get(func.overloadpacket)
        if formula is not None:
            self.bytes += formula(*args, **(kwargs or {}))
            self.ops += 1
        elif not func.is_view and func.namespace != "prim":
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


def link_bw(ranks) -> float:
    """The bandwidth of a group of global ``ranks`` (bytes/s a direction per
    GPU): NVLink where they all lie within one node, else InfiniBand."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) == 1 else IB_BW


@dataclass
class MeshRoofline:
    """A step of one rank of a mesh: ``Roofline``'s two terms and the
    collective term over the links its groups use (``link_bw``).
    ``coll_by_axes`` and ``bw_by_axes`` map each group of axes
    (``comm_cost.axes_name``) to its operand bytes and bandwidth."""

    flops: float  # per device
    bytes_accessed: float  # per device
    coll_by_axes: dict = field(default_factory=dict)
    bw_by_axes: dict = field(default_factory=dict)
    coll_detail: dict = field(default_factory=dict)

    @property
    def coll_bytes(self):
        return float(sum(self.coll_by_axes.values()))

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self):
        return sum(b / self.bw_by_axes[a] for a, b in self.coll_by_axes.items())

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

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


def from_trace(fn, *args, mesh, **kwargs):
    """One call ``fn(*args, **kwargs)`` of a rank of ``mesh`` counted as it
    runs: returns (``MeshRoofline``, memory, the call's result).  ``memory``
    holds the reference's ``memory_analysis`` fields: ``argument_bytes``
    (the distinct storages of the tensors in ``args`` and ``kwargs``),
    ``output_bytes`` and ``alias_bytes`` (the result's storages, and those
    of them that are arguments': a state updated in place) and
    ``temp_bytes`` (``comm_cost.LiveBytes``' peak: a storage counts until
    Python frees it, one held in a reference cycle until the cycle collector
    runs).  ``coll_detail`` holds the issued collectives' bytes by kind and
    by axes (named in the mesh's order), the link bandwidth of each group of
    axes, the issued and the skipped (axes of size 1) calls counted by kind
    and axes, every (name, axes, skipped) record (``calls``) and the aten
    ops counted."""
    from repro_torch.analysis import comm_cost

    flops = FlopCounterMode(display=False)
    moved = _ByteCounter()
    live = comm_cost.LiveBytes((args, kwargs))
    with comm_cost.CollectiveCounter() as coll, flops, moved, live:
        out = fn(*args, **kwargs)
    by_axes = coll.bytes_by("axes")
    bw = {}
    for (_, axes, skipped) in coll.calls:
        if not skipped:
            group, _ = M.axis_group(mesh, axes)
            bw[comm_cost.axes_name(axes)] = link_bw(dist.get_process_group_ranks(group))
    detail = {"by_kind": coll.bytes_by("kind"), "by_axes": by_axes,
              "link_bw_by_axes": bw, "issued": coll.counts(skipped=False),
              "skipped": coll.counts(skipped=True), "calls": coll.records(),
              "aten_ops": moved.ops}
    out_bytes, alias = live.output_bytes(out)
    memory = {"argument_bytes": live.argument_bytes, "output_bytes": out_bytes,
              "temp_bytes": live.peak, "alias_bytes": alias}
    rl = MeshRoofline(flops=float(flops.get_total_flops()), bytes_accessed=float(moved.bytes),
                      coll_by_axes={k: float(v) for k, v in by_axes.items()}, bw_by_axes=bw,
                      coll_detail=detail)
    return rl, memory, out


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
