"""Device meshes on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over one process
per device: NCCL between cards, gloo between CPU processes.  Every rank runs
the same program, as the reference's single-controller program does: each
builds the same job from the same seeds and reads the same global results.
The process group comes first (``init_world``: its address, world size and
rank given, never read from the environment); the mesh functions below
then lay the world out with the reference's axis names.  On the card a
mesh's ``device=None`` is this rank's card (``mesh_device``).

The named-axis layer of the LM's explicit SPMD code: ``axis_size`` and
``axis_index`` (``mesh.shape[name]`` and ``lax.axis_index``) of one axis or
of a tuple of axes (their product, the first axis the major one, as JAX
orders a tuple entry's blocks), ``axis_group`` (the process group of the
ranks that differ only along those axes), ``gather`` (a tiled all-gather of
blocks along a tensor dim, in block order) and the differentiable
collectives ``psum``, ``pmean`` and ``all_gather`` (``lax.psum``,
``lax.pmean``, ``lax.all_gather(tiled=True)``), whose backward passes are
their transposes: ``psum``'s the ``psum`` of the cotangents,
``all_gather``'s the sum of the cotangents' blocks (a reduce-scatter).
Tensor parallelism adds ``pmax`` (``lax.pmax``, no gradient: the
vocab-parallel cross-entropy's shift) and ``argmax`` (the first maximal
index of a tensor split along its last dim, from each block's (max, index)
pair: greedy decoding over vocab blocks).

A collective over axes whose size is 1 is skipped: it returns its input
(``all_reduce``, ``gather``, ``reduce_scatter`` and every function built on
them, forward and backward passes alike), so a mesh of one runs the
single-device arithmetic.  Every collective asks ``_skip`` first, the one
place a harness wraps to count them.  A sum of 16-bit floats is taken in
float32 and rounded once, as XLA promotes the reference's bf16 all-reduces
(and reduce-scatters) to float32.
"""
from __future__ import annotations

import datetime
import itertools
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import tree


def init_world(init_method: str, rank: int, world_size: int, device=None,
               timeout_s: float = 300.0):
    """Join the process group: NCCL on the card (this rank's card is
    ``rank % device_count``), gloo on the CPU (``device="cpu"``).  A rank that
    waits on a collective longer than ``timeout_s`` raises, so a rank that
    failed cannot hang the others for good.  There is no fallback from NCCL
    to gloo."""
    dev = tree.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(shape, axes, device=None):
    """A mesh of ``shape`` over the world's processes, dims named ``axes``;
    the world must hold exactly ``prod(shape)`` ranks."""
    dev = tree.resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_world first")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) = one pod of 256 devices (data x model); (2, 16, 16) = two
    pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 2, device=None):
    """A small (data, model) mesh over a test's processes."""
    return make_mesh((data, model), ("data", "model"), device)


def chips(mesh) -> int:
    return mesh.size()


def make_serve_mesh(n_devices: int | None = None, device=None):
    """Flat 1-D serving mesh, axis ``jobs``, over the whole world (or
    ``n_devices`` of it).  The serving job axis
    (``core/controller.sharded_job_mega_fn``, ``serve/snn_serve.py``) needs
    no collective inside a round: each rank runs its job shard alone."""
    return make_mesh((n_devices or dist.get_world_size(),), ("jobs",), device)


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# named axes


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes) -> int:
    """The size of an axis, or the product of a tuple of axes' sizes."""
    names = list(mesh.mesh_dim_names)
    return math.prod(mesh.shape[names.index(a)] for a in _axes(axes))


def _index(mesh, coord, axes) -> int:
    names = list(mesh.mesh_dim_names)
    idx = 0
    for a in _axes(axes):
        i = names.index(a)
        idx = idx * mesh.shape[i] + coord[i]
    return idx


def axis_index(mesh, axes) -> int:
    """This rank's index along an axis, or along a tuple of axes (the first
    the major one): the block of a dim split over ``axes`` that it holds."""
    return _index(mesh, mesh.get_coordinate(), axes)


_GROUPS: dict = {}  # id(mesh) -> (mesh, {axes: (group, block order)})


def axis_group(mesh, axes):
    """(group, order): the process group of the ranks that share this rank's
    coordinates off ``axes``, and for each of its group ranks the block
    index it holds along ``axes``.  One axis is the mesh's own group; a
    tuple's groups are made on first use, every rank making all of them in
    the same order (SPMD: every rank asks for the same axes in turn)."""
    axes = _axes(axes)
    _, cache = _GROUPS.setdefault(id(mesh), (mesh, {}))
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        layout = mesh.mesh  # global ranks, shaped like the mesh
        coords = {int(layout[c]): c for c in itertools.product(*map(range, layout.shape))}
        if len(axes) == 1:
            group = mesh.get_group(axes[0])
        else:
            keep = [i for i, a in enumerate(names) if a not in axes]
            mine = None
            for rest in itertools.product(*(range(layout.shape[i]) for i in keep)):
                ranks = sorted(r for r, c in coords.items()
                               if tuple(c[i] for i in keep) == rest)
                g = dist.new_group(ranks)
                if dist.get_rank() in ranks:
                    mine = g
            group = mine
        members = dist.get_process_group_ranks(group)
        cache[axes] = (group, [_index(mesh, coords[r], axes) for r in members])
    return cache[axes]


_HALF = (torch.bfloat16, torch.float16)  # summed in float32


def _skip(op: str, mesh, axes) -> bool:
    """True where ``axes``' size is 1: the collective ``op`` (its name, for
    a wrapper that counts the calls) has nothing to exchange."""
    return axis_size(mesh, _axes(axes)) == 1


def _gather(x, mesh, axes, dim):
    group, order = axis_group(mesh, axes)
    parts = [torch.empty_like(x) for _ in order]
    dist.all_gather(parts, x.contiguous(), group=group)
    by_block = [None] * len(order)
    for part, b in zip(parts, order):
        by_block[b] = part
    return torch.cat(by_block, dim=dim)


def gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of every rank along ``axes`` concatenated on ``dim`` in
    block order (a tiled all-gather; no gradient)."""
    if _skip("all_gather", mesh, axes):
        return x
    return _gather(x, mesh, axes, dim)


def all_reduce(x: torch.Tensor, mesh, axes, op=None, inplace=False) -> torch.Tensor:
    """``x`` reduced (summed unless ``op``) over ``axes`` (no gradient): a
    new tensor, or ``x`` itself (contiguous) with ``inplace``; ``x`` itself
    over axes of size 1."""
    op = dist.ReduceOp.SUM if op is None else op
    if _skip("all_reduce" if op == dist.ReduceOp.SUM else "all_reduce_max", mesh, axes):
        return x
    group, _ = axis_group(mesh, axes)
    if op == dist.ReduceOp.SUM and x.dtype in _HALF:
        out = x.float()
        dist.all_reduce(out, op=op, group=group)
        return x.copy_(out) if inplace else out.to(x.dtype)
    out = x if inplace else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``axes`` of ``x``
    (no gradient)."""
    if _skip("reduce_scatter", mesh, axes):
        return x
    group, order = axis_group(mesh, axes)
    wide = x.float() if x.dtype in _HALF else x
    chunks = wide.chunk(len(order), dim=dim)
    out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter(out, [chunks[b].contiguous() for b in order], group=group)
    return out.to(x.dtype)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over ``axes`` on every rank of them."""
    return _Psum.apply(x, mesh, _axes(axes))


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.pmean``: the sum over ``axes`` divided by their size."""
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``."""
    return _AllGather.apply(x, mesh, _axes(axes), dim)


class _MeanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes) / axis_size(ctx.mesh, ctx.axes), None, None


def mean_grad(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The identity, whose backward replaces each rank's cotangent by its
    mean over ``axes`` (one all-reduce).  Each rank differentiates its own
    copy of the loss and ``psum``'s backward is a ``psum``, so where a
    tensor whole on every rank of ``axes`` enters a computation split over
    them, each rank's cotangent is its share of their sum; the mean keeps
    the sum and makes the cotangent the same on every rank, as the
    reference's transpose of such a point (GSPMD's all-reduce, a
    ``shard_map`` input's ``psum``) gives it, so the cotangents upstream
    are rounded as the reference rounds them."""
    return _MeanGrad.apply(x, mesh, _axes(axes))


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over ``axes`` (no gradient)."""
    return all_reduce(x.detach(), mesh, _axes(axes), op=dist.ReduceOp.MAX)


def argmax(x: torch.Tensor, mesh, axes, offset: int) -> torch.Tensor:
    """``torch.argmax(x_global, -1)`` where ``x`` is this rank's block of
    ``x_global`` along its last dim, starting at global index ``offset``:
    each block's (max, first index) pair is all-gathered (values as float32,
    indices as int64: gloo takes no uint32 or bool) and the pairs combined by
    value, then by the lowest global index, so ties go to the first maximal
    index as ``torch.argmax``'s do.  int64 (B...,)."""
    idx = torch.argmax(x.detach(), dim=-1, keepdim=True)
    val, idx = x.detach().gather(-1, idx), idx + offset
    if _skip("argmax", mesh, axes):
        return idx[..., 0]
    vals, idxs = _gather(val.float(), mesh, _axes(axes), -1), _gather(idx, mesh, _axes(axes), -1)
    best = vals.amax(-1, keepdim=True)
    return torch.where(vals == best, idxs, torch.iinfo(torch.int64).max).amin(-1)
