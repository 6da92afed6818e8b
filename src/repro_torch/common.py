"""Spec trees, the dtype policy, initialisers and the sharding layer
(counterpart of ``repro/common.py``).

Parameters are nested dicts of tensors; beside every parameter tree is a
spec tree of the same structure whose leaves are ``ParamSpec`` (shape,
dtype, ``P`` partition spec, init kind), as the reference's.  ``P`` is the
port's own PartitionSpec: one entry per tensor dim, ``None``, a mesh axis
name or a tuple of names (the first the major one).  ``shardings`` turns a
spec tree into ``NamedSharding`` records (a mesh and a filtered spec);
``shard`` cuts this rank's block out of a global tensor and ``unshard``
all-gathers the blocks back, in JAX's block order.  The port runs explicit
SPMD over a ``torch.distributed`` mesh (``launch/mesh.py``): every rank runs
the same program on its own blocks, so a layout holds by construction and
``with_sharding``, the reference's GSPMD constraint, changes nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as T


class P:
    """A partition spec (``jax.sharding.PartitionSpec``'s counterpart): one
    entry per leading tensor dim, each ``None`` (not sharded), an axis name
    or a tuple of axis names (the dim split over their product, the first
    axis the major one; a tuple of one name is kept as the name, as JAX
    keeps it); dims past the entries are not sharded.  A leaf of the port's
    trees (not a tuple, which the tree functions walk)."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        def norm(e):  # JAX's form: a tuple of one name is the name
            e = tuple(e) if isinstance(e, list) else e
            return e[0] if isinstance(e, tuple) and len(e) == 1 else e

        self._entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self._entries == other._entries

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"P{self._entries!r}" if len(self._entries) != 1 else f"P({self._entries[0]!r})"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/sharding descriptor for one parameter leaf."""

    shape: tuple[int, ...]
    dtype: Any = torch.float32
    pspec: P = P()
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float | None = None  # override fan-in scale


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a state leaf (``jax.ShapeDtypeStruct``'s place)."""

    shape: tuple[int, ...]
    dtype: Any


def spec_map(fn: Callable[[ParamSpec], Any], tree):
    if isinstance(tree, dict):
        return {k: spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(spec_map(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# sharding


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec filtered to its axes
    (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: Any
    spec: P


def dispatch_mode_on() -> bool:
    """True while a ``TorchDispatchMode`` is on: a counter of
    ``analysis.roofline`` or ``comm_cost``, or fake tensors'
    (``launch/dryrun.py``).  The Mamba-1 scan, its backward and the chunked
    prefill attention then reach the dispatcher as one custom op each;
    otherwise they run their code directly."""
    return torch._C._len_torch_dispatch_stack() > 0


def entry_axes(entry) -> tuple[str, ...]:
    """A spec entry's axis names: () for None, a name as a 1-tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def filter_pspec(pspec: P, mesh) -> P:
    """Drop axis names not present in the mesh (e.g. 'pod' on single-pod)."""
    names = set(mesh.mesh_dim_names)

    def f(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(f(e) for e in pspec))


def named(mesh, pspec: P) -> NamedSharding:
    return NamedSharding(mesh, filter_pspec(pspec, mesh))


def shardings(tree, mesh):
    """Spec tree -> NamedSharding tree."""
    return spec_map(lambda s: named(mesh, s.pspec), tree)


def pspecs(tree):
    return spec_map(lambda s: s.pspec, tree)


def with_sharding(x, mesh, pspec: P):
    """The reference's ``with_sharding_constraint``: changes no value.  Under
    explicit SPMD each rank already holds its block of a layout the code
    built, so there is nothing to constrain; the call marks the reference's
    sites."""
    return x


def _dims(ndim: int, spec: P):
    """[(dim, axes)] of the sharded dims of an ``ndim``-dim tensor under
    ``spec``."""
    if len(spec) > ndim:
        raise ValueError(f"partition spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    return [(i, entry_axes(e)) for i, e in enumerate(spec) if e is not None]


def check_divisible(shape: tuple[int, ...], sharding: NamedSharding):
    """Raise ``ValueError`` where a dim of a global ``shape`` does not divide
    into ``sharding``'s blocks, with the substance of ``jax.device_put``'s
    message."""
    from repro_torch.launch import mesh as M

    for dim, axes in _dims(len(shape), sharding.spec):
        n = M.axis_size(sharding.mesh, axes)
        if shape[dim] % n:
            raise ValueError(
                f"a tensor was given the sharding {sharding.spec} over the mesh "
                f"{dict(zip(sharding.mesh.mesh_dim_names, sharding.mesh.shape))}, which implies "
                f"that the global size of its dimension {dim} should be divisible by {n}, but "
                f"it is equal to {shape[dim]} (full shape: {shape})")


def shard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` (a new tensor): along each
    sharded dim, block ``axis_index`` of ``axis_size`` equal blocks, as JAX
    places a global array (for a tuple entry the first axis is the major
    one).  Raises ``ValueError`` where a dim does not divide, as
    ``jax.device_put`` does."""
    from repro_torch.launch import mesh as M

    check_divisible(tuple(x.shape), sharding)
    for dim, axes in _dims(x.dim(), sharding.spec):
        size = x.shape[dim] // M.axis_size(sharding.mesh, axes)
        x = x.narrow(dim, M.axis_index(sharding.mesh, axes) * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def unshard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` of ``sharding``: an
    all-gather over each sharded dim's axes, blocks in JAX's order.  Every
    rank of the mesh must call it (a collective)."""
    from repro_torch.launch import mesh as M

    for dim, axes in _dims(x.dim(), sharding.spec):
        x = M.gather(x, sharding.mesh, axes, dim)
    return x


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    params: Any = torch.float32  # storage dtype of parameters
    compute: Any = torch.bfloat16  # matmul dtype
    accum: Any = torch.float32  # softmax / reductions / loss


def _scale(s: ParamSpec) -> float:
    if s.init == "embed":
        return 1.0
    if s.init == "small":
        return 0.02
    if s.scale is not None:
        return s.scale
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


_DRAW_SLICE = 1 << 26  # elements of a bf16 leaf drawn at a time by init_params


def init_params(spec_tree, generator: torch.Generator, device=None):
    """Random parameters with the JAX package's init kinds and scales, drawn
    from ``generator`` leaf by leaf in sorted-key order (a generator gives
    other numbers than ``jax.random``: use ``init_numpy`` to give both
    packages the same weights).  A float32 leaf is drawn whole; a bf16 leaf
    is drawn in float32 slices of at most ``_DRAW_SLICE`` elements of its
    flattened form, each cast into place, so no float32 copy of a large
    leaf exists (kimi-k2's (384, 7168, 2048) experts would take 22.5 GB)."""
    device = T.resolve_device(device)

    def leaf(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.dtype == torch.float32:
            x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
            return x.mul_(_scale(s))
        out = torch.empty(s.shape, dtype=s.dtype, device=device)
        flat = out.view(-1)
        for i in range(0, flat.numel(), _DRAW_SLICE):
            n = min(_DRAW_SLICE, flat.numel() - i)
            x = torch.randn(n, generator=generator, dtype=torch.float32, device=device)
            flat[i:i + n] = x.mul_(_scale(s))
        return out

    out = {}
    for path, s in T.leaves(spec_tree):  # draw order: sorted keys
        _set(out, path, leaf(s))
    return out


def numpy_dtype(dtype):
    """The numpy dtype of host-made parameters: float32, or a bf16 leaf's
    uint16 bit pattern (numpy has no bfloat16; ``bf16_tensor`` turns the
    bits into the port's tensor and ``np.asarray(leaf).view(np.uint16)`` a
    JAX bf16 leaf into them)."""
    if dtype == torch.float32:
        return np.dtype(np.float32)
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    raise ValueError(f"host-made parameters are float32 or bf16 bits, not {dtype}")


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns (uint16), rounded to nearest even as a
    cast to bfloat16 rounds (finite values)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)


def bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bit patterns -> a bfloat16 tensor on the CPU (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def init_numpy(spec_tree, seed: int):
    """Host parameters from ``np.random.default_rng(seed)``: float32 normals
    times the init kind's scale, leaves in sorted-key order, a bf16 leaf
    rounded to nearest even and kept as its bits (``numpy_dtype``).  The
    same arrays feed the JAX package (a bf16 leaf as
    ``jnp.asarray(bits).view(jnp.bfloat16)``) and, through
    ``models.model.params_from_numpy``, the port, so both run the same
    weights."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in T.leaves(spec_tree):
        dt = numpy_dtype(s.dtype)
        if s.init == "zeros":
            x = np.zeros(s.shape, np.float32)
        elif s.init == "ones":
            x = np.ones(s.shape, np.float32)
        else:
            x = rng.standard_normal(s.shape, dtype=np.float32)
            x *= np.float32(_scale(s))
        _set(out, path, bf16_bits(x) if dt == np.uint16 else x)
    return out


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def _set(tree: dict, path: str, value):
    *parents, last = path.strip("/").split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[last] = value


def param_count(spec_tree) -> int:
    """Parameters in a spec tree (of the model at the tp it was built at)."""
    return sum(int(np.prod(s.shape)) for _, s in T.leaves(spec_tree))


def param_bytes(spec_tree) -> int:
    """Bytes of a spec tree's parameters at their storage dtypes."""
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize for _, s in T.leaves(spec_tree))
