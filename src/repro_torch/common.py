"""Spec trees, the dtype policy and initialisers (counterpart of
``repro/common.py``).

Parameters are nested dicts of tensors; beside every parameter tree is a
spec tree of the same structure whose leaves are ``ParamSpec`` (shape,
dtype, init kind).  The JAX package's specs also carry a sharding; the port
runs on one card and drops it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype descriptor for one parameter leaf."""

    shape: tuple[int, ...]
    dtype: Any = torch.float32
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
    return fn(tree)


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
