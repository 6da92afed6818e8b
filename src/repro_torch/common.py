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


def init_params(spec_tree, generator: torch.Generator, device=None):
    """Random parameters with the JAX package's init kinds and scales, drawn
    from ``generator`` leaf by leaf in sorted-key order (a generator gives
    other numbers than ``jax.random``: use ``init_numpy`` to give both
    packages the same weights)."""
    device = T.resolve_device(device)

    def leaf(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(_scale(s)).to(s.dtype)

    out = {}
    for path, s in T.leaves(spec_tree):  # draw order: sorted keys
        _set(out, path, leaf(s))
    return out


def numpy_dtype(dtype):
    """The numpy dtype of host-made parameters: float32 only (every ported
    configuration stores float32 parameters)."""
    if dtype != torch.float32:
        raise ValueError(f"host-made parameters are float32, not {dtype}")
    return np.dtype(np.float32)


def init_numpy(spec_tree, seed: int):
    """Host parameters from ``np.random.default_rng(seed)``: float32 normals
    times the init kind's scale, leaves in sorted-key order.  The same arrays
    feed the JAX package and, through ``models.model.params_from_numpy``, the
    port, so both run the same weights."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in T.leaves(spec_tree):
        dt = numpy_dtype(s.dtype)
        if s.init == "zeros":
            x = np.zeros(s.shape, dt)
        elif s.init == "ones":
            x = np.ones(s.shape, dt)
        else:
            x = rng.standard_normal(s.shape, dtype=np.float32)
            x *= np.float32(_scale(s))
            x = x.astype(dt, copy=False)
        _set(out, path, x)
    return out


def _set(tree: dict, path: str, value):
    *parents, last = path.strip("/").split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[last] = value
