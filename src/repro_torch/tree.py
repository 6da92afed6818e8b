"""State trees: nested dicts of tensors, mirroring the JAX package's pytrees.

``from_numpy`` is the carry-across function: the JAX package's built
``(states, pending)`` trees, converted leaf by leaf to numpy, become the
port's tensors, so a test can start the port from a JAX-built state.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; the port never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device=\"cpu\" to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees (dicts and tuples) of identical
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def leaves(tree, prefix=""):
    """``[(path, leaf), ...]`` in JAX's flattening order: dicts by sorted
    key, tuples by position (path element ``/i``)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}")
        return out
    if isinstance(tree, tuple):
        return [x for i, t in enumerate(tree) for x in leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def map_with_path(fn, tree, prefix=""):
    """``fn(path, leaf)`` over every leaf, with ``leaves``' paths."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_with_path(fn, t, f"{prefix}/{i}") for i, t in enumerate(tree))
    return fn(prefix, tree)


def to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def from_numpy(tree, device):
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def cat(trees):
    return tree_map(lambda *xs: torch.cat(xs), *trees)


def take(tree, i: int):
    """Segment ``i`` as a one-segment stack (leading axis kept)."""
    return tree_map(lambda x: x[i:i + 1], tree)
