"""Model API (counterpart of ``repro/models/model.py``): ``build(cfg)`` ->
specs + functions, the decode-cache specs, and the weight carry function.

``params_from_numpy`` takes parameters as numpy arrays — the JAX package's
(``jax.tree.map(np.asarray, model.init(key))``) or ``common.init_numpy``'s —
and returns the port's tensors after checking every key, shape and dtype
against the spec tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.common import DTypePolicy, ShapeDtype, init_params, numpy_dtype, spec_map
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import transformer as TF
from repro_torch.models.ssm import ssm_state_shape


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    policy: DTypePolicy
    specs: Any

    def init(self, generator: torch.Generator, device=None):
        return init_params(self.specs, generator, device)

    def prefill(self, params, batch):
        """Returns (cache, last-token logits)."""
        h, cache, _ = TF.forward(self.cfg, params, batch, self.policy, mode="prefill")
        return cache, TF.lm_logits(self.cfg, params, h[:, -1:], self.policy)

    def decode_step(self, params, cache, batch, pos):
        """One token for every sequence in the batch. Returns (logits, cache)."""
        h, new_cache, _ = TF.forward(self.cfg, params, batch, self.policy,
                                     mode="decode", cache=cache, pos=pos)
        return TF.lm_logits(self.cfg, params, h, self.policy), new_cache


def build_specs_only(cfg: ModelConfig):
    return TF.decoder_specs(cfg)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, policy=DTypePolicy(params=cfg.params_dtype),
                 specs=build_specs_only(cfg))


def params_from_numpy(specs, tree, device=None):
    """Numpy parameters -> the port's tensors on ``device`` (``cuda`` unless
    given).  Raises ``ValueError`` on a missing or extra key or a leaf whose
    shape or dtype differs from its spec: nothing is broadcast or cast."""
    device = T.resolve_device(device)
    want = dict(T.leaves(specs))
    got = dict(T.leaves(tree))
    if want.keys() != got.keys():
        raise ValueError(f"params_from_numpy: keys differ: missing "
                         f"{sorted(want.keys() - got.keys())}, extra "
                         f"{sorted(got.keys() - want.keys())}")
    for path, s in want.items():
        x = got[path]
        if not isinstance(x, np.ndarray):
            raise ValueError(f"params_from_numpy: {path} is {type(x).__name__}, "
                             "not a numpy array")
        if x.shape != tuple(s.shape) or x.dtype != numpy_dtype(s.dtype):
            raise ValueError(f"params_from_numpy: {path} is {x.dtype} {x.shape}, "
                             f"the spec says {numpy_dtype(s.dtype)} {tuple(s.shape)}")
    return spec_map(lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device), tree)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig | str):
    """Decode-cache shapes matching ``forward``'s layout (the ssm family)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if cfg.family != "ssm":
        raise TF._family_missing(f"the {cfg.family} family's cache")
    per_layer = ssm_state_shape(cfg, shape.global_batch)
    return {"layers": spec_map(
        lambda s: ShapeDtype((cfg.n_layers,) + s.shape, s.dtype), per_layer)}
