"""Model API (counterpart of ``repro/models/model.py``): ``build(cfg)`` ->
specs + functions, the decode-cache specs, and the weight carry function.

Every family builds (``configs.base.PORTED``), serves and trains: the
decoders through ``transformer.forward``, the encoder-decoder through
``encdec.encode``/``cross_kv``/``decode_forward``; ``loss`` is the
training objective (``train/train_step.py`` differentiates it with
autograd).  The reference's ``needs_fsdp`` and
``fsdp_params`` choose a sharding of the weights over a mesh and change
no value; on one card they have no counterpart.
``params_from_numpy`` takes parameters as numpy arrays — the JAX package's
(``jax.tree.map(np.asarray, model.init(key))``) or ``common.init_numpy``'s —
and returns the port's tensors after checking every key, shape and dtype
against the spec tree (a bf16 leaf comes as its uint16 bits:
``common.numpy_dtype``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.common import DTypePolicy, ShapeDtype, bf16_tensor, init_params, numpy_dtype
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.ssm import ssm_state_shape


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    policy: DTypePolicy
    specs: Any

    def init(self, generator: torch.Generator, device=None):
        return init_params(self.specs, generator, device)

    def loss(self, params, batch):
        """Next-token cross-entropy plus the MoE load-balance loss: returns
        (ce + aux, {"ce", "aux"}), float32 scalars."""
        cfg = self.cfg
        if cfg.family == "encdec":
            h = ED.encdec_loss_forward(cfg, params, batch, self.policy)
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        else:
            h, _, aux = TF.forward(cfg, params, batch, self.policy, mode="train")
        lg = TF.lm_logits(cfg, params, h, self.policy)
        ce = L.cross_entropy(lg[:, :-1], batch["tokens"][:, 1:])
        return ce + aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch):
        """Returns (cache, last-token logits)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            memory = ED.encode(cfg, params, batch["enc_feats"], self.policy)
            xkv = ED.cross_kv(cfg, params, memory, self.policy)
            h, self_c = ED.decode_forward(cfg, params, batch["tokens"], self.policy,
                                          mode="prefill", xkv=xkv)
            cache = {"self": self_c, "cross": xkv}
        else:
            h, cache, _ = TF.forward(cfg, params, batch, self.policy, mode="prefill")
        return cache, TF.lm_logits(cfg, params, h[:, -1:], self.policy)

    def decode_step(self, params, cache, batch, pos):
        """One token for every sequence in the batch. Returns (logits, cache)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            h, self_c = ED.decode_forward(cfg, params, batch["tokens"], self.policy,
                                          mode="decode", cache=cache["self"],
                                          xkv=cache["cross"], pos=pos)
            new_cache = {"self": self_c, "cross": cache["cross"]}
        else:
            h, new_cache, _ = TF.forward(cfg, params, batch, self.policy, mode="decode",
                                         cache=cache, pos=pos)
        return TF.lm_logits(cfg, params, h, self.policy), new_cache


def build_specs_only(cfg: ModelConfig):
    if cfg.family == "encdec":
        return ED.encdec_specs(cfg)
    return TF.decoder_specs(cfg)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, policy=DTypePolicy(params=cfg.params_dtype),
                 specs=build_specs_only(cfg))


def params_from_numpy(specs, tree, device=None):
    """Numpy parameters -> the port's tensors on ``device`` (``cuda`` unless
    given).  Raises ``ValueError`` on a missing or extra key or a leaf whose
    shape or dtype differs from its spec: nothing is broadcast or cast.  On
    the CPU the tensors share the arrays' memory: an in-place update (the
    train step's) writes into the arrays."""
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
    return T.map_with_path(
        lambda path, x: (bf16_tensor(x) if want[path].dtype == torch.bfloat16
                         else torch.from_numpy(np.ascontiguousarray(x))).to(device), tree)


def _attn_cache_cell(cfg, batch, seq, n_stack):
    """One stacked attention cache entry (k or v): bf16 (n_stack, batch,
    seq, Hkv, Dh).  The reference's sharding is dropped."""
    return ShapeDtype((n_stack, batch, seq, cfg.n_kv_heads, cfg.head_dim), torch.bfloat16)


def _ssm_cache_cell(cfg, batch, lead):
    return {k: ShapeDtype(lead + s.shape, s.dtype)
            for k, s in ssm_state_shape(cfg, batch).items()}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig | str):
    """Decode-cache shapes matching ``forward``'s (and the encdec
    ``Model.prefill``'s) layout."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    b, s = shape.global_batch, shape.seq_len
    fam = cfg.family
    if fam == "encdec":
        k = _attn_cache_cell(cfg, b, s, cfg.n_layers)
        # a prefill cell encodes its whole input (cross length = seq_len); a
        # decode cell reads the native audio-frame memory
        cross_len = s if shape.kind == "prefill" else cfg.n_audio_frames
        x = _attn_cache_cell(cfg, b, cross_len, cfg.n_layers)
        return {"self": (k, k), "cross": (x, x)}
    if fam in ("dense", "vlm"):
        k = _attn_cache_cell(cfg, b, s, cfg.n_layers)
        return {"layers": (k, k)}
    if fam == "moe":
        out = {}
        if cfg.moe.first_k_dense:
            k = _attn_cache_cell(cfg, b, s, cfg.moe.first_k_dense)
            out["dense_layers"] = (k, k)
        k = _attn_cache_cell(cfg, b, s, cfg.n_layers - cfg.moe.first_k_dense)
        out["layers"] = (k, k)
        return out
    if fam == "ssm":
        return {"layers": _ssm_cache_cell(cfg, b, (cfg.n_layers,))}
    if fam == "hybrid":
        ng = TF.n_groups(cfg)
        k = _attn_cache_cell(cfg, b, s, ng)
        return {"groups": {"attn": (k, k),
                           "ssm": _ssm_cache_cell(cfg, b, (ng, cfg.attn_every))}}
    raise ValueError(fam)
