"""Model API (counterpart of ``repro/models/model.py``): ``build(cfg, tp)``
-> specs + functions, the per-cell input and decode-cache (shape, partition
spec) builders, and the weight carry function.

Every family builds (``configs.base.PORTED``), serves and trains: the
decoders through ``transformer.forward``, the encoder-decoder through
``encdec.encode``/``cross_kv``/``decode_forward``; ``loss`` is the
training objective (``train/train_step.py`` differentiates it with
autograd).  The sharding policy is the reference's: activations over the
batch axes ("pod", "data"), weights over 'model' where the axis divides
(the ``layers``/``moe``/``ssm`` spec builders), the experts' ff axis over
'data' for very large MoE (``needs_fsdp``), every large weight over 'data'
when tp-only sharding leaves over 4 GiB a device (``fsdp_params``), KV
caches over the batch axes, kv heads over 'model' or the sequence over
what is left.  Over a mesh the port runs explicit SPMD: ``Model.loss``,
``prefill`` and ``decode_step`` take this rank's batch block and the run
layout of the weights (``run_pspecs``: every weight's spec over the mesh,
the MoE layers' expert-parallel blocks, FSDP's 'data' gathered), so each
rank holds and computes its 'model' block of every weight whose spec
splits it; the logits they return are this rank's vocab block.  The cache
keeps its sequence axis whole (``cache_specs``' split-KV sequence axes
are ROADMAP item 16).
``params_from_numpy`` takes parameters as numpy arrays — the JAX package's
(``jax.tree.map(np.asarray, model.init(key))``) or ``common.init_numpy``'s —
and returns the port's tensors after checking every key, shape and dtype
against the spec tree (a bf16 leaf comes as its uint16 bits:
``common.numpy_dtype``); on a mesh, cut each rank's blocks from them with
``common.shard``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.common import (DTypePolicy, P, ShapeDtype, bf16_tensor, entry_axes,
                                filter_pspec, init_params, numpy_dtype, param_bytes, spec_map)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.models.ssm import ssm_state_shape

TP = L.TP  # the model-axis size ``build`` uses unless told


def needs_fsdp(cfg: ModelConfig) -> bool:
    """FSDP (data-axis) sharding of the expert weights for very large MoE:
    over 20 B expert parameters."""
    if cfg.moe is None:
        return False
    m = cfg.moe
    expert_params = (cfg.n_layers - m.first_k_dense) * m.n_experts * 3 * cfg.d_model * m.d_ff_expert
    return expert_params > 2e10


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    policy: DTypePolicy
    specs: Any

    def init(self, generator: torch.Generator, device=None):
        """The whole parameters (on a mesh too: place them with
        ``common.shard`` of ``run_pspecs`` or ``state_shardings`` after)."""
        return init_params(self.specs, generator, device)

    def loss(self, params, batch, mesh=None):
        """Next-token cross-entropy plus the MoE load-balance loss: returns
        (ce + aux, {"ce", "aux"}), float32 scalars.  Over ``mesh``, of this
        rank's batch block with the weights in ``run_pspecs``' layout (the
        cross-entropy over the vocab blocks: the same on every 'model'
        rank)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            h = ED.encdec_loss_forward(cfg, params, batch, self.policy, mesh=mesh)
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        else:
            h, _, aux = TF.forward(cfg, params, batch, self.policy, mode="train", mesh=mesh,
                                   fsdp=needs_fsdp(cfg))
        lg = TF.lm_logits(cfg, params, h, self.policy, mesh)
        ce = L.cross_entropy(lg[:, :-1], batch["tokens"][:, 1:], mesh=mesh,
                             vocab=cfg.vocab_size)
        return ce + aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, mesh=None):
        """Returns (cache, last-token logits): over ``mesh``, this rank's
        blocks of both."""
        cfg = self.cfg
        if cfg.family == "encdec":
            memory = ED.encode(cfg, params, batch["enc_feats"], self.policy, mesh=mesh)
            xkv = ED.cross_kv(cfg, params, memory, self.policy, mesh)
            h, self_c = ED.decode_forward(cfg, params, batch["tokens"], self.policy,
                                          mode="prefill", xkv=xkv, mesh=mesh)
            cache = {"self": self_c, "cross": xkv}
        else:
            h, cache, _ = TF.forward(cfg, params, batch, self.policy, mode="prefill", mesh=mesh,
                                     fsdp=needs_fsdp(cfg))
        return cache, TF.lm_logits(cfg, params, h[:, -1:], self.policy, mesh)

    def decode_step(self, params, cache, batch, pos, mesh=None):
        """One token for every sequence in the batch. Returns (logits, cache)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            h, self_c = ED.decode_forward(cfg, params, batch["tokens"], self.policy,
                                          mode="decode", cache=cache["self"],
                                          xkv=cache["cross"], pos=pos, mesh=mesh)
            new_cache = {"self": self_c, "cross": cache["cross"]}
        else:
            h, new_cache, _ = TF.forward(cfg, params, batch, self.policy, mode="decode",
                                         mesh=mesh, fsdp=needs_fsdp(cfg), cache=cache, pos=pos)
        return TF.lm_logits(cfg, params, h, self.policy, mesh), new_cache


def fsdp_params(cfg: ModelConfig, tp: int = TP) -> bool:
    """Full param FSDP (data-axis sharding of every large weight) when
    TP-only sharding would exceed ~4 GB/chip of raw parameter bytes."""
    return param_bytes(build_specs_only(cfg, tp)) / tp > 4 * 2**30


def build_specs_only(cfg: ModelConfig, tp: int = TP):
    if cfg.family == "encdec":
        return ED.encdec_specs(cfg, tp)
    return TF.decoder_specs(cfg, tp, fsdp=needs_fsdp(cfg))


def build(cfg: ModelConfig, tp: int = TP) -> Model:
    """The model at model-axis size ``tp``: its shapes and partition specs;
    with ``fsdp_params``, every leaf of 2^20 elements or more also over
    'data', on the largest axis its spec leaves free (``zero1_pspec``)."""
    from repro_torch.train.optimizer import zero1_pspec

    specs = build_specs_only(cfg, tp)
    if fsdp_params(cfg, tp):
        def respec(s):
            if int(np.prod(s.shape)) < 2**20:
                return s
            return dataclasses.replace(s, pspec=zero1_pspec(s))

        specs = spec_map(respec, specs)
    return Model(cfg=cfg, policy=DTypePolicy(params=cfg.params_dtype), specs=specs)


def _without_data(pspec: P) -> P:
    """``pspec`` with 'data' dropped (FSDP's split, gathered for the step)."""
    def drop(e):
        kept = tuple(a for a in entry_axes(e) if a != "data")
        return None if not kept else kept[0] if len(kept) == 1 else kept

    return P(*(drop(e) for e in pspec))


def run_pspecs(model: Model, mesh):
    """The weights' layout the forward takes over ``mesh`` (a pspec tree like
    the specs, filtered to the mesh's axes): each leaf's own spec without
    'data' (a leaf FSDP splits over 'data' is gathered for the step), so a
    leaf whose spec names 'model' is this rank's block of it; where the
    expert-parallel paths run, the MoE layers' ``moe.ep_pspecs`` behind
    their layer axis (their FSDP'd expert ff axis stays over 'data': the
    paths gather it layer by layer)."""
    cfg = model.cfg
    run = spec_map(lambda s: filter_pspec(_without_data(s.pspec), mesh), model.specs)
    if cfg.family == "moe" and MOE.expert_parallel(cfg, mesh):
        run["layers"]["moe"] = spec_map(lambda ps: filter_pspec(P(None, *ps), mesh),
                                        MOE.ep_pspecs(cfg, needs_fsdp(cfg)))
    return run


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


# ---------------------------------------------------------------------------
# per-cell input specs (shape stand-ins; no allocation)


def _batch_axes(batch: int, min_shards: int = 16):
    return ("pod", "data") if batch >= min_shards else None


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str):
    """Returns (inputs, pspecs) for one (arch, shape) cell: ``ShapeDtype``
    stand-ins and their partition specs (the batch over the data axes once
    it reaches 16).  A decode cell's cache comes from ``cache_specs``."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    b, s = shape.global_batch, shape.seq_len
    bax = _batch_axes(b)
    tok = torch.int32
    inputs: dict[str, Any] = {}
    if cfg.family == "encdec":
        if shape.kind in ("train", "prefill"):
            inputs["enc_feats"] = ShapeDtype((b, s, cfg.d_model), torch.bfloat16)
            inputs["tokens"] = ShapeDtype((b, s if shape.kind == "train" else 448), tok)
        else:  # decode
            inputs["tokens"] = ShapeDtype((b, 1), tok)
    elif shape.kind == "decode":
        inputs["tokens"] = ShapeDtype((b, 1), tok)
        if cfg.mrope:
            inputs["mrope_pos"] = ShapeDtype((3, b, 1), tok)
    else:
        inputs["tokens"] = ShapeDtype((b, s), tok)
        if cfg.family == "vlm":
            nv = min(cfg.n_vision_tokens, s // 2)
            inputs["vision_embeds"] = ShapeDtype((b, nv, cfg.d_model), torch.bfloat16)
        if cfg.mrope:
            inputs["mrope_pos"] = ShapeDtype((3, b, s), tok)
    pspecs = {k: P(None, bax, None) if k == "mrope_pos"
              else P(bax, *([None] * (len(v.shape) - 1))) for k, v in inputs.items()}
    return inputs, pspecs


def _attn_cache_cell(cfg, batch, seq, n_stack, tp=TP, inner=None):
    """(shape, pspec) of one stacked attention cache entry (k or v): bf16
    (n_stack, batch, seq, Hkv, Dh), the batch over the data axes when large
    enough, kv heads over 'model' where they divide, the sequence over what
    is left (split-KV) where it divides."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    lead = (n_stack,) if inner is None else (n_stack, inner)
    sds = ShapeDtype(lead + (batch, seq, hkv, dh), torch.bfloat16)
    bax = _batch_axes(batch)
    hax = "model" if hkv % tp == 0 else None
    if hax and bax:
        seq_ax = None
    elif hax:
        seq_ax = "data"  # long-context, tiny batch: split-KV over data
    elif bax:
        seq_ax = "model"  # heads unshardable: split-KV over model
    else:
        seq_ax = ("data", "model")
    div = tp * tp if isinstance(seq_ax, tuple) else tp
    if seq_ax is not None and seq % div != 0:
        seq_ax = None  # e.g. whisper's 1500-frame cross-attention memory
    return sds, P(*([None] * len(lead)), bax, seq_ax, hax, None)


def _ssm_cache_cell(cfg, batch, n_stack, inner=None, tp=TP):
    lead = (n_stack,) if inner is None else (n_stack, inner)
    bax = _batch_axes(batch)
    lead_p = [None] * len(lead)

    def pspec(name):
        if name in ("conv", "conv_x"):
            return P(*lead_p, bax, None, "model")
        if name == "conv_bc":
            return P(*lead_p, bax, None, None)
        if cfg.ssm.version == 1:  # ssm state (B, din, N)
            return P(*lead_p, bax, "model", None)
        return P(*lead_p, bax, "model", None, None)  # (B, nh, N, P)

    shp = ssm_state_shape(cfg, batch)
    return ({k: ShapeDtype(lead + s.shape, s.dtype) for k, s in shp.items()},
            {k: pspec(k) for k in shp})


def cache_specs(cfg: ModelConfig, shape: ShapeConfig | str, tp: int = TP):
    """Decode-cell cache (shape tree, pspec tree) matching ``forward``'s (and
    the encdec ``Model.prefill``'s) layout."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    b, s = shape.global_batch, shape.seq_len
    fam = cfg.family
    if fam == "encdec":
        ksd, kps = _attn_cache_cell(cfg, b, s, cfg.n_layers, tp)
        # a prefill cell encodes its whole input (cross length = seq_len); a
        # decode cell reads the native audio-frame memory
        cross_len = s if shape.kind == "prefill" else cfg.n_audio_frames
        xsd, xps = _attn_cache_cell(cfg, b, cross_len, cfg.n_layers, tp)
        return ({"self": (ksd, ksd), "cross": (xsd, xsd)},
                {"self": (kps, kps), "cross": (xps, xps)})
    if fam in ("dense", "vlm"):
        ksd, kps = _attn_cache_cell(cfg, b, s, cfg.n_layers, tp)
        return {"layers": (ksd, ksd)}, {"layers": (kps, kps)}
    if fam == "moe":
        out_s, out_p = {}, {}
        if cfg.moe.first_k_dense:
            ksd, kps = _attn_cache_cell(cfg, b, s, cfg.moe.first_k_dense, tp)
            out_s["dense_layers"], out_p["dense_layers"] = (ksd, ksd), (kps, kps)
        ksd, kps = _attn_cache_cell(cfg, b, s, cfg.n_layers - cfg.moe.first_k_dense, tp)
        out_s["layers"], out_p["layers"] = (ksd, ksd), (kps, kps)
        return out_s, out_p
    if fam == "ssm":
        ssd, sps = _ssm_cache_cell(cfg, b, cfg.n_layers, tp=tp)
        return {"layers": ssd}, {"layers": sps}
    if fam == "hybrid":
        ng = TF.n_groups(cfg)
        ksd, kps = _attn_cache_cell(cfg, b, s, ng, tp)
        ssd, sps = _ssm_cache_cell(cfg, b, ng, inner=cfg.attn_every, tp=tp)
        return ({"groups": {"attn": (ksd, ksd), "ssm": ssd}},
                {"groups": {"attn": (kps, kps), "ssm": sps}})
    raise ValueError(fam)
