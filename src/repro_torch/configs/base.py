"""Architecture and shape configurations (counterpart of
``repro/configs/base.py``): the same dataclasses, fields and defaults, with
dtypes as ``torch`` dtypes.

Every architecture of the JAX package has a module here that registers its
full and smoke configurations, field for field the reference's; the shape
cells (``cells``, ``all_cells``, ``skipped_cells``) are the reference's.
``PORTED`` names the families that ``models.model.build`` accepts and
serves: all six of the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    first_k_dense: int = 0  # leading dense layers (kimi-k2 style)
    d_ff_dense: int = 0  # d_ff of those dense layers


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    version: int  # 1 = Mamba (selective scan), 2 = Mamba2 (SSD)
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # mamba2 only
    dt_rank: int = 0  # mamba1 only; 0 -> d_model // 16
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0  # hybrid: shared attn block every k ssm layers
    n_enc_layers: int = 0  # encdec only
    mrope: bool = False  # vlm: multimodal 3D rope
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    n_vision_tokens: int = 0  # vlm: stub patch-embedding count
    n_audio_frames: int = 0  # encdec: default encoder length
    max_seq: int = 1_048_576
    params_dtype: Any = torch.float32
    moments_dtype: Any = torch.float32  # int8 for 8-bit Adam moments
    remat: str = "full"  # full | none
    attn_impl: str = "dense"  # dense | flash (train-path attention)
    fast_norm: bool = False  # normalize in bf16 (stats stay fp32)
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context without quadratic attention?"""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    accum_steps: int = 1  # gradient-accumulation microbatches (train only)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", accum_steps=4),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "qwen3-1.7b",
    "stablelm-12b",
    "internlm2-1.8b",
    "granite-34b",
    "whisper-tiny",
    "kimi-k2-1t-a32b",
    "llama4-scout-17b-a16e",
    "falcon-mamba-7b",
    "qwen2-vl-72b",
    "zamba2-2.7b",
]
# the families models.model.build accepts: all six
PORTED = {"dense", "moe", "ssm", "hybrid", "vlm", "encdec"}

_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in _REGISTRY:
        importlib.import_module("repro_torch.configs." + arch.replace("-", "_")
                                .replace(".", "_"))
    return _REGISTRY[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    get_config(arch)
    return _SMOKE[arch]


def cells(arch: str) -> list[str]:
    """Runnable shape cells for an arch (long_500k only for sub-quadratic)."""
    cfg = get_config(arch)
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue  # quadratic full attention at 524k: documented skip
        out.append(s.name)
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in cells(a)]


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        if not cfg.sub_quadratic:
            out.append((a, "long_500k", "pure full attention is quadratic at 524k ctx"))
    return out
