"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b family; hf-verified tier]
Field for field the JAX package's ``repro/configs/stablelm_12b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=160,
        d_ff=13824,
        vocab_size=100352,
        norm="layernorm",
        rope_theta=10_000.0,
        notes="parallel-residual-family dense decoder (LayerNorm)",
    ),
    smoke=ModelConfig(
        name="stablelm-12b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=160,
        vocab_size=512,
        norm="layernorm",
    ),
)
