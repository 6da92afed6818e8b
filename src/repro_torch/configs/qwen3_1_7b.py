"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.

qk_norm + GQA.  [hf:Qwen/Qwen3-8B family; hf-verified tier]
Field for field the JAX package's ``repro/configs/qwen3_1_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_head=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        notes="qk-norm GQA dense decoder",
    ),
    smoke=ModelConfig(
        name="qwen3-1.7b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        qk_norm=True,
        tie_embeddings=True,
    ),
)
