"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.

GQA.  [arXiv:2403.17297; hf-verified tier]
Field for field the JAX package's ``repro/configs/internlm2_1_8b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=92544,
        rope_theta=1_000_000.0,
        notes="llama-arch GQA dense decoder",
    ),
    smoke=ModelConfig(
        name="internlm2-1.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=192,
        vocab_size=512,
    ),
)
