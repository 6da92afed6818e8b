"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000 ssm_state=64.

Mamba-2 backbone + shared attention block every 6 layers (9 applications of a
single shared weight set).  [arXiv:2411.15242; hf-verified tier]
Field for field the JAX package's ``repro/configs/zamba2_2_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_head=80,
        d_ff=10240,
        vocab_size=32000,
        ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2, head_dim=64),
        attn_every=6,
        notes="hybrid: 9 groups of (shared attn block + 6 mamba2 layers); "
        "long_500k decode uses split-KV attention over the data axis",
    ),
    smoke=ModelConfig(
        name="zamba2-2.7b-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        ssm=SSMConfig(version=2, d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        attn_every=2,
    ),
)
