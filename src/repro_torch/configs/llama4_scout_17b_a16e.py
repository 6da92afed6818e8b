"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 (+1 shared), early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified tier]
Field for field the JAX package's ``repro/configs/llama4_scout_17b_a16e.py``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=202048,
        moe=MoEConfig(
            n_experts=16,
            top_k=1,
            d_ff_expert=8192,
            n_shared=1,
            capacity_factor=1.25,
        ),
        rope_theta=500_000.0,
        notes="top-1 Switch-style routing + always-on shared expert (llama4)",
    ),
    smoke=ModelConfig(
        name="llama4-scout-17b-a16e-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, n_shared=1),
    ),
)
