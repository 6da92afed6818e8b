"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert)
vocab=163840, MoE 384 experts top-8.

Trillion-param MoE (paper-table).  [arXiv:2501.kimi2; unverified tier]
Memory note: ~1.04e12 params.  bf16 params + int8 Adam moments + ZeRO-1 give
~4 bytes/param state -> 4.2 TB global; fits 512 chips (8.2 GB/chip) with
FSDP-style expert-weight sharding over the data axis; single-pod 256 chips is
borderline (16.4 GB/chip before activations) — recorded in EXPERIMENTS §Dry-run.
Field for field the JAX package's ``repro/configs/kimi_k2_1t_a32b.py``.
"""
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_head=112,
        d_ff=2048,  # expert FFN width
        vocab_size=163840,
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_ff_expert=2048,
            n_shared=1,
            capacity_factor=1.25,
            first_k_dense=1,
            d_ff_dense=18432,
        ),
        rope_theta=50_000.0,
        params_dtype=torch.bfloat16,
        moments_dtype=torch.int8,
        notes="1T-param MoE; EP over model axis (24 experts/shard), "
        "expert weights additionally FSDP-sharded over data axis",
    ),
    smoke=ModelConfig(
        name="kimi-k2-1t-a32b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=64,
        vocab_size=512,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_ff_expert=64,
            n_shared=1,
            first_k_dense=1,
            d_ff_dense=128,
        ),
    ),
)
