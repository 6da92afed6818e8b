"""falcon-mamba-7b [ssm] — 64L d_model=4096 attn-free vocab=65024 ssm_state=16.

Mamba-1 architecture (selective scan).  [arXiv:2410.05355; unverified tier]
Field for field the JAX package's ``repro/configs/falcon_mamba_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_head=1,
        d_ff=0,
        vocab_size=65024,
        ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2, dt_rank=256),
        tie_embeddings=True,
        notes="attention-free; O(1)-state decode -> long_500k runs; "
        "paper's crossbar offload applies to in/out projections only",
    ),
    smoke=ModelConfig(
        name="falcon-mamba-7b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_head=1,
        d_ff=0,
        vocab_size=512,
        ssm=SSMConfig(version=1, d_state=8, d_conv=4, expand=2, dt_rank=8, chunk=16),
        tie_embeddings=True,
    ),
)
