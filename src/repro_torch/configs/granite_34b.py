"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576 vocab=49152.

llama-arch, code model.  [arXiv:2405.04324; hf-verified tier]
Field for field the JAX package's ``repro/configs/granite_34b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_head=128,
        d_ff=24576,
        vocab_size=49152,
        rope_theta=10_000.0,
        notes="MQA (kv=1) deep code model; kv heads replicated under TP",
    ),
    smoke=ModelConfig(
        name="granite-34b-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=256,
        vocab_size=512,
    ),
)
