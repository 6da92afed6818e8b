"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE + dynamic resolution; vision frontend is a STUB — ``input_specs()``
provides precomputed patch embeddings.  [arXiv:2409.12191; hf-verified tier]
Field for field the JAX package's ``repro/configs/qwen2_vl_72b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=29568,
        vocab_size=152064,
        mrope=True,
        mrope_sections=(16, 24, 24),
        n_vision_tokens=1024,
        rope_theta=1_000_000.0,
        notes="text backbone w/ M-RoPE; patch embeds merged at leading positions",
    ),
    smoke=ModelConfig(
        name="qwen2-vl-72b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        mrope=True,
        mrope_sections=(2, 3, 3),
        n_vision_tokens=8,
    ),
)
