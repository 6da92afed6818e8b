"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.

Encoder-decoder; conv frontend is a STUB — ``input_specs()`` provides
precomputed frame embeddings.  [arXiv:2212.04356; unverified tier]
Field for field the JAX package's ``repro/configs/whisper_tiny.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,  # decoder layers
        n_enc_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_head=64,
        d_ff=1536,
        vocab_size=51865,
        norm="layernorm",
        act="gelu",
        n_audio_frames=1500,
        tie_embeddings=True,
        notes="enc-dec audio backbone; frontend stubbed to frame embeddings; "
        "6 heads not divisible by TP=16 -> attention TP disabled (policy fallback)",
    ),
    smoke=ModelConfig(
        name="whisper-tiny-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        norm="layernorm",
        act="gelu",
        n_audio_frames=64,
        tie_embeddings=True,
    ),
)
