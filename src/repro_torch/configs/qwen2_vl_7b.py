"""Qwen2-VL-7B [vlm] — M-RoPE, dynamic resolution; the vision tower is a STUB
(precomputed patch embeddings are an input) [arXiv:2409.12191]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    act="swiglu",
    norm="rmsnorm",
    n_patches=256,
    tie_embeddings=False,
)
