"""Whisper-small [audio] — enc-dec; conv frontend is a STUB (precomputed frame
embeddings are an input) [arXiv:2212.04356]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    n_encoder_layers=12,
    encoder_len=1500,
    rope_theta=0.0,  # learned positions (stubbed as sinusoidal table)
    tie_embeddings=True,
)
