"""Gemma2-27B [dense] — local/global alternating attention, logit softcaps [arXiv:2408.00118]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    layer_pattern="local_global",
    act="geglu",
    norm="rmsnorm",
    post_block_norm=True,
    embed_scale=True,
    tie_embeddings=True,
)
