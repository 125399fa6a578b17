"""Grok-1 314B [moe] — 8 experts top-2, GQA, attention softcap [hf:xai-org/grok-1]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    attn_softcap=30.0,
    act="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
