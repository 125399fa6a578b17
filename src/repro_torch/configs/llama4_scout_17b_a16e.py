"""Llama-4 Scout 17B-active/16E [moe] — top-1 routing + shared expert, chunked
local attention on 3/4 layers [hf:meta-llama/Llama-4-Scout-17B-16E]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    layer_pattern="chunked_full",
    chunk_size=8192,
    rope_theta=500_000.0,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)
