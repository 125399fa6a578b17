"""RWKV6-3B 'Finch' [ssm] — attention-free, data-dependent decay [arXiv:2404.05892]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,      # time-mix heads, head_dim 64
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rwkv=True,
    norm="layernorm",
    tie_embeddings=False,
)
