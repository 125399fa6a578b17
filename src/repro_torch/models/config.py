"""Model configuration schema + the 10 assigned architectures.

One frozen dataclass covers every family (dense / moe / ssm / hybrid /
enc-dec / vlm); family-specific fields default off.  Each assigned arch gets
its exact published config plus a `reduced()` variant for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavor ---
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None  # gemma2: 50.0, grok: 30.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: Optional[int] = None  # gemma2 local layers
    layer_pattern: str = "full"  # full | local_global | chunked_full
    chunk_size: Optional[int] = None  # llama4 chunked-local attention
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl (t, h, w)

    # --- mlp / norm ---
    act: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    post_block_norm: bool = False  # gemma2 pre+post norms
    embed_scale: bool = False  # gemma2 scales embeddings by sqrt(d)
    tie_embeddings: bool = True

    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0  # llama4 shared expert
    moe_capacity_factor: float = 1.25  # GShard-style capacity (tokens dropped
    # beyond capacity); raise to ~E/top_k for drop-free routing
    moe_group_size: int = 1024  # tokens per dispatch group

    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    shared_attn_every: int = 0  # zamba2: shared attn block every k ssm layers

    # --- rwkv6 ---
    rwkv: bool = False

    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    encoder_len: int = 0  # precomputed frame embeddings length (stub frontend)

    # --- vlm (qwen2-vl) ---
    n_patches: int = 0  # precomputed patch embeddings prepended (stub frontend)

    # --- serving/dry-run knobs ---
    attn_chunk_q: int = 1024  # blockwise-attention q tile
    attn_chunk_kv: int = 1024  # blockwise-attention kv tile
    sharded_decode_attn: bool = True  # shard_map flash-decode over seq-sharded
    # KV (EXPERIMENTS.md §Perf); False = baseline XLA-auto collectives

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True if 500k-context decode is state-based (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs generate tokens (whisper is enc-dec)

    def n_params(self) -> float:
        """Approximate parameter count (embedding + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        qkv_o = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim + (
            self.n_heads * self.head_dim * d
        )
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        mlp = mlp_mult * d * ff
        if self.rwkv:
            per_layer = 4 * d * d + 2 * d * self.d_ff  # rough: tmix + cmix
            total += self.n_layers * per_layer
        elif self.family in ("ssm", "hybrid"):
            di = self.d_inner_ssm
            per_layer = d * (2 * di + 2 * self.ssm_state * 2) + di * d + di * 3
            total += self.n_layers * per_layer
            if self.shared_attn_every:
                total += qkv_o + mlp  # one shared block
        elif self.n_experts:
            total += self.n_layers * (
                qkv_o + self.n_experts * mlp + self.n_shared_experts * mlp + d * self.n_experts
            )
        else:
            total += self.n_layers * (qkv_o + mlp)
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (qkv_o + mlp)
            total += self.n_layers * qkv_o  # cross-attention
        return float(total)

    def n_params_active(self) -> float:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        mlp = mlp_mult * d * ff
        dense = self.n_params() - self.n_layers * self.n_experts * mlp
        return dense + self.n_layers * (self.top_k + self.n_shared_experts) * mlp

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            sliding_window=32 if self.sliding_window else None,
            chunk_size=32 if self.chunk_size else None,
            n_experts=min(self.n_experts, 4),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_len=32 if self.encoder_len else 0,
            n_patches=8 if self.n_patches else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
            attn_chunk_q=16,
            attn_chunk_kv=16,
        )
