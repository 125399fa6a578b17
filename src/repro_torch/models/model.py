"""The dense decoder: init / forward / prefill / decode (counterpart of
repro.models.model, dense subset).

The parameters are an ``nn.Module`` (``DenseLM``): the embedding, the final
norm, the untied output matrix and one ``nn.ParameterDict`` per layer
(layout in ``layers``).  The reference stacks layers on a leading axis and
scans them; here a Python loop walks the per-layer dicts.

Cache convention: ``{"k": (L, B, S, KV, hd), "v": ..., "length": int}``.
K/V are appended in place by slice assignment and ``length`` is a Python
int on the host, so a decode step never waits on the card to read it.

Only the dense family runs.  The others (MoE, SSM / RWKV, hybrid,
encoder-decoder, VLM) raise ``NotImplementedError`` at ``init_params`` and
at ``forward_lm``; sliding-window and chunked-local layers raise in
``layers.attention``.  ROADMAP.md queue 1 lists them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family this port cannot run yet."""
    if cfg.rwkv or cfg.family != "dense" or cfg.n_experts or cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP.md "
            "queue 1, the model stack's remaining item); the port runs dense "
            "decoders"
        )


def _norm_names(cfg: ModelConfig, name: str) -> List[str]:
    return [name] if cfg.norm == "rmsnorm" else [name, name + "_b"]


def block_norms(cfg: ModelConfig) -> List[str]:
    """The norms of one layer (each a scale, plus a bias for LayerNorm)."""
    return ["ln1", "ln2"] + (["ln1_post", "ln2_post"] if cfg.post_block_norm else [])


def block_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of one layer's parameters in the port's layout."""
    d, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.d_ff)
    shapes = {"wqkv": (d, (H + 2 * KV) * hd), "wo": (H * hd, d)}
    if cfg.qkv_bias:
        shapes["bqkv"] = ((H + 2 * KV) * hd,)
    if cfg.act in ("swiglu", "geglu"):
        shapes["w13"] = (d, 2 * ff)
    else:
        shapes["w1"] = (d, ff)
    shapes["w2"] = (ff, d)
    for n in block_norms(cfg):
        for name in _norm_names(cfg, n):
            shapes[name] = (d,)
    return shapes


def _frozen(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class DenseLM(nn.Module):
    """Parameters of a dense decoder, on one device, in one dtype."""

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor],
                 blocks: List[Dict[str, torch.Tensor]]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(top["embed"])
        self.final_norm = _frozen(top["final_norm"])
        self.final_norm_b = _frozen(top["final_norm_b"]) if "final_norm_b" in top else None
        self.out = None if cfg.tie_embeddings else _frozen(top["out"])
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: _frozen(v) for k, v in b.items()}) for b in blocks
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> DenseLM:
    """Random weights (std 0.02, zero biases, zero RMSNorm offsets, unit
    LayerNorm scales, as the reference) drawn from ``generator`` straight
    into ``dtype`` on ``device`` -- no f32 staging copy, so a 32B model in
    bf16 needs its 61 GiB and no more.  The generator must live on the
    device (``torch.Generator(device="cuda")`` for the card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    std = 0.02

    def init(name, shape):
        if name.startswith("w") or name in ("embed", "out"):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=dev).mul_(std)
        if cfg.norm != "rmsnorm" and name.startswith(("ln", "final_norm")) \
                and not name.endswith("_b"):
            return torch.ones(shape, dtype=dtype, device=dev)  # LayerNorm scale
        return torch.zeros(shape, dtype=dtype, device=dev)  # biases, RMSNorm offsets

    top_shapes = {"embed": (cfg.vocab_size, cfg.d_model)}
    top_shapes.update({n: (cfg.d_model,) for n in _norm_names(cfg, "final_norm")})
    if not cfg.tie_embeddings:
        top_shapes["out"] = (cfg.d_model, cfg.vocab_size)
    top = {n: init(n, shape) for n, shape in top_shapes.items()}
    blocks = [{n: init(n, shape) for n, shape in block_shapes(cfg).items()}
              for _ in range(cfg.n_layers)]
    return DenseLM(cfg, top, blocks)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params: DenseLM, tokens):
    h = params.embed[tokens]
    if cfg.embed_scale:
        h = (h.float() * math.sqrt(cfg.d_model)).to(h.dtype)
    return h


def _unembed(cfg: ModelConfig, params: DenseLM, h):
    if cfg.tie_embeddings:
        logits = torch.matmul(h, params.embed.t())
    else:
        logits = torch.matmul(h, params.out)
    if cfg.final_softcap:
        logits = (cfg.final_softcap
                  * torch.tanh(logits.float() / cfg.final_softcap)).to(logits.dtype)
    return logits


def _layer_is_local(cfg: ModelConfig, i: int) -> bool:
    if cfg.layer_pattern == "local_global":
        return i % 2 == 0
    if cfg.layer_pattern == "chunked_full":
        return i % 4 != 3
    return False


def _block(cfg: ModelConfig, p, h, is_local: bool, kv_cache=None, rope=None):
    a_in = L.apply_norm(cfg, h, p["ln1"], p.get("ln1_b"))
    a_out, new_cache = L.attention(cfg, p, a_in, layer_is_local=is_local,
                                   kv_cache=kv_cache, rope=rope)
    if cfg.post_block_norm:
        a_out = L.apply_norm(cfg, a_out, p["ln1_post"], p.get("ln1_post_b"))
    h = h + a_out
    m_in = L.apply_norm(cfg, h, p["ln2"], p.get("ln2_b"))
    m_out = L.mlp(cfg, p, m_in)
    if cfg.post_block_norm:
        m_out = L.apply_norm(cfg, m_out, p["ln2_post"], p.get("ln2_post_b"))
    return h + m_out, new_cache


@torch.inference_mode()
def forward_lm(cfg: ModelConfig, params: DenseLM, tokens, *,
               cache: Optional[dict] = None):
    """Dense decoder stack over tokens (B, S).  Returns (h_final, new_cache);
    a given cache is updated in place and comes back with length + S."""
    check_supported(cfg)
    B, S = tokens.shape
    h = _embed(cfg, params, tokens)
    length = 0 if cache is None else int(cache["length"])
    rope = None
    if cfg.rope_theta > 0:
        positions = torch.arange(length, length + S, device=h.device)[None, :].expand(B, S)
        rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    lengths = None
    if cache is not None and length > 0 and S == 1:
        # the decode kernel's valid prefix, shared by every layer of the step
        lengths = torch.full((B,), length + 1, dtype=torch.int32, device=h.device)
    for i, p in enumerate(params.blocks):
        kv = None
        if cache is not None:
            kv = {"k": cache["k"][i], "v": cache["v"][i], "length": length,
                  "lengths": lengths}
        h, _ = _block(cfg, p, h, _layer_is_local(cfg, i), kv_cache=kv, rope=rope)
    h = L.apply_norm(cfg, h, params.final_norm, params.final_norm_b)
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "length": length + S}
    return h, new_cache


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: DenseLM, batch: Dict, max_len: int,
            cache_dtype: torch.dtype = torch.bfloat16):
    """Run the prompt, build a KV cache of capacity max_len.
    Returns (logits of the last position (B, 1, V), cache)."""
    tokens = batch["tokens"]
    B, _ = tokens.shape
    cache = init_cache(cfg, B, max_len, dtype=cache_dtype, device=tokens.device)
    h, cache = forward_lm(cfg, params, tokens, cache=cache)
    return _unembed(cfg, params, h[:, -1:, :]), cache


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: DenseLM, cache: dict, tokens):
    """One token per sequence: tokens (B, 1) -> (logits (B, 1, V), cache)."""
    h, cache = forward_lm(cfg, params, tokens, cache=cache)
    return _unembed(cfg, params, h[:, -1:, :]), cache


def cache_shape(cfg: ModelConfig, B: int, max_len: int) -> tuple:
    return (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)


@torch.inference_mode()
def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    check_supported(cfg)
    dev = resolve_device(device)
    shape = cache_shape(cfg, B, max_len)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "length": 0,
    }
