"""Model building blocks (counterpart of repro.models.layers): the dense
decoder's and the Mamba2 hybrid's.

Norms, rotary embeddings, the attention block, the MLPs and the Mamba2
block.  Projections are plain ``torch.matmul``, as the reference leaves
them to XLA; attention and the SSD scan go to the hand-written kernels
through ``kernels.ops``:

  * a fresh-cache prefill (or a cache-free forward) is causal attention
    over the segment's own k, v -- ``ops.flash_attention``;
  * a one-token decode attends over the layer's cache with
    ``lengths = length + 1`` -- ``ops.decode_attention``, which reads the
    cache in place;
  * the Mamba2 block's chunked SSD scan -- ``ops.ssd_scan`` (its plain
    version on CPU tensors).

Every other case (sliding-window or chunked-local masks, a multi-token
append to a non-empty cache) raises ``NotImplementedError`` on both
devices: there is no plain fallback on the card.

Weight layout of one attention block (``p``): ``wqkv`` (d, (H + 2 KV) hd)
-- the reference's wq, wk, wv (d, H|KV, hd) side by side -- with
``bqkv``; ``wo`` (H hd, d); ``w13`` (d, 2 ff) = [w1 | w3] for gated MLPs,
else ``w1`` (d, ff); ``w2`` (ff, d); norm scales ``ln1`` / ``ln2`` (and
``ln1_b`` / ``ln2_b`` for LayerNorm, ``ln1_post`` / ``ln2_post`` for
post-block norms).  A Mamba2 block keeps the reference's names:
``in_proj`` (d, 2 di + 2 N + H), ``out_proj`` (di, d), ``conv_w`` (K, di +
2 N), ``dt_bias`` / ``a_log`` / ``d_skip`` (H,).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + scale) in f32; scale is an offset."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dt)


def apply_norm(cfg: ModelConfig, x, scale, bias=None):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, scale)
    return layer_norm(x, scale, bias)


# ---------------------------------------------------------------------------
# Rotary embeddings (split-halves rotation)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B, S, 1, D/2) f32, for positions (B, S)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x, positions, theta: float, tables=None):
    """x: (B, S, H, D); positions: (B, S) int.  ``tables`` are
    rope_tables(positions, D, theta), computed once per forward when given."""
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + the kernels)
# ---------------------------------------------------------------------------


def _unsupported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, the model stack's "
        "remaining item); the port runs dense full attention only"
    )


def attention(
    cfg: ModelConfig,
    p,  # wqkv (d, (H+2KV) hd) [+ bqkv], wo (H hd, d)
    x,  # (B, S, d)
    *,
    layer_is_local: bool = False,
    kv_cache: Optional[dict] = None,  # {"k", "v": (B, S_max, KV, hd), "length": int}
    causal: bool = True,
    rope=None,  # rope_tables(positions, ...) shared by the layers of a forward
):
    """Returns (out (B, S, d), new_cache or None).  The positions are
    ``length .. length + S - 1``; the cache is updated in place (slice
    assignment at ``length``) and ``length`` stays a Python int."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mrope_sections is not None:
        raise _unsupported("M-RoPE (qwen2-vl)")
    if layer_is_local and (cfg.sliding_window is not None or cfg.chunk_size is not None):
        raise _unsupported("sliding-window / chunked-local attention")

    qkv = torch.matmul(x, p["wqkv"])
    if cfg.qkv_bias:
        qkv = qkv + p["bqkv"]
    q, k, v = torch.split(qkv, [H * hd, KV * hd, KV * hd], dim=-1)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)

    length = 0 if kv_cache is None else int(kv_cache["length"])
    if cfg.rope_theta > 0:
        positions = torch.arange(length, length + S, device=x.device)[None, :].expand(B, S)
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)

    softcap = cfg.attn_softcap
    if kv_cache is None:
        out = ops.flash_attention(q, k, v, causal=causal, softcap=softcap,
                                  device=x.device)
        new_cache = None
    else:
        kbuf, vbuf = kv_cache["k"], kv_cache["v"]
        if kbuf.dtype != x.dtype:
            raise ValueError(f"cache dtype {kbuf.dtype} differs from the "
                             f"activations' {x.dtype}")
        if length + S > kbuf.shape[1]:
            raise ValueError(f"cache of capacity {kbuf.shape[1]} cannot take "
                             f"{length} + {S} tokens")
        kbuf[:, length:length + S] = k
        vbuf[:, length:length + S] = v
        if length == 0:
            # fresh cache: attention over the buffer is attention over the
            # segment itself
            out = ops.flash_attention(q, k, v, causal=causal, softcap=softcap,
                                      device=x.device)
        elif S == 1:
            lengths = kv_cache.get("lengths")
            if lengths is None:
                lengths = torch.full((B,), length + 1, dtype=torch.int32,
                                     device=x.device)
            out = ops.decode_attention(q[:, 0], kbuf, vbuf, lengths,
                                       softcap=softcap, device=x.device)[:, None]
        else:
            raise _unsupported("a multi-token append to a non-empty cache")
        new_cache = {"k": kbuf, "v": vbuf, "length": length + S}
    out = torch.matmul(out.reshape(B, S, H * hd), p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp(cfg: ModelConfig, p, x):
    if cfg.act in ("swiglu", "geglu"):
        gate, up = torch.chunk(torch.matmul(x, p["w13"]), 2, dim=-1)
        act = F.silu(gate) if cfg.act == "swiglu" else F.gelu(gate, approximate="tanh")
        h = act * up
    else:  # plain gelu MLP
        h = F.gelu(torch.matmul(x, p["w1"]), approximate="tanh")
    return torch.matmul(h, p["w2"])


# ---------------------------------------------------------------------------
# Mamba2 (SSD, chunked) -- the hybrid family's backbone
# ---------------------------------------------------------------------------


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along seq. x: (B, S, C), w: (K, C).

    state: (B, K-1, C) trailing inputs of the previous segment (decode).
    The K shifted products are summed in the reference's order, in x's
    dtype.  Returns (y, new_state); new_state is a view of the padded input.
    """
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S+K-1, C)
    wx = w.to(x.dtype)
    y = xp[:, 0:S, :] * wx[0]  # the reference's sum(), less its leading 0 +
    for i in range(1, K):
        y = y + xp[:, i:i + S, :] * wx[i]
    new_state = xp[:, S:, :] if K > 1 else state
    return y, new_state


def mamba2_block(cfg: ModelConfig, p, x, *, ssm_state=None, conv_state=None,
                 chunk: int = 128, ssm_out=None):
    """Mamba2 block via the chunked SSD scan (``ops.ssd_scan``).

    x: (B, S, d).  State: (B, H, P, N) float32 with H = n_ssm_heads, P =
    ssm_head_dim, N = ssm_state.  Returns (y, new_ssm_state,
    new_conv_state).  With ``ssm_out`` (e.g. the cache's slice, which may be
    ``ssm_state`` itself) the scan writes the new state there.
    """
    B, S, d = x.shape
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner_ssm

    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], conv_state)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    # jax.nn.softplus is logaddexp(x, 0) (F.softplus turns linear above 20)
    dt = torch.logaddexp(dt.float() + p["dt_bias"].float(), torch.zeros((), device=x.device))
    a = -torch.exp(p["a_log"].float())  # (H,) negative
    dA = dt * a  # per-step log decay, <= 0

    y, ssm_state = ops.ssd_scan(xs, Bm, Cm, dt, dA, ssm_state, chunk=chunk,
                                state_out=ssm_out, device=x.device)
    y = y + xs.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype) * F.silu(z)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    return out, ssm_state, conv_state
