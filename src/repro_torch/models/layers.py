"""Model building blocks (counterpart of repro.models.layers): the dense
and MoE decoders', the Mamba2 hybrid's, RWKV6's, Whisper's (encoder and
cross-attention) and Qwen2-VL's (M-RoPE).

Norms, rotary embeddings (RoPE and M-RoPE), the attention block,
cross-attention, the MLPs, the MoE FFN, the Mamba2 block and RWKV6's time
mix and channel mix.  Projections (the
experts' included) are plain ``torch.matmul`` / ``torch.bmm``, as the
reference leaves them to XLA; attention and the two scans go to the
hand-written kernels through ``kernels.ops``, attention with the layer's
sliding window or chunked-local mask (chosen per layer as the reference
does):

  * a fresh-cache prefill (or a cache-free forward) is causal attention
    over the segment's own k, v -- ``ops.flash_attention``;
  * a multi-token append of S rows to a cache of ``length`` rows is causal
    attention from the new rows over the cache's prefix view ``kbuf[:,
    :length + S]`` -- ``ops.flash_attention`` reads it in place, and its
    bottom-right alignment puts row i at position ``length + i``;
  * a one-token decode attends over the layer's cache with
    ``lengths = length + 1`` -- ``ops.decode_attention``, which reads the
    cache in place;
  * Whisper's cross-attention from the decoder's rows to the encoder's T
    outputs (no mask, no rope; K and V projected from ``enc_out`` on every
    call, as the reference does): non-causal ``ops.flash_attention`` for a
    multi-row call, ``ops.decode_attention`` with ``lengths`` all T for a
    one-token decode, both reading K and V in place as views of the one
    projection;
  * the Mamba2 block's chunked SSD scan -- ``ops.ssd_scan`` (its plain
    version on CPU tensors);
  * RWKV6's WKV6 recurrence -- ``ops.wkv6_scan`` (likewise).

The caches stay full length, as the reference's: a window or a chunk
limits the keys read, not the rows kept.  M-RoPE (qwen2-vl) splits the
D/2 rotary frequencies among the (t, h, w) components of (3, B, S)
positions (``mrope_sections``); its tables, like RoPE's, are computed once
a forward and shared by its layers.

Weight layout of one attention block (``p``): ``wqkv`` (d, (H + 2 KV) hd)
-- the reference's wq, wk, wv (d, H|KV, hd) side by side -- with
``bqkv``; ``wo`` (H hd, d); ``w13`` (d, 2 ff) = [w1 | w3] for gated MLPs,
else ``w1`` (d, ff); ``w2`` (ff, d); norm scales ``ln1`` / ``ln2`` (and
``ln1_b`` / ``ln2_b`` for LayerNorm, ``ln1_post`` / ``ln2_post`` for
post-block norms).  A Whisper decoder layer adds its cross-attention's
``x_wq`` (d, H hd), ``x_wkv`` (d, 2 KV hd) -- the reference's x_wk, x_wv
side by side -- and ``x_wo`` (H hd, d), and its norm ``lnx`` (``lnx_b``);
an encoder layer is a dense layer.  An MoE layer has ``router`` (d, E) and the experts
stacked as ``w13`` (E, d, 2 ff) (``w1`` (E, d, ff) ungated) and ``w2`` (E,
ff, d), and its shared expert, if any, as ``sw13`` (d, 2 ff) (``sw1``) and
``sw2`` (ff, d).  A Mamba2 block keeps the reference's names:
``in_proj`` (d, 2 di + 2 N + H), ``out_proj`` (di, d), ``conv_w`` (K, di +
2 N), ``dt_bias`` / ``a_log`` / ``d_skip`` (H,).  An RWKV6 layer keeps the
reference's names too, its head axes flattened: ``wr`` / ``wk`` / ``wv`` /
``wg`` (d, H P), ``wo`` (H P, d), ``w_lora_a`` (d, R), ``w_lora_b`` (R, H
P), ``w_base`` / ``u_bonus`` (H, P), ``ln_x`` (P,) (an RMSNorm offset),
``ck`` (d, ff), ``cv`` (ff, d), ``cr`` (d, d), the token-shift lerps
``mu_r`` / ``mu_k`` / ``mu_v`` / ``mu_g`` / ``mu_w`` / ``mu_ck`` /
``mu_cr`` (d,).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

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


def _rotate(x, tables):
    """The split-halves rotation of x (B, S, H, D) by (cos, sin) tables, in f32."""
    cos, sin = tables
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) int."""
    return _rotate(x, rope_tables(positions, x.shape[-1], theta))


def mrope_tables(positions3, head_dim: int, theta: float,
                 sections) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE's (cos, sin), each (B, S, 1, D/2) f32, for positions3 (3, B, S)
    of the (t, h, w) components: frequency j turns with the component
    ``sections`` assigns it (the first sections[0] frequencies with t, the
    next sections[1] with h, the rest with w)."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not split the "
                         f"{head_dim // 2} frequencies of head_dim {head_dim}")
    freqs = rope_freqs(head_dim, theta, device=positions3.device)
    sel = torch.repeat_interleave(torch.arange(3, device=positions3.device),
                                  torch.as_tensor(sections, device=positions3.device))
    ang = positions3.float()[sel].permute(1, 2, 0) * freqs  # (B, S, D/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_mrope(x, positions3, theta: float, sections):
    """Multimodal RoPE (qwen2-vl): x (B, S, H, D) turned by positions3 (3, B, S)."""
    return _rotate(x, mrope_tables(positions3, x.shape[-1], theta, sections))


def rotary_tables(cfg: ModelConfig, positions):
    """The rotary tables of positions (B, S) -- or (3, B, S) for M-RoPE --
    under ``cfg``: M-RoPE's when ``mrope_sections`` is set ((B, S) positions
    taken as (t, t, t), as the reference broadcasts them), RoPE's when
    ``rope_theta > 0``, else None (no position signal: Whisper)."""
    if cfg.mrope_sections is not None:
        if positions.dim() == 2:
            positions = positions.expand(3, *positions.shape)
        return mrope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    if cfg.rope_theta > 0:
        return rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    return None


# ---------------------------------------------------------------------------
# Attention block (projections + rope + the kernels)
# ---------------------------------------------------------------------------


def layer_masks(cfg: ModelConfig, layer_is_local: bool):
    """(window, chunk) of a layer, as the reference picks them: Gemma2's
    local layers take the sliding window, Llama-4's the chunk and no window;
    global layers neither."""
    if not layer_is_local:
        return None, None
    if cfg.layer_pattern == "chunked_full":
        return None, cfg.chunk_size
    return cfg.sliding_window, None


def attention(
    cfg: ModelConfig,
    p,  # wqkv (d, (H+2KV) hd) [+ bqkv], wo (H hd, d)
    x,  # (B, S, d)
    *,
    layer_is_local: bool = False,
    kv_cache: Optional[dict] = None,  # {"k", "v": (B, S_max, KV, hd), "length": int}
    causal: bool = True,
    rope=None,  # rotary_tables(cfg, positions) shared by the layers of a forward
):
    """Returns (out (B, S, d), new_cache or None).  The positions are
    ``length .. length + S - 1`` (``rope`` given: the forward's own tables);
    the cache is updated in place (slice assignment at ``length``) and
    ``length`` stays a Python int."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window, chunk = layer_masks(cfg, layer_is_local)

    qkv = torch.matmul(x, p["wqkv"])
    if cfg.qkv_bias:
        qkv = qkv + p["bqkv"]
    q, k, v = torch.split(qkv, [H * hd, KV * hd, KV * hd], dim=-1)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)

    length = 0 if kv_cache is None else int(kv_cache["length"])
    if rope is None and (cfg.mrope_sections is not None or cfg.rope_theta > 0):
        positions = torch.arange(length, length + S, device=x.device)[None, :].expand(B, S)
        rope = rotary_tables(cfg, positions)
    if rope is not None:
        q, k = _rotate(q, rope), _rotate(k, rope)

    mask = dict(softcap=cfg.attn_softcap, window=window, chunk=chunk, device=x.device)
    if kv_cache is None:
        out = ops.flash_attention(q, k, v, causal=causal, **mask)
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
            out = ops.flash_attention(q, k, v, causal=causal, **mask)
        elif S == 1:
            lengths = kv_cache.get("lengths")
            if lengths is None:
                lengths = torch.full((B,), length + 1, dtype=torch.int32,
                                     device=x.device)
            out = ops.decode_attention(q[:, 0], kbuf, vbuf, lengths, **mask)[:, None]
        else:
            # an append: the new rows over the cache's prefix, in place
            end = length + S
            out = ops.flash_attention(q, kbuf[:, :end], vbuf[:, :end], causal=causal,
                                      **mask)
        new_cache = {"k": kbuf, "v": vbuf, "length": length + S}
    out = torch.matmul(out.reshape(B, S, H * hd), p["wo"])
    return out, new_cache


def cross_attention(cfg: ModelConfig, p, x, enc_out):
    """Whisper's decoder cross-attention: x (B, S, d) attends to all T rows
    of enc_out (B, T, d), no mask, no rope; K and V are projected from
    enc_out on every call (``x_wkv``), as the reference does.  S > 1 runs
    non-causal ``ops.flash_attention``; S = 1 runs ``ops.decode_attention``
    with lengths all T; both read K and V in place as views of the
    projection."""
    B, S, _ = x.shape
    T = enc_out.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["x_wq"]).reshape(B, S, H, hd)
    k, v = (t.reshape(B, T, KV, hd)
            for t in torch.chunk(torch.matmul(enc_out, p["x_wkv"]), 2, dim=-1))
    if S == 1:
        lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, 0], k, v, lengths, device=x.device)[:, None]
    else:
        out = ops.flash_attention(q, k, v, causal=False, device=x.device)
    return torch.matmul(out.reshape(B, S, H * hd), p["x_wo"])


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _gated(cfg: ModelConfig, h):
    """The activation of x [w1 | w3] (gated) or of x w1 (plain gelu)."""
    if cfg.act not in ("swiglu", "geglu"):
        return F.gelu(h, approximate="tanh")
    gate, up = torch.chunk(h, 2, dim=-1)
    return (F.silu(gate) if cfg.act == "swiglu" else F.gelu(gate, approximate="tanh")) * up


def mlp(cfg: ModelConfig, p, x):
    w1 = p["w13"] if cfg.act in ("swiglu", "geglu") else p["w1"]
    return torch.matmul(_gated(cfg, torch.matmul(x, w1)), p["w2"])


# ---------------------------------------------------------------------------
# Mixture of Experts -- grouped dispatch with capacity (GShard-style)
# ---------------------------------------------------------------------------


class MoERound(NamedTuple):
    """One of the top_k routing rounds, per (group, token): the chosen
    expert, its gate, the slot it takes in that expert's buffer, and
    whether the slot is within capacity (False: the token is dropped in
    this round)."""

    expert: torch.Tensor  # (G, g) int64
    gate: torch.Tensor  # (G, g) f32
    slot: torch.Tensor  # (G, g) int64
    kept: torch.Tensor  # (G, g) bool


def moe_capacity(cfg: ModelConfig, g: int) -> int:
    """Slots per expert and group: max(4, ceil(g k / E * capacity_factor))."""
    return int(max(4, math.ceil(g * cfg.top_k / cfg.n_experts * cfg.moe_capacity_factor)))


def moe_route(cfg: ModelConfig, router, xg) -> List[MoERound]:
    """The reference's routing for tokens xg (G, g, d): an f32 softmax
    router, then top_k argmax rounds, each masking the expert it chose;
    a token's slot in its expert is the count of earlier claims on that
    expert in its group -- tokens before it in this round plus every claim
    of the earlier rounds (the cumulative sum carried as ``base``) -- and
    slots past ``moe_capacity`` are dropped."""
    E = cfg.n_experts
    cap = moe_capacity(cfg, xg.shape[1])
    gates_left = torch.softmax(torch.matmul(xg, router).float(), dim=-1)  # (G, g, E)
    base = torch.zeros((xg.shape[0], 1, E), dtype=torch.float32, device=xg.device)
    rounds = []
    for _ in range(cfg.top_k):
        idx = torch.argmax(gates_left, dim=-1)  # the first of equal maxima, as jnp
        gate = torch.gather(gates_left, -1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, E).float()
        pos = torch.cumsum(onehot, dim=1) - 1.0 + base  # (G, g, E)
        slot = torch.gather(pos, -1, idx[..., None])[..., 0]
        rounds.append(MoERound(idx, gate, slot.long(), slot < cap))
        base = base + onehot.sum(dim=1, keepdim=True)
        gates_left = gates_left * (1.0 - onehot)
    return rounds


def moe_ffn(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (B, S, d): the reference's ``moe_ffn``.

    Tokens go in groups of ``moe_group_size`` (the last padded), are routed
    by ``moe_route`` and copied into their experts' buffers (E, G cap, d) by
    index -- equal to the reference's 0/1 dispatch einsum, without its (G,
    g, E, cap) tensors; a dropped token's copy lands in one spare row that
    is never read, so nothing waits on the host.  The experts run as two
    batched products over E; each token gathers its kept slots' outputs
    back, weighted by its gates (cast to x's dtype, as the reference's
    combine), summed in f32.  A shared expert adds ``mlp`` of x.
    """
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    g = min(cfg.moe_group_size, T)
    G = -(-T // g)
    xt = x.reshape(T, d)
    if G * g > T:
        xt = F.pad(xt, (0, 0, 0, G * g - T))
    xg = xt.reshape(G, g, d)
    rounds = moe_route(cfg, p["router"], xg)
    cap = moe_capacity(cfg, g)

    n = E * G * cap  # buffer rows; row n is the spare
    grp = torch.arange(G, device=x.device)[:, None]
    rows = [torch.where(r.kept, (r.expert * G + grp) * cap + r.slot, n) for r in rounds]
    xe = torch.zeros((n + 1, d), dtype=x.dtype, device=x.device)
    for r in rows:
        xe[r.reshape(-1)] = xg.reshape(-1, d)
    w1 = p["w13"] if cfg.act in ("swiglu", "geglu") else p["w1"]
    ye = torch.bmm(_gated(cfg, torch.bmm(xe[:n].view(E, G * cap, d), w1)), p["w2"])
    ye = ye.reshape(n, d)
    y = torch.zeros((G, g, d), dtype=torch.float32, device=x.device)
    for r, row in zip(rounds, rows):
        w = torch.where(r.kept, r.gate, 0.0).to(x.dtype).float()
        y = y + w[..., None] * ye[row.clamp(max=n - 1)].float()
    y = y.to(x.dtype).reshape(G * g, d)[:T].reshape(B, S, d)
    if cfg.n_shared_experts:
        w1 = "w13" if cfg.act in ("swiglu", "geglu") else "w1"
        y = y + mlp(cfg, {w1: p["s" + w1], "w2": p["sw2"]}, x)
    return y


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


# ---------------------------------------------------------------------------
# RWKV6 (Finch) -- time mix (the WKV6 recurrence) + channel mix
# ---------------------------------------------------------------------------


def _token_shift(x, shift_state):
    """(x_prev, new_shift): the previous token of each position (the first
    from ``shift_state`` (B, 1, d), zeros when None) and the last row."""
    if shift_state is None:
        shift_state = torch.zeros_like(x[:, :1])
    return torch.cat([shift_state, x[:, :-1]], dim=1), x[:, -1:]


def rwkv6_time_mix(cfg: ModelConfig, p, x, *, state=None, shift_state=None,
                   state_out=None):
    """x: (B, S, d) -> (y, new_state, new_shift), the reference's
    ``rwkv6_time_mix``.

    state: (B, H, P, P) float32 WKV state; shift_state: (B, 1, d), the last
    token of the previous segment.  The five lerps and the r / k / v / g
    projections run in x's dtype, the Finch decay w = exp(-exp(w_base +
    tanh(x_w w_lora_a) w_lora_b)) in float32; the recurrence is
    ``ops.wkv6_scan`` (written into ``state_out`` when given, e.g. the
    cache's slice, which may be ``state`` itself); then ``ln_x`` (an RMSNorm
    over each head's P channels, float32), the gate and ``wo``.
    """
    B, S, d = x.shape
    H, P = cfg.n_heads, cfg.head_dim
    x_prev, new_shift = _token_shift(x, shift_state)
    dx = x_prev - x

    def lerp(name):
        return x + p[f"mu_{name}"].to(x.dtype) * dx

    def proj(name, wname):
        return torch.matmul(lerp(name), p[wname].to(x.dtype)).reshape(B, S, H, P)

    r, k, v = proj("r", "wr"), proj("k", "wk"), proj("v", "wv")
    g = F.silu(torch.matmul(lerp("g"), p["wg"].to(x.dtype)))
    wx = torch.tanh(torch.matmul(lerp("w"), p["w_lora_a"].to(x.dtype)))
    w_log = p["w_base"].float() + torch.matmul(
        wx.float(), p["w_lora_b"].float()).reshape(B, S, H, P)
    w = torch.exp(-torch.exp(w_log))  # (B, S, H, P) in (0, 1), float32
    y, state = ops.wkv6_scan(r, k, v, w, p["u_bonus"].float(), state,
                             state_out=state_out, device=x.device)
    y = rms_norm(y, p["ln_x"].float()).to(x.dtype).reshape(B, S, H * P) * g
    return torch.matmul(y, p["wo"].to(x.dtype)), state, new_shift


def rwkv6_channel_mix(cfg: ModelConfig, p, x, *, shift_state=None):
    """x: (B, S, d) -> (y, new_shift): sigmoid(x_r cr) * (relu(x_k ck)^2 cv)."""
    x_prev, new_shift = _token_shift(x, shift_state)
    dx = x_prev - x
    xk = x + p["mu_ck"].to(x.dtype) * dx
    xr = x + p["mu_cr"].to(x.dtype) * dx
    kk = torch.square(F.relu(torch.matmul(xk, p["ck"].to(x.dtype))))
    kv = torch.matmul(kk, p["cv"].to(x.dtype))
    rr = torch.sigmoid(torch.matmul(xr, p["cr"].to(x.dtype)))
    return rr * kv, new_shift
