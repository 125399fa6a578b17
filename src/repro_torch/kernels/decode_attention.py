"""One-token GQA flash-decode: the CUDA kernel's wrapper and plain version.

The kernel is ``csrc/decode_attention.cu``; it replaces the Pallas kernel
``decode_attention`` of the JAX package.  It reads q and the caches in
place as (B, H, D) and (B, S, KV, D) through their strides -- no copy of
either -- and only the first ``lengths[b]`` rows of each cache, split
across blocks along the key axis (flash-decoding): ``_split_plan`` picks
the number of splits from the shapes and the card's SM count alone, and a
second kernel in the same source, launched from the same C entry point,
combines the splits' partials.  ``decode_attention_ref`` is the plain
PyTorch version, with the reference oracle's semantics exactly;
``decode_attention_split_ref`` repeats the kernel's split-and-combine
arithmetic in plain PyTorch, for the tests.

A tensor on the CPU runs the plain version; a CUDA tensor launches the
kernel (one call of the C entry point, on the current stream, counted in
``launches``) or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..device import refuse_grad
from ..device import sm_count as _sm_count
from . import _build
from .flash_attention import DTYPES, HEAD_DIMS, NEG_INF, aligned16

#: fewest keys a split takes (unless it is the only one): one step of the
#: kernel's 8 key groups x 6 keys at D = 128; and most splits (the combine
#: kernel holds a row's splits in registers)
MIN_CHUNK, MAX_SPLITS = 48, 16
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
             + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         softcap: Optional[float] = None):
    """Single-token GQA decode.  q: (B,H,D); caches: (B,S,KV,D); lengths: (B,)."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) / math.sqrt(D)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]  # (B, S)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def _split_plan(B: int, S: int, KV: int, n_sm: int) -> int:
    """Splits of the key axis for B * KV (batch row, kv head) blocks on a card
    with ``n_sm`` SMs: enough for about one block per SM, each split at least
    MIN_CHUNK keys, at most MAX_SPLITS.  It reads no lengths (they live on
    the card, and reading them would cost a sync per layer and step)."""
    return max(1, min(-(-n_sm // (B * KV)), S // MIN_CHUNK, MAX_SPLITS))


def split_bounds(S: int, n_split: int):
    """[start, end) of each split's keys, as the kernel computes them."""
    return [(i * S // n_split, (i + 1) * S // n_split) for i in range(n_split)]


def decode_attention_split_ref(q, k_cache, v_cache, lengths, n_split: int, *,
                               softcap: Optional[float] = None):
    """decode_attention_ref computed as the kernel computes it: per split a
    partial (m, l, acc) over its valid keys -- (-inf, 0, 0) when the split
    starts at or past the valid length -- then the combine
    sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30), w_i = exp(m_i - max m),
    empty splits skipped.  p is rounded to v's dtype before P.V."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    lengths = torch.as_tensor(lengths, device=q.device).long()
    none = lengths <= 0  # every key takes part, at the masked score
    n_keys = torch.where(none, torch.full_like(lengths, S), lengths.clamp(max=S))
    pos = torch.arange(S, device=q.device)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(D)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(none[:, None, None, None], torch.full_like(s, NEG_INF), s)
    parts = []
    for c0, c1 in split_bounds(S, n_split):
        keys = (pos >= c0) & (pos < c1) & (pos[None, :] < n_keys[:, None])  # (B, S)
        x = s.masked_fill(~keys[:, None, None, :], -math.inf)
        m = x.amax(-1)  # -inf for an empty split
        p = torch.exp(x - torch.where(torch.isinf(m), torch.zeros_like(m), m)[..., None])
        p = p.masked_fill(~keys[:, None, None, :], 0.0)
        acc = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                           v_cache.float())
        parts.append((m, p.sum(-1), acc))
    mb = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - mb))
        num = num + w[..., None] * acc
        den = den + w * l
    out = num / den.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def check_inputs(q, k_cache, v_cache, lengths) -> None:
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or lengths.dim() != 1:
        raise ValueError("q must be (B,H,D), caches (B,S,KV,D), lengths (B,)")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}; q, k and v must share float32 "
                            "or bfloat16")
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lengths must be an integer tensor, got {lengths.dtype}")
    B, H, D = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or lengths.shape[0] != B):
        raise ValueError(f"caches {tuple(k_cache.shape)} / lengths "
                         f"{tuple(lengths.shape)} vs q {tuple(q.shape)}")
    KV = k_cache.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} q heads are not a multiple of {KV} kv heads")
    if k_cache.shape[1] == 0:
        raise ValueError("decode over an empty cache")


def check_readable(q, k_cache, v_cache) -> None:
    """Raise unless the kernel can read q and the caches in place: last axis
    contiguous, base pointers and row strides 16-byte aligned (it loads 16
    bytes of a row at a time).  A copy here would move the whole cache on
    every step."""
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, stride "
                             f"{x.stride(-1)}")
        if not aligned16(x):
            raise ValueError(f"the kernel loads 16-byte chunks of rows: {name} needs "
                             "a 16-byte aligned base pointer and strides")


def _launch(q, k_cache, v_cache, lengths, softcap) -> torch.Tensor:
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernel's {HEAD_DIMS}")
    check_readable(q, k_cache, v_cache)
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    n_split = _split_plan(B, S, KV, _sm_count(q.device))
    # the splits' partials (m, l, acc) in f32
    part = (torch.empty(n_split * B * H * (D + 2), dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    fn = _build.function("decode_attention", "decode_attention_launch",
                         ctypes.c_int, _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        B, S, H, KV, D, n_split,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        int(softcap is not None), float(softcap or 0.0), DTYPES[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    return out


def decode_attention(q, k_cache, v_cache, lengths, *,
                     softcap: Optional[float] = None, block_k: int = 256):
    """Attention of one token per sequence (B, H, D) in q's dtype.

    ``block_k`` is the reference's tile size, kept for parity of the
    signature: neither version's result depends on it.
    """
    check_inputs(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, softcap=softcap)
    out = _launch(q, k_cache, v_cache, lengths, softcap)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
