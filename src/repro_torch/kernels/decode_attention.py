"""One-token GQA flash-decode: the CUDA kernel's wrapper and plain version.

The kernel is ``csrc/decode_attention.cu``; it replaces the Pallas kernel
``decode_attention`` of the JAX package.  It reads the caches in place as
(B, S, KV, D) through their strides -- no transposed or padded copy -- and
only the first ``lengths[b]`` rows of each.  ``decode_attention_ref`` is
the plain PyTorch version, with the reference oracle's semantics exactly.

A tensor on the CPU runs the plain version; a CUDA tensor launches the
kernel (one launch, on the current stream, counted in ``launches``) or
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .flash_attention import DTYPES, HEAD_DIMS, NEG_INF


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


def _launch(q, k_cache, v_cache, lengths, softcap) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernel's {HEAD_DIMS}")
    if k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        # a copy here would move the whole cache on every step
        raise ValueError("the caches' last axis must be contiguous")
    if q.stride(-1) != 1:
        q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    fn = _build.load("decode_attention").decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 8
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, S, H, KV, D,
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
