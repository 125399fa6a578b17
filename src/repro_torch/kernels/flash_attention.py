"""Blockwise GQA attention forward: the CUDA kernels' wrapper and plain version.

The kernels are in ``csrc/flash_attention.cu``; they replace the Pallas
kernel ``flash_attention`` of the JAX package, and its header says how they
are laid out and what bounds them: bf16 inputs run on the tensor cores
(``wgmma``), f32 inputs on the CUDA cores (the tensor cores would round f32
to TF32).  ``attention_ref`` below is the plain PyTorch version, with the
reference oracle's semantics exactly (``-1e30`` masking, f32 softmax).

Masks.  Query row i sits at the absolute position ``q_pos = i + Sk - Sq``
(bottom-right alignment: the last query row is the last key).  Key k is
visible to it when ``k <= q_pos`` (``causal``), ``q_pos - k < window``
(a sliding window; Gemma2's local layers) and ``q_pos // chunk == k //
chunk`` (chunked-local attention; Llama-4's local layers), floor division,
as the reference's blockwise attention (``repro.models.layers``) masks.
``window`` / ``chunk`` of None mean no such mask.  An append of S rows to
a cache of ``length`` rows is attention over the cache's prefix view
``kbuf[:, :length + S]``: the alignment then puts row i at ``length + i``.

A tensor on the CPU runs the plain version; a CUDA tensor launches the
kernel (one launch, on the current stream, counted in ``launches``) or
raises.  The kernels read q, k and v in place through their strides; the
wrapper copies none of them.  ``return_lse=True`` also returns each row's
log-sum-exp (B, H, Sq) f32 (``lse_ref`` is its plain version), which the
backward kernel (``flash_attention_bwd``) reads.  The wrapper itself has
no backward: under grad mode a CUDA tensor that requires grad is refused
here, and ``ops.flash_attention`` routes it through the autograd
``Function`` (``ops.FlashAttentionFn``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..device import refuse_grad
from . import _build

NEG_INF = -1e30
#: head sizes the kernel is instantiated for
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p])


def check_mask(window: Optional[int], chunk: Optional[int]) -> None:
    """A window or a chunk is a positive int, or None for none."""
    for name, x in (("window", window), ("chunk", chunk)):
        if x is not None and (isinstance(x, bool) or int(x) != x or x < 1):
            raise ValueError(f"{name} must be a positive int or None, got {x!r}")


def visible(q_pos, k_pos, *, causal: bool, window: Optional[int] = None,
            chunk: Optional[int] = None):
    """The (len(q_pos), len(k_pos)) boolean mask of the keys each query
    position sees (see the module doc)."""
    q, k = q_pos[:, None], k_pos[None, :]
    mask = torch.ones((q.shape[0], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k <= q
    if window is not None:
        mask &= q - k < window
    if chunk is not None:
        mask &= torch.div(q, chunk, rounding_mode="floor") == torch.div(
            k, chunk, rounding_mode="floor")
    return mask


def _scores(q, k, causal, softcap, kv_len=None, window=None, chunk=None):
    """Scaled, capped and masked scores (B, KV, G, Sq, Sk) in f32."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / math.sqrt(D)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(Sk, device=q.device)
    mask = visible(torch.arange(Sq, device=q.device) + (Sk - Sq), k_pos, causal=causal,
                   window=window, chunk=chunk)
    if kv_len is not None:
        mask &= k_pos[None, :] < kv_len
    return s.masked_fill(~mask, NEG_INF)


def lse_ref(q, k, *, causal: bool = True, softcap: Optional[float] = None,
            window: Optional[int] = None, chunk: Optional[int] = None):
    """Each row's log-sum-exp of the masked scores, (B, H, Sq) f32."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal, softcap, window=window, chunk=chunk)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def attention_ref(q, k, v, *, causal: bool = True,
                  softcap: Optional[float] = None, kv_len=None,
                  window: Optional[int] = None, chunk: Optional[int] = None):
    """Naive masked softmax attention.  q: (B,Sq,H,D), k/v: (B,Sk,KV,D)."""
    B, Sq, H, D = q.shape
    p = torch.softmax(_scores(q, k, causal, softcap, kv_len, window, chunk), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def check_inputs(q, k, v) -> None:
    """Shapes, dtypes and devices the kernel (and the plain version) take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(x.shape)}")
        if x.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, "
                             f"q is {q.dtype} on {q.device}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} vs q {tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"{H} q heads are not a multiple of {k.shape[2]} kv heads")
    if k.shape[1] == 0:
        raise ValueError("attention over an empty key sequence")


def aligned16(x: torch.Tensor) -> bool:
    """Base pointer and the stride of every axis but the last (where that
    axis has more than one entry) 16-byte aligned: what 16-byte copies of
    whole rows need."""
    step = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        st % step == 0 for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n > 1)


def check_readable(q, k, v) -> None:
    """Raise unless the kernel for q's dtype can read q, k and v in place:
    the last axis contiguous, and for bf16 (16-byte copies of rows) every
    base pointer and row stride 16-byte aligned."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, stride "
                             f"{x.stride(-1)}")
    if q.dtype == torch.bfloat16 and not all(aligned16(x) for x in (q, k, v)):
        raise ValueError("the bf16 kernel copies 16-byte chunks of rows: q, k and v "
                         "need 16-byte aligned base pointers and strides")


def _launch(q, k, v, causal: bool, softcap: Optional[float], want_lse: bool,
            window: Optional[int] = None, chunk: Optional[int] = None):
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernel's {HEAD_DIMS}")
    check_readable(q, k, v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if want_lse else None
    fn = _build.function("flash_attention", "flash_attention_launch",
                         ctypes.c_int, _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window or 0), int(chunk or 0), int(softcap is not None),
        float(softcap or 0.0), DTYPES[q.dtype], None if lse is None else lse.data_ptr(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    softcap: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, return_lse: bool = False,
                    window: Optional[int] = None, chunk: Optional[int] = None):
    """Attention (B, Sq, H, D) in q's dtype; see attention_ref.  With
    ``return_lse``, (out, lse (B, H, Sq) f32).  ``window`` / ``chunk``: the
    masks of the module doc (None for none).

    ``block_q`` / ``block_k`` are the reference's tile sizes, kept for
    parity of the signature: neither version's result depends on them.
    """
    check_inputs(q, k, v)
    check_mask(window, chunk)
    mask = dict(causal=causal, softcap=softcap, window=window, chunk=chunk)
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, **mask)
        if return_lse:
            return out, lse_ref(q, k, **mask)
        return out
    refuse_grad("flash_attention (use ops.flash_attention, which has a backward)",
                q, k, v)
    out, lse = _launch(q, k, v, causal, softcap, return_lse, window, chunk)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
