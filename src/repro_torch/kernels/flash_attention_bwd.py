"""Blockwise GQA attention backward: the CUDA kernels' wrapper and plain version.

The kernels are in ``csrc/flash_attention_bwd.cu``: the gradient of the
forward kernel's function (``flash_attention.py``), FlashAttention-2's
backward -- a short first pass for D = rowsum(dO * O), one kernel for dK
and dV per (b, kv head, key tile), one for dQ per (b, head, query tile) --
with no atomics, so the gradient is the same from run to run.  bf16 runs
on the tensor cores (``wgmma``; P and dS rounded to bf16 before their
products, as the forward rounds P), f32 in IEEE f32 on the CUDA cores.
They replace no TPU kernel: the JAX package trains through its differentiable jnp attention
and its Pallas kernel has no backward.

Masks.  The forward's: causal, ``window`` and ``chunk`` (None for none),
query row i at position ``i + Sk - Sq`` (``flash_attention.visible``).  A
row's visible keys are one span [lo, hi) that never moves back as the
row moves on, so the kernels walk only the tiles a mask leaves: a dK / dV
block the query tiles with a row that sees one of its keys (plus those
of rows that see no key, which average every key), a dQ block the key
tiles of its rows' spans.  ``spans``, ``seen_by``, ``query_tiles``,
``key_tiles`` and ``tile_open`` mirror that arithmetic of the ``.cu`` in
Python; the CPU tests hold them to the mask.

``flash_attention_bwd_ref`` is the plain version: ``torch.autograd.grad``
through ``attention_ref``.  A tensor on the CPU runs it; a CUDA tensor
launches the kernels (one call, three launches on the current stream,
counted once in ``launches`` and per kernel in ``instance_launches``) or
raises.  q, k, v and dO are read in place through their strides (last axis
contiguous); on the card ``out`` (the forward's output) and ``lse`` (its
log-sum-exp, (B, H, Sq) f32) must be contiguous.  dq, dk and dv come back
contiguous in q's dtype.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention import DTYPES, HEAD_DIMS, attention_ref, check_inputs, check_mask

#: the kernels one call launches, in order
KERNELS = ("dot", "dkdv", "dq")
#: rows of a bf16 tile and of an f32 query tile; keys of an f32 dK / dV
#: block and of an f32 dQ step (the .cu's TILE and F_KT)
TILE, F_KT = 64, 32
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def spans(p: int, Sk: int, causal: bool, window: Optional[int] = None,
          chunk: Optional[int] = None) -> Tuple[int, int]:
    """The keys [lo, hi) a query at absolute position p sees (the .cu's
    span_lo / span_hi); empty (hi <= lo) for a row that sees no key."""
    lo, hi = 0, Sk
    if window is not None:
        lo = max(lo, p - window + 1)
    if chunk is not None:
        lo = max(lo, p // chunk * chunk)
        hi = min(hi, (p // chunk + 1) * chunk)
    if causal:
        hi = min(hi, p + 1)
    return min(lo, Sk), max(hi, 0)


def seen_by(k: int, causal: bool, window: Optional[int] = None,
            chunk: Optional[int] = None) -> Tuple[int, int]:
    """The positions [first, last] of the rows that see key k (the .cu's
    SeenBy, clamped to +-2^30); a row that sees no key is never among them."""
    first, last = -(1 << 30), 1 << 30
    if causal:
        first = k
    if chunk is not None:
        first = max(first, k // chunk * chunk)
        last = k // chunk * chunk + chunk - 1
    if window is not None:
        last = min(last, k + window - 1)
    return first, min(last, 1 << 30)


def query_tiles(k0: int, nk: int, Sq: int, Sk: int, causal: bool,
                window: Optional[int] = None, chunk: Optional[int] = None) -> list:
    """The query tiles (of TILE rows) a dK / dV block of keys [k0, k0 + nk)
    walks, in order (the .cu's QTiles): the blind rows' tiles, then those
    from the first row that sees k0 to the last that sees the last key."""
    nq = -(-Sq // TILE)
    off = Sk - Sq
    nblind = min(nq, -(off // TILE)) if (causal or chunk is not None) and off < 0 else 0
    r_lo = max(seen_by(k0, causal, window, chunk)[0] - off, 0)
    r_hi = min(seen_by(min(k0 + nk, Sk) - 1, causal, window, chunk)[1] - off, Sq - 1)
    lo, hi = (r_lo // TILE, r_hi // TILE + 1) if r_lo <= r_hi else (0, 0)
    return list(range(nblind)) + list(range(max(lo, nblind), hi))


def key_tiles(q0: int, q_last: int, Sq: int, Sk: int, causal: bool,
              window: Optional[int] = None, chunk: Optional[int] = None,
              tile: int = TILE) -> Tuple[int, int]:
    """The key tiles [begin, end) a dQ block of query rows [q0, q_last]
    walks (the .cu's KTiles)."""
    off = Sk - Sq
    k_lo = spans(max(q0 + off, 0), Sk, causal, window, chunk)[0]
    k_hi = spans(q_last + off, Sk, causal, window, chunk)[1]
    begin = k_lo // tile
    return begin, (-(-k_hi // tile) if k_hi > k_lo else begin)


def tile_open(q0: int, nr: int, k0: int, nk: int, Sq: int, Sk: int, causal: bool,
              window: Optional[int] = None, chunk: Optional[int] = None) -> bool:
    """Whether every pair of rows [q0, q0 + nr) and keys [k0, k0 + nk) is
    visible (the .cu's tile_open: such a step skips the per-pair tests)."""
    off = Sk - Sq
    return (q0 + nr <= Sq and k0 + nk <= Sk
            and k0 >= spans(q0 + nr - 1 + off, Sk, causal, window, chunk)[0]
            and k0 + nk <= spans(q0 + off, Sk, causal, window, chunk)[1])


def flash_attention_bwd_ref(q, k, v, dout, *, causal: bool = True,
                            softcap: Optional[float] = None, window: Optional[int] = None,
                            chunk: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref`` for the output gradient ``dout``,
    by autograd (f32 inside; the gradients in the inputs' dtype)."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = attention_ref(qq, kk, vv, causal=causal, softcap=softcap, window=window,
                            chunk=chunk)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def _check_saved(q, out, lse, dout) -> None:
    B, Sq, H, D = q.shape
    if tuple(dout.shape) != (B, Sq, H, D) or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} vs q "
                         f"{tuple(q.shape)} {q.dtype}")
    if tuple(out.shape) != (B, Sq, H, D) or out.dtype != q.dtype:
        raise ValueError("out must be the forward's (B, Sq, H, D) output")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("lse must be the forward's (B, H, Sq) float32 log-sum-exp")
    for name, x in (("out", out), ("lse", lse), ("dout", dout)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")


def _launch(q, k, v, out, lse, dout, causal: bool, softcap: Optional[float],
            window: Optional[int], chunk: Optional[int]):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernel's {HEAD_DIMS}")
    if not (out.is_contiguous() and lse.is_contiguous()):
        raise ValueError("the kernels read out and lse contiguous")
    for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, stride "
                             f"{x.stride(-1)}")
    dev = q.device
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Sk, KV, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Sk, KV, D), dtype=q.dtype, device=dev)
    dvec = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                         ctypes.c_int, _ARGTYPES)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Sk, H, KV, D,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        dout.stride(0), dout.stride(1), dout.stride(2),
        int(causal), int(window or 0), int(chunk or 0), int(softcap is not None),
        float(softcap or 0.0), DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {rc}")
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        softcap: Optional[float] = None, window: Optional[int] = None,
                        chunk: Optional[int] = None):
    """(dq, dk, dv) of the attention forward for ``dout``; ``out`` and ``lse``
    are the forward kernel's (``flash_attention(..., return_lse=True)``)
    under the same masks."""
    check_inputs(q, k, v)
    check_mask(window, chunk)
    _check_saved(q, out, lse, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal, softcap=softcap,
                                       window=window, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")
    grads = _launch(q, k, v, out, lse, dout, causal, softcap, window, chunk)
    flash_attention_bwd.launches += 1
    for name in KERNELS:
        counts = flash_attention_bwd.instance_launches
        counts[name] = counts.get(name, 0) + 1
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.instance_launches = {}
