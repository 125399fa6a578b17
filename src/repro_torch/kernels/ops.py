"""Public entry points of the kernels (counterpart of repro.kernels.ops).

The Bellman entry points cast to the kernel's f32 and move the inputs to
``device`` exactly as the reference wrappers cast: ``h_overflow`` becomes a
float32 scalar, the arrays float32.  The attention entry points keep the
inputs' dtype (float32 or bfloat16) and move them to ``device``; so does
the SSD scan, whose dt / dA / state are float32.  On a CPU
device they run the plain PyTorch version; on a CUDA device they launch the
hand-written kernel or raise -- there is no fallback from one to the other.

Gradients.  On the CPU the plain versions are differentiable by autograd.
On a CUDA device, under grad mode, ``flash_attention`` sends a tensor that
requires grad through ``FlashAttentionFn``: the forward kernel with its
log-sum-exp saved, then the hand backward kernel
(``kernels/flash_attention_bwd.py``).  Every other kernel has no backward
and its wrapper raises on such a tensor, so no gradient is dropped in
silence.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from . import bellman as _bellman
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import flash_attention_bwd as _flash_bwd
from . import ssd_scan as _ssd


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def bellman_backup(h_main, pmfs, tails, h_overflow, *, device: DeviceLike = None):
    """Banded RVI backup G[t, a] (see kernels/bellman.py); (T, A) float32."""
    dev = resolve_device(device)
    return _bellman.bellman_banded(
        _f32(h_main, dev), _f32(pmfs, dev), _f32(tails, dev),
        _f32(h_overflow, dev),
    )


def bellman_backup_batched(h_main, pmfs, tails, h_overflow, *,
                           device: DeviceLike = None):
    """Spec-batched banded RVI backup G[n, t, a]; (N, T, A) float32."""
    dev = resolve_device(device)
    return _bellman.bellman_banded_batched(
        _f32(h_main, dev), _f32(pmfs, dev), _f32(tails, dev),
        _f32(h_overflow, dev),
    )


def _on(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=dev)


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel with a backward: the forward launch saves q, k, v,
    out and the rows' log-sum-exp; the backward launches the hand backward
    kernel on them.  (Under activation checkpointing the forward runs again
    before the backward, and the saved tensors are that run's.)"""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softcap: Optional[float]):
        out, lse = _flash.flash_attention(q, k, v, causal=causal, softcap=softcap,
                                          return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.softcap = causal, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:  # the kernel reads rows of dO in place
            dout = dout.contiguous()
        dq, dk, dv = _flash_bwd.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    causal=ctx.causal,
                                                    softcap=ctx.softcap)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    softcap: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, device: DeviceLike = None):
    """Blockwise GQA attention (see kernels/flash_attention.py).

    q (B, Sq, H, D), k / v (B, Sk, KV, D); returns (B, Sq, H, D) in q's dtype.
    On a CUDA device, under grad mode, inputs that require grad go through
    ``FlashAttentionFn`` (forward and backward kernels).
    """
    dev = resolve_device(device)
    q, k, v = _on(q, dev), _on(k, dev), _on(v, dev)
    if (dev.type == "cuda" and torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, v))):
        return FlashAttentionFn.apply(q, k, v, causal, softcap)
    return _flash.flash_attention(q, k, v, causal=causal, softcap=softcap,
                                  block_q=block_q, block_k=block_k)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     softcap: Optional[float] = None, block_k: int = 256,
                     device: DeviceLike = None):
    """One-token GQA flash-decode (see kernels/decode_attention.py).

    q (B, H, D), caches (B, S, KV, D) read in place, lengths (B,) valid
    prefix per sequence; returns (B, H, D) in q's dtype.
    """
    dev = resolve_device(device)
    return _decode.decode_attention(
        _on(q, dev), _on(k_cache, dev), _on(v_cache, dev),
        torch.as_tensor(lengths, dtype=torch.int32, device=dev),
        softcap=softcap, block_k=block_k,
    )


def ssd_scan(xs, Bm, Cm, dt, dA, state=None, *, chunk: int = 128,
             state_out: Optional[torch.Tensor] = None, device: DeviceLike = None):
    """Chunked SSD scan of a Mamba2 block (see kernels/ssd_scan.py).

    xs (B, S, H, P), Bm / Cm (B, S, N) in the activation dtype, dt / dA
    (B, S, H) float32, state (B, H, P, N) float32 or None; returns (y (B, S,
    H, P) float32 before the skip term, final state), the state written
    into ``state_out`` when one is given.
    """
    dev = resolve_device(device)
    return _ssd.ssd_scan(
        _on(xs, dev), _on(Bm, dev), _on(Cm, dev), _on(dt, dev), _on(dA, dev),
        None if state is None else _on(state, dev), chunk=chunk, state_out=state_out,
    )
