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
from .flash_attention import DTYPES, HEAD_DIMS, attention_ref, check_inputs

#: the kernels one call launches, in order
KERNELS = ("dot", "dkdv", "dq")
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_bwd_ref(q, k, v, dout, *, causal: bool = True,
                            softcap: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref`` for the output gradient ``dout``,
    by autograd (f32 inside; the gradients in the inputs' dtype)."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = attention_ref(qq, kk, vv, causal=causal, softcap=softcap)
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


def _launch(q, k, v, out, lse, dout, causal: bool, softcap: Optional[float]):
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
        int(causal), int(softcap is not None), float(softcap or 0.0), DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {rc}")
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        softcap: Optional[float] = None):
    """(dq, dk, dv) of the attention forward for ``dout``; ``out`` and ``lse``
    are the forward kernel's (``flash_attention(..., return_lse=True)``)."""
    check_inputs(q, k, v)
    _check_saved(q, out, lse, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")
    grads = _launch(q, k, v, out, lse, dout, causal, softcap)
    flash_attention_bwd.launches += 1
    for name in KERNELS:
        counts = flash_attention_bwd.instance_launches
        counts[name] = counts.get(name, 0) + 1
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.instance_launches = {}
