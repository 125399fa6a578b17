"""The chunked SSD scan of a Mamba2 block: the CUDA kernel's wrapper and
plain version.

Per sequence and SSM head, the steps are cut into chunks of L (the last
padded with dt = dA = 0, which leaves the state as it is) and each chunk
does, with cum = cumsum(dA) over the chunk:

    y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
          + exp(cum_i) C_i . state
    state = state exp(cum_L) + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T

This is the ``chunk_body`` scan of the reference's ``mamba2_block``
(src/repro/models/layers.py:484-527), which ``ssd_scan_ref`` below repeats
op for op in torch.  The kernel is ``csrc/ssd_scan.cu``, the device
counterpart of that ``lax.scan`` (not of a Pallas kernel); its header says
how it is laid out and what bounds it.

Inputs: ``xs`` (B, S, H, P) and ``Bm`` / ``Cm`` (B, S, N) in the
activation dtype (float32 or bfloat16), ``dt`` and ``dA`` (B, S, H)
float32, the incoming ``state`` (B, H, P, N) float32 (None: zeros).  The
output is float32 (B, S, H, P), before the ``d_skip`` term, and the final
state.  Tensors on the CPU run the plain version; CUDA tensors launch the
kernel (one launch, on the current stream, counted in ``launches``) or
raise.  The kernel reads xs, Bm and Cm in place through their batch and
step strides, as views of the block's fused projection.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory a block may take on an H100 (227 KB)
MAX_SMEM = 232_448
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
             + ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 2
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk length: ``chunk`` if S >= chunk else S."""
    return chunk if S >= chunk else S


def smem_bytes(P: int, N: int, L: int) -> int:
    """Shared memory of one kernel block (csrc/ssd_scan.cu's layout)."""
    return 4 * (L * P + 2 * L * (N + 1) + 3 * L + L * L + P * (N + 1))


def check_inputs(xs, Bm, Cm, dt, dA, state, chunk: int) -> None:
    """Shapes, dtypes and devices both versions take."""
    for name, x in (("xs", xs), ("Bm", Bm), ("Cm", Cm), ("dt", dt), ("dA", dA)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.device != xs.device:
            raise ValueError(f"{name} is on {x.device}, xs on {xs.device}")
    if xs.dim() != 4:
        raise ValueError(f"xs must be (B, S, H, P), got {tuple(xs.shape)}")
    B, S, H, P = xs.shape
    if xs.dtype not in DTYPES or Bm.dtype != xs.dtype or Cm.dtype != xs.dtype:
        raise TypeError(f"xs, Bm and Cm must share float32 or bfloat16, got "
                        f"{xs.dtype}, {Bm.dtype}, {Cm.dtype}")
    if Bm.dim() != 3 or Bm.shape != Cm.shape or Bm.shape[:2] != (B, S):
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} vs xs "
                         f"{tuple(xs.shape)}")
    for name, x in (("dt", dt), ("dA", dA)):
        if x.dtype != torch.float32 or tuple(x.shape) != (B, S, H):
            raise ValueError(f"{name} must be float32 {(B, S, H)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    N = Bm.shape[2]
    if state is not None and (state.dtype != torch.float32 or state.device != xs.device
                              or tuple(state.shape) != (B, H, P, N)):
        raise ValueError(f"state must be float32 {(B, H, P, N)} on {xs.device}, got "
                         f"{state.dtype} {tuple(state.shape)} on {state.device}")
    if S < 1 or chunk < 1 or min(B, H, P, N) < 1:
        raise ValueError(f"empty scan: xs {tuple(xs.shape)}, N {N}, chunk {chunk}")


def ssd_scan_ref(xs, Bm, Cm, dt, dA, state=None, *, chunk: int = 128,
                 state_out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the reference's padded chunk loop in torch ops.
    Returns (y (B, S, H, P) f32, final state (B, H, P, N) f32); with
    ``state_out`` the final state is copied into it and it is returned."""
    check_inputs(xs, Bm, Cm, dt, dA, state, chunk)
    B, S, H, P = xs.shape
    N = Bm.shape[2]
    if state is None:
        state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xs.device)
    L = chunk_len(S, chunk)
    n_ch = (S + L - 1) // L
    pad = n_ch * L - S
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        dA, dt = F.pad(dA, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    above = ~torch.tril(torch.ones((L, L), dtype=torch.bool, device=xs.device))
    ys = []
    for c in range(n_ch):
        sl = slice(c * L, (c + 1) * L)
        xc, bc, cc = xs[:, sl].float(), Bm[:, sl].float(), Cm[:, sl].float()
        dac, dtc = dA[:, sl], dt[:, sl]
        cum = torch.cumsum(dac, dim=1)  # (B, L, H)
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        dec = cum[:, :, None, :] - cum[:, None, :, :]  # (B, L, L, H)
        dec = dec.masked_fill(above[None, :, :, None], float("-inf"))
        att = cb[..., None] * torch.exp(dec)
        att = att * dtc[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", att, xc)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", cc, state, torch.exp(cum))
        tot = cum[:, -1, :]  # (B, H)
        w_j = torch.exp(tot[:, None, :] - cum) * dtc
        state = state * torch.exp(tot)[:, :, None, None] + torch.einsum(
            "blh,blhp,bln->bhpn", w_j, xc, bc)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :S]
    if state_out is not None:
        state_out.copy_(state)
        state = state_out
    return y, state


def _readable(xs, Bm, Cm) -> None:
    """Raise unless the kernel can read the inputs in place: xs's (H, P)
    and Bm's / Cm's N axis contiguous (batch and step strides are free)."""
    H, P = xs.shape[2], xs.shape[3]
    if xs.stride(3) != 1 or (H > 1 and xs.stride(2) != P):
        raise ValueError(f"xs's head and channel axes must be contiguous, strides "
                         f"{xs.stride()}")
    for name, x in (("Bm", Bm), ("Cm", Cm)):
        if x.stride(2) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, stride {x.stride(2)}")


def _launch(xs, Bm, Cm, dt, dA, state, chunk, state_out):
    if xs.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {xs.device}")
    B, S, H, P = xs.shape
    N = Bm.shape[2]
    L = chunk_len(S, chunk)
    smem = smem_bytes(P, N, L)
    if smem > MAX_SMEM:
        raise ValueError(f"a block of chunk {L}, P {P}, N {N} needs {smem} bytes of "
                         f"shared memory, over {MAX_SMEM}")
    _readable(xs, Bm, Cm)
    for name, x in (("dt", dt), ("dA", dA)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state is None:
        state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xs.device)
    elif not state.is_contiguous():
        raise ValueError("state must be contiguous")
    if state_out is None:
        state_out = torch.empty_like(state)
    elif (state_out.dtype != torch.float32 or state_out.shape != state.shape
          or state_out.device != xs.device or not state_out.is_contiguous()):
        raise ValueError("state_out must be a contiguous float32 tensor shaped as state")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=xs.device)
    fn = _build.function("ssd_scan", "ssd_scan_launch", ctypes.c_int, _ARGTYPES)
    rc = fn(xs.data_ptr(), xs.stride(0), xs.stride(1),
            Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
            Cm.data_ptr(), Cm.stride(0), Cm.stride(1),
            dt.data_ptr(), dA.data_ptr(), state.data_ptr(), y.data_ptr(),
            state_out.data_ptr(), B, S, H, P, N, L, DTYPES[xs.dtype],
            torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    return y, state_out


def ssd_scan(xs, Bm, Cm, dt, dA, state=None, *, chunk: int = 128,
             state_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P) f32, final state (B, H, P, N) f32); see ssd_scan_ref.

    ``state_out`` receives the final state and may be ``state`` itself (the
    cache updated in place); without it a new tensor is returned.
    """
    check_inputs(xs, Bm, Cm, dt, dA, state, chunk)
    if xs.device.type == "cpu":
        return ssd_scan_ref(xs, Bm, Cm, dt, dA, state, chunk=chunk, state_out=state_out)
    out = _launch(xs, Bm, Cm, dt, dA, state, chunk, state_out)
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0
