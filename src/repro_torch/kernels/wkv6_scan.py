"""The WKV6 recurrence of an RWKV6 (Finch) time-mix block: the CUDA
kernel's wrapper and plain version.

Per sequence b and head h, with a P x P float32 state S and per step t:

    kv[i, j] = k_t[i] v_t[j]
    y_t[j]   = sum_i r_t[i] (S[i, j] + u[h, i] kv[i, j])
    S[i, j] <- w_t[i] S[i, j] + kv[i, j]

This is the ``step`` of the reference's ``rwkv6_time_mix``
(src/repro/models/layers.py:599-627), a ``lax.scan`` (not a Pallas
kernel), which ``wkv6_scan_ref`` below repeats op for op in torch.  The
reference cuts long scans into segments of 64 (``_segmented_scan``, its
checkpointing device for training) and pads the last with decay 1 and
k = v = 0, which leaves the state and the kept outputs as they are; both
versions here walk the S steps directly.  The kernel is
``csrc/wkv6_scan.cu``; its header says how it is laid out and what bounds
it.  ``wkv6_scan_grouped`` repeats the kernel's arithmetic in its order
(row-group partial sums of r^T S, their sum, then the rank-1 bonus) in
plain torch, for the CPU tests; nothing on the main path calls it.

Inputs: ``r``, ``k``, ``v`` (B, S, H, P) in the activation dtype (float32
or bfloat16; upcast per step, as the reference does), ``w`` (B, S, H, P)
float32 (the reference keeps the decay in f32: bf16 cannot hold 1 - w
for slow-decay channels), ``u`` (H, P) float32, the incoming ``state``
(B, H, P, P) float32 (None: zeros).  The output ``y`` is float32 (B, S, H,
P), before ``ln_x``, and the final state; ``state_out`` receives it and
may be ``state`` itself (a cache updated in place).  Tensors on the CPU
run the plain version; CUDA tensors launch the kernel on the current
stream (counted in ``launches``) or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..device import refuse_grad
from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes the kernel is built for (csrc/wkv6_scan.cu's instances)
HEAD_DIMS = (16, 32, 64)
#: row groups the kernel's instance for each head size cuts the P rows into:
#: Layout<P>::G = P / Shape<P>::R in csrc/wkv6_scan.cu, kept in step by hand
ROW_GROUPS = {16: 4, 32: 4, 64: 8}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def check_inputs(r, k, v, w, u, state) -> None:
    """Shapes, dtypes and devices both versions take."""
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, P), got {tuple(r.shape)}")
    B, S, H, P = r.shape
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k and v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != r.shape:
            raise ValueError(f"{name} {tuple(x.shape)} vs r {tuple(r.shape)}")
    if w.dtype != torch.float32 or w.shape != r.shape:
        raise ValueError(f"w must be float32 {(B, S, H, P)}, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if u.dtype != torch.float32 or tuple(u.shape) != (H, P):
        raise ValueError(f"u must be float32 {(H, P)}, got {u.dtype} {tuple(u.shape)}")
    if state is not None and (state.dtype != torch.float32 or state.device != r.device
                              or tuple(state.shape) != (B, H, P, P)):
        raise ValueError(f"state must be float32 {(B, H, P, P)} on {r.device}, got "
                         f"{state.dtype} {tuple(state.shape)} on {state.device}")
    if min(B, S, H, P) < 1:
        raise ValueError(f"empty scan: r {tuple(r.shape)}")


def wkv6_scan_ref(r, k, v, w, u, state=None, *,
                  state_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the reference's ``step``, a loop over the S steps.
    Returns (y (B, S, H, P) f32, final state (B, H, P, P) f32); with
    ``state_out`` the final state is copied into it and it is returned."""
    check_inputs(r, k, v, w, u, state)
    B, S, H, P = r.shape
    s = (torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
         if state is None else state)
    ub = u[None, :, :, None]
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t].float(), k[:, t].float(), v[:, t].float(), w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]  # (B, H, P, P) outer k^T v
        ys.append(torch.einsum("bhp,bhpq->bhq", rt, s + ub * kv))
        s = wt[..., :, None] * s + kv
    y = torch.stack(ys, dim=1)
    if state_out is not None:
        state_out.copy_(s)
        s = state_out
    return y, s


def wkv6_scan_grouped(r, k, v, w, u, state=None, *, groups: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of the arithmetic: per step, the partial sums of
    r^T S over each of ``groups`` row groups (``ROW_GROUPS[P]`` by
    default), added in group order, then the hoisted rank-1 bonus a_t v_t
    with a_t = sum_i r_t[i] u[i] k_t[i]; then S <- w S + k v^T.  It follows
    the kernel's row groups and its bonus, not its order of sums within a
    group (einsum's here, one FMA a row there) nor its tree for a_t, so it
    checks the decomposition, not the kernel's rounding.  Returns (y
    (B, S, H, P) f32, final state (B, H, P, P) f32)."""
    check_inputs(r, k, v, w, u, state)
    B, S, H, P = r.shape
    G = ROW_GROUPS.get(P, 1) if groups is None else groups
    if G < 1 or P % G:
        raise ValueError(f"{G} row groups do not divide P = {P}")
    s = (torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
         if state is None else state)
    rf, kf, vf = r.float(), k.float(), v.float()
    a = (rf * u * kf).sum(-1)  # (B, S, H): the bonus's weight a step
    ys = []
    for t in range(S):
        parts = torch.einsum("bhgr,bhgrq->bhgq", rf[:, t].reshape(B, H, G, P // G),
                             s.reshape(B, H, G, P // G, P))
        yt = parts[:, :, 0]
        for gi in range(1, G):
            yt = yt + parts[:, :, gi]
        ys.append(yt + a[:, t, :, None] * vf[:, t])
        s = w[:, t, :, :, None] * s + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    return torch.stack(ys, dim=1), s


def _launch(r, k, v, w, u, state, state_out):
    refuse_grad("wkv6_scan", r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {r.device}")
    B, S, H, P = r.shape
    if P not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head sizes {HEAD_DIMS}, got {P}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("state", state)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("state", state),
                    ("state_out", state_out)):
        if x is not None and x.data_ptr() % 16:  # the kernel's vector loads and stores
            raise ValueError(f"{name} must be 16-byte aligned")
    if state_out is None:
        state_out = torch.empty((B, H, P, P), dtype=torch.float32, device=r.device)
    elif (state_out.dtype != torch.float32 or tuple(state_out.shape) != (B, H, P, P)
          or state_out.device != r.device or not state_out.is_contiguous()):
        raise ValueError(f"state_out must be a contiguous float32 {(B, H, P, P)} tensor "
                         f"on {r.device}")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=r.device)
    fn = _build.function("wkv6_scan", "wkv6_scan_launch", ctypes.c_int, _ARGTYPES)
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), y.data_ptr(),
            state_out.data_ptr(), B, S, H, P, DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_scan launch failed: CUDA error {rc}")
    return y, state_out


def wkv6_scan(r, k, v, w, u, state=None, *,
              state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P) f32, final state (B, H, P, P) f32); see wkv6_scan_ref.

    ``state_out`` receives the final state and may be ``state`` itself (the
    cache updated in place); without it a new tensor is returned.
    """
    check_inputs(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, w, u, state, state_out=state_out)
    out = _launch(r, k, v, w, u, state, state_out)
    wkv6_scan.launches += 1
    return out


wkv6_scan.launches = 0
