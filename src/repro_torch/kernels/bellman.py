"""Banded RVI Bellman backup: the CUDA kernel's wrappers and plain versions.

    G[t, a] = sum_k pmfs[a, k] * h_main[t + k] + tails[t, a] * h_overflow

(core.rvi.banded_backup's correlation core).  The kernel is
``csrc/bellman.cu`` -- it replaces the Pallas kernels ``bellman_banded`` /
``bellman_banded_batched`` of the JAX package; its header says how it is
laid out and what bounds it.

Both wrappers take f32 tensors.  A tensor on the CPU runs the plain
PyTorch version below; a CUDA tensor launches the kernel (one launch, on
the current stream, counted in the wrapper's ``launches``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: the kernel takes at most this many specs (CUDA's grid.z limit)
MAX_SPECS = 65535


def bellman_banded_ref(h_main, pmfs, tails, h_overflow):
    """Plain version: Hankel gather + matmul.

    h_main: (T + K - 1 or longer,) value function over states 0..s_max,
    zero past s_max; pmfs: (A, K) arrival pmfs; tails: (T, A) overflow
    mass towards S_o; h_overflow: scalar h(S_o).  Returns (T, A).
    """
    T = tails.shape[0]
    K = pmfs.shape[1]
    dev = h_main.device
    idx = torch.arange(T, device=dev)[:, None] + torch.arange(K, device=dev)[None, :]
    return h_main[idx] @ pmfs.T + tails * h_overflow


def bellman_banded_batched_ref(h_main, pmfs, tails, h_overflow):
    """Plain version of the spec-batched backup.

    h_main: (N, >= T + K - 1); pmfs: (N, A, K); tails: (N, T, A);
    h_overflow: (N,).  Returns (N, T, A).
    """
    T = tails.shape[1]
    K = pmfs.shape[2]
    dev = h_main.device
    idx = torch.arange(T, device=dev)[:, None] + torch.arange(K, device=dev)[None, :]
    hwin = h_main[:, idx]  # (N, T, K)
    return torch.bmm(hwin, pmfs.transpose(1, 2)) + tails * h_overflow[:, None, None]


def _check(h_main, pmfs, tails, h_overflow, batched: bool) -> None:
    ndim = (2, 3, 3, 1) if batched else (1, 2, 2, 0)
    for name, x, nd in zip(
        ("h_main", "pmfs", "tails", "h_overflow"),
        (h_main, pmfs, tails, h_overflow),
        ndim,
    ):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {tuple(x.shape)}")
        if x.device != h_main.device:
            raise ValueError(f"{name} on {x.device}, h_main on {h_main.device}")
    T, A = tails.shape[-2:]
    K = pmfs.shape[-1]
    if pmfs.shape[-2] != A:
        raise ValueError(f"pmfs {tuple(pmfs.shape)} vs tails {tuple(tails.shape)}")
    if h_main.shape[-1] < T + K - 1:
        raise ValueError(
            f"h_main needs >= T + K - 1 = {T + K - 1} entries, "
            f"got {h_main.shape[-1]}"
        )
    if batched:
        N = tails.shape[0]
        if not (h_main.shape[0] == pmfs.shape[0] == h_overflow.shape[0] == N):
            raise ValueError("batched inputs disagree on the spec axis")
        if N > MAX_SPECS:
            raise ValueError(f"at most {MAX_SPECS} specs per launch, got {N}")


def _launch(h2, p3, t3, hso1) -> torch.Tensor:
    """One kernel launch over (N, T, A); inputs already checked."""
    if h2.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {h2.device}")
    h2, p3, t3, hso1 = (x.contiguous() for x in (h2, p3, t3, hso1))
    N, T, A = t3.shape
    K = p3.shape[2]
    out = torch.empty((N, T, A), dtype=torch.float32, device=h2.device)
    fn = _build.load("bellman").bellman_banded_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(h2.device).cuda_stream
    rc = fn(
        h2.data_ptr(), p3.data_ptr(), t3.data_ptr(), hso1.data_ptr(),
        out.data_ptr(), N, T, A, K, h2.shape[1], stream,
    )
    if rc != 0:
        raise RuntimeError(f"bellman_banded launch failed: CUDA error {rc}")
    return out


def bellman_banded(h_main, pmfs, tails, h_overflow):
    """G (T, A) for one spec; see bellman_banded_ref for the shapes.

    ``h_overflow`` is a float32 0-d tensor on the inputs' device (kept on
    the device so the RVI loop never syncs to read it).
    """
    _check(h_main, pmfs, tails, h_overflow, batched=False)
    if h_main.device.type == "cpu":
        return bellman_banded_ref(h_main, pmfs, tails, h_overflow)
    out = _launch(h_main[None], pmfs[None], tails[None], h_overflow.reshape(1))
    bellman_banded.launches += 1
    return out[0]


def bellman_banded_batched(h_main, pmfs, tails, h_overflow):
    """G (N, T, A) for N specs in one launch (the spec axis is grid.z)."""
    _check(h_main, pmfs, tails, h_overflow, batched=True)
    if h_main.device.type == "cpu":
        return bellman_banded_batched_ref(h_main, pmfs, tails, h_overflow)
    out = _launch(h_main, pmfs, tails, h_overflow)
    bellman_banded_batched.launches += 1
    return out


bellman_banded.launches = 0
bellman_banded_batched.launches = 0
