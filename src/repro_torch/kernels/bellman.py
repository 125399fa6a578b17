"""Banded RVI Bellman backup: the CUDA kernel's wrappers and plain versions.

    G[t, a] = sum_k pmfs[a, k] * h_main[t + k] + tails[t, a] * h_overflow

(core.rvi.banded_backup's correlation core).  The kernel is
``csrc/bellman.cu`` -- it replaces the Pallas kernels ``bellman_banded`` /
``bellman_banded_batched`` of the JAX package; its header says how it is
laid out and what bounds it.  The lanes of a warp split the k range
``_split_plan`` ways (from the shapes and the card's SM count alone) and
reduce their partial sums in a fixed order; ``bellman_banded_split_ref``
repeats that partition and order in plain PyTorch, for the tests.

Both wrappers take f32 tensors.  A tensor on the CPU runs the plain
PyTorch version below; a CUDA tensor launches the kernel (one launch, on
the current stream, counted in the wrapper's ``launches``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import sm_count as _sm_count
from . import _build

#: the kernel takes at most this many specs (CUDA's grid.z limit)
MAX_SPECS = 65535
#: the kernel's tile (csrc/bellman.cu): consecutive base states and actions
#: a lane keeps, actions a block covers at once, the widest staged k chunk
#: (tests/test_torch_bellman.py holds these and the geometry below to the .cu)
RT, RA, A_TILE, KC = 5, 3, 66, 256
#: the splits the kernel takes: k slices per warp, 32 / split t-groups
SPLITS = (1, 2, 4, 8, 16, 32)
#: _split_plan's aims: warps in flight per SM, fewest k steps a slice takes
WARPS_PER_SM, MIN_SLICE = 8, 4
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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


def chunk_width(K: int) -> int:
    """Width of the k chunks the kernel stages (the last may be narrower)."""
    return max(1, min(K, KC))


def grid_warps(N: int, T: int, A: int, split: int) -> int:
    """Warps the kernel launches for N specs of (T, A) at ``split``."""
    t_tile = (32 // split) * RT
    return N * -(-T // t_tile) * -(-min(A, A_TILE) // RA)


def _split_plan(N: int, T: int, A: int, K: int, n_sm: int) -> int:
    """k slices per warp for N specs of (T, A, K) on a card with ``n_sm``
    SMs: the fewest that put WARPS_PER_SM warps on every SM, as long as a
    slice keeps at least MIN_SLICE k steps of the first chunk."""
    w = chunk_width(K)
    best = 1
    for split in SPLITS:
        if split > 1 and -(-w // split) < MIN_SLICE:
            break
        best = split
        if grid_warps(N, T, A, split) >= WARPS_PER_SM * n_sm:
            break
    return best


def split_slices(K: int, split: int):
    """Per k slice s, the [k0, k1) ranges it sums, chunk by chunk, as the
    kernel partitions them: slices of L = ceil(w / split) | 1 steps."""
    kc = chunk_width(K)
    out = [[] for _ in range(split)]
    for c0 in range(0, K, kc):
        w = min(kc, K - c0)
        L = -(-w // split) | 1
        for s in range(split):
            ks, ke = s * L, min(s * L + L, w)
            if ke > ks:
                out[s].append((c0 + ks, c0 + ke))
    return out


def bellman_banded_split_ref(h_main, pmfs, tails, h_overflow, split: int):
    """bellman_banded(_batched)_ref computed as the kernel computes it: one
    partial sum per k slice (split_slices, chunk after chunk), each k the
    kernel's fused multiply-add emulated: the exact product added in
    float64, that sum rounded to float64 and then to float32 -- twice,
    where fmaf rounds once, so the two can differ by an ulp where the
    first rounding lands on a float32 tie -- then the lanes' butterfly in
    float32 (at step m = 1, 2, 4, ... slice s adds slice s ^ m) and last
    the tail term, product and sum each rounded.  Scalar or batched
    shapes.  Slow (a step per k): for tests."""
    batched = tails.dim() == 3
    if not batched:
        h_main, pmfs, tails = h_main[None], pmfs[None], tails[None]
        h_overflow = h_overflow.reshape(1)
    N, T, A = tails.shape
    K = pmfs.shape[2]
    dev = h_main.device
    idx = torch.arange(T, device=dev)[:, None] + torch.arange(K, device=dev)[None, :]
    hwin = h_main[:, idx].double()  # (N, T, K)
    p64 = pmfs.double()
    parts = []
    for ranges in split_slices(K, split):
        acc = torch.zeros((N, T, A), dtype=torch.float32, device=dev)
        for k0, k1 in ranges:
            for k in range(k0, k1):
                acc = (acc.double() + hwin[:, :, k, None] * p64[:, None, :, k]).float()
        parts.append(acc)
    m = 1
    while m < split:
        parts = [parts[s] + parts[s ^ m] for s in range(split)]
        m <<= 1
    out = parts[0] + tails * h_overflow[:, None, None]
    return out if batched else out[0]


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
    split = _split_plan(N, T, A, K, _sm_count(h2.device))
    fn = _build.function("bellman", "bellman_banded_launch", ctypes.c_int, _ARGTYPES)
    stream = torch.cuda.current_stream(h2.device).cuda_stream
    rc = fn(
        h2.data_ptr(), p3.data_ptr(), t3.data_ptr(), hso1.data_ptr(),
        out.data_ptr(), N, T, A, K, h2.shape[1], split, stream,
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
