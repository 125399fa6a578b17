"""Relative value iteration (Algorithm 1), scalar path, in PyTorch.

The discrete-time backup is

    J_{i+1}(s) = min_{a in A_s} { c~(s,a) + sum_j m~(j|s,a) H_i(j) }      (29)
    H_{i+1}(s) = J_{i+1}(s) - J_{i+1}(s*)

with span-based stopping.  Backup implementations (``backup=``):

  * dense  — contraction against the (S, A, S) transition tensor;
  * banded — exploits the transition structure m(j|s,a) = p^{[a]}_{j-s+a}:
             per action the backup is a windowed correlation of H with the
             arrival pmf, an O(A*S*K) computation instead of O(A*S^2);
             plain float64 tensor ops, the oracle of the kernel path;
  * pallas — the same banded math with the correlation core on the
             hand-written CUDA kernel (kernels/csrc/bellman.cu) in float32;
             the name is the reference's, so callers switch packages
             without renaming.

Everything is float64 except the kernel's f32 core, and the casts around
that core are the reference's (``h`` and ``h(S_o)`` to f32, ``G`` back to
f64).  The loop is a Python loop over device tensors; the span check
reads one (span, g) pair from the device per backup.

The accelerated loops (``accel="mpi"`` / ``"anderson"``) and the batched
lockstep come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .smdp import TruncatedSMDP

F64 = torch.float64


@dataclasses.dataclass
class RVIResult:
    policy: np.ndarray  # (S,) batch-size action per truncated state
    g: float  # average expected cost per unit time (g~ = g^)
    h: np.ndarray  # (S,) relative value function of the DTMDP
    iterations: int
    span: float
    converged: bool
    wall_time_s: float


# ---------------------------------------------------------------------------
# Backups
# ---------------------------------------------------------------------------


def _make_backup(
    kind: str, c_tilde, m_tilde, pmfs, tails, scale, s_max: int
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The Q-backup h -> (S, A) with its index tensors built once.

    c_tilde/scale: (S, A); m_tilde: (S, A, S) (dense only); pmfs: (A, K)
    arrival pmfs over k <= s_max (row 0 unused); tails: (A, s_max + 1).
    """
    if kind == "dense":
        return lambda h: c_tilde + torch.einsum("saj,j->sa", m_tilde, h)
    if kind not in ("banded", "pallas"):
        raise ValueError(f"unknown backup {kind!r}")
    dev = c_tilde.device
    S, A = c_tilde.shape
    T = s_max + 1  # base states 0..s_max
    K = pmfs.shape[1]
    s_idx = torch.arange(S, device=dev)
    acts = torch.arange(A, device=dev)
    # scatter (T, A) -> (S, A): base t = s_val(s) - a, S_o behaves as s_max
    s_val = torch.clamp(s_idx, max=s_max)
    base_c = torch.clamp(s_val[:, None] - acts[None, :], 0, s_max)
    act_idx = acts[None, :].expand(S, A)
    # a == 0 column: next state s + 1 (or S_o)
    nxt = torch.where(s_idx < s_max, s_idx + 1, S - 1)
    one_minus_scale = 1.0 - scale

    if kind == "banded":
        # windowed H matrix: Hwin[t, k] = h[t + k] masked to t + k <= s_max
        j = torch.arange(T, device=dev)[:, None] + torch.arange(K, device=dev)[None, :]
        valid = j <= s_max
        j_c = torch.clamp(j, max=s_max)
        pmfs_t = pmfs.T
        tails_t = tails.T

        def core(h):
            hwin = torch.where(valid, h[j_c], 0.0)
            return hwin @ pmfs_t + tails_t * h[S - 1]  # (T, A)
    else:
        from ..kernels import ops as kops

        pmfs32 = pmfs.to(torch.float32).contiguous()
        tails32 = tails.T.to(torch.float32).contiguous()

        def core(h):
            h_main = torch.zeros(T + K, dtype=torch.float32, device=dev)
            h_main[:T] = h[:T].to(torch.float32)
            G = kops.bellman_backup(h_main, pmfs32, tails32, h[S - 1], device=dev)
            return G.to(h.dtype)

    def backup(h):
        mh = core(h)[base_c, act_idx]  # (S, A)
        mh[:, 0] = h[nxt]
        return c_tilde + scale * mh + one_minus_scale * h[:, None]

    return backup


def dense_backup(c_tilde, m_tilde, h):
    """Q(s,a) = c~(s,a) + sum_j m~(j|s,a) h(j); infeasible entries are +inf."""
    return _make_backup("dense", c_tilde, m_tilde, None, None, None, 0)(h)


def banded_backup(c_tilde, pmfs, tails, scale, s_max: int, h):
    """Structured backup; mathematically equal to dense_backup.

    For a != 0 and base t = s - a:
        (M^ h)(s) = sum_{k=0}^{s_max - t} p^{[a]}_k h(t + k) + tail(a,t) h(S_o)
    For a == 0: (M^ h)(s) = h(min(s+1, s_max -> S_o)); S_o self-loops.
    Discretized:  Q = c~ + scale * (M^ h) + (1 - scale) * h(s).
    """
    return _make_backup("banded", c_tilde, None, pmfs, tails, scale, s_max)(h)


def pallas_backup(c_tilde, pmfs, tails, scale, s_max: int, h):
    """banded_backup with the correlation core on the CUDA kernel.

    Identical math; on a CPU tensor the kernel wrapper runs its plain
    f32 version.  Used by backup="pallas".
    """
    return _make_backup("pallas", c_tilde, None, pmfs, tails, scale, s_max)(h)


#: in-window pmf mass below this is dropped by the banded backups; the
#: overflow tails stay exact, so the induced backup error is O(BAND_TOL * |h|)
BAND_TOL = 1e-14


def trimmed_band(pm: np.ndarray, tol: float = BAND_TOL) -> int:
    """Width of the pmf band holding all but ``tol`` of every action's mass.

    ``pm`` is (..., A, K+1) with a zero row for a = 0.  The correlation in
    the banded backup is O(S * A * band), so trimming the vanishing tail of
    the arrival pmfs (their support is concentrated around lam * l(a))
    directly cuts every RVI iteration's work.
    """
    serve = pm[..., 1:, :]
    width = int((serve.cumsum(-1) < 1.0 - tol).sum(-1).max()) + 2
    return min(width, pm.shape[-1])


def make_banded_inputs(mdp: TruncatedSMDP, *, device: torch.device,
                       dtype: torch.dtype = F64):
    """Precompute (pmfs, tails, scale) for banded_backup from a built SMDP."""
    spec = mdp.spec
    # truncate pmf columns to k <= s_max (k larger always lands in S_o)
    pm = mdp.arrival_pmfs[:, : spec.s_max + 1].copy()
    # tails[a, t] = 1 - sum_{k <= s_max - t} p_k: reversed cumulative mass
    csum = np.cumsum(pm, axis=-1)
    tails = np.maximum(0.0, 1.0 - csum[:, ::-1])
    tails[0, :] = 0.0
    scale = mdp.eta / mdp.y
    return tuple(
        torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)
        for x in (pm, tails, scale)
    )


# ---------------------------------------------------------------------------
# RVI driver
# ---------------------------------------------------------------------------


def _rvi_loop(backup, S: int, device: torch.device, eps: float,
              eps_rel: float, max_iter: int, ref_state: int = 0):
    """The reference's while_loop, step for step.

    Starts from span = inf, g = 0; stops once span < max(eps, eps_rel *
    |g|) with g of the last backup, or at max_iter; the policy is the
    first argmin of one more backup.
    """
    h = torch.zeros(S, dtype=F64, device=device)
    i, span, g = 0, math.inf, 0.0
    while i < max_iter and span >= max(eps, eps_rel * abs(g)):
        j = backup(h).min(dim=1).values
        g_t = j[ref_state]
        h_new = j - g_t
        diff = h_new - h
        stats = torch.stack((diff.max() - diff.min(), g_t))
        h = h_new
        i += 1
        span, g = stats.tolist()  # one device -> host read per backup
    q = backup(h).cpu().numpy()
    policy = np.argmin(q, axis=1)  # first minimum, as jnp.argmin
    return policy, g, h.cpu().numpy(), i, span


def relative_value_iteration(
    mdp: TruncatedSMDP,
    eps: float = 1e-2,
    max_iter: int = 10_000,
    backup: str = "banded",
    eps_rel: float = 2e-4,
    accel: str = "none",
    *,
    device: DeviceLike = None,
) -> RVIResult:
    """Solve the discretized MDP; the policy is eps-optimal for the SMDP."""
    if accel != "none":
        raise NotImplementedError(
            f"accel={accel!r} is not ported yet (see ROADMAP.md, queue 1)"
        )
    dev = resolve_device(device)
    t0 = time.perf_counter()
    c_tilde = torch.as_tensor(mdp.c_tilde, dtype=F64, device=dev)
    if backup == "dense":
        m_tilde = torch.as_tensor(mdp.m_tilde, dtype=F64, device=dev)
        fn = _make_backup("dense", c_tilde, m_tilde, None, None, None, 0)
    else:
        pmfs, tails, scale = make_banded_inputs(mdp, device=dev)
        fn = _make_backup(backup, c_tilde, None, pmfs, tails, scale, mdp.spec.s_max)
    policy, g, h, it, span = _rvi_loop(
        fn, mdp.n_states, dev, eps, eps_rel, max_iter
    )
    return RVIResult(
        policy=policy,
        g=float(g),
        h=h,
        iterations=it,
        span=float(span),
        converged=it < max_iter,
        wall_time_s=time.perf_counter() - t0,
    )
