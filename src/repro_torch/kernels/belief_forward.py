"""The MMPP phase-belief forward filter: its wrapper and plain version.

Per trace, the exact Bayesian posterior over the hidden phase is folded
over the arrival times, as ``serving.arrivals.PhaseBeliefFilter.observe``
does one arrival at a time:

    gap  = max(t - last, 0)
    p    = Re(b @ (V diag(exp(d gap)) V^-1))          (V, d: eig of R - Lambda)
    p    = where(finite(p), max(p, 0), 0);  s = sum(p)
    p, s = b0, sum(b0)                if s is not finite or s <= TINY
    b'   = (p / s) * rates;  s2 = sum(b')
    b', s2 = b0 * rates, sum(b0 * rates)  if s2 is not finite or s2 <= TINY
    b    = b' / s2

+inf / NaN slots keep the carry (b, last) and repeat the previous row.
Every product-sum is the fused multiply-add chain that numpy's and
torch's BLAS take for these small products (acc = x0 * y0, then acc =
fma(xk, yk, acc) for k = 1..K-1), and every other sum runs in order k =
0..K-1, as numpy sums fewer than 8 terms; so for real eigenvalues (every
two-phase MMPP) the plain version equals the numpy filter bit for bit.

The kernel is ``csrc/belief_forward.cu``, the device counterpart of the
reference's ``lax.scan`` in ``belief_forward_jax`` (not of a Pallas
kernel).  Traces given as CPU tensors run the plain version below; CUDA
tensors launch the kernel or raise.  ``belief_forward.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

#: posterior-mass floor below which a propagated belief counts as
#: degenerate (the reference's _BELIEF_TINY)
BELIEF_TINY = 1e-300
#: the kernel keeps a step matrix's K x K entries in registers
MAX_PHASES = 8


class FilterConsts(NamedTuple):
    """The filter's constants as f64 tensors on one device: the
    eigendecomposition of (R - Lambda) as real / imaginary parts (zero
    imaginary parts when the eigenvalues are real), the rates and the
    stationary start ``b0``."""

    d_re: torch.Tensor  # (K,)
    d_im: torch.Tensor  # (K,)
    v_re: torch.Tensor  # (K, K)
    v_im: torch.Tensor  # (K, K)
    vi_re: torch.Tensor  # (K, K) inverse of V
    vi_im: torch.Tensor  # (K, K)
    rates: torch.Tensor  # (K,)
    b0: torch.Tensor  # (K,)


def _fma_chain(xs, ys):
    """acc = xs[0] * ys[0], then acc = fma(xs[k], ys[k], acc): addcmul is
    one fused multiply-add per element."""
    acc = xs[0] * ys[0]
    for x, y in zip(xs[1:], ys[1:]):
        acc = torch.addcmul(acc, x, y)
    return acc


def _seq_sum(v):
    """Sum over the last axis in order k = 0..K-1 (numpy's order below 8
    terms; numpy's pairwise tree at exactly 8)."""
    K = v.shape[-1]
    if K == 8:
        pair = [v[..., 2 * i] + v[..., 2 * i + 1] for i in range(4)]
        return (pair[0] + pair[1]) + (pair[2] + pair[3])
    acc = v[..., 0]
    for k in range(1, K):
        acc = acc + v[..., k]
    return acc


def step_matrices(gap, c: FilterConsts):
    """Re(V diag(exp(d gap)) V^-1) for every gap: (..., K, K) from (...)."""
    g = gap[..., None]
    er = torch.exp(c.d_re * g)
    ex_re = er * torch.cos(c.d_im * g)
    ex_im = er * torch.sin(c.d_im * g)
    # Vex = V * ex (columns scaled), complex, each product rounded on its own
    vex_re = c.v_re * ex_re[..., None, :] - c.v_im * ex_im[..., None, :]
    vex_im = c.v_re * ex_im[..., None, :] + c.v_im * ex_re[..., None, :]
    K = c.rates.shape[0]
    xs, ys = [], []
    for m in range(K):  # Re(sum_m vex[k, m] vi[m, j]), one fma pair per m
        xs += [vex_re[..., :, m, None], -vex_im[..., :, m, None]]
        ys += [c.vi_re[m], c.vi_im[m]]
    return _fma_chain(xs, ys)


def belief_forward_ref(times, b_init, t_init: float, c: FilterConsts):
    """Plain version: the fold over (S, N) times in torch ops on their
    device.  Returns (beliefs (S, N, K), b_final (S, K), t_final (S,))."""
    S, N = times.shape
    K = c.rates.shape[0]
    valid = torch.isfinite(times)
    # the last valid time before each slot (t_init before the first)
    idx = torch.arange(N, device=times.device).expand(S, N)
    last_idx = torch.cummax(torch.where(valid, idx, -1), dim=1).values
    prev_idx = torch.cat([torch.full((S, 1), -1, device=times.device,
                                     dtype=last_idx.dtype), last_idx[:, :-1]], 1)
    prev_t = torch.where(prev_idx >= 0, times.gather(1, prev_idx.clamp(min=0)),
                         torch.as_tensor(t_init, dtype=times.dtype, device=times.device))
    gap = torch.where(valid, torch.clamp(times - prev_t, min=0.0), 0.0)
    E = step_matrices(gap, c)  # (S, N, K, K)
    b = b_init.expand(S, K).clone()
    b0_sum = _seq_sum(c.b0)
    b0r = c.b0 * c.rates
    b0r_sum = _seq_sum(b0r)
    out = torch.empty((S, N, K), dtype=times.dtype, device=times.device)
    live = valid.any(dim=0).tolist()  # one read: slots padded in every trace
    for i in range(N):
        if not live[i]:
            out[:, i] = b
            continue
        e = E[:, i]
        p = _fma_chain([b[:, k, None] for k in range(K)], [e[:, k] for k in range(K)])
        p = torch.where(torch.isfinite(p), torch.clamp(p, min=0.0), 0.0)
        s = _seq_sum(p)
        ok = torch.isfinite(s) & (s > BELIEF_TINY)
        p = torch.where(ok[:, None], p, c.b0)
        s = torch.where(ok, s, b0_sum)
        bn = (p / s[:, None]) * c.rates
        s2 = _seq_sum(bn)
        ok2 = torch.isfinite(s2) & (s2 > BELIEF_TINY)
        bn = torch.where(ok2[:, None], bn, b0r)
        s2 = torch.where(ok2, s2, b0r_sum)
        b = torch.where(valid[:, i, None], bn / s2[:, None], b)
        out[:, i] = b
    t_final = torch.where(last_idx[:, -1] >= 0,
                          times.gather(1, last_idx[:, -1:].clamp(min=0))[:, 0],
                          torch.as_tensor(t_init, dtype=times.dtype, device=times.device))
    return out, b, t_final


def _check(times, b_init, c: FilterConsts) -> None:
    if not isinstance(times, torch.Tensor) or times.dtype != torch.float64 or times.dim() != 2:
        raise TypeError("times must be a 2-d float64 tensor (S, N)")
    K = c.rates.shape[0]
    if not 1 <= K <= MAX_PHASES:
        raise ValueError(f"belief kernel takes 1..{MAX_PHASES} phases, got {K}")
    shapes = dict(d_re=(K,), d_im=(K,), v_re=(K, K), v_im=(K, K), vi_re=(K, K),
                  vi_im=(K, K), rates=(K,), b0=(K,))
    for name, want in shapes.items():
        x = getattr(c, name)
        if x.dtype != torch.float64 or tuple(x.shape) != want:
            raise TypeError(f"{name} must be float64 of shape {want}")
        if x.device != times.device:
            raise ValueError(f"{name} on {x.device}, times on {times.device}")
    if b_init.dtype != torch.float64 or tuple(b_init.shape) != (K,):
        raise TypeError(f"b_init must be float64 of shape ({K},)")
    if b_init.device != times.device:
        raise ValueError(f"b_init on {b_init.device}, times on {times.device}")


def belief_forward(times, b_init, t_init: float, c: FilterConsts):
    """Posterior rows for (S, N) f64 times from the state (``b_init`` (K,),
    ``t_init``), every trace from the same state.  Returns (beliefs (S, N,
    K), b_final (S, K), t_final (S,)) on the times' device."""
    _check(times, b_init, c)
    if times.device.type == "cpu":
        return belief_forward_ref(times, b_init, t_init, c)
    if times.device.type != "cuda":
        raise ValueError(f"unsupported device {times.device}")
    S, N = times.shape
    K = c.rates.shape[0]
    dev = times.device
    times = times.contiguous()
    consts = torch.cat([c.d_re, c.d_im, c.v_re.reshape(-1), c.v_im.reshape(-1),
                        c.vi_re.reshape(-1), c.vi_im.reshape(-1), c.rates, c.b0,
                        b_init, torch.full((1,), float(t_init), dtype=torch.float64,
                                           device=dev)]).contiguous()
    beliefs = torch.empty((S, N, K), dtype=torch.float64, device=dev)
    b_final = torch.empty((S, K), dtype=torch.float64, device=dev)
    t_final = torch.empty((S,), dtype=torch.float64, device=dev)
    fn = _build.function("belief_forward", "belief_forward_launch", ctypes.c_int,
                         [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                         + [ctypes.c_void_p])
    rc = fn(times.data_ptr(), consts.data_ptr(), beliefs.data_ptr(),
            b_final.data_ptr(), t_final.data_ptr(), S, N, K,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"belief_forward launch failed: CUDA error {rc}")
    belief_forward.launches += 1
    return beliefs, b_final, t_final


belief_forward.launches = 0
