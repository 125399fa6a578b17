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
kernel).  It is time-parallel over each trace: the trace is cut into
chunks of ``CHUNK`` slots; the chunks' products of step matrices (pass
A, all slots at once) give each chunk's start belief (pass B, a walk
over windows of 32 chunks, each window a warp scan), and every chunk is
then folded exactly from its start (pass C, all chunks at once).  A
chunk where a guard could fire, or whose step matrices round below zero,
is folded exactly in pass B instead.  So its rows agree with the serial
fold to rounding (atol 1e-12 is the bar), and its rows over a prefix of
the slots are, bit for bit, those of a call on that prefix.
``belief_forward_chunked_ref`` is the same algorithm in torch ops, for
the tests.

Traces given as CPU tensors run the plain serial version below; CUDA
tensors launch the kernel or raise.  ``belief_forward.launches`` counts
calls; ``belief_forward.instance_launches`` counts each pass's kernel
(``products``, ``starts``, ``fold``; a call on zero slots launches only
``starts``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..device import refuse_grad
from . import _build

#: posterior-mass floor below which a propagated belief counts as
#: degenerate (the reference's _BELIEF_TINY)
BELIEF_TINY = 1e-300
#: the kernel keeps a step matrix's K x K entries in registers
MAX_PHASES = 8
#: slots a chunk of the kernel's time-parallel fold.  Fixed for every call,
#: so chunk c always covers slots [c CHUNK, (c + 1) CHUNK) and a call's rows
#: over a prefix equal those of a call on the prefix.
CHUNK = 64
#: a slot is safe for the products when E is finite and nonnegative (the
#: fold's clip and the products' clip are then no-ops) and no guard can
#: fire from any normalised start: its row sums of E and of E diag(rates)
#: clear this margin (1e50 over BELIEF_TINY); csrc/belief_forward.cu's kSafe
SAFE = 1e-250
#: a propagated chunk start whose largest entry is not above this is folded
#: exactly instead (csrc/belief_forward.cu's kLive)
LIVE = 2.0 ** -900


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


def _gaps(times, t_init: float):
    """(valid, gap, last valid index) per slot of (S, N) times: the gap to
    the last valid time before the slot (t_init before the first), 0 at a
    padded slot."""
    S, N = times.shape
    valid = torch.isfinite(times)
    idx = torch.arange(N, device=times.device).expand(S, N)
    last_idx = torch.cummax(torch.where(valid, idx, -1), dim=1).values
    prev_idx = torch.cat([torch.full((S, 1), -1, device=times.device,
                                     dtype=last_idx.dtype), last_idx[:, :-1]], 1)[:, :N]
    prev_t = torch.where(prev_idx >= 0, times.gather(1, prev_idx.clamp(min=0)),
                         torch.as_tensor(t_init, dtype=times.dtype, device=times.device))
    gap = torch.where(valid, torch.clamp(times - prev_t, min=0.0), 0.0)
    return valid, gap, last_idx


def _t_final(times, last_idx, t_init: float):
    if times.shape[1] == 0:
        return torch.full((times.shape[0],), float(t_init), dtype=times.dtype,
                          device=times.device)
    return torch.where(last_idx[:, -1] >= 0,
                       times.gather(1, last_idx[:, -1:].clamp(min=0))[:, 0],
                       torch.as_tensor(t_init, dtype=times.dtype, device=times.device))


class _Fold(NamedTuple):
    c: FilterConsts
    b0_sum: torch.Tensor
    b0r: torch.Tensor
    b0r_sum: torch.Tensor


def _fold_consts(c: FilterConsts) -> _Fold:
    b0r = c.b0 * c.rates
    return _Fold(c, _seq_sum(c.b0), b0r, _seq_sum(b0r))


def _fold_step(b, e, f: _Fold):
    """One arrival folded into beliefs b (..., K) through step matrices e
    (..., K, K): the guarded step, operation for operation."""
    c = f.c
    K = c.rates.shape[0]
    p = _fma_chain([b[..., k, None] for k in range(K)], [e[..., k, :] for k in range(K)])
    p = torch.where(torch.isfinite(p), torch.clamp(p, min=0.0), 0.0)
    s = _seq_sum(p)
    ok = torch.isfinite(s) & (s > BELIEF_TINY)
    p = torch.where(ok[..., None], p, c.b0)
    s = torch.where(ok, s, f.b0_sum)
    bn = (p / s[..., None]) * c.rates
    s2 = _seq_sum(bn)
    ok2 = torch.isfinite(s2) & (s2 > BELIEF_TINY)
    bn = torch.where(ok2[..., None], bn, f.b0r)
    s2 = torch.where(ok2, s2, f.b0r_sum)
    return bn / s2[..., None]


def belief_forward_ref(times, b_init, t_init: float, c: FilterConsts):
    """Plain version: the serial fold over (S, N) times in torch ops on
    their device.  Returns (beliefs (S, N, K), b_final (S, K), t_final
    (S,))."""
    S, N = times.shape
    K = c.rates.shape[0]
    valid, gap, last_idx = _gaps(times, t_init)
    E = step_matrices(gap, c)  # (S, N, K, K)
    b = b_init.expand(S, K).clone()
    f = _fold_consts(c)
    out = torch.empty((S, N, K), dtype=times.dtype, device=times.device)
    live = valid.any(dim=0).tolist()  # one read: slots padded in every trace
    for i in range(N):
        if live[i]:
            b = torch.where(valid[:, i, None], _fold_step(b, E[:, i], f), b)
        out[:, i] = b
    return out, b, _t_final(times, last_idx, t_init)


def _pow2_scale(mx):
    """2^-e with mx 2^-e in [1, 2); 1 where mx is 0, subnormal, above 2^1023
    or not finite (csrc/belief_forward.cu's pow2_scale)."""
    _, e = torch.frexp(mx)
    scale = torch.ldexp(torch.ones_like(mx), 1 - e)
    usable = torch.isfinite(mx) & (mx >= torch.finfo(mx.dtype).tiny) & (mx < 2.0 ** 1023)
    return torch.where(usable, scale, torch.ones_like(mx))


def _start_belief(v, first, b_init):
    """A chunk's fold start: b_init for the first chunk of a trace, else the
    propagated start over its sum."""
    return torch.where(first[..., None], b_init, v / _seq_sum(v)[..., None])


def belief_forward_chunked_ref(times, b_init, t_init: float, c: FilterConsts, chunk: int,
                               *, stats=None):
    """The kernel's time-parallel algorithm in torch ops, chunks of
    ``chunk`` slots (csrc/belief_forward.cu's passes A-C; not the kernel's
    operations in its products and pass B, whose rounding differs).  For
    the tests: the CPU path keeps the serial plain fold.  Returns what
    ``belief_forward_ref`` returns; ``stats["unsafe_chunks"]`` (S,) counts
    the chunks pass B folded exactly."""
    S, N = times.shape
    K = c.rates.shape[0]
    C = int(chunk)
    if C < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev, dt = times.device, times.dtype
    nC = -(-N // C)
    f = _fold_consts(c)
    valid, gap, last_idx = _gaps(times, t_init)
    E = step_matrices(gap, c)  # (S, N, K, K)
    eye = torch.eye(K, dtype=dt, device=dev)
    # pass A: each slot's M = E diag(rates) clipped at 0, its safety (E
    # finite and nonnegative, no guard can fire), the chunks' products
    # scaled by powers of two
    r = c.rates
    rates_ok = bool((torch.isfinite(r) & (r >= 0)).all())
    Er = E * r
    rs = E.sum(-1)
    safe = ((torch.isfinite(E) & (E >= 0)).all(-1).all(-1) & rates_ok
            & (rs.amin(-1) > SAFE)
            & (Er.sum(-1).amin(-1) > SAFE * torch.clamp(rs.amax(-1), min=1.0)))
    M = torch.where(valid[..., None, None], torch.clamp(Er, min=0.0), eye)
    pad = nC * C - N
    M = torch.cat([M, eye.expand(S, pad, K, K)], 1).reshape(S, nC, C, K, K)
    unsafe = torch.cat([valid & ~safe, torch.zeros((S, pad), dtype=torch.bool, device=dev)],
                       1).reshape(S, nC, C).any(-1)
    P = M[:, :, 0]
    for j in range(1, C):
        P = P @ M[:, :, j]
        P = P * _pow2_scale(P.abs().amax((-1, -2)))[..., None, None]
    # pass B: the chunks' starts, a chunk that could trip a guard (or whose
    # propagated start dies) folded exactly
    starts = torch.empty((S, nC, K), dtype=dt, device=dev)
    n_unsafe = torch.zeros(S, dtype=torch.int32)
    v = b_init.expand(S, K).clone()
    if nC:
        starts[:, 0] = v
    for cc in range(nC - 1):
        nv = (v[:, None, :] @ P[:, cc])[:, 0]
        ok = (~unsafe[:, cc] & torch.isfinite(_seq_sum(nv))
              & (nv.amax(-1) > LIVE)).tolist()
        for s_ in (s_ for s_, good in enumerate(ok) if not good):
            n_unsafe[s_] += 1
            first = torch.tensor(cc == 0, device=dev)
            b = _start_belief(v[s_], first, b_init)
            for i in range(cc * C, (cc + 1) * C):
                if valid[s_, i]:
                    b = _fold_step(b, E[s_, i], f)
            nv[s_] = b
        v = nv * _pow2_scale(nv.amax(-1))[:, None]
        starts[:, cc + 1] = v
    # pass C: every chunk folded exactly from its start
    first = torch.zeros(nC, dtype=torch.bool, device=dev)
    first[:1] = True
    b = _start_belief(starts, first.expand(S, nC), b_init)
    out = torch.empty((S, nC * C, K), dtype=dt, device=dev)
    Ep = torch.cat([E, eye.expand(S, pad, K, K)], 1).reshape(S, nC, C, K, K)
    vp = torch.cat([valid, torch.zeros((S, pad), dtype=torch.bool, device=dev)],
                   1).reshape(S, nC, C)
    for j in range(C):
        b = torch.where(vp[:, :, j, None], _fold_step(b, Ep[:, :, j], f), b)
        out[:, j::C] = b
    if stats is not None:
        stats["unsafe_chunks"] = n_unsafe
    b_final = out[:, N - 1].clone() if N else b_init.expand(S, K).clone()
    return out[:, :N].contiguous(), b_final, _t_final(times, last_idx, t_init)


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


def pack_consts(c: FilterConsts, b_init, t_init: float):
    """The kernel's constants as one f64 tensor (csrc/belief_fold.cuh's
    layout): d_re, d_im, v_re, v_im, vi_re, vi_im, rates, b0, b_init,
    t_init."""
    return torch.cat([c.d_re, c.d_im, c.v_re.reshape(-1), c.v_im.reshape(-1),
                      c.vi_re.reshape(-1), c.vi_im.reshape(-1), c.rates, c.b0, b_init,
                      torch.full((1,), float(t_init), dtype=torch.float64,
                                 device=b_init.device)]).contiguous()


def _launch(times, b_init, t_init: float, c: FilterConsts, chunk: int):
    """The kernel on CUDA tensors, chunks of ``chunk`` slots.  Returns (beliefs, b_final, t_final, unsafe_chunks):
    the last an (S,) int32 tensor on the card, the chunks its pass B
    folded exactly.  ``belief_forward`` calls it at ``CHUNK``; the card
    tests and chip_smoke.py call it at other chunk lengths (C = N is a
    serial fold)."""
    _check(times, b_init, c)
    if times.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {times.device}")
    refuse_grad("belief_forward", times, b_init)
    C = int(chunk)
    if C < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    S, N = times.shape
    K = c.rates.shape[0]
    dev = times.device
    times = times.contiguous()
    consts = pack_consts(c, b_init, t_init)
    beliefs = torch.empty((S, N, K), dtype=torch.float64, device=dev)
    b_final = torch.empty((S, K), dtype=torch.float64, device=dev)
    t_final = torch.empty((S,), dtype=torch.float64, device=dev)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    sizes = (ll * 2)()
    _build.function("belief_forward", "belief_forward_scratch", None,
                    [ll] * 4 + [ctypes.POINTER(ll)])(S, N, K, C, sizes)
    dscratch = torch.empty(max(sizes[0], 1), dtype=torch.float64, device=dev)
    iscratch = torch.empty(max(sizes[1], 1), dtype=torch.int32, device=dev)
    fn = _build.function("belief_forward", "belief_forward_launch", ctypes.c_int,
                         [vp] * 5 + [ll] * 4 + [vp] * 3)
    rc = fn(times.data_ptr(), consts.data_ptr(), beliefs.data_ptr(),
            b_final.data_ptr(), t_final.data_ptr(), S, N, K, C, dscratch.data_ptr(),
            iscratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"belief_forward launch failed: CUDA error {rc}")
    belief_forward.launches += 1
    counts = belief_forward.instance_launches
    for inst in (("products", "starts", "fold") if N > 0 else ("starts",)):
        counts[inst] = counts.get(inst, 0) + 1
    return beliefs, b_final, t_final, iscratch[sizes[1] - S:sizes[1]]


def belief_forward(times, b_init, t_init: float, c: FilterConsts):
    """Posterior rows for (S, N) f64 times from the state (``b_init`` (K,),
    ``t_init``), every trace from the same state.  Returns (beliefs (S, N,
    K), b_final (S, K), t_final (S,)) on the times' device."""
    _check(times, b_init, c)
    if times.device.type == "cpu":
        return belief_forward_ref(times, b_init, t_init, c)
    if times.device.type != "cuda":
        raise ValueError(f"unsupported device {times.device}")
    return _launch(times, b_init, t_init, c, CHUNK)[:3]


belief_forward.launches = 0
belief_forward.instance_launches = {}
