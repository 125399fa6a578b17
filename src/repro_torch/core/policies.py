"""Benchmark batching policies + Prop.-4 closed-form control limit.

All policies are represented as action tables over the truncated state space
{0..s_max, S_o} (length s_max + 2), matching RVIResult.policy, so that
evaluate.py and simulate.py treat SMDP and benchmark policies uniformly.
The infinite-state extension is eq. (30): pi(s > s_max) = pi(s_max).
"""
from __future__ import annotations

import numpy as np


def _table(s_max: int) -> np.ndarray:
    return np.zeros(s_max + 2, dtype=np.int64)


def _s_values(s_max: int) -> np.ndarray:
    s = np.arange(s_max + 2)
    s[-1] = s_max  # S_o counts as s_max requests
    return s


def static_policy(b: int, s_max: int) -> np.ndarray:
    """pi(s) = b if s >= b else 0 (Definition 1)."""
    s = _s_values(s_max)
    return np.where(s >= b, b, 0).astype(np.int64)


def greedy_policy(s_max: int, b_min: int, b_max: int) -> np.ndarray:
    """pi(s) = max(min(s, B_max), B_min) when feasible, else wait (Def. 2)."""
    s = _s_values(s_max)
    act = np.maximum(np.minimum(s, b_max), b_min)
    return np.where(s >= b_min, act, 0).astype(np.int64)


def q_policy(q: int, s_max: int, b_max: int) -> np.ndarray:
    """Control-limit policy (Definition 3): serve min(s, B_max) iff s >= Q."""
    s = _s_values(s_max)
    return np.where(s >= q, np.minimum(s, b_max), 0).astype(np.int64)


def is_control_limit(policy: np.ndarray, s_max: int, b_max: int):
    """Check the Def.-3 structure; returns (True, Q) or (False, None)."""
    s = _s_values(s_max)
    serve = policy > 0
    if not serve.any():
        return False, None
    q = int(np.argmax(serve))
    expected = q_policy(q, s_max, b_max)
    return bool(np.array_equal(policy, expected)), (q if np.array_equal(policy, expected) else None)


def optimal_q_closed_form(
    lam: float, mu: float, b_max: int, w1: float = 1.0, w2: float = 0.0, zeta0: float = 0.0
) -> int:
    """Proposition 4 (Deb–Serfozo): optimal control limit for M/M-type service.

    Requires size-independent exponential service (Assumptions 1-4).
    """
    psi = lam / (lam + mu)

    # unique root of (1 - psi) xi^{B+1} - xi + psi = 0 in (0, 1)
    def f(x):
        return (1.0 - psi) * x ** (b_max + 1) - x + psi

    lo, hi = 1e-12, 1.0 - 1e-12
    # f(0) = psi > 0; f(1-) -> 0 from below for stable systems; bisect on sign
    flo = f(lo)
    xi = None
    # scan for a sign change to bracket the interior root
    grid = np.linspace(lo, hi, 4096)
    vals = f(grid)
    sign_change = np.nonzero(np.diff(np.sign(vals)) != 0)[0]
    if len(sign_change) == 0:
        raise RuntimeError("no interior root for xi — check stability")
    a_, b_ = grid[sign_change[0]], grid[sign_change[0] + 1]
    for _ in range(200):
        mid = 0.5 * (a_ + b_)
        if f(a_) * f(mid) <= 0:
            b_ = mid
        else:
            a_ = mid
    xi = 0.5 * (a_ + b_)

    chi = lam / mu
    r = xi / (1.0 - xi)
    for q in range(1, b_max + 1):
        d_q = (
            q * (0.5 * (q + 1) + chi - r)
            - r**2 * xi**q
            + r * (r - chi)
            - w2 * zeta0 * lam**2 / w1
        )
        if d_q >= 0:
            return q
    return b_max
