"""Service-time models G_b, latency l(b) and energy zeta(b) profiles.

The paper (Sec. III) assumes:
  * l(b) = E[G_b] monotone non-decreasing, theta(b) = b/l(b) non-decreasing;
  * zeta(b) monotone with eta(b) = b/zeta(b) non-decreasing;
  * arbitrary service distribution G_b with finite second moment.

We implement the paper's families (deterministic / Erlang-2 / exponential /
hyper-exponential, Sec. VII-C-3) plus an empirical atom-mixture family so
profiled latency histograms can be plugged in directly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Latency / energy profiles (deterministic functions of batch size)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AffineProfile:
    """f(b) = slope * b + intercept (the paper's fitted form, Fig. 2)."""

    slope: float
    intercept: float

    def __call__(self, b):
        return self.slope * np.asarray(b, dtype=np.float64) + self.intercept


@dataclasses.dataclass(frozen=True)
class ConstantProfile:
    """f(b) = c (ideal parallelism, paper Sec. VII-C-1)."""

    value: float

    def __call__(self, b):
        return np.full_like(np.asarray(b, dtype=np.float64), self.value)


@dataclasses.dataclass(frozen=True)
class LogProfile:
    """f(b) = a * log(b) + c (paper Sec. VII-C-2 energy scenario)."""

    scale: float
    intercept: float

    def __call__(self, b):
        return self.scale * np.log(np.asarray(b, dtype=np.float64)) + self.intercept


@dataclasses.dataclass(frozen=True)
class TableProfile:
    """f(b) from a profiled lookup table, b in [1, len(table)]."""

    table: Tuple[float, ...]

    def __call__(self, b):
        arr = np.asarray(b)
        return np.asarray(self.table, dtype=np.float64)[arr - 1]


@dataclasses.dataclass(frozen=True)
class PiecewiseMaxProfile:
    """f(b) = max(a1*b + c1, a2*b + c2) — roofline-shaped latency.

    This is the TPU-native form: compute-term vs memory-term maximum.  It is
    monotone non-decreasing and theta(b)=b/f(b) is non-decreasing whenever
    both branches individually satisfy it (affine with positive intercept).
    """

    slope1: float
    intercept1: float
    slope2: float
    intercept2: float

    def __call__(self, b):
        barr = np.asarray(b, dtype=np.float64)
        return np.maximum(
            self.slope1 * barr + self.intercept1,
            self.slope2 * barr + self.intercept2,
        )


Profile = Callable[[np.ndarray], np.ndarray]

# ---------------------------------------------------------------------------
# Service-time distribution families
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Distribution family of the batch service time G_b.

    ``latency`` gives the mean l(b); the family shapes the distribution
    around that mean.  ``family`` in {'det', 'erlang', 'expo', 'hyperexpo',
    'atoms'}.

    * det       : Pr[G_b = l(b)] = 1                                (CoV 0)
    * erlang    : Erlang-k with mean l(b) (default k=2)             (CoV 1/sqrt(k))
    * expo      : exponential with mean l(b)                        (CoV 1)
    * hyperexpo : mixture of exponentials, means scales_i * l(b),
                  weights w_i (paper: w=(2/3,1/3), scales=(0.5,2))  (CoV > 1)
    * atoms     : Pr[G_b = atom_scales_i * l(b)] = atom_weights_i   (empirical)
    """

    latency: Profile
    family: str = "det"
    erlang_k: int = 2
    hyper_weights: Tuple[float, ...] = (2.0 / 3.0, 1.0 / 3.0)
    hyper_scales: Tuple[float, ...] = (0.5, 2.0)
    atom_weights: Tuple[float, ...] = (1.0,)
    atom_scales: Tuple[float, ...] = (1.0,)

    # -- moments ------------------------------------------------------------
    def mean(self, b) -> np.ndarray:
        return np.asarray(self.latency(b), dtype=np.float64)

    def second_moment(self, b) -> np.ndarray:
        m = self.mean(b)
        if self.family == "det":
            return m**2
        if self.family == "erlang":
            k = self.erlang_k
            return m**2 * (1.0 + 1.0 / k)
        if self.family == "expo":
            return 2.0 * m**2
        if self.family == "hyperexpo":
            w = np.asarray(self.hyper_weights)
            s = np.asarray(self.hyper_scales)
            # mixture of exponentials with means s_i * m — but the mixture
            # mean is sum(w_i s_i) m; we renormalize scales so E = m exactly.
            norm = float(np.sum(w * s))
            s = s / norm
            return 2.0 * m**2 * float(np.sum(w * s**2))
        if self.family == "atoms":
            w = np.asarray(self.atom_weights)
            s = np.asarray(self.atom_scales)
            norm = float(np.sum(w * s))
            s = s / norm
            return m**2 * float(np.sum(w * s**2))
        raise ValueError(f"unknown family {self.family!r}")

    def cov(self, b) -> np.ndarray:
        m = self.mean(b)
        var = self.second_moment(b) - m**2
        return np.sqrt(np.maximum(var, 0.0)) / m

    # -- P(k arrivals during service of batch b), Poisson(lam) arrivals ------
    def arrival_pmf(self, b: int, lam: float, k_max: int) -> np.ndarray:
        """p_k^{[b]} for k = 0..k_max (eq. 4); tail mass is 1 - sum.

        Closed forms per family (all exact):
          det       : Poisson(k; lam * l(b))
          erlang-k  : NegBin: C(n+k-1, n) q^n (1-q)^k with q = lam/(lam+nu),
                      nu = k_stages / l(b)   [k arrivals across k_stages]
          expo      : geometric, q = lam/(lam+1/l(b))
          hyperexpo : mixture of geometrics
          atoms     : mixture of Poissons
        """
        m = float(self.mean(b))
        ks = np.arange(k_max + 1)
        if self.family == "det":
            return _poisson_pmf(ks, lam * m)
        if self.family == "erlang":
            stages = self.erlang_k
            nu = stages / m  # per-stage rate
            q = lam / (lam + nu)
            return _negbin_pmf(ks, stages, q)
        if self.family == "expo":
            q = lam / (lam + 1.0 / m)
            return _negbin_pmf(ks, 1, q)
        if self.family == "hyperexpo":
            w = np.asarray(self.hyper_weights, dtype=np.float64)
            s = np.asarray(self.hyper_scales, dtype=np.float64)
            s = s / float(np.sum(w * s))
            out = np.zeros(k_max + 1)
            for wi, si in zip(w, s):
                qi = lam / (lam + 1.0 / (si * m))
                out += wi * _negbin_pmf(ks, 1, qi)
            return out
        if self.family == "atoms":
            w = np.asarray(self.atom_weights, dtype=np.float64)
            s = np.asarray(self.atom_scales, dtype=np.float64)
            s = s / float(np.sum(w * s))
            out = np.zeros(k_max + 1)
            for wi, si in zip(w, s):
                out += wi * _poisson_pmf(ks, lam * si * m)
            return out
        raise ValueError(f"unknown family {self.family!r}")

    # -- sampling (for the event-driven simulator) ---------------------------
    def unit_draws(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """n unit-scale draws U with sample(b) ~ mean(b) * U for every b.

        Every family is a scale mixture around the batch mean, so a single
        a-independent draw sequence parameterizes the whole service law —
        the compiled simulator (serving.compiled) consumes one draw per
        serve epoch, and a shared sequence makes the compiled and Python
        backends decision-for-decision identical.  `det` consumes no rng
        state (matching sample(), which never touches the generator).
        """
        if self.family == "det":
            return np.ones(n)
        if self.family == "erlang":
            k = self.erlang_k
            return rng.gamma(shape=k, scale=1.0 / k, size=n)
        if self.family == "expo":
            return rng.exponential(scale=1.0, size=n)
        if self.family == "hyperexpo":
            w = np.asarray(self.hyper_weights)
            s = np.asarray(self.hyper_scales)
            s = s / float(np.sum(w * s))
            comp = rng.choice(len(w), size=n, p=w / w.sum())
            return rng.exponential(scale=s[comp], size=n)
        if self.family == "atoms":
            w = np.asarray(self.atom_weights)
            s = np.asarray(self.atom_scales)
            s = s / float(np.sum(w * s))
            comp = rng.choice(len(w), size=n, p=w / w.sum())
            return s[comp]
        raise ValueError(f"unknown family {self.family!r}")

    def sample(self, b: int, rng: np.random.Generator, n: int) -> np.ndarray:
        m = float(self.mean(b))
        if self.family == "det":
            return np.full(n, m)
        if self.family == "erlang":
            k = self.erlang_k
            return rng.gamma(shape=k, scale=m / k, size=n)
        if self.family == "expo":
            return rng.exponential(scale=m, size=n)
        if self.family == "hyperexpo":
            w = np.asarray(self.hyper_weights)
            s = np.asarray(self.hyper_scales)
            s = s / float(np.sum(w * s))
            comp = rng.choice(len(w), size=n, p=w / w.sum())
            return rng.exponential(scale=s[comp] * m, size=n)
        if self.family == "atoms":
            w = np.asarray(self.atom_weights)
            s = np.asarray(self.atom_scales)
            s = s / float(np.sum(w * s))
            comp = rng.choice(len(w), size=n, p=w / w.sum())
            return s[comp] * m
        raise ValueError(f"unknown family {self.family!r}")


def _poisson_pmf(ks: np.ndarray, rate: float) -> np.ndarray:
    """Numerically stable Poisson pmf via log-space recurrence."""
    if rate <= 0.0:
        out = np.zeros_like(ks, dtype=np.float64)
        out[ks == 0] = 1.0
        return out
    logs = ks * math.log(rate) - rate - _log_factorial(ks)
    return np.exp(logs)


def _negbin_pmf(ks: np.ndarray, r: int, q: float) -> np.ndarray:
    """P(K=k) = C(k+r-1, k) (1-q)^r q^k  (arrivals across r expo stages)."""
    log_comb = _log_factorial(ks + r - 1) - _log_factorial(ks) - _log_factorial(
        np.full_like(ks, r - 1)
    )
    logs = log_comb + r * math.log(max(1.0 - q, 1e-300)) + ks * math.log(max(q, 1e-300))
    return np.exp(logs)


def _log_factorial(ks: np.ndarray) -> np.ndarray:
    from scipy.special import gammaln

    return gammaln(np.asarray(ks, dtype=np.float64) + 1.0)


# ---------------------------------------------------------------------------
# Paper's fitted profiles (Sec. VII preamble)
# ---------------------------------------------------------------------------

#: GoogLeNet on TESLA P4 (ms / mJ), fitted from NVIDIA measurements [7].
GOOGLENET_P4_LATENCY = AffineProfile(slope=0.3051, intercept=1.0524)
GOOGLENET_P4_ENERGY = AffineProfile(slope=19.899, intercept=19.603)

#: Sec. VII-C-1 — ideal parallelism (constant batch latency).
IDEAL_PARALLEL_LATENCY = ConstantProfile(value=6.0859)

#: Sec. VII-C-2 — logarithmic energy.
LOG_ENERGY = LogProfile(scale=105.0, intercept=60.0)
