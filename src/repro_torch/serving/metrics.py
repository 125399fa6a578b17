"""Serving metrics: streaming latency quantiles, power, arrival-rate estimation.

Two O(1)-memory latency-quantile sketches, one per backend:

  * P² streaming estimation (Jain & Chlamtac) for the Python event loop —
    sequential updates, arbitrary stream shapes, no samples retained; every
    engine mode streams its batches through ServingMetrics.
  * A fixed-bin log-spaced histogram for the compiled backend (the
    event kernel bins each served request's latency as it serves; a
    fixed-bin count is O(1) per request where P²'s marker moves are
    data-dependent).  `histogram_quantiles` reconstructs
    P50/P95/P99 from the counts by within-bin linear interpolation.

RateEstimator is the online lambda-hat (EWMA of inter-arrival gaps, or a
sliding window) for the bank-retuning AdaptiveController
(serving.scheduler); the compiled adaptive lane carries the EWMA form.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np


class P2Quantile:
    """P² single-quantile estimator; O(1) memory, no samples stored."""

    def __init__(self, q: float):
        self.q = q
        self._init: List[float] = []
        self.n = [0, 1, 2, 3, 4]
        self.ns = [0.0, 0.0, 0.0, 0.0, 0.0]
        self.heights: List[float] = []

    def update(self, x: float) -> None:
        if len(self._init) < 5:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self.heights = list(self._init)
                self.ns = [0, 2 * self.q, 4 * self.q, 2 + 2 * self.q, 4]
            return
        h = self.heights
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            self.n[i] += 1
        for i in range(5):
            self.ns[i] += [0, self.q / 2, self.q, (1 + self.q) / 2, 1][i]
        for i in (1, 2, 3):
            d = self.ns[i] - self.n[i]
            if (d >= 1 and self.n[i + 1] - self.n[i] > 1) or (
                d <= -1 and self.n[i - 1] - self.n[i] < -1
            ):
                s = int(np.sign(d))
                # parabolic update, clamped to neighbours
                num = h[i] + s / (self.n[i + 1] - self.n[i - 1]) * (
                    (self.n[i] - self.n[i - 1] + s) * (h[i + 1] - h[i])
                    / (self.n[i + 1] - self.n[i])
                    + (self.n[i + 1] - self.n[i] - s) * (h[i] - h[i - 1])
                    / (self.n[i] - self.n[i - 1])
                )
                if h[i - 1] < num < h[i + 1]:
                    h[i] = num
                else:
                    h[i] = h[i] + s * (h[i + s] - h[i]) / (self.n[i + s] - self.n[i])
                self.n[i] += s

    @property
    def value(self) -> float:
        if len(self._init) < 5:
            return float(np.percentile(self._init, self.q * 100)) if self._init else float("nan")
        return self.heights[2]

    def snapshot(self) -> dict:
        """Full marker state as arrays (FleetStream's durable carry).

        restore() of a snapshot reproduces the estimator exactly: every
        subsequent update() computes from bit-identical marker values."""
        return {
            "q": np.float64(self.q),
            "init": np.asarray(self._init, dtype=np.float64),
            "n": np.asarray(self.n, dtype=np.int64),
            "ns": np.asarray(self.ns, dtype=np.float64),
            "heights": np.asarray(self.heights, dtype=np.float64),
        }

    def restore(self, state: dict) -> None:
        self.q = float(state["q"])
        self._init = [float(x) for x in state["init"]]
        self.n = [int(x) for x in state["n"]]
        self.ns = [float(x) for x in state["ns"]]
        self.heights = [float(x) for x in state["heights"]]


def histogram_quantiles(counts, edges, qs) -> np.ndarray:
    """Quantiles from a fixed-bin histogram sketch (compiled-kernel side).

    ``counts`` has ``len(edges) + 1`` entries: counts[0] is mass below
    edges[0], counts[-1] mass at or above edges[-1] (the scan kernel's
    under/overflow bins); counts[i] covers [edges[i-1], edges[i]).  The
    quantile is the within-bin linear interpolation of the empirical CDF;
    under/overflow quantiles clamp to the nearest edge, so callers should
    size edges (serving.compiled.default_hist_edges) to cover the data.
    """
    counts = np.asarray(counts, dtype=np.float64)
    edges = np.asarray(edges, dtype=np.float64)
    if counts.ndim != 1:
        raise ValueError(
            "histogram_quantiles takes one lane of counts; index "
            "run_grid's hist per (scenario, policy) before calling"
        )
    if counts.shape[-1] != len(edges) + 1:
        raise ValueError(
            f"counts last dim {counts.shape[-1]} != len(edges) + 1"
        )
    qs = np.atleast_1d(np.asarray(qs, dtype=np.float64))
    total = counts.sum()
    # empty lane (starved replica, sub-batch smoke horizon) or a poisoned
    # sketch (NaN/inf counts): well-defined NaN out, never garbage interp
    if not np.isfinite(total) or total <= 0:
        return np.full(qs.shape, np.nan)
    cum = np.cumsum(counts)
    out = np.empty(qs.shape)
    for j, q in enumerate(qs):
        target = q * total
        i = int(np.searchsorted(cum, target, side="left"))
        i = min(i, len(counts) - 1)
        if i == 0:
            out[j] = edges[0]
        elif i == len(counts) - 1:
            out[j] = edges[-1]
        else:
            below = cum[i - 1]
            inbin = counts[i]
            frac = (target - below) / inbin if inbin > 0 else 0.0
            lo, hi = edges[i - 1], edges[i]
            out[j] = lo + frac * (hi - lo)
    return out


class RateEstimator:
    """Online arrival-rate estimator lambda-hat from observed arrival times.

    Two modes:
      * EWMA (default): exponentially weighted mean of inter-arrival gaps,
        rate = 1 / gap_bar.  Averaging gaps (not their inverses) keeps the
        estimator unbiased for Poisson input — E[gap] = 1/lambda, while
        E[1/gap] diverges.
      * window=N: sliding window of the last N arrival times,
        rate = (N - 1) / (t_last - t_first).
    """

    def __init__(
        self,
        *,
        ewma: float = 0.1,
        window: Optional[int] = None,
        init: Optional[float] = None,
        min_gap: float = 1e-12,
    ):
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        if window is not None and window < 2:
            raise ValueError("window needs >= 2 arrivals to estimate a rate")
        self.ewma = ewma
        self.window = window
        self.min_gap = min_gap
        self._init_rate = init
        self._gap_bar: Optional[float] = 1.0 / init if init else None
        self._last: Optional[float] = None
        self._times: collections.deque = collections.deque(
            maxlen=window if window is not None else 1
        )
        self.n_observed = 0

    def observe(self, t: float) -> None:
        self.n_observed += 1
        if self.window is not None:
            self._times.append(t)
            return
        if self._last is not None:
            gap = max(t - self._last, self.min_gap)
            if self._gap_bar is None:
                self._gap_bar = gap
            else:
                self._gap_bar = (1 - self.ewma) * self._gap_bar + self.ewma * gap
        self._last = t

    @property
    def rate(self) -> float:
        if self.window is not None:
            if len(self._times) >= 2:
                span = self._times[-1] - self._times[0]
                if span > 0:
                    return (len(self._times) - 1) / span
            return self._init_rate if self._init_rate else float("nan")
        if self._gap_bar is None:
            return self._init_rate if self._init_rate else float("nan")
        return 1.0 / max(self._gap_bar, self.min_gap)

    def snapshot(self) -> dict:
        return {
            "gap_bar": self._gap_bar,
            "last": self._last,
            "times": list(self._times),
            "n_observed": self.n_observed,
        }

    def restore(self, state: dict) -> None:
        self._gap_bar = state["gap_bar"]
        self._last = state["last"]
        self._times.clear()
        self._times.extend(state["times"])
        self.n_observed = state["n_observed"]


@dataclasses.dataclass
class ServingMetrics:
    """Aggregates the objective terms the SMDP policy optimizes, online."""

    quantiles: Dict[float, P2Quantile] = dataclasses.field(
        default_factory=lambda: {q: P2Quantile(q) for q in (0.5, 0.95, 0.99)}
    )
    n_served: int = 0
    latency_sum: float = 0.0
    energy: float = 0.0
    span: float = 0.0
    batch_sum: int = 0
    n_batches: int = 0

    def observe_batch(self, latencies, zeta: float, t_now: float) -> None:
        for lat in latencies:
            self.latency_sum += lat
            self.n_served += 1
            for est in self.quantiles.values():
                est.update(lat)
        self.energy += zeta
        self.span = t_now
        self.batch_sum += len(latencies)
        self.n_batches += 1

    def report(self) -> Dict[str, float]:
        # count-zero lanes report NaN, not 0.0 — a starved replica's
        # "mean latency" is undefined, and 0.0 would win every argmin
        return {
            "W_mean": (
                self.latency_sum / self.n_served
                if self.n_served > 0
                else float("nan")
            ),
            "P50": self.quantiles[0.5].value,
            "P95": self.quantiles[0.95].value,
            "P99": self.quantiles[0.99].value,
            "power": self.energy / self.span if self.span else float("nan"),
            "mean_batch": (
                self.batch_sum / self.n_batches
                if self.n_batches > 0
                else float("nan")
            ),
            "n_served": float(self.n_served),
        }
