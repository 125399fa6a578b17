"""Latency-energy tradeoff sweeps (paper Fig. 5/7/8/9) and benchmark grids.

All weight grids route through sweep.sweep_solve: the whole w2 axis is
stacked into one BatchedSMDP and solved by the batched lockstep RVI on the
device, instead of re-building and re-dispatching per point.  The
benchmark policies (greedy, static-b) are evaluated in numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from .evaluate import evaluate_policy
from .policies import greedy_policy, static_policy
from .smdp import SMDPSpec, build_smdp
from .solve import SolveResult, solve
from .sweep import sweep_solve


@dataclasses.dataclass
class TradeoffPoint:
    w2: float
    w_bar: float
    p_bar: float
    g: float
    policy: np.ndarray


def smdp_tradeoff_curve(
    base: SMDPSpec,
    w2_values: Sequence[float],
    eps: float = 1e-2,
    delta: float = 1e-3,
    backup: str = "banded",
    *,
    device: DeviceLike = None,
) -> List[TradeoffPoint]:
    """Sweep w2 (w1 fixed) -> (W_bar, P_bar) pairs of SMDP solutions.

    ``backup`` ("banded" | "pallas") is forwarded to sweep_solve.
    """
    specs = [dataclasses.replace(base, w2=float(w2)) for w2 in w2_values]
    results = sweep_solve(specs, eps=eps, delta=delta, backup=backup, device=device)
    return [
        TradeoffPoint(
            w2=float(w2),
            w_bar=res.eval.w_bar,
            p_bar=res.eval.p_bar,
            g=res.eval.g,
            policy=res.policy,
        )
        for w2, res in zip(w2_values, results)
    ]


def benchmark_points(
    spec: SMDPSpec, static_sizes: Iterable[int] = (8, 16, 32)
) -> Dict[str, Tuple[float, float]]:
    """(W_bar, P_bar) for greedy + static-b benchmark policies."""
    mdp = build_smdp(spec)
    out: Dict[str, Tuple[float, float]] = {}
    g = greedy_policy(spec.s_max, spec.b_min, spec.b_max)
    ev = evaluate_policy(mdp, g)
    out["greedy"] = (ev.w_bar, ev.p_bar)
    for b in static_sizes:
        if b > spec.b_max:
            continue
        pol = static_policy(b, spec.s_max)
        try:
            ev = evaluate_policy(mdp, pol)
        except RuntimeError:
            continue  # unstable under this static size
        out[f"static_{b}"] = (ev.w_bar, ev.p_bar)
    return out


def average_cost_grid(
    base: SMDPSpec,
    w2_values: Sequence[float],
    static_sizes: Iterable[int] = (8, 16, 32),
    eps: float = 1e-2,
    delta: float = 1e-3,
    *,
    backup: str = "banded",
    device: DeviceLike = None,
) -> Dict[str, List[float]]:
    """Paper Fig. 4: average cost per unit time of each policy vs w2.

    Benchmark policies are weight-independent; their *cost* depends on the
    weights through the objective.  g(policy) = w1 * W_bar_term + w2 * P_bar
    where W_bar_term re-uses the evaluator's decomposition.  The SMDP column
    solves the entire w2 grid in one batched call; ``backup`` ("banded" |
    "pallas") is forwarded to sweep_solve.
    """
    mdp = build_smdp(base)
    bench: Dict[str, Tuple[float, float]] = {}
    gp = greedy_policy(base.s_max, base.b_min, base.b_max)
    ev = evaluate_policy(mdp, gp)
    bench["greedy"] = (ev.w_bar, ev.p_bar)
    for b in static_sizes:
        pol = static_policy(b, base.s_max)
        try:
            ev = evaluate_policy(mdp, pol)
            bench[f"static_{b}"] = (ev.w_bar, ev.p_bar)
        except RuntimeError:
            bench[f"static_{b}"] = (float("inf"), float("inf"))

    specs = [dataclasses.replace(base, w2=float(w2)) for w2 in w2_values]
    results = sweep_solve(specs, eps=eps, delta=delta, backup=backup, device=device)

    out: Dict[str, List[float]] = {k: [] for k in bench}
    out["smdp"] = []
    for w2, res in zip(w2_values, results):
        out["smdp"].append(base.w1 * res.eval.w_bar + float(w2) * res.eval.p_bar)
        for k, (w_bar, p_bar) in bench.items():
            out[k].append(base.w1 * w_bar + float(w2) * p_bar)
    return out


def solve_serial(
    base: SMDPSpec,
    w2_values: Sequence[float],
    eps: float = 1e-2,
    delta: float = 1e-3,
    *,
    device: DeviceLike = None,
) -> List[SolveResult]:
    """Per-point serial loop (the pre-batched path), the baseline of sweep
    timings and of equivalence tests."""
    results = []
    s_max = base.s_max
    for w2 in w2_values:
        spec = dataclasses.replace(base, w2=float(w2), s_max=s_max)
        res = solve(spec, eps=eps, delta=delta, device=device)
        s_max = res.spec.s_max  # warm-start truncation level for next weight
        results.append(res)
    return results
