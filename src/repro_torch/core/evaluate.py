"""Exact policy evaluation on the truncated SMDP (eq. 21-22).

Given a stationary deterministic policy (action table over S_hat), compute
the stationary distribution of the induced semi-Markov chain and derive

  g_hat  = sum_s mu_s c^(s, pi(s)) / sum_s mu_s y(s, pi(s))        (eq. 21)
  Delta  = mu_{S_o} c^(S_o, pi(S_o)) / sum_s mu_s y(s, pi(s))      (eq. 22)
  W_bar  = average request response time  (w1-term with w1 = 1)
  P_bar  = average power                  (w2-term with w2 = 1)

The numpy evaluators of a *solved* policy on the physical chain, copied
from the reference.  The batched evaluators and the linear-solve polish
of the accelerated RVI come with the batched slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .smdp import BatchedSMDP, TruncatedSMDP


@dataclasses.dataclass
class PolicyEval:
    g: float  # average weighted cost per unit time (with spec's w1, w2)
    delta: float  # tail-state contribution (approximation quality, eq. 22)
    w_bar: float  # average response time
    p_bar: float  # average power consumption
    mu: np.ndarray  # stationary distribution over S_hat
    mean_batch: float  # average served batch size
    throughput: float  # served requests per unit time


def stationary_distribution(p: np.ndarray, tol: float = 1e-12) -> np.ndarray:
    """Solve mu P = mu, sum(mu) = 1 via a dense linear solve."""
    n = p.shape[0]
    a = p.T - np.eye(n)
    a[-1, :] = 1.0
    b = np.zeros(n)
    b[-1] = 1.0
    try:
        mu = np.linalg.solve(a, b)
    except np.linalg.LinAlgError:
        mu = np.linalg.lstsq(a, b, rcond=None)[0]
    mu = np.clip(mu, 0.0, None)
    s = mu.sum()
    if s <= tol:
        raise RuntimeError("degenerate stationary distribution")
    return mu / s


def _check_feasible(feasible: np.ndarray, acts: np.ndarray) -> np.ndarray:
    S = feasible.shape[0]
    if acts.shape != (S,):
        raise ValueError(f"policy shape {acts.shape} != ({S},)")
    rows = np.arange(S)
    feas = feasible[rows, acts]
    if not feas.all():
        bad = rows[~feas]
        raise ValueError(f"policy takes infeasible actions at states {bad[:5]}")
    return rows


def _finish_eval(
    mu: np.ndarray,
    acts: np.ndarray,
    y_pi: np.ndarray,
    c_pi: np.ndarray,
    hold_pi: np.ndarray,
    energy_pi: np.ndarray,
    overflow: Optional[np.ndarray] = None,
) -> PolicyEval:
    """Aggregate (g, Delta, W_bar, P_bar, ...) from mu and gathered rows.

    ``overflow`` marks the overflow state(s) for the Delta term; default is
    the last state (the scalar chain).
    """
    denom = float(mu @ y_pi)
    g = float(mu @ c_pi) / denom
    if overflow is None:
        delta = float(mu[-1] * c_pi[-1]) / denom
    else:
        delta = float(mu[overflow] @ c_pi[overflow]) / denom

    # objective decomposition (abstract cost excluded — it is a solver device,
    # not part of the physical objective)
    w_bar = float(mu @ hold_pi) / denom  # = L_bar / lam = W_bar (Little)
    p_bar = float(mu @ energy_pi) / denom

    served = acts.astype(np.float64)
    mean_batch = float(mu @ (served * (served > 0))) / max(
        float(mu @ (served > 0)), 1e-300
    )
    throughput = float(mu @ served) / denom
    return PolicyEval(
        g=g,
        delta=delta,
        w_bar=w_bar,
        p_bar=p_bar,
        mu=mu,
        mean_batch=mean_batch,
        throughput=throughput,
    )


def evaluate_policy(mdp: TruncatedSMDP, policy: np.ndarray) -> PolicyEval:
    acts = np.asarray(policy, dtype=np.int64)
    rows = _check_feasible(mdp.feasible, acts)
    p_pi = mdp.m_hat[rows, acts, :]
    mu = stationary_distribution(p_pi)
    return _finish_eval(
        mu,
        acts,
        mdp.y[rows, acts],
        mdp.c_hat[rows, acts],
        mdp.c_hold[rows, acts],
        mdp.c_energy[rows, acts],
    )


def evaluate_policy_banded(
    batch: BatchedSMDP, i: int, policy: np.ndarray
) -> PolicyEval:
    """evaluate_policy for spec ``i`` of a batch, from banded data only.

    Mathematically identical to evaluating batch.dense(i) but never
    materializes the (S, A, S) transition tensor — the hot path of sweeps.
    """
    acts = np.asarray(policy, dtype=np.int64)
    rows = _check_feasible(batch.feasible[i], acts)
    p_pi = batch.policy_transitions(i, acts)
    mu = stationary_distribution(p_pi)
    return _finish_eval(
        mu,
        acts,
        batch.y[i, rows, acts],
        batch.c_hat[i, rows, acts],
        batch.c_hold[i, rows, acts],
        batch.c_energy[i, rows, acts],
    )
