"""Exact policy evaluation on the truncated SMDP (eq. 21-22).

Given a stationary deterministic policy (action table over S_hat), compute
the stationary distribution of the induced semi-Markov chain and derive

  g_hat  = sum_s mu_s c^(s, pi(s)) / sum_s mu_s y(s, pi(s))        (eq. 21)
  Delta  = mu_{S_o} c^(S_o, pi(S_o)) / sum_s mu_s y(s, pi(s))      (eq. 22)
  W_bar  = average request response time  (w1-term with w1 = 1)
  P_bar  = average power                  (w2-term with w2 = 1)

Two families of routines live here:

  * numpy evaluation of a *solved* policy on the physical chain
    (stationary distribution -> g / Delta / W_bar / P_bar), copied from
    the reference, the spec-batched forms included;
  * torch evaluation of the *discretized* MDP under frozen policies
    (policy_matrix_banded / policy_eval_linear) over a leading spec axis
    -- the linear-solve polish of the accelerated batched RVI
    (rvi accel="mpi").  Both are dense-free: the (S, A, S) tensor is never
    materialized, only the (S, S) matrix of each frozen policy.

Both families have phase-modulated counterparts on the K*S product chain
of smdp.ModulatedBatchedSMDP (phase-blocked flattening, z * S + s):
evaluate_policy_modulated(_batched) for the physical chain -- delta sums
over *every* phase's overflow state -- and policy_matrix_banded_modulated
feeding the same policy_eval_linear for the MPI polish and exact gain of
the modulated RVI.  Nothing is densified beyond the (K*S, K*S) matrix of
one frozen policy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .smdp import BatchedSMDP, ModulatedBatchedSMDP, TruncatedSMDP


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
    the last state (the scalar chain).  The modulated chain passes a mask
    over every phase's S_o.
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


def stationary_distribution_batched(p: np.ndarray, tol: float = 1e-12):
    """Batched mu P = mu, sum(mu) = 1: one LAPACK call for the whole stack.

    Returns (mu (N, S), ok (N,) bool); rows with ``ok`` False (singular or
    degenerate chains) carry no meaning and must be re-solved per spec —
    evaluate_policy_batched falls back to the scalar path for those.
    """
    n = p.shape[-1]
    a = np.swapaxes(p, -1, -2) - np.eye(n)[None]
    a[:, -1, :] = 1.0
    b = np.zeros((p.shape[0], n))
    b[:, -1] = 1.0
    try:
        mu = np.linalg.solve(a, b[..., None])[..., 0]
    except np.linalg.LinAlgError:
        # one singular matrix poisons the batched call; mark all for retry
        return np.zeros_like(b), np.zeros(p.shape[0], dtype=bool)
    ok = np.isfinite(mu).all(axis=-1)
    mu = np.clip(mu, 0.0, None)
    s = mu.sum(axis=-1)
    ok &= s > tol
    mu = mu / np.where(s > tol, s, 1.0)[:, None]
    return mu, ok


def _finish_from_batch(
    batch: BatchedSMDP, i: int, acts: np.ndarray, mu: np.ndarray
) -> PolicyEval:
    rows = np.arange(batch.n_states)
    return _finish_eval(
        mu,
        acts,
        batch.y[i, rows, acts],
        batch.c_hat[i, rows, acts],
        batch.c_hold[i, rows, acts],
        batch.c_energy[i, rows, acts],
    )


def evaluate_policy_batched(
    batch: BatchedSMDP, policies: Sequence[np.ndarray]
) -> List[PolicyEval]:
    """Per-spec policy evaluation across a BatchedSMDP (aligned with specs).

    The stationary distributions of the whole stack come from ONE batched
    linear solve; specs whose batched solve degenerates fall back to the
    scalar path, preserving its error behaviour.
    """
    if len(policies) != batch.n_specs:
        raise ValueError(f"{len(policies)} policies for {batch.n_specs} specs")
    acts = np.asarray(policies, dtype=np.int64)
    for i in range(batch.n_specs):
        _check_feasible(batch.feasible[i], acts[i])
    p = batch.policy_transitions_batched(acts)
    mu, ok = stationary_distribution_batched(p)
    return [
        _finish_from_batch(batch, i, acts[i], mu[i])
        if ok[i]
        else evaluate_policy_banded(batch, i, acts[i])
        for i in range(batch.n_specs)
    ]


# ---------------------------------------------------------------------------
# Phase-modulated product chain (K*S states, phase-blocked flattening)
# ---------------------------------------------------------------------------


def _gather_modulated(mbatch: ModulatedBatchedSMDP, i: int, acts: np.ndarray):
    """Flattened (K*S,) per-state rows of y/c/hold/energy under a policy."""
    K, S = mbatch.n_phases, mbatch.n_states
    zz = np.arange(K)[:, None]
    ss = np.arange(S)[None, :]
    gather = lambda arr: arr[i, zz, ss, acts].reshape(-1)  # noqa: E731
    return (
        gather(mbatch.y),
        gather(mbatch.c_hat),
        gather(mbatch.c_hold),
        gather(mbatch.c_energy),
    )


def _check_feasible_modulated(
    mbatch: ModulatedBatchedSMDP, i: int, acts: np.ndarray
) -> None:
    K, S = mbatch.n_phases, mbatch.n_states
    if acts.shape != (K, S):
        raise ValueError(f"policy shape {acts.shape} != ({K}, {S})")
    feas = mbatch.feasible[i][np.arange(S)[None, :], acts]
    if not feas.all():
        bad = np.argwhere(~feas)
        raise ValueError(
            f"policy takes infeasible actions at (phase, state) {bad[:5]}"
        )


def _overflow_mask(K: int, S: int) -> np.ndarray:
    m = np.zeros((K, S), dtype=bool)
    m[:, -1] = True
    return m.reshape(-1)


def _finish_modulated(
    mbatch: ModulatedBatchedSMDP, i: int, acts: np.ndarray, mu: np.ndarray
) -> PolicyEval:
    y_pi, c_pi, hold_pi, energy_pi = _gather_modulated(mbatch, i, acts)
    return _finish_eval(
        mu,
        acts.reshape(-1),
        y_pi,
        c_pi,
        hold_pi,
        energy_pi,
        overflow=_overflow_mask(mbatch.n_phases, mbatch.n_states),
    )


def evaluate_policy_modulated(
    mbatch: ModulatedBatchedSMDP, i: int, policy: np.ndarray
) -> PolicyEval:
    """evaluate_policy on the (phase, queue) product chain of spec ``i``.

    ``policy`` is a (K, S) phase-indexed action table.  Delta (the paper's
    tail-tolerance, eq. 22) sums the contribution of every phase's overflow
    state, so the adaptive-truncation rule carries over unchanged.
    """
    acts = np.asarray(policy, dtype=np.int64)
    _check_feasible_modulated(mbatch, i, acts)
    p_pi = mbatch.take([i]).policy_transitions_batched(acts[None])[0]
    mu = stationary_distribution(p_pi)
    return _finish_modulated(mbatch, i, acts, mu)


def evaluate_policy_modulated_batched(
    mbatch: ModulatedBatchedSMDP, policies: np.ndarray
) -> List[PolicyEval]:
    """Per-spec evaluation of (N, K, S) policies: one batched K*S solve.

    Specs whose batched stationary solve degenerates fall back to the
    scalar-path solver, mirroring evaluate_policy_batched.
    """
    acts = np.asarray(policies, dtype=np.int64)
    if acts.shape[0] != mbatch.n_specs:
        raise ValueError(f"{acts.shape[0]} policies for {mbatch.n_specs} specs")
    for i in range(mbatch.n_specs):
        _check_feasible_modulated(mbatch, i, acts[i])
    p = mbatch.policy_transitions_batched(acts)
    mu, ok = stationary_distribution_batched(p)
    return [
        _finish_modulated(
            mbatch, i, acts[i], mu[i] if ok[i] else stationary_distribution(p[i])
        )
        for i in range(mbatch.n_specs)
    ]


# ---------------------------------------------------------------------------
# Dense-free policy evaluation of the *discretized* MDP (m_tilde under a
# frozen policy), over a leading spec axis: the building blocks of the
# modified-policy-iteration polish in rvi.py.  They run on the device of
# their inputs, in their dtype.
# ---------------------------------------------------------------------------


def policy_matrix_banded(pmfs, tails, scale, s_max: int, policy):
    """(N, S, S) discretized transition matrices m_tilde(. | s, pi_n(s)).

    Built from the banded data only (arrival pmfs possibly trimmed to a
    band narrower than s_max + 1, overflow tails, eta / y scale) — the same
    inputs as rvi.banded_backup, and mathematically the rows of
    smdp._dense_m_tilde selected by ``policy``.  The trimmed in-band mass
    (< rvi.BAND_TOL per row) is the only deviation from row-stochasticity.

    pmfs: (N, A, Kb); tails: (N, A, s_max+1); scale: (N, S, A);
    policy: (N, S) int64.  The reference builds one spec per call under
    vmap; here the spec axis is written out.
    """
    N, S, _ = scale.shape
    Kb = pmfs.shape[2]
    dev = scale.device
    s_o = S - 1
    s_idx = torch.arange(S, device=dev)
    s_val = torch.clamp(s_idx, max=s_max)
    a = policy
    sc = torch.gather(scale, 2, a[..., None])[..., 0]  # (N, S)
    serve = a >= 1
    base = torch.clamp(s_val[None, :] - a, 0, s_max)  # (N, S)
    # serve rows: window pmf over columns 0..s_max plus tail mass to S_o
    k = torch.arange(s_max + 1, device=dev)[None, None, :] - base[..., None]
    in_band = (k >= 0) & (k < Kb)
    n_idx = torch.arange(N, device=dev)[:, None]
    window = torch.where(
        in_band & serve[..., None],
        pmfs[n_idx[..., None], a[..., None], torch.clamp(k, 0, Kb - 1)],
        0.0,
    )  # (N, S, s_max+1)
    m_hat = torch.zeros((N, S, S), dtype=scale.dtype, device=dev)
    m_hat[:, :, : s_max + 1] = window
    m_hat[:, :, s_o] += torch.where(serve, tails[n_idx, a, base], 0.0)
    # wait rows: deterministic +1 (S_o self-loops)
    nxt = torch.where(s_idx < s_max, s_idx + 1, s_o)
    wait_rows = torch.zeros((S, S), dtype=scale.dtype, device=dev)
    wait_rows[s_idx, nxt] = 1.0
    m_hat = torch.where(serve[..., None], m_hat, wait_rows)
    # discretize (eq. 23): scale towards eta-uniformization
    return sc[..., None] * m_hat + torch.diag_embed(1.0 - sc)


def policy_eval_linear(c_pi, m_pi, ref_state: int = 0):
    """Exact average-cost evaluation of frozen policies: solve for (g, h).

    The gauge-fixed evaluation equations  h + g*1 = c_pi + M_pi h,
    h[ref] = 0  collapse to one (S, S) linear system per spec by storing g
    in the slot of the pinned unknown: A = (I - M_pi) with column
    ``ref_state`` replaced by ones.  Unichain policies give a nonsingular
    A; a multichain (or otherwise degenerate) policy surfaces as
    non-finite output, which the MPI safeguard in rvi.py rejects (a
    singular A is reported by the LU, not raised, and its row set to NaN).

    c_pi: (N, S); m_pi: (N, S, S).  Returns g (N,), h (N, S).
    """
    S = c_pi.shape[-1]
    a = torch.eye(S, dtype=c_pi.dtype, device=c_pi.device) - m_pi
    a[..., ref_state] = 1.0
    x, info = torch.linalg.solve_ex(a, c_pi[..., None])
    x = torch.where((info == 0)[..., None], x[..., 0], float("nan"))
    g = x[..., ref_state].clone()
    x[..., ref_state] = 0.0
    return g, x


def policy_matrix_banded_modulated(pmfs, tails, wait_m, scale, s_max: int, policy):
    """(N, K*S, K*S) discretized transition matrices of frozen (K, S) policies.

    The modulated analogue of policy_matrix_banded: built from the
    phase-coupled banded data only (pmfs possibly band-trimmed), feeding
    the same policy_eval_linear for the MPI polish and the exact final
    gain of the modulated RVI.  Flattened index = z * S + s.

    pmfs: (N, A, K, K, Kb); tails: (N, A, K, K, s_max+1); wait_m: (N, K, K);
    scale: (N, K, S, A); policy: (N, K, S) int64.  The reference builds one
    spec per call under vmap; here the spec axis is written out.
    """
    N, K, S, _ = scale.shape
    Kb = pmfs.shape[-1]
    dev = scale.device
    s_o = S - 1
    s_idx = torch.arange(S, device=dev)
    s_val = torch.clamp(s_idx, max=s_max)
    a = policy  # (N, K, S)
    sc = torch.gather(scale, 3, a[..., None])[..., 0]  # (N, K, S)
    serve = a >= 1
    base = torch.clamp(s_val - a, 0, s_max)  # (N, K, S)
    k = torch.arange(s_max + 1, device=dev) - base[..., None]  # (N, K, S, s_max+1)
    in_band = (k >= 0) & (k < Kb)
    n_i = torch.arange(N, device=dev)[:, None, None, None, None]
    z_i = torch.arange(K, device=dev)[None, :, None, None, None]
    w_i = torch.arange(K, device=dev)[None, None, None, :, None]
    # window[n, z, s, w, j] = pmfs[n, a[n,z,s], z, w, k[n,z,s,j]]
    window = torch.where(
        (in_band & serve[..., None])[:, :, :, None, :],
        pmfs[n_i, a[..., None, None], z_i, w_i,
             torch.clamp(k, 0, Kb - 1)[:, :, :, None, :]],
        0.0,
    )  # (N, K, S, K, s_max+1)
    m_hat = torch.zeros((N, K, S, K, S), dtype=scale.dtype, device=dev)
    m_hat[..., : s_max + 1] = window
    tail = tails[n_i[..., 0], a[..., None], z_i[..., 0], w_i[..., 0],
                 base[..., None]]  # (N, K, S, K)
    m_hat[..., s_o] += torch.where(serve[..., None], tail, 0.0)
    # wait rows: (z, s) -> (w, s + 1) (S_o self-block) weighted by wait_m
    nxt = torch.where(s_idx < s_max, s_idx + 1, s_o)
    onehot = torch.zeros((S, S), dtype=scale.dtype, device=dev)
    onehot[s_idx, nxt] = 1.0
    wait_rows = wait_m[:, :, None, :, None] * onehot[None, None, :, None, :]
    m_hat = torch.where(serve[..., None, None], m_hat, wait_rows)
    m_flat = m_hat.reshape(N, K * S, K * S)
    sc_flat = sc.reshape(N, K * S)
    return sc_flat[..., None] * m_flat + torch.diag_embed(1.0 - sc_flat)
