"""SMDP construction: truncation, abstract cost, discretization (paper Sec. IV-V).

State space  S_hat = {0, 1, ..., s_max, S_o}; index S_o = s_max + 1.
Action space A     = {0} U {B_min..B_max}; action index == batch size.

Pipeline (paper Sec. V):
  build_smdp()         -> truncated continuous-time SMDP  (m_hat, c_hat, y)  [eq. 18-19]
  discretize           -> associated discrete-time MDP    (m_tilde, c_tilde) [eq. 23-25]
  build_smdp_batched() -> a stack of specs sharing (s_max, b_max), assembled
                          with one broadcast pass; the scalar path is the
                          N == 1 slice of the same construction.

All tensors are dense numpy on the host (S ~ O(100), A ~ O(33)); the iteration
itself (rvi.py) runs in PyTorch.  The batched container keeps only the *banded*
transition data (arrival pmfs + overflow tails) — the (N, S, A, S) dense
tensors are materialized per spec on demand, so a wide sweep stays O(N*S*A)
in memory.

Phase-modulated extension (beyond-paper, ROADMAP "true MMPP-aware solve")
-------------------------------------------------------------------------

build_smdp_modulated() generalizes the state space from ``queue`` to
``(phase, queue)`` for a K-phase Markov-modulated Poisson arrival process
(PhaseConfig: per-phase rates lambda_z and a phase generator R).  The
transition data stays banded — per action the joint law of (arrivals k
during one service, end phase z') is a K x K matrix-valued pmf over the
same k <= s_max band, plus phase-resolved overflow tails and a K x K
arrival-phase matrix for the wait action — computed *exactly* by
uniformizing the marked Markov process at theta >= max_z(lambda_z + q_z):

    D_{n,k} = D_{n-1,k} U0 + D_{n-1,k-1} U1,   D_{0,0} = I,
    U0 = I + (R - Lambda)/theta  (no arrival),  U1 = Lambda/theta  (arrival),
    p^{[a]}_k = sum_n  P(Poisson(theta G_a) = n)  D_{n,k},

where the step-count mixture P(Poisson(theta G_a) = n) is exactly
ServiceModel.arrival_pmf(a, theta, .) — every service family already has it
in closed form.  The phase-modulated holding cost uses the uniformization
identity E[int_0^t f(X_u) du] = (1/theta) sum_n P(N_theta(t) > n) E[f(X_n)].
With K = 1 every quantity degenerates bitwise to the Poisson construction
above (U0 = 0, U1 = 1 makes D_{n,k} = delta_{nk}), which is the refactor's
safety rail: the K = 1 modulated solve must reproduce the scalar oracle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .service_models import ServiceModel, Profile


@dataclasses.dataclass(frozen=True)
class SMDPSpec:
    """Problem definition (paper Sec. III-IV)."""

    lam: float  # Poisson arrival rate
    service: ServiceModel  # G_b family + l(b)
    energy: Profile  # zeta(b)
    b_min: int = 1
    b_max: int = 32
    w1: float = 1.0  # weight on average response time (via holding cost)
    w2: float = 0.0  # weight on average power
    s_max: int = 128  # truncation level (>= b_max)
    c_o: float = 100.0  # abstract overflow-cost rate (paper Sec. V-A)
    buffer: Optional[int] = None  # finite waiting room B (None = abstract tail)
    c_drop: float = 0.0  # per-dropped-request cost (finite buffer only)

    def __post_init__(self):
        if self.s_max < self.b_max:
            raise ValueError("s_max must be >= b_max (paper Sec. V-A)")
        if not (0 < self.b_min <= self.b_max):
            raise ValueError("need 0 < b_min <= b_max")
        if self.c_drop < 0:
            raise ValueError("c_drop must be >= 0")
        if self.buffer is not None:
            if self.buffer != self.s_max:
                raise ValueError(
                    "finite-buffer specs fold exactly at the truncation "
                    f"level: need buffer == s_max, got buffer={self.buffer}, "
                    f"s_max={self.s_max}"
                )
            if self.lam <= 0:
                raise ValueError("need lam > 0")
            # overload (rho >= 1) is allowed: a finite-buffer chain is
            # always stable, and shedding is the regime of interest
            return
        rho = self.rho
        if not (0.0 < rho < 1.0):
            raise ValueError(f"instability: rho={rho:.3f} not in (0,1)")

    @property
    def rho(self) -> float:
        """Normalized traffic intensity lam / (B_max * mu^[B_max])."""
        return self.lam * float(self.service.mean(self.b_max)) / self.b_max


@dataclasses.dataclass
class TruncatedSMDP:
    """Dense truncated SMDP (eq. 18-19) and its discretized MDP (eq. 23)."""

    spec: SMDPSpec
    n_states: int  # s_max + 2
    n_actions: int  # b_max + 1
    feasible: np.ndarray  # (S, A) bool
    y: np.ndarray  # (S, A) expected sojourn times
    c_hat: np.ndarray  # (S, A) expected costs (with abstract cost at S_o)
    m_hat: np.ndarray  # (S, A, S) transition probs
    # discretized
    eta: float
    c_tilde: np.ndarray  # (S, A)
    m_tilde: np.ndarray  # (S, A, S)
    # component costs for objective decomposition (same layout as c_hat)
    c_hold: np.ndarray  # w1-free holding cost integral  E[int s(t) dt]/lam
    c_energy: np.ndarray  # zeta(a) (0 for a=0)
    arrival_pmfs: np.ndarray  # (A, K+1) p_k per action (0 row for a=0)

    @property
    def s_o(self) -> int:
        return self.n_states - 1


@dataclasses.dataclass
class BatchedSMDP:
    """A stack of truncated SMDPs sharing (s_max, b_max).

    Leading axis N indexes specs; the layout of every per-spec slice matches
    TruncatedSMDP.  Transition structure is stored banded — ``pmfs_banded``
    (arrival pmfs truncated to k <= s_max) plus ``tails`` (overflow mass
    towards S_o per base state) — exactly the inputs of rvi.banded_backup.
    """

    specs: List[SMDPSpec]
    n_specs: int
    n_states: int  # S = s_max + 2
    n_actions: int  # A = b_max + 1
    feasible: np.ndarray  # (N, S, A) bool
    y: np.ndarray  # (N, S, A)
    c_hat: np.ndarray  # (N, S, A)
    eta: np.ndarray  # (N,)
    c_tilde: np.ndarray  # (N, S, A), +inf at infeasible
    c_hold: np.ndarray  # (N, S, A)
    c_energy: np.ndarray  # (N, S, A)
    arrival_pmfs: np.ndarray  # (N, A, K+1), K = s_max + 1
    pmfs_banded: np.ndarray  # (N, A, s_max+1): columns k <= s_max
    tails: np.ndarray  # (N, A, s_max+1): overflow mass per base state t
    scale: np.ndarray  # (N, S, A) = eta / y

    @property
    def s_max(self) -> int:
        return self.specs[0].s_max

    @property
    def s_o(self) -> int:
        return self.n_states - 1

    def m_hat_dense(self, i: Optional[int] = None) -> np.ndarray:
        """Materialize the dense (eq. 18) transition tensor.

        Returns (N, S, A, S), or (S, A, S) for a single spec ``i``.
        """
        sel = slice(None) if i is None else slice(i, i + 1)
        m = _dense_m_hat(
            self.specs[0].s_max,
            self.arrival_pmfs[sel],
            self.tails[sel],
            self.feasible[sel],
        )
        return m if i is None else m[0]

    def m_tilde_dense(self, i: Optional[int] = None) -> np.ndarray:
        """Materialize the discretized (eq. 23) transition tensor."""
        sel = slice(None) if i is None else slice(i, i + 1)
        m = _dense_m_tilde(
            self.m_hat_dense()[sel] if i is None else self.m_hat_dense(i)[None],
            self.scale[sel],
            self.feasible[sel],
        )
        return m if i is None else m[0]

    def take(self, indices: Sequence[int]) -> "BatchedSMDP":
        """Sub-batch view over the given spec indices (no re-building)."""
        idx = list(indices)
        return BatchedSMDP(
            specs=[self.specs[i] for i in idx],
            n_specs=len(idx),
            n_states=self.n_states,
            n_actions=self.n_actions,
            feasible=self.feasible[idx],
            y=self.y[idx],
            c_hat=self.c_hat[idx],
            eta=self.eta[idx],
            c_tilde=self.c_tilde[idx],
            c_hold=self.c_hold[idx],
            c_energy=self.c_energy[idx],
            arrival_pmfs=self.arrival_pmfs[idx],
            pmfs_banded=self.pmfs_banded[idx],
            tails=self.tails[idx],
            scale=self.scale[idx],
        )

    def with_c_o(self, c_os: Sequence[float]) -> "BatchedSMDP":
        """Copy of the batch with new per-spec abstract overflow costs.

        c_o only enters the S_o row of c_hat (eq. 19) and its discretized
        c_tilde — transitions, eta and scale are untouched — so swapping it
        is a row patch, not a rebuild.  This is how sweep_solve reuses the
        c_o = 0 probe batch of the abstract-cost calibration as the first
        solve batch.
        """
        c_os = np.asarray(c_os, dtype=np.float64)
        if c_os.shape != (self.n_specs,):
            raise ValueError(f"need {self.n_specs} c_o values")
        old = np.array([sp.c_o for sp in self.specs])
        # finite-buffer specs have no abstract tail: S_o is an exact alias
        # of state B and carries no c_o term, so the patch is a no-op there
        finite = np.array([sp.buffer is not None for sp in self.specs])
        c_os = np.where(finite, old, c_os)
        s_o = self.s_o
        c_hat = self.c_hat.copy()
        c_hat[:, s_o, :] += (c_os - old)[:, None] * self.y[:, s_o, :]
        c_tilde = self.c_tilde.copy()
        with np.errstate(invalid="ignore"):
            c_tilde[:, s_o, :] = np.where(
                self.feasible[:, s_o, :],
                c_hat[:, s_o, :] / self.y[:, s_o, :],
                np.inf,
            )
        return dataclasses.replace(
            self,
            specs=[
                dataclasses.replace(sp, c_o=float(c))
                for sp, c in zip(self.specs, c_os)
            ],
            c_hat=c_hat,
            c_tilde=c_tilde,
        )

    def policy_transitions_batched(self, policies: np.ndarray) -> np.ndarray:
        """(N, S, S) m_hat rows under per-spec policies — no dense tensor.

        The batch-wide form of policy_transitions: one broadcast gather
        instead of N python loops, feeding the batched stationary solve of
        evaluate.evaluate_policy_batched.
        """
        s_max = self.specs[0].s_max
        S = self.n_states
        s_o = S - 1
        N = self.n_specs
        acts = np.asarray(policies, dtype=np.int64)  # (N, S)
        if acts.shape != (N, S):
            raise ValueError(f"policies shape {acts.shape} != ({N}, {S})")
        s_val = _state_values(s_max).astype(np.int64)
        s_idx = np.arange(S)
        serve = acts >= 1
        base = np.clip(s_val[None, :] - acts, 0, s_max)  # (N, S)
        k = np.arange(s_max + 1)[None, None, :] - base[..., None]  # (N, S, K)
        nn = np.arange(N)[:, None, None]
        gathered = self.pmfs_banded[nn, acts[..., None], np.clip(k, 0, s_max)]
        p = np.zeros((N, S, S))
        p[:, :, : s_max + 1] = np.where((k >= 0) & serve[..., None], gathered, 0.0)
        p[:, :, s_o] += np.where(
            serve, self.tails[np.arange(N)[:, None], acts, base], 0.0
        )
        nxt = np.where(s_idx < s_max, s_idx + 1, s_o)
        onehot = np.zeros((S, S))
        onehot[s_idx, nxt] = 1.0
        p = np.where(serve[..., None], p, onehot[None])
        # normalize tiny numerical drift (same rule as the dense path)
        row_sums = p.sum(axis=-1, keepdims=True)
        np.divide(p, row_sums, out=p, where=row_sums > 1e-12)
        return p

    def policy_transitions(self, i: int, policy: np.ndarray) -> np.ndarray:
        """(S, S) m_hat rows of spec ``i`` under ``policy`` — no dense tensor.

        Row s is the arrival-pmf window of the chosen action (eq. 18), so
        policy evaluation over a whole sweep never materializes (S, A, S).
        """
        s_max = self.specs[0].s_max
        S = self.n_states
        s_o = S - 1
        acts = np.asarray(policy, dtype=np.int64)
        s_val = _state_values(s_max).astype(np.int64)
        p = np.zeros((S, S))
        s_idx = np.arange(S)
        wait = acts == 0
        nxt = np.where(s_idx < s_max, s_idx + 1, s_o)
        p[s_idx[wait], nxt[wait]] = 1.0
        serve = ~wait
        if serve.any():
            a_s = acts[serve]
            base = s_val[serve] - a_s  # >= 0 for feasible actions
            k = np.arange(s_max + 1)[None, :] - base[:, None]
            pm = self.pmfs_banded[i]  # (A, s_max+1)
            window = np.where(k >= 0, pm[a_s[:, None], np.clip(k, 0, s_max)], 0.0)
            p[serve, : s_max + 1] = window
            p[serve, s_o] = self.tails[i][a_s, base]
        # normalize tiny numerical drift (same rule as the dense path)
        row_sums = p.sum(axis=-1, keepdims=True)
        np.divide(p, row_sums, out=p, where=row_sums > 1e-12)
        return p

    def dense(self, i: int) -> TruncatedSMDP:
        """Per-spec TruncatedSMDP view with materialized dense tensors."""
        m_hat = self.m_hat_dense(i)
        m_tilde = _dense_m_tilde(
            m_hat[None], self.scale[i : i + 1], self.feasible[i : i + 1]
        )[0]
        return TruncatedSMDP(
            spec=self.specs[i],
            n_states=self.n_states,
            n_actions=self.n_actions,
            feasible=self.feasible[i],
            y=self.y[i],
            c_hat=self.c_hat[i],
            m_hat=m_hat,
            eta=float(self.eta[i]),
            c_tilde=self.c_tilde[i],
            m_tilde=m_tilde,
            c_hold=self.c_hold[i],
            c_energy=self.c_energy[i],
            arrival_pmfs=self.arrival_pmfs[i],
        )


# ---------------------------------------------------------------------------
# Broadcast assembly
# ---------------------------------------------------------------------------


def _state_values(s_max: int) -> np.ndarray:
    """Requests represented by each state index; S_o counts as s_max."""
    s_val = np.arange(s_max + 2, dtype=np.float64)
    s_val[-1] = s_max
    return s_val


def _dense_m_hat(
    s_max: int,
    pmfs: np.ndarray,  # (N, A, K+1)
    tails: np.ndarray,  # (N, A, s_max+1)
    feasible: np.ndarray,  # (N, S, A)
    pmf_tol: float = 1e-12,
) -> np.ndarray:
    """Broadcast construction of the (N, S, A, S) transition tensor (eq. 18)."""
    N, A = pmfs.shape[0], pmfs.shape[1]
    S = s_max + 2
    s_o = S - 1
    K = pmfs.shape[2] - 1
    s_val = _state_values(s_max)
    acts = np.arange(A)

    m = np.zeros((N, S, A, S))
    # a = 0: deterministic +1 (S_o self-loops; s_max -> S_o)
    rows = np.arange(s_max)
    m[:, rows, 0, rows + 1] = 1.0
    m[:, s_max, 0, s_o] = 1.0
    m[:, s_o, 0, s_o] = 1.0
    # a != 0: base state t = s_val(s) - a; arrivals k land at j = t + k
    base = s_val[:, None] - acts[None, :]  # (S, A)
    j = np.arange(s_max + 1)
    k = j[None, None, :] - base[:, :, None]  # (S, A, s_max+1)
    serve = feasible & (acts[None, None, :] >= 1)  # (N, S, A)
    valid = (k >= 0) & serve[..., None]  # (N, S, A, s_max+1)
    k_idx = np.clip(k, 0, K).astype(np.int64)
    gathered = pmfs[:, acts[:, None], k_idx]  # (N, S, A, J)
    m[..., : s_max + 1] += np.where(valid, gathered, 0.0)
    # overflow mass towards S_o
    t_idx = np.clip(base, 0, s_max).astype(np.int64)  # (S, A)
    tail_gather = tails[:, acts, t_idx]  # (N, S, A)
    m[..., s_o] += np.where(serve, tail_gather, 0.0)
    # normalize tiny numerical drift
    row_sums = m.sum(axis=-1, keepdims=True)
    np.divide(m, row_sums, out=m, where=row_sums > pmf_tol)
    return m


def _dense_m_tilde(
    m_hat: np.ndarray,  # (N, S, A, S)
    scale: np.ndarray,  # (N, S, A)
    feasible: np.ndarray,  # (N, S, A)
) -> np.ndarray:
    """Discretized transitions (eq. 23): scale towards eta-uniformization."""
    N, S, A = scale.shape
    idx = np.arange(S)
    m = m_hat * scale[..., None]
    m[:, idx[:, None], np.arange(A)[None, :], idx[:, None]] += 1.0 - scale
    # infeasible rows: harmless self-loop (masked out in the backup anyway)
    inf_mask = ~feasible
    m[inf_mask] = 0.0
    nI, sI, aI = np.nonzero(inf_mask)
    m[nI, sI, aI, sI] = 1.0
    return m


def _finite_buffer_patches(
    s_max: int,
    lam: np.ndarray,  # (N,)
    y_a: np.ndarray,  # (N, A) E[G_a] (1/lam in column 0, unused here)
    e2: np.ndarray,  # (N, A) E[G_a^2]
    pmfs: np.ndarray,  # (N, A, K+1) arrival pmfs
    feasible: np.ndarray,  # (N, S, A)
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact capped-holding corrections and drop counts for B = s_max.

    Serving a from state s leaves t = s - a waiting and c = B - t free
    slots; with N the arrivals during the service (pmf p_k, E[N] =
    lam E[G_a], E[N^2] = lam E[G_a] + lam^2 E[G_a^2]):

      E[drops]  = E[max(0, N - c)] = E[N] - c + sum_{k<=c} (c - k) p_k
      E[excess] = E[int_0^G max(0, N(u) - c) du]
                = (1/lam) sum_{k>c} (k - c) Q_k,      Q_k = P(N > k),

    the excess integral via the Poisson identity E[lam T_k] = Q_k for
    T_k = time spent at count k (exactly one arrival occurs while the
    count sits at k iff N ends above k), closed with sum_k Q_k = E[N]
    and sum_k k Q_k = (E[N^2] - E[N]) / 2:

      sum_{k>c} (k-c) Q_k
        = (E[N^2] - E[N])/2 - c E[N] + sum_{k<=c} (c - k) Q_k.

    Both prefix sums stop at c <= s_max, inside the exactly-known pmf
    band, so no truncation enters.  Returns ``(hold_corr, drops)`` as
    (N, S, A) arrays, zero at wait / infeasible entries; hold_corr is in
    c_hold units (E[int . du] / lam, hence the extra 1/lam).
    """
    N, A = y_a.shape
    S = s_max + 2
    T = s_max + 1
    s_val = _state_values(s_max)
    acts = np.arange(A)
    ks = np.arange(T, dtype=np.float64)
    pm = pmfs[:, :, :T]
    P0 = np.cumsum(pm, axis=-1)  # (N, A, T): sum_{k<=c} p_k
    P1 = np.cumsum(pm * ks, axis=-1)  # sum_{k<=c} k p_k
    Q = np.maximum(0.0, 1.0 - P0)  # Q_c = P(N > c)
    S0 = np.cumsum(Q, axis=-1)  # sum_{k<=c} Q_k
    S1 = np.cumsum(Q * ks, axis=-1)  # sum_{k<=c} k Q_k
    EN = lam[:, None] * y_a  # (N, A) = lam E[G_a]
    EN2 = EN + lam[:, None] ** 2 * e2
    base = s_val[:, None] - acts[None, :]  # (S, A): waiting after dispatch
    c_cap = np.clip(s_max - base, 0, s_max).astype(np.int64)  # free slots
    cf = c_cap.astype(np.float64)
    a_idx = np.broadcast_to(acts[None, :], (S, A))
    P0g = P0[:, a_idx, c_cap]  # (N, S, A)
    P1g = P1[:, a_idx, c_cap]
    S0g = S0[:, a_idx, c_cap]
    S1g = S1[:, a_idx, c_cap]
    drops = EN[:, None, :] - cf[None] + cf[None] * P0g - P1g
    excess = (
        0.5 * (EN2 - EN)[:, None, :]
        - cf[None] * EN[:, None, :]
        + cf[None] * S0g
        - S1g
    )
    serve = feasible & (acts[None, None, :] >= 1)
    drops = np.where(serve, np.maximum(0.0, drops), 0.0)
    hold_corr = np.where(
        serve, np.maximum(0.0, excess) / lam[:, None, None] ** 2, 0.0
    )
    return hold_corr, drops


def build_smdp_batched(specs: Sequence[SMDPSpec]) -> BatchedSMDP:
    """Construct a stacked batch of truncated SMDPs (eq. 18-19, 23-25).

    All specs must share (s_max, b_max) — use sweep.pad_specs to lift a
    mixed-truncation list to a common level.  Arrival rates, weights,
    service families, energy profiles and b_min may vary freely.
    """
    specs = list(specs)
    if not specs:
        raise ValueError("empty spec batch")
    s_max = specs[0].s_max
    b_max = specs[0].b_max
    for sp in specs[1:]:
        if sp.s_max != s_max or sp.b_max != b_max:
            raise ValueError(
                "batched specs must share (s_max, b_max); got "
                f"({sp.s_max}, {sp.b_max}) vs ({s_max}, {b_max})"
            )
    N = len(specs)
    S = s_max + 2
    A = b_max + 1
    s_o = S - 1
    K = s_max + 1
    s_val = _state_values(s_max)
    acts = np.arange(A)
    bs = np.arange(1, A)

    lam = np.array([sp.lam for sp in specs])
    b_min = np.array([sp.b_min for sp in specs])
    w1 = np.array([sp.w1 for sp in specs])
    w2 = np.array([sp.w2 for sp in specs])
    c_o = np.array([sp.c_o for sp in specs])

    # --- per-spec action profiles (vectorized over b; closed-form pmfs) ---
    y_a = np.zeros((N, A))
    e2 = np.zeros((N, A))
    zeta = np.zeros((N, A))
    pmfs = np.zeros((N, A, K + 1))
    for i, sp in enumerate(specs):
        y_a[i, 0] = 1.0 / sp.lam
        y_a[i, 1:] = sp.service.mean(bs)
        e2[i, 1:] = sp.service.second_moment(bs)
        zeta[i, 1:] = sp.energy(bs)
        for a in range(1, A):
            pmfs[i, a] = sp.service.arrival_pmf(a, sp.lam, K)

    # --- feasibility: wait always; serve iff b_min <= a <= s (eq. 8) ---
    feasible = (s_val[None, :, None] >= acts[None, None, :]) & (
        acts[None, None, :] >= b_min[:, None, None]
    )
    feasible[:, :, 0] = True

    # --- sojourn times y(s, a)  (eq. 9): s-independent ---
    y = np.broadcast_to(y_a[:, None, :], (N, S, A)).copy()

    # --- costs (eq. 11, 19) ---
    c_hold = np.zeros((N, S, A))  # = E[int_0^gamma s(t) dt] / lam (w1 term)
    c_hold[:, :, 0] = s_val[None, :] / lam[:, None] ** 2
    c_hold[:, :, 1:] = (
        s_val[None, :, None] * y_a[:, None, 1:] / lam[:, None, None]
        + 0.5 * e2[:, None, 1:]
    )
    c_energy = np.broadcast_to(zeta[:, None, :], (N, S, A)).copy()  # w2 term
    # finite-buffer specs: S_o becomes an exact alias of state B = s_max
    # (the banded backup already serves S_o from base s_max and folds the
    # overflow tail back onto S_o, so duplicating B's cost rows makes the
    # tail-fold the *physical* fold-at-B — an exact chain, not a
    # truncation).  Serve costs get the exact capped-holding correction
    # and the exact expected drop count; waiting at a full buffer sheds
    # the next arrival.  Patches are indexed so tail-abstracted specs in
    # the same batch stay byte-identical to the plain construction.
    finite = np.array([sp.buffer is not None for sp in specs])
    fin_idx = np.nonzero(finite)[0]
    if fin_idx.size:
        c_drop_arr = np.array([sp.c_drop for sp in specs])
        hold_corr, drops = _finite_buffer_patches(
            s_max, lam, y_a, e2, pmfs, feasible
        )
        c_hold[fin_idx] -= hold_corr[fin_idx]
    c_hat = w1[:, None, None] * c_hold + w2[:, None, None] * c_energy
    if fin_idx.size:
        c_hat[fin_idx] += c_drop_arr[fin_idx, None, None] * drops[fin_idx]
        c_hat[fin_idx, s_max, 0] += c_drop_arr[fin_idx]  # wait at B: 1 shed
        c_hat[fin_idx, s_o, 0] += c_drop_arr[fin_idx]  # S_o aliases B
    # abstract cost at the overflow state (eq. 19): + c_o * y(s, a) —
    # tail-abstracted specs only (finite buffers have no abstract tail)
    inf_idx = np.nonzero(~finite)[0]
    c_hat[inf_idx, s_o, :] += c_o[inf_idx, None] * y[inf_idx, s_o, :]

    # --- banded transition data ---
    pm = pmfs[:, :, : s_max + 1].copy()  # k > s_max always lands in S_o
    csum = np.cumsum(pm, axis=-1)
    # tails[i, a, t] = 1 - sum_{k <= s_max - t} p_k  (overflow from base t)
    tails = np.maximum(0.0, 1.0 - csum[:, :, ::-1])
    tails[:, 0, :] = 0.0

    # --- discretization (eq. 23-25) ---
    # structured self-transition probabilities: for feasible (s, a != 0) the
    # diagonal entry is p^{[a]}_a (k = a puts the chain back at s); at S_o it
    # is the overflow tail from base s_max - a; waiting self-loops only at S_o
    diag = np.zeros((N, S, A))
    pm_diag = pm[:, acts, np.minimum(acts, s_max)]  # (N, A): p^{[a]}_a
    diag[:, : s_max + 1, :] = np.where(
        feasible[:, : s_max + 1, :] & (acts[None, None, :] >= 1),
        pm_diag[:, None, :],
        0.0,
    )
    diag[:, s_o, 1:] = tails[:, bs, s_max - bs]
    diag[:, s_o, 0] = 1.0

    with np.errstate(divide="ignore"):
        bound = np.where(
            (diag < 1.0) & feasible, y / np.maximum(1.0 - diag, 1e-300), np.inf
        )
    eta = 0.999 * bound.reshape(N, -1).min(axis=1)
    if not np.all(np.isfinite(eta)) or np.any(eta <= 0):
        raise RuntimeError("degenerate eta bound")

    with np.errstate(invalid="ignore"):
        c_tilde = np.where(feasible, c_hat / y, np.inf)
    scale = eta[:, None, None] / y

    return BatchedSMDP(
        specs=specs,
        n_specs=N,
        n_states=S,
        n_actions=A,
        feasible=feasible,
        y=y,
        c_hat=c_hat,
        eta=eta,
        c_tilde=c_tilde,
        c_hold=c_hold,
        c_energy=c_energy,
        arrival_pmfs=pmfs,
        pmfs_banded=pm,
        tails=tails,
        scale=scale,
    )


def build_smdp(spec: SMDPSpec, pmf_tol: float = 1e-12) -> TruncatedSMDP:
    """Construct the truncated SMDP per eq. (18)-(19).

    The scalar path is the N == 1 slice of the broadcast batched assembly.
    """
    del pmf_tol  # drift normalization is part of the dense materialization
    return build_smdp_batched([spec]).dense(0)


# ---------------------------------------------------------------------------
# Phase-modulated (MMPP-K) product chain
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhaseConfig:
    """K-phase MMPP arrival modulation: per-phase rates + phase generator.

    ``rates[z]`` is the Poisson arrival rate while the modulating chain sits
    in phase z; ``gen`` is the K x K generator of that (autonomous) chain —
    rows sum to zero, off-diagonals non-negative.  Arrivals never switch the
    phase (MMPP, not MAP).  K = 1 with gen = ((0,),) is plain Poisson.
    """

    rates: Tuple[float, ...]
    gen: Tuple[Tuple[float, ...], ...]

    def __post_init__(self):
        rates = np.asarray(self.rates, dtype=np.float64)
        R = np.asarray(self.gen, dtype=np.float64)
        K = len(rates)
        if R.shape != (K, K):
            raise ValueError(f"gen shape {R.shape} != ({K}, {K})")
        if np.any(rates < 0) or not np.any(rates > 0):
            raise ValueError("phase rates must be >= 0 with at least one > 0")
        off = R - np.diag(np.diag(R))
        if np.any(off < -1e-12):
            raise ValueError("generator off-diagonals must be >= 0")
        if np.any(np.abs(R.sum(axis=1)) > 1e-9 * max(1.0, np.abs(R).max())):
            raise ValueError("generator rows must sum to 0")

    @property
    def n_phases(self) -> int:
        return len(self.rates)

    @property
    def rates_arr(self) -> np.ndarray:
        return np.asarray(self.rates, dtype=np.float64)

    @property
    def gen_arr(self) -> np.ndarray:
        return np.asarray(self.gen, dtype=np.float64)

    def stationary(self) -> np.ndarray:
        """Stationary distribution pi of the phase generator (pi R = 0)."""
        K = self.n_phases
        if K == 1:
            return np.ones(1)
        a = self.gen_arr.T.copy()
        a[-1, :] = 1.0
        b = np.zeros(K)
        b[-1] = 1.0
        pi = np.linalg.solve(a, b)
        pi = np.clip(pi, 0.0, None)
        return pi / pi.sum()

    @property
    def mean_rate(self) -> float:
        """Long-run average arrival rate sum_z pi_z lambda_z."""
        return float(self.stationary() @ self.rates_arr)

    def scaled(self, factor: float) -> "PhaseConfig":
        """Copy with every phase rate scaled (same burst structure).

        The lambda axis of a modulated sweep bank: scaling rates (not
        dwells) moves the mean rate while preserving the rate *ratio* and
        the switching dynamics.
        """
        return PhaseConfig(
            rates=tuple(float(r) * float(factor) for r in self.rates),
            gen=self.gen,
        )

    @classmethod
    def mmpp2(
        cls, lam1: float, lam2: float, dwell1: float, dwell2: float
    ) -> "PhaseConfig":
        """Two-phase MMPP from rates + mean dwell times (serving.MMPP2)."""
        return cls(
            rates=(float(lam1), float(lam2)),
            gen=(
                (-1.0 / dwell1, 1.0 / dwell1),
                (1.0 / dwell2, -1.0 / dwell2),
            ),
        )

    @classmethod
    def from_mmpp(cls, m) -> "PhaseConfig":
        """Coerce an MMPP2-like object (lam1/lam2/dwell1/dwell2 attrs)."""
        return cls.mmpp2(m.lam1, m.lam2, m.dwell1, m.dwell2)

    @classmethod
    def poisson(cls, lam: float) -> "PhaseConfig":
        """The degenerate K = 1 config (the bit-identity safety rail)."""
        return cls(rates=(float(lam),), gen=((0.0,),))


def modulated_spec(base: SMDPSpec, phases: PhaseConfig) -> SMDPSpec:
    """Pin the spec's lam to the modulation's mean rate (rho bookkeeping)."""
    return dataclasses.replace(base, lam=phases.mean_rate)


def phase_rho(spec: SMDPSpec, phases: PhaseConfig) -> float:
    """Worst *within-phase* traffic intensity of a modulated spec.

    The burst phase sets the solver's mixing wall even when the mean rho
    is small, so acceleration decisions key on this, not on spec.rho.
    """
    return (
        float(phases.rates_arr.max())
        * float(spec.service.mean(spec.b_max))
        / spec.b_max
    )


@dataclasses.dataclass
class ModulatedBatchedSMDP:
    """A stack of phase-modulated truncated SMDPs sharing (s_max, b_max, K).

    The product state space per spec is (phase z, queue state s) with
    s in {0..s_max, S_o}; the flattened index order is z * S + s (phase
    blocks).  Transition data stays banded and phase-coupled:

      * ``pmfs_banded[n, a, z, w, k]`` — P(k arrivals in band, end phase w |
        start phase z, serve a);
      * ``tails[n, a, z, w, t]``       — overflow mass to (w, S_o) from base
        state t;
      * ``wait_m[n, z, w]``            — P(next arrival occurs in phase w |
        start phase z) for the wait action (sojourn ``y[., z, :, 0]``).

    Feasibility is phase-independent ((N, S, A), same rule as the scalar
    chain); costs/sojourns/scales carry the phase axis ((N, K, S, A)).
    There is deliberately no dense materialization — every consumer
    (rvi/evaluate/sweep) operates on the K*S banded system.
    """

    specs: List[SMDPSpec]
    phases: List[PhaseConfig]
    n_specs: int
    n_phases: int  # K
    n_states: int  # S = s_max + 2 (per phase)
    n_actions: int  # A = b_max + 1
    feasible: np.ndarray  # (N, S, A) bool — phase-independent
    y: np.ndarray  # (N, K, S, A)
    c_hat: np.ndarray  # (N, K, S, A)
    eta: np.ndarray  # (N,)
    c_tilde: np.ndarray  # (N, K, S, A), +inf at infeasible
    c_hold: np.ndarray  # (N, K, S, A)
    c_energy: np.ndarray  # (N, K, S, A)
    scale: np.ndarray  # (N, K, S, A) = eta / y
    pmfs_banded: np.ndarray  # (N, A, K, K, s_max+1)
    tails: np.ndarray  # (N, A, K, K, s_max+1)
    wait_m: np.ndarray  # (N, K, K)
    lam_eff: np.ndarray  # (N,) mean arrival rates

    @property
    def s_max(self) -> int:
        return self.specs[0].s_max

    @property
    def s_o(self) -> int:
        return self.n_states - 1

    def take(self, indices: Sequence[int]) -> "ModulatedBatchedSMDP":
        """Sub-batch view over the given spec indices (no re-building)."""
        idx = list(indices)
        return ModulatedBatchedSMDP(
            specs=[self.specs[i] for i in idx],
            phases=[self.phases[i] for i in idx],
            n_specs=len(idx),
            n_phases=self.n_phases,
            n_states=self.n_states,
            n_actions=self.n_actions,
            feasible=self.feasible[idx],
            y=self.y[idx],
            c_hat=self.c_hat[idx],
            eta=self.eta[idx],
            c_tilde=self.c_tilde[idx],
            c_hold=self.c_hold[idx],
            c_energy=self.c_energy[idx],
            scale=self.scale[idx],
            pmfs_banded=self.pmfs_banded[idx],
            tails=self.tails[idx],
            wait_m=self.wait_m[idx],
            lam_eff=self.lam_eff[idx],
        )

    def with_c_o(self, c_os: Sequence[float]) -> "ModulatedBatchedSMDP":
        """Copy with new per-spec abstract overflow costs (row patch).

        Exactly the BatchedSMDP.with_c_o trick: c_o only enters the S_o rows
        of c_hat (every phase's overflow state) and their c_tilde.
        """
        c_os = np.asarray(c_os, dtype=np.float64)
        if c_os.shape != (self.n_specs,):
            raise ValueError(f"need {self.n_specs} c_o values")
        old = np.array([sp.c_o for sp in self.specs])
        s_o = self.s_o
        c_hat = self.c_hat.copy()
        c_hat[:, :, s_o, :] += (c_os - old)[:, None, None] * self.y[:, :, s_o, :]
        c_tilde = self.c_tilde.copy()
        with np.errstate(invalid="ignore"):
            c_tilde[:, :, s_o, :] = np.where(
                self.feasible[:, None, s_o, :],
                c_hat[:, :, s_o, :] / self.y[:, :, s_o, :],
                np.inf,
            )
        return dataclasses.replace(
            self,
            specs=[
                dataclasses.replace(sp, c_o=float(c))
                for sp, c in zip(self.specs, c_os)
            ],
            c_hat=c_hat,
            c_tilde=c_tilde,
        )

    def policy_transitions_batched(self, policies: np.ndarray) -> np.ndarray:
        """(N, K*S, K*S) embedded-chain (m_hat) rows under per-spec policies.

        ``policies`` is (N, K, S) int.  Feeds the batched stationary solve
        of evaluate.evaluate_policy_modulated_batched; rows are normalized
        against the ~1e-13 uniformization-truncation drift, the same rule
        as the scalar banded path.
        """
        N, K, S = self.n_specs, self.n_phases, self.n_states
        s_max = self.s_max
        s_o = S - 1
        acts = np.asarray(policies, dtype=np.int64)
        if acts.shape != (N, K, S):
            raise ValueError(f"policies shape {acts.shape} != ({N}, {K}, {S})")
        s_val = _state_values(s_max).astype(np.int64)  # (S,)
        serve = acts >= 1  # (N, K, S)
        base = np.clip(s_val[None, None, :] - acts, 0, s_max)  # (N, K, S)
        k = (
            np.arange(s_max + 1)[None, None, None, :] - base[..., None]
        )  # (N, K, S, s_max+1)
        nn = np.arange(N)[:, None, None, None, None]
        zz = np.arange(K)[None, :, None, None, None]
        ww = np.arange(K)[None, None, None, :, None]
        a_idx = acts[:, :, :, None, None]
        k_idx = np.clip(k, 0, s_max)[:, :, :, None, :]
        # window[n, z, s, w, j] = p^{[a]}_{j - base}[z -> w]
        window = np.where(
            (k[:, :, :, None, :] >= 0) & serve[..., None, None],
            self.pmfs_banded[nn, a_idx, zz, ww, k_idx],
            0.0,
        )  # (N, K, S, K, s_max+1)
        p = np.zeros((N, K, S, K, S))
        p[..., : s_max + 1] = window
        tail = self.tails[
            nn[..., 0], acts[..., None], zz[..., 0], ww[..., 0],
            base[..., None],
        ]  # (N, K, S, K)
        p[..., s_o] += np.where(serve[..., None], tail, 0.0)
        # wait rows: (z, s) -> (w, s + 1) (S_o absorbs) with wait_m weights
        s_idx = np.arange(S)
        nxt = np.where(s_idx < s_max, s_idx + 1, s_o)
        wait_rows = np.zeros((N, K, S, K, S))
        # advanced indices split by a slice put the broadcast (S,) axis first
        wait_rows[:, :, s_idx, :, nxt] = self.wait_m[None]
        p = np.where(serve[..., None, None], p, wait_rows)
        p = p.reshape(N, K * S, K * S)
        row_sums = p.sum(axis=-1, keepdims=True)
        np.divide(p, row_sums, out=p, where=row_sums > 1e-12)
        return p


def _modulated_action_data(
    spec: SMDPSpec,
    phases: PhaseConfig,
    tol: float = 1e-13,
    n_cap: int = 1 << 15,
    chunk: int = 128,
):
    """Exact per-action phase-coupled arrival law via marked uniformization.

    Returns (pmfs (A, K, K, T), tails (A, K, K, T), wait_m (K, K),
    y_wait (K,), c_extra (A, K), lam_eff) for one spec; see the module
    docstring for the recursion.  ``c_extra[a, z]`` is
    E[int_0^{G_a} N(u) du | phase z at start] — the arrivals' holding-cost
    integral during one service (the modulated analogue of lam E[G^2]/2).
    """
    rates = phases.rates_arr
    R = phases.gen_arr
    K = len(rates)
    s_max = spec.s_max
    T = s_max + 1
    A = spec.b_max + 1
    theta = float(np.max(rates - np.diag(R)))
    if theta <= 0:
        raise ValueError("degenerate modulation: all rates and switching 0")
    Lam = np.diag(rates)
    U0 = np.eye(K) + (R - Lam) / theta
    U1 = Lam / theta
    Pi = U0 + U1  # phase-marginal uniformized step, = I + R/theta

    # steps-per-service mixture: P(Poisson(theta * G_a) = n), exact per family
    n_hi = 256
    while True:
        W = np.zeros((A, n_hi + 1))
        for a in range(1, A):
            W[a] = spec.service.arrival_pmf(a, theta, n_hi)
        miss = 1.0 - W[1:].sum(axis=1)
        if miss.max() <= tol or n_hi >= n_cap:
            break
        n_hi *= 2
    if miss.max() > 1e-9:
        raise RuntimeError(
            f"uniformized step distribution not captured at n = {n_hi} "
            f"(missing mass {miss.max():.2e}); theta * l(b_max) too large"
        )

    # recursion over uniformized steps, chunked einsum accumulation
    P = np.zeros((A, T, K, K))  # p^{[a]}_k[z, w], k <= s_max
    Phi_a = np.zeros((A, K, K))  # E[Pi^steps] per action (end-phase law)
    E = np.zeros((n_hi + 1, K))  # e_n[z] = E[N_n | z]
    Dk = np.zeros((T, K, K))
    Dk[0] = np.eye(K)
    Mn = np.eye(K)
    uv = rates / theta  # u_m = Pi^m (lambda/theta), m = 0
    e = np.zeros(K)
    d_buf, m_buf, n0 = [], [], [0]

    def flush(n_end):
        if not d_buf:
            return
        Ds = np.stack(d_buf)  # (C, T, K, K)
        Ms = np.stack(m_buf)  # (C, K, K)
        Wc = W[:, n0[0]:n_end]  # (A, C)
        np.add(P, np.einsum("ac,ctzw->atzw", Wc, Ds), out=P)
        np.add(Phi_a, np.einsum("ac,czw->azw", Wc, Ms), out=Phi_a)
        d_buf.clear()
        m_buf.clear()
        n0[0] = n_end

    for n in range(n_hi + 1):
        E[n] = e
        d_buf.append(Dk.copy())
        m_buf.append(Mn.copy())
        if len(d_buf) >= chunk:
            flush(n + 1)
        if n == n_hi:
            break
        # advance: D_{n+1,k} = D_{n,k} U0 + D_{n,k-1} U1; M_{n+1} = M_n Pi
        Dn = Dk @ U0
        Dn[1:] += Dk[:-1] @ U1
        Dk = Dn
        Mn = Mn @ Pi
        e = e + uv
        uv = Pi @ uv
    flush(n_hi + 1)

    # normalize the captured phase-transition law row-stochastic (the
    # missing <= tol step mass redistributes proportionally; K = 1 divides
    # by itself, keeping the Poisson path bit-identical)
    row = Phi_a.sum(axis=-1, keepdims=True)
    Phi_n = np.divide(Phi_a, row, out=np.zeros_like(Phi_a), where=row > 1e-12)

    # overflow tails per base state t: what the band k <= s_max - t misses
    csum = np.cumsum(P, axis=1)  # (A, T, K, K) cumulative over k
    tails = np.maximum(0.0, Phi_n[:, None] - csum[:, ::-1])  # index t
    tails[0] = 0.0
    P[0] = 0.0

    # holding-cost integral of in-service arrivals (uniformization identity)
    tail_w = np.maximum(0.0, 1.0 - np.cumsum(W, axis=1))  # (A, n_hi+1)
    c_extra = (tail_w @ E) / theta  # (A, K)
    c_extra[0] = 0.0

    # wait action: time-to-next-arrival phase law
    y_wait = np.linalg.solve(Lam - R, np.ones(K))
    wait_m = np.linalg.solve(Lam - R, Lam)
    if np.any(y_wait <= 0) or not np.all(np.isfinite(wait_m)):
        raise RuntimeError("degenerate wait-time law; check rates/generator")

    lam_eff = phases.mean_rate
    return (
        P.transpose(0, 2, 3, 1),  # (A, K, K, T)
        tails.transpose(0, 2, 3, 1),  # (A, K, K, T)
        wait_m,
        y_wait,
        c_extra,
        lam_eff,
    )


def build_smdp_modulated_batched(
    specs: Sequence[SMDPSpec],
    phases: Sequence[PhaseConfig],
) -> ModulatedBatchedSMDP:
    """Construct a stacked batch of phase-modulated truncated SMDPs.

    ``specs`` and ``phases`` align; all specs must share (s_max, b_max) and
    all phase configs the same K.  Each spec's ``lam`` must equal its
    modulation's mean rate (use ``modulated_spec``) so rho bookkeeping — and
    hence sweep ordering/acceleration thresholds — stays meaningful.
    """
    specs = list(specs)
    phases = list(phases)
    if not specs:
        raise ValueError("empty spec batch")
    if len(phases) != len(specs):
        raise ValueError(f"{len(phases)} phase configs for {len(specs)} specs")
    s_max = specs[0].s_max
    b_max = specs[0].b_max
    K = phases[0].n_phases
    for sp, ph in zip(specs, phases):
        if sp.buffer is not None:
            raise NotImplementedError(
                "finite-buffer builds are Poisson-only; use "
                "build_smdp_batched (the overload-aware serving tables)"
            )
        if sp.s_max != s_max or sp.b_max != b_max:
            raise ValueError("modulated batch must share (s_max, b_max)")
        if ph.n_phases != K:
            raise ValueError("modulated batch must share the phase count K")
        if abs(sp.lam - ph.mean_rate) > 1e-9 * max(1.0, ph.mean_rate):
            raise ValueError(
                f"spec.lam = {sp.lam} != modulation mean rate "
                f"{ph.mean_rate}; build specs via modulated_spec()"
            )
    N = len(specs)
    S = s_max + 2
    A = b_max + 1
    s_o = S - 1
    T = s_max + 1
    s_val = _state_values(s_max)
    acts = np.arange(A)
    bs = np.arange(1, A)

    pmfs = np.zeros((N, A, K, K, T))
    tails = np.zeros((N, A, K, K, T))
    wait_m = np.zeros((N, K, K))
    y_wait = np.zeros((N, K))
    c_extra = np.zeros((N, A, K))
    lam_eff = np.zeros(N)
    for i, (sp, ph) in enumerate(zip(specs, phases)):
        (
            pmfs[i],
            tails[i],
            wait_m[i],
            y_wait[i],
            c_extra[i],
            lam_eff[i],
        ) = _modulated_action_data(sp, ph)

    b_min = np.array([sp.b_min for sp in specs])
    w1 = np.array([sp.w1 for sp in specs])
    w2 = np.array([sp.w2 for sp in specs])
    c_o = np.array([sp.c_o for sp in specs])

    y_a = np.zeros((N, A))
    zeta = np.zeros((N, A))
    for i, sp in enumerate(specs):
        y_a[i, 1:] = sp.service.mean(bs)
        zeta[i, 1:] = sp.energy(bs)

    # feasibility: phase-independent, same rule as the scalar chain (eq. 8)
    feasible = (s_val[None, :, None] >= acts[None, None, :]) & (
        acts[None, None, :] >= b_min[:, None, None]
    )
    feasible[:, :, 0] = True

    # sojourn times: wait depends on the phase, service does not
    y = np.broadcast_to(y_a[:, None, None, :], (N, K, S, A)).copy()
    y[..., 0] = y_wait[:, :, None]

    # costs: holding integral / lam_eff (Little), energy, abstract overflow
    c_hold = np.zeros((N, K, S, A))
    c_hold[..., 0] = (
        s_val[None, None, :] * y_wait[:, :, None] / lam_eff[:, None, None]
    )
    c_extra_t = c_extra.transpose(0, 2, 1)  # (N, K, A)
    c_hold[..., 1:] = (
        s_val[None, None, :, None] * y_a[:, None, None, 1:]
        + c_extra_t[:, :, None, 1:]
    ) / lam_eff[:, None, None, None]
    c_energy = np.broadcast_to(zeta[:, None, None, :], (N, K, S, A)).copy()
    c_hat = w1[:, None, None, None] * c_hold + w2[:, None, None, None] * c_energy
    c_hat[:, :, s_o, :] += c_o[:, None, None] * y[:, :, s_o, :]

    # eta bound from structured self-transition probabilities
    diag = np.zeros((N, K, S, A))
    # serve at s <= s_max: return iff k = a and the phase is unchanged
    zz = np.arange(K)
    for a in range(1, A):
        diag[:, :, : s_max + 1, a] = np.where(
            feasible[:, None, : s_max + 1, a],
            pmfs[:, a, zz, zz, min(a, s_max)][:, :, None],
            0.0,
        )
        diag[:, :, s_o, a] = tails[:, a, zz, zz, s_max - a]
    diag[:, :, s_o, 0] = wait_m[:, zz, zz]

    feas_k = np.broadcast_to(feasible[:, None], (N, K, S, A))
    with np.errstate(divide="ignore"):
        bound = np.where(
            (diag < 1.0) & feas_k, y / np.maximum(1.0 - diag, 1e-300), np.inf
        )
    eta = 0.999 * bound.reshape(N, -1).min(axis=1)
    if not np.all(np.isfinite(eta)) or np.any(eta <= 0):
        raise RuntimeError("degenerate eta bound (modulated)")

    with np.errstate(invalid="ignore"):
        c_tilde = np.where(feas_k, c_hat / y, np.inf)
    scale = eta[:, None, None, None] / y

    return ModulatedBatchedSMDP(
        specs=specs,
        phases=phases,
        n_specs=N,
        n_phases=K,
        n_states=S,
        n_actions=A,
        feasible=feasible,
        y=y,
        c_hat=c_hat,
        eta=eta,
        c_tilde=c_tilde,
        c_hold=c_hold,
        c_energy=c_energy,
        scale=scale,
        pmfs_banded=pmfs,
        tails=tails,
        wait_m=wait_m,
        lam_eff=lam_eff,
    )


def build_smdp_modulated(
    spec: SMDPSpec, phases: PhaseConfig
) -> ModulatedBatchedSMDP:
    """The N == 1 modulated build (banded container; never densified)."""
    return build_smdp_modulated_batched([spec], [phases])
