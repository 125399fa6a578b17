"""Relative value iteration (Algorithm 1) and its accelerants, in PyTorch.

The discrete-time backup is

    J_{i+1}(s) = min_{a in A_s} { c~(s,a) + sum_j m~(j|s,a) H_i(j) }      (29)
    H_{i+1}(s) = J_{i+1}(s) - J_{i+1}(s*)

with span-based stopping.  Backup implementations (``backup=``):

  * dense  — contraction against the (S, A, S) transition tensor;
  * banded — exploits the transition structure m(j|s,a) = p^{[a]}_{j-s+a}:
             per action the backup is a windowed correlation of H with the
             arrival pmf, an O(A*S*K) computation instead of O(A*S^2);
             plain tensor ops, the oracle of the kernel path;
  * pallas — the same banded math with the correlation core on the
             hand-written CUDA kernel (kernels/csrc/bellman.cu) in float32;
             the batched loops launch its spec-batched form once per
             lockstep backup.  The name is the reference's, so callers
             switch packages without renaming.

The casts around the kernel's f32 core are the reference's (``h`` and
``h(S_o)`` to f32, ``G`` back to the loop's dtype).  Every loop is a
Python loop over device tensors: the reference's ``while_loop`` condition
becomes one device -> host read per backup, and nothing else is read
inside a loop (except Anderson's rejection branch, below).

Batched solves (relative_value_iteration_batched) run every spec of a
BatchedSMDP in lockstep, with three paths (``accel=``):

  * "none"     — plain lockstep RVI; with ``mixed_precision`` a float32
    coarse phase on the narrow band, then a float64 lockstep from it;
  * "mpi"      — modified policy iteration: every ``accel_period``
    backups the greedy policy is frozen and h is polished by the exact
    gauge-fixed policy-evaluation linear solve (evaluate.
    policy_matrix_banded / policy_eval_linear), accepted per spec only
    where it is finite and shrinks the span residual;
  * "anderson" — span-seminorm-safe Anderson: gauge-fixed secant history,
    Tikhonov-regularized least squares, and a per-spec safeguard backup
    that refuses span-increasing steps.  The reference's lax.cond on
    "every spec took its candidate" becomes a host branch: the one read
    of an iteration carries that flag with the loop condition, and only
    an iteration where some spec refused reads a second time.

Both accelerants finish with an exact linear-solve gain of the final
greedy policy.  ``guard=True`` wraps a batched solve in the reference's
fallback ladder (SolveReport).  The scalar float64 ``solve()`` path stays
the untouched oracle these are tested against.

relative_value_iteration_modulated runs the same lockstep / MPI loops on
the (phase, queue) product chain of a ModulatedBatchedSMDP, always in
float64 torch ops (the reference's phase-coupled correlation is a
jnp.einsum outside any Pallas kernel).  avi / api are the reference's
numpy Appendix-F baselines.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .evaluate import (
    policy_eval_linear,
    policy_matrix_banded,
    policy_matrix_banded_modulated,
)
from .smdp import TruncatedSMDP, build_smdp

F64 = torch.float64
F32 = torch.float32

#: rho at which the MPI polish starts paying for itself — below it plain
#: lockstep converges in ~100 backups and the polish machinery is pure
#: overhead; above it mixing slows exponentially and MPI wins big.  Shared
#: by every accel="auto" decision (sweep_solve).
ACCEL_RHO_THRESHOLD = 0.5


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
    """The Q-backup h -> q with its index tensors built once.

    One spec: c_tilde/scale (S, A), m_tilde (S, A, S) (dense only), pmfs
    (A, K) arrival pmfs over k <= s_max (row 0 unused, possibly
    band-trimmed), tails (A, s_max + 1), h (S,).  A spec batch puts a
    leading N on every array (the reference's vmap, written out; banded
    and pallas only).  "pallas" runs the correlation core on the CUDA
    kernel in float32 -- one launch per backup, of the scalar or the
    spec-batched kernel by the inputs' rank.
    """
    if kind == "dense":
        return lambda h: c_tilde + torch.einsum("saj,j->sa", m_tilde, h)
    if kind not in ("banded", "pallas"):
        raise ValueError(f"unknown backup {kind!r}")
    dev = c_tilde.device
    S, A = c_tilde.shape[-2:]
    T = s_max + 1  # base states 0..s_max
    K = pmfs.shape[-1]
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
        pmfs_t = pmfs.transpose(-1, -2)
        tails_t = tails.transpose(-1, -2)

        def core(h):
            hwin = torch.where(valid, h[..., j_c], 0.0)
            return hwin @ pmfs_t + tails_t * h[..., S - 1, None, None]  # (.., T, A)
    else:
        from ..kernels import ops as kops

        batched = c_tilde.dim() == 3
        launch = kops.bellman_backup_batched if batched else kops.bellman_backup
        pmfs32 = pmfs.to(F32).contiguous()
        tails32 = tails.transpose(-1, -2).to(F32).contiguous()

        def core(h):
            h_main = torch.zeros(h.shape[:-1] + (T + K,), dtype=F32, device=dev)
            h_main[..., :T] = h[..., :T].to(F32)
            G = launch(h_main, pmfs32, tails32, h[..., S - 1], device=dev)
            return G.to(h.dtype)

    def backup(h):
        mh = core(h)[..., base_c, act_idx]  # (.., S, A)
        mh[..., 0] = h[..., nxt]
        return c_tilde + scale * mh + one_minus_scale * h[..., None]

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
    accel_period: int = 6,
    accel_memory: int = 5,
    accel_safeguard: bool = True,
    *,
    device: DeviceLike = None,
) -> RVIResult:
    """Solve the discretized MDP; the policy is eps-optimal for the SMDP.

    ``accel`` ("none" | "mpi" | "anderson") routes through the accelerated
    batched machinery with N = 1 (see relative_value_iteration_batched);
    the default stays the plain loop — the exact oracle path of solve().
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if accel != "none":
        if backup == "dense":
            raise ValueError("accelerated RVI requires a banded backup")
        pmfs, tails, scale = make_banded_inputs(mdp, device=dev)
        pm_full = pmfs.cpu().numpy()  # (A, s_max+1) f64
        pm_trim = pmfs[:, : trimmed_band(pm_full)]
        c_tilde = torch.as_tensor(mdp.c_tilde, dtype=F64, device=dev)
        policies, g, h, span, it_conv, _, _ = _run_accel(
            c_tilde[None], pm_trim[None], tails[None], scale[None],
            mdp.spec.s_max, eps, eps_rel, max_iter, accel, backup, None,
            accel_period, accel_memory, accel_safeguard,
        )
        span_f = float(span[0])
        g_f = float(g[0])
        return RVIResult(
            policy=policies[0],
            g=g_f,
            h=h[0],
            iterations=int(it_conv[0]),
            span=span_f,
            converged=span_f < max(eps, eps_rel * abs(g_f)),
            wall_time_s=time.perf_counter() - t0,
        )
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


# ---------------------------------------------------------------------------
# Batched RVI: the whole spec sweep advances in lockstep, one backup per step
# ---------------------------------------------------------------------------


def pallas_backup_batched(c_tilde, pmfs, tails, scale, s_max: int, h):
    """Spec-batched pallas_backup: one launch of the spec-batched CUDA
    kernel; a CPU tensor runs the kernel's plain version.  banded_backup
    takes the same batched arrays.

    c_tilde/scale: (N, S, A); pmfs: (N, A, K); tails: (N, A, T); h: (N, S).
    """
    return _make_backup("pallas", c_tilde, None, pmfs, tails, scale, s_max)(h)


@dataclasses.dataclass
class BatchedRVIResult:
    """Per-spec RVI outputs for a BatchedSMDP, leading axis = spec."""

    policies: np.ndarray  # (N, S)
    g: np.ndarray  # (N,)
    h: np.ndarray  # (N, S)
    iterations: np.ndarray  # (N,) backup count at which each spec converged
    span: np.ndarray  # (N,)
    converged: np.ndarray  # (N,) bool
    wall_time_s: float
    accel: str = "none"  # which accelerant produced this result
    accel_accepts: Optional[np.ndarray] = None  # (N,) accepted accel steps
    accel_rejects: Optional[np.ndarray] = None  # (N,) span-increasing steps
    #   (taken when safeguard is off, refused when it is on)
    report: Optional["SolveReport"] = None  # guard=True attaches certificates

    def unstack(self, i: int) -> RVIResult:
        return RVIResult(
            policy=self.policies[i],
            g=float(self.g[i]),
            h=self.h[i],
            iterations=int(self.iterations[i]),
            span=float(self.span[i]),
            converged=bool(self.converged[i]),
            wall_time_s=self.wall_time_s / len(self.g),
        )


# ---------------------------------------------------------------------------
# Guardrail ladder: per-spec NaN/Inf sentinels + divergence detection, with
# an automatic fallback ladder so one pathological spec degrades to a slower
# solve path (or a per-spec quarantine re-solve) instead of poisoning the
# whole batch.  Enabled with guard=True; core.sweep turns it on by default.
# The ladder catches no exception: a kernel that fails to build or launch
# raises through it.  On a CUDA device with backup="pallas" a row that the
# banded rung heals raises too: the kernel disagreed with its plain version
# there (see _ladder).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SolveReport:
    """Residual certificates + guardrail record of one batched solve.

    ``span`` against ``eps`` (with the relative floor already folded into
    ``converged``) is the per-spec convergence certificate.  A spec is
    ``healthy`` when its g/h are finite AND it converged.  ``rungs`` maps
    each fallback rung that fired to the spec rows it was applied to (in
    the order tried); ``quarantined`` rows were re-solved through the
    scalar float64 oracle path; ``failed`` rows stayed unhealthy after the
    entire ladder (their outputs carry NaN/Inf — the batch still
    completes, callers decide what to do with those rows).
    """

    eps: float
    span: np.ndarray  # (N,) final span residuals
    converged: np.ndarray  # (N,) bool
    healthy: np.ndarray  # (N,) bool — finite g/h and converged
    rungs: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    quarantined: List[int] = dataclasses.field(default_factory=list)
    failed: List[int] = dataclasses.field(default_factory=list)

    @property
    def any_fired(self) -> bool:
        return bool(self.rungs) or bool(self.quarantined)

    @staticmethod
    def merged(
        parts: Sequence[Tuple["SolveReport", Sequence[int]]],
        n: int,
        eps: float,
    ) -> "SolveReport":
        """Fold per-batch reports into one n-spec report (sweep rounds).

        ``parts`` pairs each report with the caller-level index of every
        batch row; later parts overwrite earlier ones per spec (a regrown
        spec's final solve wins), and a spec counts as failed only if its
        LAST solve left it unhealthy.
        """
        span = np.full(n, np.nan)
        converged = np.zeros(n, dtype=bool)
        healthy = np.zeros(n, dtype=bool)
        rungs: Dict[str, List[int]] = {}
        quarantined: List[int] = []
        ever_failed: set = set()
        for rep, rows in parts:
            rows = list(rows)
            span[rows] = rep.span
            converged[rows] = rep.converged
            healthy[rows] = rep.healthy
            for name, applied in rep.rungs.items():
                rungs.setdefault(name, []).extend(rows[i] for i in applied)
            quarantined.extend(rows[i] for i in rep.quarantined)
            ever_failed.update(rows[i] for i in rep.failed)
        return SolveReport(
            eps=eps,
            span=span,
            converged=converged,
            healthy=healthy,
            rungs=rungs,
            quarantined=sorted(set(quarantined)),
            failed=sorted(i for i in ever_failed if not healthy[i]),
        )


def _spec_health(res: BatchedRVIResult) -> np.ndarray:
    """(N,) bool NaN/Inf sentinel + divergence check per spec."""
    g = np.asarray(res.g, dtype=np.float64)
    h = np.asarray(res.h, dtype=np.float64).reshape(g.shape[0], -1)
    finite = np.isfinite(g) & np.isfinite(h).all(axis=-1)
    return finite & np.asarray(res.converged, dtype=bool)


def _writable(res: BatchedRVIResult) -> BatchedRVIResult:
    """Copy the per-spec arrays so ladder rungs can patch rows in place."""
    return dataclasses.replace(
        res,
        policies=np.array(res.policies),
        g=np.array(res.g, dtype=np.float64),
        h=np.array(res.h, dtype=np.float64),
        iterations=np.array(res.iterations),
        span=np.array(res.span, dtype=np.float64),
        converged=np.array(res.converged, dtype=bool),
    )


def _patch_rows(
    res: BatchedRVIResult, sub: BatchedRVIResult, dst: np.ndarray, src: np.ndarray
) -> None:
    res.policies[dst] = np.asarray(sub.policies)[src]
    res.g[dst] = np.asarray(sub.g)[src]
    res.h[dst] = np.asarray(sub.h)[src]
    res.iterations[dst] = np.asarray(sub.iterations)[src]
    res.span[dst] = np.asarray(sub.span)[src]
    res.converged[dst] = np.asarray(sub.converged)[src]


def _ladder(
    backup: str, mixed_precision: bool, accel: str, h0, device: torch.device
) -> Tuple[List[Tuple[str, dict]], bool]:
    """The reference's rungs in the reference's order, and whether the
    banded rung checks the kernel.

    The rungs are the same on every device.  On a CUDA device with
    backup="pallas" (``True``) the ``backup_banded`` rung runs the kernel's
    own precision, accelerant and warm start with only the correlation core
    swapped for its plain version, so a row it heals is one the kernel left
    unhealthy while the plain core solved it: _guarded_batched raises for
    such rows instead of patching them.  Rows it cannot heal either (a NaN
    spec, a poisoned warm start, an f32 conditioning loss) are the spec's
    fault and go on down the ladder.
    """
    ladder = []
    bk = backup
    if bk == "pallas":
        ladder.append(
            ("backup_banded", dict(mp=mixed_precision, ac=accel, bk="banded", drop_h0=False))
        )
        bk = "banded"
    if accel != "none" or h0 is not None:
        ladder.append(
            ("plain_restart", dict(mp=mixed_precision, ac="none", bk=bk, drop_h0=True))
        )
    if mixed_precision:
        ladder.append(
            ("float64", dict(mp=False, ac="none", bk=bk, drop_h0=True))
        )
    return ladder, backup == "pallas" and device.type == "cuda"


def _guarded_batched(
    batch,
    eps: float,
    max_iter: int,
    eps_rel: float,
    h0,
    mixed_precision: bool,
    accel: str,
    backup: str,
    accel_kw: dict,
    device: torch.device,
) -> BatchedRVIResult:
    """Guardrail ladder around the batched RVI (see SolveReport).

    Rung order mirrors likely-culprit order: the kernel backup falls back
    to the banded backup, the accelerant (and any caller-supplied warm
    start — a poisoned anchor h0 turns every row NaN) falls back to the
    plain lockstep loop, mixed precision falls back to single-phase
    float64, and rows that survive all of that are quarantined: re-solved
    one by one through the scalar float64 oracle path.  Only the unhealthy
    rows ride each rung, so a healthy batch pays one numpy health check.
    On a CUDA device with backup="pallas" a row that the banded rung heals
    raises (the kernel disagrees with its plain version there, _ladder);
    every other row follows the reference's rungs, so the report is the
    reference's on every device.
    """

    def run(b, h0_, mp, ac, bk):
        return relative_value_iteration_batched(
            b,
            eps=eps,
            max_iter=max_iter,
            eps_rel=eps_rel,
            h0=h0_,
            mixed_precision=mp,
            accel=ac,
            backup=bk,
            device=device,
            **accel_kw,
        )

    res = run(batch, h0, mixed_precision, accel, backup)
    healthy = _spec_health(res)
    rungs: Dict[str, List[int]] = {}
    quarantined: List[int] = []
    failed: List[int] = []
    if not healthy.all():
        res = _writable(res)
        bad = np.flatnonzero(~healthy)
        ladder, kernel_checked = _ladder(backup, mixed_precision, accel, h0, device)
        for name, opt in ladder:
            if bad.size == 0:
                break
            sub = batch.take([int(i) for i in bad])
            sub_h0 = (
                None
                if (opt["drop_h0"] or h0 is None)
                else np.asarray(h0)[bad]
            )
            sub_res = run(sub, sub_h0, opt["mp"], opt["ac"], opt["bk"])
            ok = _spec_health(sub_res)
            if kernel_checked and name == "backup_banded" and ok.any():
                raise RuntimeError(
                    f"batched RVI rows {[int(i) for i in bad[ok]]} are non-finite or "
                    "unconverged on the CUDA Bellman kernel but healthy on its plain "
                    "(banded) version with the same precision, accelerant and warm "
                    "start: the kernel disagrees with its plain version"
                )
            rungs[name] = [int(i) for i in bad]
            if ok.any():
                _patch_rows(res, sub_res, bad[ok], np.flatnonzero(ok))
            bad = bad[~ok]
        if bad.size:
            rungs["quarantine"] = [int(i) for i in bad]
            for i in bad:
                i = int(i)
                quarantined.append(i)
                oracle = relative_value_iteration(
                    build_smdp(batch.specs[i]),
                    eps=eps,
                    max_iter=max_iter,
                    backup="banded",
                    eps_rel=eps_rel,
                    accel="none",
                    device=device,
                )
                if (
                    np.isfinite(oracle.g)
                    and np.isfinite(oracle.h).all()
                    and oracle.converged
                ):
                    res.policies[i] = oracle.policy
                    res.g[i] = oracle.g
                    res.h[i] = oracle.h
                    res.iterations[i] = oracle.iterations
                    res.span[i] = oracle.span
                    res.converged[i] = True
                else:
                    failed.append(i)
        healthy = _spec_health(res)
    return dataclasses.replace(
        res,
        report=SolveReport(
            eps=eps,
            span=np.asarray(res.span),
            converged=np.asarray(res.converged),
            healthy=healthy,
            rungs=rungs,
            quarantined=quarantined,
            failed=failed,
        ),
    )


def _thresh(g, eps: float, eps_rel: float):
    # relative criterion: costs scale with w2, so a purely absolute span
    # threshold stalls convergence detection for large weights
    return torch.clamp(eps_rel * g.abs(), min=eps)


def _span(diff):
    return diff.amax(dim=-1) - diff.amin(dim=-1)


def _greedy(backup, h):
    """The policy of h: first argmin of its backup (as jnp.argmin)."""
    return torch.argmin(backup(h), dim=-1)


def _rvi_loop_batched(
    c_tilde,  # (N, S, A)
    pmfs,  # (N, A, K)
    tails,  # (N, A, T)
    scale,  # (N, S, A)
    eps: float,
    eps_rel: float,
    max_iter: int,
    s_max: int,
    h0=None,  # (N, S) warm start; zeros when None
    ref_state: int = 0,
    backup_kind: str = "banded",
):
    """Vectorized Algorithm 1: every spec runs the backup in lockstep.

    The loop stops when EVERY spec's span is below its (relative)
    threshold; already-converged specs keep refining, which only tightens
    their h.  ``it_conv`` records the backup at which each spec first
    converged.  The final argmin uses the same backup kind (so the kernel
    path launches once more).
    """
    N, S, _ = c_tilde.shape
    backup = _make_backup(backup_kind, c_tilde, None, pmfs, tails, scale, s_max)
    dt, dev = c_tilde.dtype, c_tilde.device
    h = torch.zeros((N, S), dtype=dt, device=dev) if h0 is None else h0.to(dt)
    span = torch.full((N,), math.inf, dtype=dt, device=dev)
    g = torch.zeros((N,), dtype=dt, device=dev)
    it_conv = torch.full((N,), -1, dtype=torch.int64, device=dev)
    i, running = 0, True
    while i < max_iter and running:
        j = backup(h).amin(dim=-1)
        g = j[:, ref_state]
        h_new = j - g[:, None]
        span = _span(h_new - h)
        th = _thresh(g, eps, eps_rel)
        it_conv = torch.where((span < th) & (it_conv < 0), i + 1, it_conv)
        h = h_new
        i += 1
        running = bool((span >= th).any())  # one device -> host read
    policies = _greedy(backup, h)
    it_conv = torch.where(it_conv < 0, i, it_conv)
    return policies, g, h, i, span, it_conv


def _rvi_loop_batched_mpi(
    c_tilde,
    pmfs,
    tails,
    scale,
    eps: float,
    eps_rel: float,
    max_iter: int,
    s_max: int,
    backup_kind: str = "banded",
    period: int = 10,
    h0=None,
    ref_state: int = 0,
):
    """Batched modified policy iteration: RVI backups + periodic exact polish.

    Every ``period`` backups the greedy policy is frozen and h is replaced
    by its exact gauge-fixed policy evaluation (one batched linear solve),
    followed by one verification backup through the same backup kind.
    The polish is accepted per spec only where it is finite and shrinks
    the span residual, and never touches specs that already converged —
    so the loop is at worst plain RVI plus an amortized O(S^3/period)
    overhead.  The period test is a host integer; the loop condition is
    the one read per iteration.
    """
    N, S, _ = c_tilde.shape
    backup = _make_backup(backup_kind, c_tilde, None, pmfs, tails, scale, s_max)
    dt, dev = c_tilde.dtype, c_tilde.device

    def bell(h):
        q = backup(h)
        j = q.amin(dim=-1)
        g = j[:, ref_state]
        return q, j - g[:, None], g

    h = torch.zeros((N, S), dtype=dt, device=dev) if h0 is None else h0.to(dt)
    span = torch.full((N,), math.inf, dtype=dt, device=dev)
    g = torch.zeros((N,), dtype=dt, device=dev)
    it_conv = torch.full((N,), -1, dtype=torch.int64, device=dev)
    acc = torch.zeros((N,), dtype=torch.int64, device=dev)
    rej = torch.zeros_like(acc)
    it = nb = 0
    running = True
    while it < max_iter and running:
        q, hb, g = bell(h)
        nb += 1
        span = _span(hb - h)
        conv = span < _thresh(g, eps, eps_rel)
        if (it + 1) % period == 0:
            pol = torch.argmin(q, dim=-1)
            m_pi = policy_matrix_banded(pmfs, tails, scale, s_max, pol)
            c_pi = torch.gather(c_tilde, 2, pol[..., None])[..., 0]
            g_pol, h_pol = policy_eval_linear(c_pi, m_pi, ref_state)
            _, hb2, g2 = bell(h_pol)
            span2 = _span(hb2 - h_pol)
            ok = (
                torch.isfinite(g_pol)
                & torch.isfinite(h_pol).all(dim=-1)
                & (span2 < span)
                & ~conv
            )
            h = torch.where(ok[:, None], hb2, hb)
            span = torch.where(ok, span2, span)
            g = torch.where(ok, g2, g)
            nb += 1
            acc = acc + ok
            rej = rej + (~ok & ~conv)
        else:
            h = hb
        th = _thresh(g, eps, eps_rel)
        it_conv = torch.where((span < th) & (it_conv < 0), nb, it_conv)
        it += 1
        running = bool((span >= th).any())  # one device -> host read
    # exact final policy extraction always on the banded path
    policies = _greedy(
        _make_backup("banded", c_tilde, None, pmfs, tails, scale, s_max), h
    )
    it_conv = torch.where(it_conv < 0, nb, it_conv)
    return policies, g, h, nb, span, it_conv, acc, rej


def _rvi_loop_batched_anderson(
    c_tilde,
    pmfs,
    tails,
    scale,
    eps: float,
    eps_rel: float,
    max_iter: int,
    s_max: int,
    backup_kind: str = "banded",
    memory: int = 5,
    safeguard: bool = True,
    h0=None,
    ref_state: int = 0,
    reg: float = 1e-8,
):
    """Span-seminorm-safe Anderson acceleration of the batched RVI.

    Each iteration extrapolates a candidate from the last ``memory``
    gauge-fixed secant pairs (Tikhonov-regularized least squares), then
    evaluates it with one backup and accepts it per spec only where its
    span residual does not exceed the current one.  Rejected specs fall
    back to the plain gauge-fixed backup step (one shared extra backup,
    paid only on iterations where some spec rejects) and restart their
    history.  With an empty history the candidate IS the plain step.
    ``safeguard=False`` always takes the finite candidate: the
    known-divergent textbook variant, kept for the regression test.
    """
    N, S, _ = c_tilde.shape
    M = memory
    backup = _make_backup(backup_kind, c_tilde, None, pmfs, tails, scale, s_max)
    dt, dev = c_tilde.dtype, c_tilde.device

    def bell(h):
        j = backup(h).amin(dim=-1)
        g = j[:, ref_state]
        return j - g[:, None], g

    h = torch.zeros((N, S), dtype=dt, device=dev) if h0 is None else h0.to(dt)
    hb0, g = bell(h)
    r = hb0 - h
    span = _span(r)
    it_conv = torch.full((N,), -1, dtype=torch.int64, device=dev)
    dh = torch.zeros((N, M, S), dtype=dt, device=dev)
    dr = torch.zeros_like(dh)
    valid = torch.zeros((N, M), dtype=torch.bool, device=dev)
    acc = torch.zeros((N,), dtype=torch.int64, device=dev)
    rej = torch.zeros_like(acc)
    eye = torch.eye(M, dtype=dt, device=dev)
    it, nb = 0, 1
    running = bool((span >= _thresh(g, eps, eps_rel)).any())
    while it < max_iter and running:
        # plain step: h + r is the gauge-fixed backup of h (already computed)
        h_pl = h + r
        # Anderson candidate: regularized secant over gauge-fixed history
        # (empty history -> gamma = 0 -> the candidate is the plain step)
        vm = valid[..., None]
        rm = torch.where(vm, dr, 0.0)  # (N, M, S)
        gram = torch.einsum("nms,nks->nmk", rm, rm)
        rhs = torch.einsum("nms,ns->nm", rm, r)
        tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
        lam = (reg * tr / M + 1e-30)[:, None, None] * eye
        gamma, info = torch.linalg.solve_ex(gram + lam, rhs[..., None])
        gamma = torch.where((info == 0)[:, None], gamma[..., 0], float("nan"))
        h_cand = h_pl - torch.einsum(
            "nm,nms->ns", gamma, torch.where(vm, dh, 0.0) + rm
        )
        h_cand = h_cand - h_cand[:, ref_state][:, None]  # pin the gauge
        hb_c, g_c = bell(h_cand)
        r_c = hb_c - h_cand
        span_c = _span(r_c)
        nb += 1
        has_hist = valid.any(dim=-1)
        finite = (torch.isfinite(h_cand) & torch.isfinite(r_c)).all(dim=-1)
        worse = span_c > span  # the step the safeguard exists to refuse
        if safeguard:
            take = finite & ~worse
        else:
            take = finite & (has_hist | ~worse)
        rej = rej + (has_hist & finite & worse)
        acc = acc + (take & has_hist)
        # one read: did every spec take its candidate, and if so, does the
        # loop go on (span_new = span_c, g_new = g_c in that case)
        all_take, go_on = torch.stack(
            (take.all(), (span_c >= _thresh(g_c, eps, eps_rel)).any())
        ).tolist()
        if all_take:
            h_new, r_new, g_new, span_new = h_cand, r_c, g_c, span_c
        else:
            # some spec refused its candidate: one shared plain backup
            hb_pl, g_pl = bell(h_pl)
            nb += 1
            h_new = torch.where(take[:, None], h_cand, h_pl)
            r_new = torch.where(take[:, None], r_c, hb_pl - h_pl)
            g_new = torch.where(take, g_c, g_pl)
            span_new = torch.where(take, span_c, _span(r_new))
        # history update: safe-mode rejection restarts the window
        if safeguard:
            valid = valid & take[:, None]
        slot = it % M
        dh[:, slot] = h_new - h
        dr[:, slot] = r_new - r
        valid[:, slot] = True
        h, r, g, span = h_new, r_new, g_new, span_new
        th = _thresh(g, eps, eps_rel)
        it_conv = torch.where((span < th) & (it_conv < 0), nb, it_conv)
        it += 1
        running = bool(go_on) if all_take else bool((span >= th).any())
    policies = _greedy(
        _make_backup("banded", c_tilde, None, pmfs, tails, scale, s_max), h
    )
    it_conv = torch.where(it_conv < 0, nb, it_conv)
    return policies, g, h, nb, span, it_conv, acc, rej


def _exact_gain(c_tilde, pmfs, tails, scale, s_max, policies, ref_state=0):
    """Exact (linear-solve) gain + relative values of frozen greedy policies."""
    m_pi = policy_matrix_banded(pmfs, tails, scale, s_max, policies)
    c_pi = torch.gather(c_tilde, 2, policies[..., None])[..., 0]
    return policy_eval_linear(c_pi, m_pi, ref_state)


def _exact_or_loop(c_tilde, pmfs, tails, scale, s_max, policies, g, h):
    """(g, h) as numpy: the exact linear-solve evaluation of ``policies``
    wherever it is finite, the loop's own fixed-point estimates elsewhere."""
    g_exact, h_exact = _exact_gain(c_tilde, pmfs, tails, scale, s_max, policies)
    g_exact, h_exact = g_exact.cpu().numpy(), h_exact.cpu().numpy()
    ok = np.isfinite(g_exact) & np.isfinite(h_exact).all(axis=-1)
    g = np.where(ok, g_exact, g.cpu().numpy())
    h = np.where(ok[:, None], h_exact, h.cpu().numpy())
    return g, h


def _run_accel(
    c_tilde,  # (N, S, A)
    pmfs,  # (N, A, Kb), band-trimmed
    tails,  # (N, A, T)
    scale,  # (N, S, A)
    s_max: int,
    eps: float,
    eps_rel: float,
    max_iter: int,
    accel: str,
    backup: str,
    h0,
    period: int,
    memory: int,
    safeguard: bool,
):
    """Run an accelerated loop, then the exact final gain.

    Inputs are tensors on one device, in one dtype.  Returns (policies,
    g, h, span, it_conv, accepts, rejects) as numpy.  ``g`` / ``h`` are
    the exact linear-solve evaluation of the final greedy policy wherever
    that solve is finite; the loop's own estimates back them up otherwise.
    """
    loop_args = (c_tilde, pmfs, tails, scale, eps, eps_rel, max_iter, s_max)
    if accel == "mpi":
        out = _rvi_loop_batched_mpi(
            *loop_args, backup_kind=backup, period=period, h0=h0
        )
    elif accel == "anderson":
        out = _rvi_loop_batched_anderson(
            *loop_args,
            backup_kind=backup,
            memory=memory,
            safeguard=safeguard,
            h0=h0,
        )
    else:
        raise ValueError(f"unknown accel {accel!r}")
    policies, g, h, _, span, it_conv, acc, rej = out
    g, h = _exact_or_loop(c_tilde, pmfs, tails, scale, s_max, policies, g, h)
    return (
        policies.cpu().numpy(),
        g,
        h,
        span.cpu().numpy(),
        it_conv.cpu().numpy(),
        acc.cpu().numpy(),
        rej.cpu().numpy(),
    )


def relative_value_iteration_batched(
    batch,  # BatchedSMDP
    eps: float = 1e-2,
    max_iter: int = 10_000,
    eps_rel: float = 2e-4,
    h0: Optional[np.ndarray] = None,
    mixed_precision: bool = True,
    accel: str = "none",
    backup: str = "banded",
    accel_period: int = 6,
    accel_memory: int = 5,
    accel_safeguard: bool = True,
    guard: bool = False,
    *,
    device: DeviceLike = None,
) -> BatchedRVIResult:
    """Solve every spec of a BatchedSMDP in lockstep on ``device``.

    ``h0`` (N, S) warm-starts the relative values (any h0 converges to the
    same fixed point; a good one gets there in fewer lockstep iterations).

    ``accel`` selects the solve path (see the module docstring):
      * "none"     — plain lockstep RVI.  With ``mixed_precision`` the bulk
        runs in float32 on the narrow band (trimmed at 1e-8) with floored
        stopping thresholds max(eps, 1e-4) / max(eps_rel, 1e-5), and a
        float64 banded lockstep finishes from the float32 fixed point.
      * "mpi"      — modified policy iteration (the high-rho default of
        the sweep engine); with ``mixed_precision`` an f32 accelerated
        coarse phase, then an f64 lockstep and the exact f64 gain.
      * "anderson" — span-safe restarted Anderson with ``accel_memory``
        secant pairs; ``accel_safeguard=False`` exposes the unsafeguarded
        (divergent) textbook variant for tests.
    ``iterations`` counts Bellman backups (including safeguard
    verification backups) so plain and accelerated counts compare.

    ``backup`` ("banded" | "pallas") picks the backup of the lockstep
    phase that runs it (the f32 coarse phase, or the single f64 phase of
    the accelerated paths); the final policy extraction of the
    accelerated loops and the f64 finish always use the banded path, so
    policies are stable across backends.

    ``guard=True`` wraps the solve in the guardrail ladder and attaches a
    SolveReport; healthy batches return results identical to guard=False.
    """
    dev = resolve_device(device)
    if guard:
        return _guarded_batched(
            batch,
            eps=eps,
            max_iter=max_iter,
            eps_rel=eps_rel,
            h0=h0,
            mixed_precision=mixed_precision,
            accel=accel,
            backup=backup,
            accel_kw=dict(
                accel_period=accel_period,
                accel_memory=accel_memory,
                accel_safeguard=accel_safeguard,
            ),
            device=dev,
        )
    t0 = time.perf_counter()
    pm = batch.pmfs_banded
    arrs = (
        np.asarray(batch.c_tilde),
        np.asarray(pm[:, :, : trimmed_band(pm)]),
        np.asarray(batch.tails),
        np.asarray(batch.scale),
    )
    s_max = batch.specs[0].s_max

    def on(arrays, dtype):
        return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays)

    def coarse_arrays():
        # the float32 phase cannot resolve pmf mass below its epsilon
        # anyway, so it runs on a narrower band than the float64 finish
        pm32 = pm[:, :, : trimmed_band(pm, tol=1e-8)]
        return on((arrs[0], pm32, arrs[2], arrs[3]), F32)

    h0_t = None if h0 is None else torch.as_tensor(np.asarray(h0), device=dev)
    if accel != "none":
        if mixed_precision:
            # accelerated f32 coarse phase on the narrow band: the floored
            # thresholds keep it from stalling, the per-spec safeguards
            # absorb any f32 conditioning loss in the polish
            _, _, h32, _, it_conv32, acc, rej = _run_accel(
                *coarse_arrays(),
                s_max,
                max(eps, 1e-4),
                max(eps_rel, 1e-5),
                max_iter,
                accel,
                backup,
                None if h0_t is None else h0_t.to(F32),
                accel_period,
                accel_memory,
                accel_safeguard,
            )
            it_accel = int(it_conv32.max())
            # float64 finish: plain lockstep from the f32 fixed point (a
            # handful of backups), exact gain from the final greedy policy
            f64 = on(arrs, F64)
            policies, g, h, _, span, it_conv = _rvi_loop_batched(
                *f64, eps, eps_rel, max_iter, s_max,
                h0=torch.as_tensor(h32.astype(np.float64), device=dev),
            )
            g, h = _exact_or_loop(*f64, s_max, policies, g, h)
            policies = policies.cpu().numpy()
            span = span.cpu().numpy()
            it_conv = it_conv.cpu().numpy() + it_accel
        else:
            policies, g, h, span, it_conv, acc, rej = _run_accel(
                *on(arrs, F64),
                s_max,
                eps,
                eps_rel,
                max_iter,
                accel,
                backup,
                None if h0_t is None else h0_t.to(F64),
                accel_period,
                accel_memory,
                accel_safeguard,
            )
        return BatchedRVIResult(
            policies=policies,
            g=g,
            h=h,
            iterations=it_conv,
            span=span,
            converged=span < np.maximum(eps, eps_rel * np.abs(g)),
            wall_time_s=time.perf_counter() - t0,
            accel=accel,
            accel_accepts=acc,
            accel_rejects=rej,
        )
    if mixed_precision:
        coarse = _rvi_loop_batched(
            *coarse_arrays(),
            max(eps, 1e-4),
            max(eps_rel, 1e-5),
            max_iter,
            s_max,
            h0=None if h0_t is None else h0_t.to(F32),
            backup_kind=backup,
        )
        h0_t = coarse[2].to(F64)
        it_coarse = int(coarse[3])
    else:
        it_coarse = 0
    policies, g, h, _, span, it_conv = _rvi_loop_batched(
        *on(arrs, F64),
        eps,
        eps_rel,
        max_iter,
        s_max,
        h0=h0_t,
    )
    g = g.cpu().numpy()
    span = span.cpu().numpy()
    return BatchedRVIResult(
        policies=policies.cpu().numpy(),
        g=g,
        h=h.cpu().numpy(),
        iterations=it_conv.cpu().numpy() + it_coarse,
        span=span,
        converged=span < np.maximum(eps, eps_rel * np.abs(g)),
        wall_time_s=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# Phase-modulated RVI: the same lockstep / MPI machinery on the (phase,
# queue) product chain.  h carries a (K, S) phase-blocked layout; the backup
# is the phase-coupled windowed correlation (one einsum against the K x K
# matrix-valued arrival pmfs), the wait column mixes phases through the
# arrival-phase matrix, and the MPI polish reuses policy_eval_linear on the
# (K*S, K*S) matrix of the frozen policy.  Always float64 torch ops on the
# device, as in the reference (its correlation is a jnp.einsum outside any
# Pallas kernel): no kernel backup, no mixed precision.
# ---------------------------------------------------------------------------


def _make_backup_modulated(c_tilde, pmfs, tails, wait_m, scale, s_max: int):
    """The modulated Q-backup h -> q over a spec batch, index tensors built
    once.  c_tilde/scale (N, K, S, A) (+inf at infeasible), pmfs (N, A, K,
    K, Kb) (possibly band-trimmed), tails (N, A, K, K, T), wait_m (N, K, K),
    h (N, K, S).  The reference's vmap over specs, written out.

    For a != 0 and base t = s - a:
        (M^ h)(z, s) = sum_{w,k<=s_max-t} p^{[a]}_k[z,w] h(w, t+k)
                       + sum_w tail[a,z,w,t] h(w, S_o)
    For a == 0: (M^ h)(z, s) = sum_w wait_m[z,w] h(w, min(s+1 -> S_o)).
    Discretized:  Q = c~ + scale * (M^ h) + (1 - scale) * h(z, s).
    """
    dev = c_tilde.device
    S, A = c_tilde.shape[-2:]
    T = s_max + 1
    Kb = pmfs.shape[-1]
    j = torch.arange(T, device=dev)[:, None] + torch.arange(Kb, device=dev)[None, :]
    valid = j <= s_max
    j_c = torch.clamp(j, max=s_max)
    s_idx = torch.arange(S, device=dev)
    acts = torch.arange(A, device=dev)
    s_val = torch.clamp(s_idx, max=s_max)
    base = torch.clamp(s_val[:, None] - acts[None, :], 0, s_max)  # (S, A)
    act_idx = acts[None, :].expand(S, A)
    nxt = torch.where(s_idx < s_max, s_idx + 1, S - 1)
    one_minus_scale = 1.0 - scale

    def backup(h):
        hwin = torch.where(valid, h[..., j_c], 0.0)  # (N, K, T, Kb)
        # G[n, z, t, a] = sum_{w, k} pmfs[n, a, z, w, k] hwin[n, w, t, k]
        G = torch.einsum("nazwk,nwtk->nzta", pmfs, hwin)
        G = G + torch.einsum("nazwt,nw->nzta", tails, h[..., S - 1])
        mh = G[:, :, base, act_idx]  # (N, K, S, A)
        mh[..., 0] = wait_m @ h[..., nxt]
        return c_tilde + scale * mh + one_minus_scale * h[..., None]

    return backup


def banded_backup_modulated(c_tilde, pmfs, tails, wait_m, scale, s_max: int, h):
    """Phase-blocked structured backup of one spec; K = 1 degenerates to
    banded_backup.  c_tilde/scale (K, S, A), pmfs (A, K, K, Kb), tails (A,
    K, K, T), wait_m (K, K), h (K, S); returns q (K, S, A)."""
    fn = _make_backup_modulated(c_tilde[None], pmfs[None], tails[None],
                                wait_m[None], scale[None], s_max)
    return fn(h[None])[0]


def trimmed_band_modulated(pm: np.ndarray, tol: float = BAND_TOL) -> int:
    """Band width holding all but ``tol`` of every (action, phase) row.

    ``pm`` is (N, A, K, K, T); the row mass sums over end phases w.  The
    overflow tails stay full-width (exact), so trimming only drops in-band
    mass below ``tol`` — the same guarantee as trimmed_band.
    """
    row = pm[:, 1:].sum(axis=3)  # (N, A-1, K, T): mass per (a, z) over w
    tot = row.sum(axis=-1, keepdims=True)
    width = int((np.cumsum(row, axis=-1) < tot - tol).sum(-1).max()) + 2
    return min(width, pm.shape[-1])


def _span_flat(diff):
    d = diff.reshape(diff.shape[0], -1)
    return d.amax(dim=-1) - d.amin(dim=-1)


def _rvi_loop_modulated(c_tilde, pmfs, tails, wait_m, scale, eps: float,
                        eps_rel: float, max_iter: int, s_max: int, h0=None):
    """Lockstep RVI on the product chain (gauge at (z=0, s=0)).

    The reference's while_loop step for step: every spec advances until
    every span is below its threshold, ``it_conv`` records the backup at
    which each first converged; one device -> host read per backup.
    """
    N, K, S, _ = c_tilde.shape
    backup = _make_backup_modulated(c_tilde, pmfs, tails, wait_m, scale, s_max)
    dev = c_tilde.device
    h = torch.zeros((N, K, S), dtype=F64, device=dev) if h0 is None else h0.to(F64)
    span = torch.full((N,), math.inf, dtype=F64, device=dev)
    g = torch.zeros((N,), dtype=F64, device=dev)
    it_conv = torch.full((N,), -1, dtype=torch.int64, device=dev)
    i, running = 0, True
    while i < max_iter and running:
        j = backup(h).amin(dim=-1)  # (N, K, S)
        g = j[:, 0, 0]
        h_new = j - g[:, None, None]
        span = _span_flat(h_new - h)
        th = _thresh(g, eps, eps_rel)
        it_conv = torch.where((span < th) & (it_conv < 0), i + 1, it_conv)
        h = h_new
        i += 1
        running = bool((span >= th).any())  # one device -> host read
    policies = torch.argmin(backup(h), dim=-1)
    it_conv = torch.where(it_conv < 0, i, it_conv)
    return policies, g, h, i, span, it_conv


def _rvi_loop_modulated_mpi(c_tilde, pmfs, tails, wait_m, scale, eps: float,
                            eps_rel: float, max_iter: int, s_max: int,
                            period: int = 6, h0=None):
    """Modulated modified policy iteration: lockstep + periodic exact polish.

    The polish freezes the greedy (K, S) policy and replaces h by its exact
    gauge-fixed evaluation on the (K*S, K*S) policy matrix, accepted per
    spec only where finite and span-shrinking and never for a spec that
    already converged — so it can never do worse than plain lockstep.
    """
    N, K, S, _ = c_tilde.shape
    backup = _make_backup_modulated(c_tilde, pmfs, tails, wait_m, scale, s_max)
    dev = c_tilde.device

    def bell(h):
        q = backup(h)
        j = q.amin(dim=-1)
        g = j[:, 0, 0]
        return q, j - g[:, None, None], g

    h = torch.zeros((N, K, S), dtype=F64, device=dev) if h0 is None else h0.to(F64)
    span = torch.full((N,), math.inf, dtype=F64, device=dev)
    g = torch.zeros((N,), dtype=F64, device=dev)
    it_conv = torch.full((N,), -1, dtype=torch.int64, device=dev)
    acc = torch.zeros((N,), dtype=torch.int64, device=dev)
    rej = torch.zeros_like(acc)
    it = nb = 0
    running = True
    while it < max_iter and running:
        q, hb, g = bell(h)
        nb += 1
        span = _span_flat(hb - h)
        conv = span < _thresh(g, eps, eps_rel)
        if (it + 1) % period == 0:
            pol = torch.argmin(q, dim=-1)  # (N, K, S)
            m_pi = policy_matrix_banded_modulated(pmfs, tails, wait_m, scale, s_max, pol)
            c_pi = torch.gather(c_tilde, 3, pol[..., None])[..., 0].reshape(N, K * S)
            g_pol, h_pol_flat = policy_eval_linear(c_pi, m_pi, 0)
            h_pol = h_pol_flat.reshape(N, K, S)
            _, hb2, g2 = bell(h_pol)
            span2 = _span_flat(hb2 - h_pol)
            ok = (
                torch.isfinite(g_pol)
                & torch.isfinite(h_pol_flat).all(dim=-1)
                & (span2 < span)
                & ~conv
            )
            h = torch.where(ok[:, None, None], hb2, hb)
            span = torch.where(ok, span2, span)
            g = torch.where(ok, g2, g)
            nb += 1
            acc = acc + ok
            rej = rej + (~ok & ~conv)
        else:
            h = hb
        th = _thresh(g, eps, eps_rel)
        it_conv = torch.where((span < th) & (it_conv < 0), nb, it_conv)
        it += 1
        running = bool((span >= th).any())  # one device -> host read
    policies = torch.argmin(backup(h), dim=-1)
    it_conv = torch.where(it_conv < 0, nb, it_conv)
    return policies, g, h, nb, span, it_conv, acc, rej


def _exact_gain_modulated(c_tilde, pmfs, tails, wait_m, scale, s_max, policies,
                          ref_state=0):
    """Exact linear-solve gain + relative values of frozen (K, S) policies."""
    N, K, S, _ = c_tilde.shape
    m_pi = policy_matrix_banded_modulated(pmfs, tails, wait_m, scale, s_max, policies)
    c_pi = torch.gather(c_tilde, 3, policies[..., None])[..., 0].reshape(N, K * S)
    g, h = policy_eval_linear(c_pi, m_pi, ref_state)
    return g, h.reshape(N, K, S)


def _guarded_modulated(mbatch, eps: float, max_iter: int, eps_rel: float, h0,
                       accel: str, accel_period: int,
                       device: torch.device) -> BatchedRVIResult:
    """Guardrail ladder for the modulated batched RVI (the reference's).

    The rungs that apply to the product chain (always float64, no kernel
    backup): the MPI accelerant and any caller h0 fall back to the plain
    lockstep loop, and rows still unhealthy are quarantined into
    single-spec plain-f64 re-solves — the oracle path the K = 1 tests pin
    the modulated solver against.
    """

    def run(b, h0_, ac):
        return relative_value_iteration_modulated(
            b, eps=eps, max_iter=max_iter, eps_rel=eps_rel, h0=h0_,
            accel=ac, accel_period=accel_period, device=device,
        )

    res = run(mbatch, h0, accel)
    healthy = _spec_health(res)
    rungs: Dict[str, List[int]] = {}
    quarantined: List[int] = []
    failed: List[int] = []
    if not healthy.all():
        res = _writable(res)
        bad = np.flatnonzero(~healthy)
        if accel != "none" or h0 is not None:
            sub_res = run(mbatch.take([int(i) for i in bad]), None, "none")
            ok = _spec_health(sub_res)
            rungs["plain_restart"] = [int(i) for i in bad]
            if ok.any():
                _patch_rows(res, sub_res, bad[ok], np.flatnonzero(ok))
            bad = bad[~ok]
        if bad.size:
            rungs["quarantine"] = [int(i) for i in bad]
            for i in bad:
                i = int(i)
                quarantined.append(i)
                oracle = run(mbatch.take([i]), None, "none")
                if _spec_health(oracle)[0]:
                    _patch_rows(res, oracle, np.array([i]), np.array([0]))
                else:
                    failed.append(i)
        healthy = _spec_health(res)
    return dataclasses.replace(
        res,
        report=SolveReport(
            eps=eps,
            span=np.asarray(res.span),
            converged=np.asarray(res.converged),
            healthy=healthy,
            rungs=rungs,
            quarantined=quarantined,
            failed=failed,
        ),
    )


def relative_value_iteration_modulated(
    mbatch,  # ModulatedBatchedSMDP
    eps: float = 1e-2,
    max_iter: int = 10_000,
    eps_rel: float = 2e-4,
    h0: Optional[np.ndarray] = None,
    accel: str = "auto",
    accel_period: int = 6,
    guard: bool = False,
    *,
    device: DeviceLike = None,
) -> BatchedRVIResult:
    """Solve every spec of a ModulatedBatchedSMDP in float64 on ``device``.

    Returns a BatchedRVIResult whose per-spec policy/h carry the (K, S)
    phase-blocked layout.  ``accel`` in {"none", "mpi", "auto"}; "auto"
    routes through the MPI polish once any spec's *within-phase* traffic
    intensity reaches ACCEL_RHO_THRESHOLD (the burst phase sets the mixing
    wall, so the decision keys on max_z rho_z, not on the mean).  g/h are
    replaced by the exact linear-solve evaluation of the final greedy
    policy wherever that solve is finite.  ``guard=True`` wraps the solve
    in the guardrail ladder and attaches a SolveReport.  ``device=None``
    means CUDA.
    """
    from .smdp import phase_rho

    dev = resolve_device(device)
    if guard:
        return _guarded_modulated(
            mbatch, eps=eps, max_iter=max_iter, eps_rel=eps_rel, h0=h0,
            accel=accel, accel_period=accel_period, device=dev,
        )
    t0 = time.perf_counter()
    pm = mbatch.pmfs_banded
    band = trimmed_band_modulated(pm)
    args = tuple(
        torch.as_tensor(np.ascontiguousarray(x), dtype=F64, device=dev)
        for x in (mbatch.c_tilde, pm[..., :band], mbatch.tails, mbatch.wait_m,
                  mbatch.scale)
    )
    s_max = mbatch.s_max
    if accel == "auto":
        rho_z = max(phase_rho(sp, ph) for sp, ph in zip(mbatch.specs, mbatch.phases))
        accel = "mpi" if rho_z >= ACCEL_RHO_THRESHOLD else "none"
    h0_t = None if h0 is None else torch.as_tensor(np.asarray(h0), dtype=F64, device=dev)
    acc = rej = None
    if accel == "mpi":
        policies, g, h, _, span, it_conv, acc, rej = _rvi_loop_modulated_mpi(
            *args, eps, eps_rel, max_iter, s_max, period=accel_period, h0=h0_t
        )
        acc, rej = acc.cpu().numpy(), rej.cpu().numpy()
    elif accel == "none":
        policies, g, h, _, span, it_conv = _rvi_loop_modulated(
            *args, eps, eps_rel, max_iter, s_max, h0=h0_t
        )
    else:
        raise ValueError(f"unknown accel {accel!r} for modulated RVI")
    g_exact, h_exact = _exact_gain_modulated(*args, s_max, policies)
    g_exact, h_exact = g_exact.cpu().numpy(), h_exact.cpu().numpy()
    ok = np.isfinite(g_exact) & np.isfinite(h_exact.reshape(mbatch.n_specs, -1)).all(axis=-1)
    g = np.where(ok, g_exact, g.cpu().numpy())
    h = np.where(ok[:, None, None], h_exact, h.cpu().numpy())
    span = span.cpu().numpy()
    return BatchedRVIResult(
        policies=policies.cpu().numpy(),
        g=g,
        h=h,
        iterations=it_conv.cpu().numpy(),
        span=span,
        converged=span < np.maximum(eps, eps_rel * np.abs(g)),
        wall_time_s=time.perf_counter() - t0,
        accel=accel,
        accel_accepts=acc,
        accel_rejects=rej,
    )


# ---------------------------------------------------------------------------
# Appendix-F baselines: approximate value / policy iteration on the
# *untruncated* associated DTMDP with an expanding state window (numpy, as
# in the reference: the baselines of benchmarks/table3_iteration_algos.py).
# ---------------------------------------------------------------------------


def _untruncated_arrays(spec, n_states: int):
    """c~, p_k, y for states 0..n_states-1 of the untruncated DTMDP."""
    big = dataclasses.replace(spec, s_max=max(n_states - 2, spec.b_max), c_o=0.0)
    mdp = build_smdp(big)
    return mdp


def avi(
    spec,
    n_outer: int = 400,
    n0: int = 8,
    growth: int = 1,
    eval_s_max: int = 160,
) -> RVIResult:
    """Thomas–Stengos Scheme I: VI with an expanding state window.

    Iteration i backs up states {0..n0 + growth*i}; values outside the
    current window are taken as the boundary value (h of the largest known
    state), which mirrors the scheme's 'latter states see fewer backups'.
    """
    t0 = time.perf_counter()
    n_final = n0 + growth * n_outer + spec.b_max + 2
    mdp = _untruncated_arrays(spec, n_final + 2)
    n_states = mdp.n_states  # n_final + 2 (incl. S_o)
    c = np.where(mdp.feasible, mdp.c_tilde, np.inf)[: n_final + 1]
    m = mdp.m_tilde[: n_final + 1, :, :]  # (n_final+1, A, n_states)
    h = np.zeros(n_states)
    g = 0.0
    for i in range(n_outer):
        n_i = min(n0 + growth * i, n_final)
        q = c[: n_i + 1] + np.einsum("saj,j->sa", m[: n_i + 1, :, :], h)
        j = np.min(q, axis=1)
        g = j[0]
        h[: n_i + 1] = j - g
    q = c + np.einsum("saj,j->sa", m, h)
    policy = np.argmin(q, axis=1)
    pol = policy[: eval_s_max + 2].copy()
    pol[-1] = pol[eval_s_max]  # overflow state mirrors s_max
    return RVIResult(
        policy=pol,
        g=float(g),
        h=h[: eval_s_max + 2],
        iterations=n_outer,
        span=float("nan"),
        converged=True,
        wall_time_s=time.perf_counter() - t0,
    )


def api(
    spec,
    n_outer: int = 12,
    inner_per_outer: int = 20,
    n0: int = 8,
    growth: int = 1,
    eval_s_max: int = 160,
) -> RVIResult:
    """Thomas–Stengos Scheme IV: policy iteration with AVI inner evaluation."""
    t0 = time.perf_counter()
    max_inner = sum(inner_per_outer * (i + 1) for i in range(n_outer))
    n_final = n0 + growth * max_inner + spec.b_max + 2
    mdp = _untruncated_arrays(spec, n_final + 2)
    n_states = mdp.n_states
    c = np.where(mdp.feasible, mdp.c_tilde, np.inf)[: n_final + 1]
    m = mdp.m_tilde[: n_final + 1, :, :]
    policy = np.zeros(n_final + 1, dtype=np.int64)  # initial: always wait
    h = np.zeros(n_states)
    g = 0.0
    step = 0
    for outer in range(n_outer):
        # inner: approximate evaluation of `policy` with expanding window
        for _ in range(inner_per_outer * (outer + 1)):
            n_i = min(n0 + growth * step, n_final)
            step += 1
            rows = np.arange(n_i + 1)
            cp = c[rows, policy[: n_i + 1]]
            mp = m[rows, policy[: n_i + 1], :]
            j = cp + mp @ h
            g = j[0]
            h[: n_i + 1] = j - g
        # improvement
        q = c + np.einsum("saj,j->sa", m, h)
        policy = np.argmin(q, axis=1)
    pol = policy[: eval_s_max + 2].copy()
    pol[-1] = pol[eval_s_max]
    return RVIResult(
        policy=pol,
        g=float(g),
        h=h[: eval_s_max + 2],
        iterations=step,
        span=float("nan"),
        converged=True,
        wall_time_s=time.perf_counter() - t0,
    )
