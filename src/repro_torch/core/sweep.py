"""Batched spec sweeps: solve a whole w2 / lambda / profile grid at once.

Every figure in the paper (Fig. 4/5/8/9, Table III) is a sweep over some
spec parameter.  Here the grid is stacked into one BatchedSMDP
(smdp.build_smdp_batched) and solved by the lockstep batched RVI on the
device (rvi.relative_value_iteration_batched); with backup="pallas" each
lockstep backup of the whole batch is one launch of the spec-batched CUDA
Bellman kernel.  Policy evaluation and the abstract-cost calibration run
on the banded transition structure in numpy, so nothing on the sweep path
is O(S^2) per spec.

The paper's adaptive truncation rule (Sec. V: accept when the tail
tolerance Delta^pi < delta, else grow s_max) is applied batch-wide: after
each batched solve only the specs whose Delta still exceeds delta are
regrown and re-solved together.

The sweep defaults to accel="auto" — the accelerated solver (accel="mpi")
whenever the sweep reaches the slow-mixing regime, plain lockstep
otherwise — and each batch is re-ordered along (rho, w2) so the
anchor-interpolated warm starts chain along the rho axis.  The c_o probe
batch is reused as the first solve batch.  Results always come back in
the caller's original spec order.

sweep_solve_modulated / sweep_bank(phases=...) are the exact MMPP-aware
mirrors: the same ordering, c_o-probe reuse, warm-start chaining and
adaptive-truncation machinery runs on the (phase, queue) product chain
(smdp.build_smdp_modulated_batched) in float64 on the device, producing
(K, S) phase-indexed policies the serving layer consumes as table stacks.

Long-horizon robustness (both sweep entry points):

  * guard=True (default) routes every batched solve through the rvi
    guardrail ladder, and report_sink=[...] collects the merged
    SolveReport;
  * checkpoint_dir=... makes the sweep durable and SIGTERM-preemptible:
    solved chunks persist through checkpoint.CheckpointManager (the
    reference's on-disk format) and an identical re-run on the same
    device type resumes bitwise-identically (see "Durable, resumable
    sweeps" below for the invariant).
"""
from __future__ import annotations

import dataclasses
import hashlib
import signal
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from .evaluate import (
    PolicyEval,
    _finish_from_batch,
    evaluate_policy_banded,
    evaluate_policy_batched,
    evaluate_policy_modulated,
    evaluate_policy_modulated_batched,
    stationary_distribution_batched,
)
from .policies import greedy_policy
from .rvi import (
    ACCEL_RHO_THRESHOLD as _ACCEL_RHO_THRESHOLD,
    RVIResult,
    SolveReport,
    relative_value_iteration_batched,
    relative_value_iteration_modulated,
)
from .smdp import (
    PhaseConfig,
    SMDPSpec,
    build_smdp_batched,
    build_smdp_modulated_batched,
    modulated_spec,
    phase_rho,
)
from .solve import ModulatedSolveResult, SolveResult


def sweep_bank(
    base: SMDPSpec,
    lams: Sequence[float],
    w2s: Optional[Sequence[float]] = None,
    profiles: Optional[dict] = None,
    phases: Optional[PhaseConfig] = None,
    **solve_kw,
):
    """Solve a lambda x w2 (x service-profile) grid as an SMDPSchedulerBank.

    The serving-side entry point for regime-adaptive scheduling: the bank's
    keyed action tables are what the serving layer hot-swaps as the
    arrival rate (or the energy price) drifts.  ``w2s`` defaults to the
    base spec's w2 (a pure lambda grid).

    ``profiles`` adds the third bank axis: a mapping from a numeric
    service-profile id to the spec fields that profile overrides (a dict
    for dataclasses.replace).  Keys become (lam, w2, profile).  All
    profiles must share b_max (the action axis cannot be padded).
    ``solve_kw`` goes to sweep_solve (``backup=``, ``device=``, ...).

    ``phases`` switches the bank to *exact MMPP-aware* solves: each lam is
    the target mean rate, the PhaseConfig's per-phase rates are scaled to
    hit it (same burst ratio and switching dynamics), and every table
    becomes a (K, S) phase-indexed stack solved on the (phase, queue)
    product chain (sweep_solve_modulated; ``solve_kw`` goes there).
    Mutually exclusive with ``profiles``.
    """
    from ..serving.scheduler import SMDPScheduler

    lams = list(lams)
    w2s = [base.w2] if w2s is None else list(w2s)
    if len(lams) == 0 or len(w2s) == 0:
        raise ValueError("sweep_bank needs at least one lam and one w2")
    if phases is not None:
        if profiles is not None:
            raise ValueError("phases= and profiles= are mutually exclusive")
        specs, phase_list, keys = [], [], []
        for lam in lams:
            ph = phases.scaled(float(lam) / phases.mean_rate)
            for w2 in w2s:
                specs.append(
                    modulated_spec(dataclasses.replace(base, w2=float(w2)), ph)
                )
                phase_list.append(ph)
                keys.append((float(lam), float(w2)))
        return SMDPScheduler.bank(
            sweep_solve_modulated(specs, phase_list, **solve_kw),
            keys=keys,
            key_names=("lam", "w2"),
        )
    variants = [(None, {})] if profiles is None else [
        (float(pid), dict(over)) for pid, over in profiles.items()
    ]
    if not variants:
        raise ValueError("profiles= must contain at least one profile")
    specs, keys = [], []
    for pid, over in variants:
        for lam in lams:
            for w2 in w2s:
                specs.append(
                    dataclasses.replace(
                        base, lam=float(lam), w2=float(w2), **over
                    )
                )
                keys.append(
                    (float(lam), float(w2))
                    if pid is None
                    else (float(lam), float(w2), pid)
                )
    key_names = ("lam", "w2") if profiles is None else ("lam", "w2", "profile")
    return SMDPScheduler.bank(
        sweep_solve(specs, **solve_kw), keys=keys, key_names=key_names
    )


def pad_specs(specs: Sequence[SMDPSpec]) -> List[SMDPSpec]:
    """Lift a mixed-truncation spec list to a shared s_max (batch padding).

    A larger truncation level only refines the approximation, so padding to
    the max is always sound.  b_max must already agree across specs — the
    action axis cannot be padded without changing feasible sets.
    """
    specs = list(specs)
    if not specs:
        return []
    b_maxes = {sp.b_max for sp in specs}
    if len(b_maxes) > 1:
        raise ValueError(f"sweep specs must share b_max; got {sorted(b_maxes)}")
    s_max = max(sp.s_max for sp in specs)
    # finite-buffer specs are never padded: their truncation level IS the
    # physical buffer (buffer == s_max is an exact-fold invariant)
    return [
        sp
        if sp.s_max == s_max or sp.buffer is not None
        else dataclasses.replace(sp, s_max=s_max)
        for sp in specs
    ]


def _greedy_c_o(batch) -> np.ndarray:
    """Per-spec abstract cost c_o = max(100, 2 * g_greedy) from a c_o=0 batch.

    The greedy gains of the whole probe batch come from one batched
    stationary solve; specs whose greedy chain degenerates keep the paper
    default of 100 (same fallback as the serial resolver).
    """
    pols = np.stack(
        [
            greedy_policy(sp.s_max, sp.b_min, sp.b_max)
            for sp in batch.specs
        ]
    )
    p = batch.policy_transitions_batched(pols)
    mu, ok = stationary_distribution_batched(p)
    out = np.empty(batch.n_specs)
    for i in range(batch.n_specs):
        if ok[i]:
            g = _finish_from_batch(batch, i, pols[i], mu[i]).g
        else:
            try:
                g = evaluate_policy_banded(batch, i, pols[i]).g
            except RuntimeError:
                g = 100.0
        out[i] = max(100.0, 2.0 * g)
    return out


def resolve_abstract_cost_batched(
    specs: Sequence[SMDPSpec],
) -> List[SMDPSpec]:
    """Batched solve.resolve_abstract_cost: c_o = max(100, 2 * g_greedy).

    One banded batch build of the c_o = 0 probes calibrates every spec's
    abstract cost (one batched stationary solve for all greedy gains).
    """
    specs = list(specs)
    probes = [dataclasses.replace(sp, c_o=0.0) for sp in specs]
    batch = build_smdp_batched(probes)
    c_os = _greedy_c_o(batch)
    return [
        dataclasses.replace(sp, c_o=float(c)) for sp, c in zip(specs, c_os)
    ]


# ---------------------------------------------------------------------------
# Durable, resumable sweeps
#
# Invariant: a checkpointed sweep that is killed and re-run with the same
# arguments, checkpoint_dir and device type produces exactly the arrays a
# never-killed checkpointed run produces, because
#   * chunks are consecutive slices of a stably-sorted group, so the
#     unprocessed remainder of a round is a suffix of the processing plan
#     and re-chunking a suffix reproduces the original chunk boundaries;
#   * the current round's remaining queue and the next round's regrow queue
#     are persisted separately (merging them would reorder level groups);
#   * calibrated c_o values are persisted, and the c_o probe batch is never
#     reused as a solve batch under checkpointing, so every chunk batch is
#     rebuilt from its specs alone on both paths;
#   * the device type is fingerprinted: the Bellman kernel's f32 coarse
#     phase and the CPU plain version sum in different orders, so a chunk
#     solved on the card and its neighbour resumed on the CPU would not be
#     the uninterrupted run's; such a resume is refused as a different
#     sweep.
# ---------------------------------------------------------------------------

#: default specs per checkpointed chunk (checkpoint_dir set, chunk_size not)
_DEFAULT_CHUNK = 16


class SweepPreempted(RuntimeError):
    """A preemption signal (SIGTERM) arrived; progress is durable on disk.

    Raised only after the in-flight chunk's checkpoint finished its atomic
    rename, so the step named here holds every result solved so far.
    Re-running the same sweep call with the same checkpoint_dir resumes
    from it."""

    def __init__(self, checkpoint_dir, step: int):
        super().__init__(
            f"sweep preempted; progress saved to {checkpoint_dir} "
            f"(step {step})"
        )
        self.checkpoint_dir = str(checkpoint_dir)
        self.step = step


class _PreemptGuard:
    """SIGTERM -> save-and-exit flag.

    The handler only sets a flag; the sweep loop checks it after each
    chunk's checkpoint commits and raises SweepPreempted.  Installed only
    from the main thread (signal.signal raises ValueError elsewhere -- a
    sweep running on a worker thread simply cannot be signal-preempted)."""

    def __init__(self, enabled: bool):
        self.hit = False
        self._old = None
        self._installed = False
        if enabled:
            try:
                self._old = signal.signal(signal.SIGTERM, self._handler)
                self._installed = True
            except ValueError:
                pass

    def _handler(self, signum, frame):
        self.hit = True

    def restore(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._old)


def _canon(obj, h) -> None:
    """Feed a canonical byte stream of obj into hash h.

    repr() is avoided for arrays (truncation) and bare objects (id()); spec
    trees bottom out at dataclasses / ndarrays / primitives, with qualified
    names as the last resort for callables."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _canon(getattr(obj, f.name), h)
    elif isinstance(obj, np.ndarray):
        h.update(str(obj.dtype).encode())
        h.update(str(obj.shape).encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (list, tuple)):
        h.update(b"[")
        for it in obj:
            _canon(it, h)
        h.update(b"]")
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj):
            h.update(str(k).encode())
            _canon(obj[k], h)
        h.update(b"}")
    elif isinstance(obj, (bool, int, float, str, bytes)) or obj is None:
        h.update(repr(obj).encode())
    else:
        h.update(
            getattr(obj, "__qualname__", type(obj).__qualname__).encode()
        )


def _fingerprint(*parts) -> bytes:
    h = hashlib.sha256()
    for p in parts:
        _canon(p, h)
    return h.digest()


class _SweepCheckpointer:
    """Sweep state through CheckpointManager, keyed by an argument hash.

    Flat payload schema (``//``-joined keys, via restore_flat):
      meta//fingerprint      sha256 of (specs, solver params) as uint8
      meta//c_o              (N,) calibrated abstract costs, batch order
      meta//pending_idx/_smax  current round's unprocessed queue
      meta//next_idx/_smax     next round's regrow queue
      done//idx              (n,) the solved specs' indices
      done//{g,iterations,span,converged,smax,c_o}  (n,) one entry a spec
      done//ev               (n, 6) the PolicyEval scalars
      done//{policy,h,mu}    every spec's array raveled and concatenated,
                             with done//<name>_shape (n, 2) its (rows,
                             cols) and done//<name>_ndim (n,)

    The solved records are stacked (a fixed number of arrays a step),
    where the reference writes ten arrays a spec: the writer thread's
    Python work a save then stays a few milliseconds, and it shares the
    interpreter with the sweep's host-bound launch loop.
    """

    def __init__(self, directory, fingerprint: bytes, keep_last_k: int):
        from ..checkpoint import CheckpointManager

        self.dir = directory
        self.mgr = CheckpointManager(directory, keep_last_k=keep_last_k)
        self.fp = fingerprint
        self.step = 0

    def load(self) -> Optional[dict]:
        step = self.mgr.latest_step()
        if step is None:
            return None
        flat = self.mgr.restore_flat()
        if bytes(bytearray(flat["meta//fingerprint"])) != self.fp:
            raise ValueError(
                f"checkpoint in {self.dir} was written by a different sweep "
                "(the specs, solver parameters or device type changed); pass "
                "a fresh checkpoint_dir or re-run with the original arguments"
            )
        self.step = step + 1
        return flat

    def save(self, tree: dict) -> None:
        # async: the fsync+rename overlaps the next chunk's solve (the host
        # copy is taken synchronously, so later mutation is safe); wait()
        # is the commit barrier before SweepPreempted / return
        tree["meta"]["fingerprint"] = np.frombuffer(self.fp, dtype=np.uint8)
        self.mgr.save(self.step, tree, async_=True)
        self.step += 1

    def wait(self) -> None:
        self.mgr.wait()


_ARRAYS = ("policy", "h", "mu")
_SCALARS = ("g", "iterations", "span", "converged", "smax", "c_o")


def _pack_result(res) -> dict:
    """SolveResult / ModulatedSolveResult -> flat-array checkpoint record."""
    rvi, ev = res.rvi, res.eval
    return {
        "policy": np.asarray(rvi.policy),
        "g": np.asarray(rvi.g, dtype=np.float64),
        "h": np.asarray(rvi.h, dtype=np.float64),
        "iterations": np.asarray(rvi.iterations, dtype=np.int64),
        "span": np.asarray(rvi.span, dtype=np.float64),
        "converged": np.asarray(rvi.converged),
        "smax": np.asarray(res.spec.s_max, dtype=np.int64),
        "c_o": np.asarray(res.spec.c_o, dtype=np.float64),
        "ev": np.asarray(
            [ev.g, ev.delta, ev.w_bar, ev.p_bar, ev.mean_batch, ev.throughput],
            dtype=np.float64,
        ),
        "mu": np.asarray(ev.mu, dtype=np.float64),
    }


def _pack_done(results: list) -> dict:
    """The solved results as the stacked ``done//`` arrays."""
    idx = [i for i, r in enumerate(results) if r is not None]
    recs = [_pack_result(results[i]) for i in idx]
    done = {"idx": np.asarray(idx, dtype=np.int64)}
    for f in _SCALARS:
        done[f] = np.asarray([r[f] for r in recs])
    done["ev"] = np.asarray([r["ev"] for r in recs], dtype=np.float64).reshape(-1, 6)
    for f in _ARRAYS:
        arrs = [r[f] for r in recs]
        done[f] = (np.concatenate([a.ravel() for a in arrs]) if arrs
                   else np.zeros(0, dtype=np.float64))
        done[f + "_shape"] = np.asarray(
            [a.reshape(-1, a.shape[-1]).shape if a.ndim else (1, 1) for a in arrs],
            dtype=np.int64).reshape(-1, 2)
        done[f + "_ndim"] = np.asarray([a.ndim for a in arrs], dtype=np.int64)
    return done


def _unpack_done(flat: dict, base_by_idx: dict) -> dict:
    """Checkpoint arrays -> {idx: (spec, RVIResult, PolicyEval)}.

    float64/int64 arrays round-trip npz losslessly, so restored results are
    bitwise-identical to the in-memory ones the checkpointed run held
    (wall_time_s excepted -- it is not persisted and restores as 0)."""
    idx = [int(i) for i in flat["done//idx"]]
    arrays = {f: [] for f in _ARRAYS}
    for f in _ARRAYS:
        data, off = flat[f"done//{f}"], 0
        for (r, c), nd in zip(flat[f"done//{f}_shape"], flat[f"done//{f}_ndim"]):
            a = data[off:off + r * c]
            off += r * c
            arrays[f].append(a.reshape(r, c) if nd == 2 else a)
    out = {}
    for k, i in enumerate(idx):
        g = lambda f: flat[f"done//{f}"][k]  # noqa: E731
        spec = dataclasses.replace(
            base_by_idx[i], s_max=int(g("smax")), c_o=float(g("c_o"))
        )
        rvi = RVIResult(
            policy=arrays["policy"][k],
            g=float(g("g")),
            h=arrays["h"][k],
            iterations=int(g("iterations")),
            span=float(g("span")),
            converged=bool(g("converged")),
            wall_time_s=0.0,
        )
        e = flat["done//ev"][k]
        ev = PolicyEval(
            g=float(e[0]),
            delta=float(e[1]),
            w_bar=float(e[2]),
            p_bar=float(e[3]),
            mu=arrays["mu"][k],
            mean_batch=float(e[4]),
            throughput=float(e[5]),
        )
        out[i] = (spec, rvi, ev)
    return out


def _sweep_state(
    results: list, remaining: list, next_round: list, c_os
) -> dict:
    """Checkpoint tree for the sweep loop's full solver state."""
    meta = {
        "pending_idx": np.asarray([it[0] for it in remaining], dtype=np.int64),
        "pending_smax": np.asarray(
            [it[1].s_max for it in remaining], dtype=np.int64
        ),
        "next_idx": np.asarray([it[0] for it in next_round], dtype=np.int64),
        "next_smax": np.asarray(
            [it[1].s_max for it in next_round], dtype=np.int64
        ),
    }
    if c_os is not None:
        meta["c_o"] = np.asarray(c_os, dtype=np.float64)
    return {"meta": meta, "done": _pack_done(results)}


def _restored_report(
    results: list, idxs: List[int], eps: float
) -> Tuple[SolveReport, List[int]]:
    """Certificates recomputed from solved (or checkpoint-restored) results.

    Health comes from the arrays; a previous process's rung history is not
    persisted (and an unguarded sweep has none), so these specs contribute
    certificates but no rung attribution to the merged report."""
    span = np.array([results[i].rvi.span for i in idxs])
    conv = np.array([results[i].rvi.converged for i in idxs], dtype=bool)
    healthy = np.array(
        [
            bool(c)
            and np.isfinite(results[i].rvi.g)
            and bool(np.isfinite(results[i].rvi.h).all())
            for i, c in zip(idxs, conv)
        ],
        dtype=bool,
    )
    rep = SolveReport(
        eps=eps,
        span=span,
        converged=conv,
        healthy=healthy,
        failed=[k for k in range(len(idxs)) if not healthy[k]],
    )
    return rep, idxs


def _restore_queues(state, pending, phases=None):
    """(results by idx, pending, next_round) from a restored sweep state.

    ``pending`` is the fresh run's first-round queue of (idx, spec[,
    phases]) items, its specs carrying the calibrated c_o."""
    base_by_idx = {it[0]: it[1] for it in pending}
    restored = _unpack_done(state, base_by_idx)

    def queue(name):
        out = []
        for i, s in zip(state[f"meta//{name}_idx"], state[f"meta//{name}_smax"]):
            it = (int(i), dataclasses.replace(base_by_idx[int(i)], s_max=int(s)))
            out.append(it if phases is None else it + (phases[int(i)],))
        return out

    return restored, queue("pending"), queue("next")


def _round_plan(
    pending: List[tuple], chunk_size: Optional[int]
) -> List[List[tuple]]:
    """Chunked processing plan for one sweep round.

    Items are (idx, spec) tuples.  Groups by truncation level (ascending),
    stably sorts each group along (rho, w2) and splits groups into
    consecutive chunks of ``chunk_size`` (one chunk per group if None).
    """
    plan: List[List[tuple]] = []
    for s_max in sorted({it[1].s_max for it in pending}):
        group = [it for it in pending if it[1].s_max == s_max]
        group.sort(key=lambda it: (it[1].rho, it[1].w2))
        step = len(group) if chunk_size is None else int(chunk_size)
        for k in range(0, len(group), step):
            plan.append(group[k : k + step])
    return plan


def _nan_eval(n_states: int) -> PolicyEval:
    """Placeholder eval for rows the guard ladder could not heal."""
    nan = float("nan")
    return PolicyEval(
        g=nan,
        delta=nan,
        w_bar=nan,
        p_bar=nan,
        mu=np.full(n_states, np.nan),
        mean_batch=nan,
        throughput=nan,
    )


def _eval_healthy(
    batch,
    policies: np.ndarray,
    healthy: np.ndarray,
    batched_eval: Callable,
    n_states: Callable[[SMDPSpec], int],
) -> List[PolicyEval]:
    """Evaluate only ladder-healthy rows; failed rows get NaN placeholders.

    evaluate_* rejects the garbage policies a failed row carries, so those
    rows are masked out of the batched stationary solve entirely and come
    back as all-NaN PolicyEvals (the sweep accepts them without
    regrowing)."""
    if healthy.all():
        return batched_eval(batch, policies)
    evs: List[Optional[PolicyEval]] = [None] * len(healthy)
    ok = [int(i) for i in np.flatnonzero(healthy)]
    if ok:
        sub = batched_eval(batch.take(ok), policies[np.asarray(ok)])
        for j, e in zip(ok, sub):
            evs[j] = e
    return [
        e if e is not None else _nan_eval(n_states(batch.specs[j]))
        for j, e in enumerate(evs)
    ]


#: below this batch width the anchor pre-solve costs more than it saves
_WARM_START_MIN = 6


def _warm_start_t(specs: Sequence[SMDPSpec], c_feat: np.ndarray) -> np.ndarray:
    """Per-spec interpolation coordinate t in [0, 1] along the anchor pair.

      * rho varies across the batch — project the normalized (rho, w2)
        parameter point onto the anchor segment (c_tilde is NOT affine in
        lambda: the arrival pmfs move with it);
      * rho constant (w2 / energy-profile sweeps) — project the cost
        features ``c_feat`` (finite c_tilde entries, flattened per spec)
        onto the anchor segment, exact for any parameter c_tilde is
        affine in.
    """
    rhos = np.array([sp.rho for sp in specs])
    w2s = np.array([sp.w2 for sp in specs])
    if abs(rhos[-1] - rhos[0]) > 1e-12:

        def norm(v):
            span = v[-1] - v[0]
            return (v - v[0]) / span if abs(span) > 1e-12 else np.zeros_like(v)

        theta = np.stack([norm(rhos), norm(w2s)], axis=1)  # (N, 2)
        d = theta[-1] - theta[0]
        return np.clip(theta @ d / float(d @ d), 0.0, 1.0)
    d = c_feat[-1] - c_feat[0]
    denom = float(d @ d)
    if denom <= 0.0:
        return np.zeros(len(specs))
    return np.clip((c_feat - c_feat[0]) @ d / denom, 0.0, 1.0)


def _anchor_warm_start(batch, eps: float, max_iter: int, **rvi_kw):
    """Interpolated h0 from solving the two end-of-batch anchor specs.

    Any h0 reaches the same fixed point — a good one just makes the
    batched RVI converge in fewer lockstep iterations.  The batch is
    pre-sorted along (rho, w2) by sweep_solve, so the anchors are the
    extreme-rho specs and interpolation chains along the rho axis.
    """
    if batch.n_specs < _WARM_START_MIN:
        return None
    anchors = relative_value_iteration_batched(
        batch.take([0, batch.n_specs - 1]), eps=eps, max_iter=max_iter, **rvi_kw
    )
    mask = batch.feasible.all(axis=0)  # finite c_tilde in every spec
    t = _warm_start_t(batch.specs, batch.c_tilde[:, mask])
    return (1.0 - t)[:, None] * anchors.h[0] + t[:, None] * anchors.h[1]


def _anchor_warm_start_modulated(mbatch, eps: float, max_iter: int, **rvi_kw):
    """Modulated anchor warm start: h0 chains along rho per phase block.

    The discipline of _anchor_warm_start — the anchors are the
    extreme-(rho, w2) specs of the pre-sorted batch — with the (K, S)
    phase-blocked h interpolated jointly (every phase block shares the
    spec's interpolation coordinate: the whole chain moves with (rho, w2)).
    """
    if mbatch.n_specs < _WARM_START_MIN:
        return None
    anchors = relative_value_iteration_modulated(
        mbatch.take([0, mbatch.n_specs - 1]), eps=eps, max_iter=max_iter, **rvi_kw
    )
    mask = mbatch.feasible.all(axis=0)  # (S, A) feasible in every spec
    c_feat = mbatch.c_tilde[:, :, mask].reshape(mbatch.n_specs, -1)
    t = _warm_start_t(mbatch.specs, c_feat)
    return (
        (1.0 - t)[:, None, None] * anchors.h[0]
        + t[:, None, None] * anchors.h[1]
    )


def _checkpointer(checkpoint_dir, chunk_size, keep_last_k, *parts):
    """(_SweepCheckpointer, chunk_size, restored state) for a durable sweep,
    (None, chunk_size, None) without a checkpoint_dir."""
    if checkpoint_dir is None:
        return None, chunk_size, None
    if chunk_size is None:
        chunk_size = _DEFAULT_CHUNK
    params = dict(parts[-1], chunk_size=chunk_size)
    ckpt = _SweepCheckpointer(
        checkpoint_dir, _fingerprint(*parts[:-1], params), keep_last_k
    )
    return ckpt, chunk_size, ckpt.load()


def _run_rounds(pending, next_round, chunk_size, ckpt, checkpoint_dir,
                results, c_os, solve_chunk):
    """The sweep loop: rounds of chunked solves, a save per chunk.

    ``solve_chunk(chunk)`` solves one chunk and returns the items to regrow
    (it writes the accepted results into ``results``).  With a checkpointer
    every chunk's state is saved (async; the commit barrier is ``wait()``)
    and a SIGTERM raises SweepPreempted once that chunk's step is durable."""
    preempt = _PreemptGuard(ckpt is not None)
    try:
        while pending or next_round:
            if not pending:
                pending, next_round = next_round, []
            plan = _round_plan(pending, chunk_size)
            for ci, chunk in enumerate(plan):
                next_round += solve_chunk(chunk)
                if ckpt is not None:
                    remaining = [it for ch in plan[ci + 1:] for it in ch]
                    ckpt.save(_sweep_state(results, remaining, next_round, c_os))
                    if preempt.hit and (remaining or next_round):
                        ckpt.wait()  # the named step must be durable
                        raise SweepPreempted(checkpoint_dir, ckpt.step - 1)
            pending, next_round = next_round, []
    finally:
        preempt.restore()
        if ckpt is not None:
            ckpt.wait()


def _regrown(sp, grow_factor, max_s_max):
    return dataclasses.replace(
        sp, s_max=min(int(np.ceil(sp.s_max * grow_factor)), max_s_max)
    )


def sweep_solve(
    specs: Sequence[SMDPSpec],
    eps: float = 1e-2,
    max_iter: int = 10_000,
    delta: float = 1e-3,
    grow_factor: float = 1.5,
    max_s_max: int = 4096,
    auto_c_o: bool = True,
    accel: str = "auto",
    backup: str = "banded",
    guard: bool = True,
    report_sink: Optional[list] = None,
    checkpoint_dir: Optional[str] = None,
    chunk_size: Optional[int] = None,
    keep_last_k: int = 3,
    *,
    device: DeviceLike = None,
) -> List[SolveResult]:
    """Batched equivalent of solve.solve() over a list of specs.

    Returns one SolveResult per input spec, in input order; each matches the
    serial solver's output for the same spec to solver tolerance.  Specs with
    differing s_max are padded to the batch maximum first.  Results carry no
    dense tensors — ``result.mdp`` materializes one lazily if accessed.

    ``accel`` / ``backup`` are forwarded to the batched RVI, which runs on
    ``device`` (CUDA unless ``device="cpu"``).  The default "auto" routes
    through accel="mpi" whenever the sweep reaches into the slow-mixing
    regime (any rho >= ACCEL_RHO_THRESHOLD) and stays on the plain
    lockstep path otherwise.  ``chunk_size`` splits each round's batches.

    ``guard`` (default on) runs every batched solve through the rvi
    guardrail ladder; rows the full ladder cannot heal come back with NaN
    evals rather than raising, on every device.  On a CUDA device with
    backup="pallas" a row that the banded rung heals raises instead: the
    kernel disagreed with its plain version there (rvi._ladder).  Pass a
    list as ``report_sink`` to receive one merged rvi.SolveReport for the
    sweep.

    ``checkpoint_dir`` makes the sweep durable: progress is persisted after
    every ``chunk_size`` specs (default 16) via checkpoint.CheckpointManager
    (the last ``keep_last_k`` steps kept), a SIGTERM saves-and-raises
    SweepPreempted, and re-running the identical call with the same
    directory resumes — producing bitwise-identical results to a
    never-interrupted checkpointed run (wall_time_s excepted).  A
    checkpoint written by different specs or parameters, or on another
    device type (the card's f32 Bellman core and the CPU's plain version
    round differently), is rejected by fingerprint.
    """
    dev = resolve_device(device)
    specs = list(specs)
    flags = {sp.buffer is not None for sp in specs}
    if len(flags) > 1:
        raise ValueError(
            "sweep_solve cannot mix finite-buffer and tail-abstracted "
            "specs in one batch; solve the two families separately"
        )
    if flags and flags.pop():
        # finite-buffer solves: no abstract tail to calibrate, and Delta
        # is not a truncation error (B is physical) — never regrow
        auto_c_o = False
        delta = None
    specs = pad_specs(specs)
    if not specs:
        return []
    if accel == "auto":
        accel = (
            "mpi"
            if max(sp.rho for sp in specs) >= _ACCEL_RHO_THRESHOLD
            else "none"
        )
    # chain the work along rho (then w2) once, up front: the warm-start
    # anchors become the extreme-rho specs, where mixing is worst, and the
    # c_o probe batch can be reused (row-patched) as the first solve batch
    order = sorted(
        range(len(specs)), key=lambda i: (specs[i].rho, specs[i].w2)
    )
    ckpt, chunk_size, state = _checkpointer(
        checkpoint_dir, chunk_size, keep_last_k, specs,
        dict(kind="sweep_solve", eps=eps, max_iter=max_iter, delta=delta,
             grow_factor=grow_factor, max_s_max=max_s_max, auto_c_o=auto_c_o,
             accel=accel, backup=backup, guard=guard, device=dev.type),
    )
    prebuilt = c_os = None
    if auto_c_o:
        if state is not None:
            c_os = state["meta//c_o"]
            base = [
                dataclasses.replace(specs[i], c_o=float(c))
                for i, c in zip(order, c_os)
            ]
        else:
            probe_batch = build_smdp_batched(
                [dataclasses.replace(specs[i], c_o=0.0) for i in order]
            )
            c_os = _greedy_c_o(probe_batch)
            patched = probe_batch.with_c_o(c_os)
            base = list(patched.specs)
            if ckpt is None:
                # resumable runs always rebuild chunk batches from specs,
                # so a resumed first round matches the one-shot bit-for-bit
                prebuilt = patched
    else:
        base = [specs[i] for i in order]
    pending = list(zip(order, base))
    results: List[SolveResult] = [None] * len(specs)  # type: ignore[list-item]
    report_parts: List[Tuple[SolveReport, List[int]]] = []
    next_round: List[tuple] = []
    if state is not None:
        restored, pending, next_round = _restore_queues(state, pending)
        for idx, (sp, rvi, ev) in restored.items():
            results[idx] = SolveResult(spec=sp, rvi=rvi, eval=ev)
        if guard and restored:
            report_parts.append(_restored_report(results, sorted(restored), eps))
    rvi_kw = dict(accel=accel, backup=backup, device=dev)

    def solve_chunk(chunk):
        nonlocal prebuilt
        if (
            prebuilt is not None
            and len(chunk) == prebuilt.n_specs
            and all(a is b for (_, a), b in zip(chunk, prebuilt.specs))
        ):
            batch = prebuilt
        else:
            batch = build_smdp_batched([sp for _, sp in chunk])
        prebuilt = None  # the probe batch serves the first round only
        rvi = relative_value_iteration_batched(
            batch,
            eps=eps,
            max_iter=max_iter,
            h0=_anchor_warm_start(batch, eps, max_iter, **rvi_kw),
            guard=guard,
            **rvi_kw,
        )
        if rvi.report is not None:
            healthy = rvi.report.healthy
            report_parts.append((rvi.report, [idx for idx, _ in chunk]))
        else:
            healthy = np.ones(len(chunk), dtype=bool)
        evs = _eval_healthy(batch, rvi.policies, healthy,
                            evaluate_policy_batched, lambda sp: sp.s_max + 1)
        regrow = []
        for row, (idx, sp) in enumerate(chunk):
            ev = evs[row]
            if (
                not healthy[row]
                # ladder-exhausted row: keep the NaN-flagged result
                # (growing the truncation cannot heal divergence)
                or delta is None
                or ev.delta < delta
                or sp.s_max >= max_s_max
            ):
                results[idx] = SolveResult(spec=sp, rvi=rvi.unstack(row), eval=ev)
            else:
                regrow.append((idx, _regrown(sp, grow_factor, max_s_max)))
        return regrow

    _run_rounds(pending, next_round, chunk_size, ckpt, checkpoint_dir,
                results, c_os, solve_chunk)
    if report_sink is not None:
        report_sink.append(
            SolveReport.merged(report_parts, len(specs), eps)
            if report_parts
            else _restored_report(results, list(range(len(specs))), eps)[0]
        )
    return results


# ---------------------------------------------------------------------------
# Phase-modulated sweeps (exact MMPP-aware solves)
# ---------------------------------------------------------------------------


def _greedy_c_o_modulated(mbatch) -> np.ndarray:
    """Per-spec abstract cost c_o = max(100, 2 * g_greedy), modulated chain.

    The greedy policy is phase-independent (largest feasible batch now), so
    its (K, S) lift is the scalar table tiled across phases; gains come
    from the batched product-chain stationary solve."""
    K = mbatch.n_phases
    pols = np.stack(
        [
            np.tile(greedy_policy(sp.s_max, sp.b_min, sp.b_max)[None, :], (K, 1))
            for sp in mbatch.specs
        ]
    )
    out = np.empty(mbatch.n_specs)
    try:
        evs = evaluate_policy_modulated_batched(mbatch, pols)
        for i, ev in enumerate(evs):
            out[i] = max(100.0, 2.0 * ev.g)
    except RuntimeError:
        for i in range(mbatch.n_specs):
            try:
                g = evaluate_policy_modulated(mbatch, i, pols[i]).g
            except RuntimeError:
                g = 100.0
            out[i] = max(100.0, 2.0 * g)
    return out


def sweep_solve_modulated(
    specs: Sequence[SMDPSpec],
    phases,
    eps: float = 1e-2,
    max_iter: int = 10_000,
    delta: float = 1e-3,
    grow_factor: float = 1.5,
    max_s_max: int = 1024,
    auto_c_o: bool = True,
    accel: str = "auto",
    guard: bool = True,
    report_sink: Optional[list] = None,
    checkpoint_dir: Optional[str] = None,
    chunk_size: Optional[int] = None,
    keep_last_k: int = 3,
    *,
    device: DeviceLike = None,
) -> List[ModulatedSolveResult]:
    """Batched exact MMPP-aware solves over aligned (spec, phases) pairs.

    The modulated mirror of sweep_solve: specs are padded to a shared
    s_max, sorted along (rho, w2) so anchor warm starts chain along the
    rho axis per phase block, the c_o = 0 probe batch calibrates every
    abstract cost with one batched product-chain stationary solve (then
    row-patched via with_c_o, never rebuilt), and the paper's adaptive
    truncation rule regrows only the specs whose Delta (summed over every
    phase's overflow state) still exceeds ``delta``.  Results return in
    input order; each carries the (K, S) phase-indexed policy.  The RVI
    runs in float64 on ``device`` (CUDA unless ``device="cpu"``).

    ``phases`` may be one shared PhaseConfig or a sequence aligned with
    ``specs``.  ``max_s_max`` defaults lower than the scalar sweep: the
    product chain is K x larger per state.  ``guard`` / ``report_sink`` /
    ``checkpoint_dir`` / ``chunk_size`` / ``keep_last_k`` behave exactly as
    in sweep_solve: with a checkpoint_dir the sweep is durable,
    SIGTERM-preemptible, and resumes bitwise-identically on the same
    device type.
    """
    dev = resolve_device(device)
    specs = list(specs)
    if not specs:
        return []
    if isinstance(phases, PhaseConfig):
        phases = [phases] * len(specs)
    phases = list(phases)
    if len(phases) != len(specs):
        raise ValueError(f"{len(phases)} phase configs for {len(specs)} specs")
    specs = pad_specs(specs)
    if accel == "auto":
        # the burst phase sets the mixing wall: key on max within-phase rho
        rho_z = max(phase_rho(sp, ph) for sp, ph in zip(specs, phases))
        accel = "mpi" if rho_z >= _ACCEL_RHO_THRESHOLD else "none"
    order = sorted(range(len(specs)), key=lambda i: (specs[i].rho, specs[i].w2))
    ckpt, chunk_size, state = _checkpointer(
        checkpoint_dir, chunk_size, keep_last_k, specs, phases,
        dict(kind="sweep_solve_modulated", eps=eps, max_iter=max_iter,
             delta=delta, grow_factor=grow_factor, max_s_max=max_s_max,
             auto_c_o=auto_c_o, accel=accel, guard=guard, device=dev.type),
    )
    prebuilt = c_os = None
    if auto_c_o:
        if state is not None:
            c_os = state["meta//c_o"]
            base = [
                dataclasses.replace(specs[i], c_o=float(c))
                for i, c in zip(order, c_os)
            ]
        else:
            probe = build_smdp_modulated_batched(
                [dataclasses.replace(specs[i], c_o=0.0) for i in order],
                [phases[i] for i in order],
            )
            c_os = _greedy_c_o_modulated(probe)
            patched = probe.with_c_o(c_os)
            base = list(patched.specs)
            if ckpt is None:
                prebuilt = patched
    else:
        base = [specs[i] for i in order]
    pending = [(i, sp, phases[i]) for i, sp in zip(order, base)]
    results: List[ModulatedSolveResult] = [None] * len(specs)  # type: ignore[list-item]
    report_parts: List[Tuple[SolveReport, List[int]]] = []
    next_round: List[tuple] = []
    if state is not None:
        restored, pending, next_round = _restore_queues(state, pending, phases)
        for idx, (sp, rvi, ev) in restored.items():
            results[idx] = ModulatedSolveResult(
                spec=sp, phases=phases[idx], rvi=rvi, eval=ev
            )
        if guard and restored:
            report_parts.append(_restored_report(results, sorted(restored), eps))
    rvi_kw = dict(accel=accel, device=dev)

    def solve_chunk(chunk):
        nonlocal prebuilt
        if (
            prebuilt is not None
            and len(chunk) == prebuilt.n_specs
            and all(a is b for (_, a, _), b in zip(chunk, prebuilt.specs))
        ):
            mbatch = prebuilt
        else:
            mbatch = build_smdp_modulated_batched(
                [sp for _, sp, _ in chunk], [ph for _, _, ph in chunk]
            )
        prebuilt = None  # the probe batch serves the first round only
        rvi = relative_value_iteration_modulated(
            mbatch,
            eps=eps,
            max_iter=max_iter,
            h0=_anchor_warm_start_modulated(mbatch, eps, max_iter, **rvi_kw),
            guard=guard,
            **rvi_kw,
        )
        if rvi.report is not None:
            healthy = rvi.report.healthy
            report_parts.append((rvi.report, [idx for idx, _, _ in chunk]))
        else:
            healthy = np.ones(len(chunk), dtype=bool)
        evs = _eval_healthy(
            mbatch, rvi.policies, healthy, evaluate_policy_modulated_batched,
            lambda sp: mbatch.n_phases * (sp.s_max + 1),
        )
        regrow = []
        for row, (idx, sp, ph) in enumerate(chunk):
            ev = evs[row]
            if (
                not healthy[row]
                or delta is None
                or ev.delta < delta
                or sp.s_max >= max_s_max
            ):
                results[idx] = ModulatedSolveResult(
                    spec=sp, phases=ph, rvi=rvi.unstack(row), eval=ev
                )
            else:
                regrow.append((idx, _regrown(sp, grow_factor, max_s_max), ph))
        return regrow

    _run_rounds(pending, next_round, chunk_size, ckpt, checkpoint_dir,
                results, c_os, solve_chunk)
    if report_sink is not None:
        report_sink.append(
            SolveReport.merged(report_parts, len(specs), eps)
            if report_parts
            else _restored_report(results, list(range(len(specs))), eps)[0]
        )
    return results


def solve_modulated(
    spec: SMDPSpec, phases: PhaseConfig, **kw
) -> ModulatedSolveResult:
    """Exact MMPP-aware solve of one spec (the N == 1 modulated sweep).

    ``spec.lam`` must equal ``phases.mean_rate`` (use smdp.modulated_spec).
    The K = 1 degenerate config reproduces the scalar solve() policy — the
    safety rail the tests pin.  ``device=None`` means CUDA.
    """
    return sweep_solve_modulated([spec], phases, **kw)[0]
