"""Batch schedulers: the SMDP policy (the paper) + benchmark policies.

A scheduler answers one question at each decision epoch (batch completion,
or arrival-at-idle): given s queued requests, what batch size now?
`0` means wait for more arrivals.

``as_action_table()`` lowers any stateless scheduler (SMDP / static /
greedy / Q-policy / oracle-phase) to the dense table the compiled event
kernel indexes.  Tables may carry a leading phase axis: a (K, L) stack,
one row per modulating phase; OraclePhaseScheduler selects the row from
the true switch trace, and its ``phase_at`` hands the same information to
the compiled lane as a per-arrival phase array.

A solved sweep (core.sweep.sweep_solve over a lambda / w2 / service-profile
grid) turns into an SMDPSchedulerBank via SMDPScheduler.bank() or
core.sweep.sweep_bank(): a keyed table bank the serving layer hot-swaps
(``retune``) when traffic, the energy-price weight, or the active service
profile shifts, without re-solving online; ``stacked()`` turns a bank into
one (P, L) array.

AdaptiveController closes the loop: an online arrival-rate estimate
(serving.metrics.RateEstimator) retunes the active table against the bank,
with hysteresis at regime boundaries; non-rate axes (w2, profile) are
pinned coordinates.  The compiled backend runs it inside the event kernel
(serving.compiled.AdaptiveLane).

Who sets the phase row of a (K, L) stack:

  * OraclePhaseScheduler — the true switch trace (estimation-free bound);
  * BeliefPhaseScheduler — the non-oracle counterpart: an MMPP forward
    filter (arrivals.PhaseBeliefFilter) tracks the phase posterior from
    inter-arrival gaps; the argmax phase selects the row, or the posterior
    blends the per-phase actions (``mode="mix"``);
  * AdaptiveController(phase_filter=...) — belief-tracked phase row on top
    of online lambda-estimate bank retuning;
  * PhaseAwareScheduler — per-phase tables (solve_phase_policies, the
    paper's Sec.-VIII heuristic) tracked by an EWMA rate estimate.

Copied from the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class Scheduler:
    name = "base"

    def decide(self, queue_len: int) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def snapshot(self) -> dict:
        return {}

    def restore(self, state: dict) -> None:
        pass


class SMDPScheduler(Scheduler):
    """Table-driven scheduler from a solved SMDP (paper eq. 30).

    The table may be 1-D (queue-indexed) or a (K, L) phase-indexed stack;
    with a stack, ``phase`` selects the active row.
    """

    name = "smdp"

    def __init__(self, solution):
        self._set_table(solution.action_table())
        self._bank: Optional["SMDPSchedulerBank"] = None
        self.phase = 0

    def _set_table(self, table: np.ndarray) -> None:
        table = np.asarray(table, dtype=np.int64)
        if table.ndim not in (1, 2):
            raise ValueError(f"action table must be 1-D or (K, L); got {table.shape}")
        self.table = table
        self.s_max = table.shape[-1] - 1

    @classmethod
    def from_table(cls, table: np.ndarray) -> "SMDPScheduler":
        obj = cls.__new__(cls)
        obj._set_table(table)
        obj._bank = None
        obj.phase = 0
        return obj

    @classmethod
    def bank(
        cls,
        solutions: Sequence,
        keys: Optional[Sequence[Tuple[float, ...]]] = None,
        key_names: Tuple[str, ...] = ("lam", "w2"),
    ) -> "SMDPSchedulerBank":
        """Turn a solved sweep into a hot-swappable table bank.

        By default each solution is keyed by its spec's (lam, w2); pass
        explicit ``keys`` (tuples aligned with ``key_names``) to key on
        other sweep axes (e.g. service profile id).
        """
        if keys is None:
            keys = [
                tuple(float(getattr(sol.spec, n)) for n in key_names)
                for sol in solutions
            ]
        if len(keys) != len(solutions):
            raise ValueError("keys and solutions must align")
        tables = {}
        for key, sol in zip(keys, solutions):
            k = tuple(float(v) for v in key)
            if k in tables:
                raise ValueError(
                    f"duplicate bank key {k}: the sweep varies something "
                    f"{key_names} does not capture — pass explicit keys"
                )
            tables[k] = sol.action_table()
        return SMDPSchedulerBank(tables, key_names)

    def decide(self, queue_len: int) -> int:
        table = self.table
        if table.ndim == 1:
            row = table
        else:
            if not 0 <= self.phase < table.shape[0]:
                # same contract as the compiled lane's phases validation:
                # fail loudly instead of silently serving a clamped row
                raise ValueError(
                    f"phase {self.phase} outside table stack "
                    f"[0, {table.shape[0]})"
                )
            row = table[self.phase]
        return int(row[min(queue_len, len(row) - 1)])

    def phase_at(self, times) -> np.ndarray:
        """Per-arrival phases for the compiled lane: the pinned phase."""
        return np.full(len(times), int(self.phase), dtype=np.int64)

    def swap_table(self, table: np.ndarray) -> None:
        """Hot-swap the action table (atomic from decide()'s point of view).

        The phase pointer survives the swap.
        """
        self._set_table(table)

    def retune(self, **coords: float) -> Tuple[float, ...]:
        """Re-point at the bank entry nearest the observed operating point.

        Returns the selected key.  Requires the scheduler to have been
        minted by an SMDPSchedulerBank.
        """
        if self._bank is None:
            raise RuntimeError("scheduler has no attached bank; use bank()")
        key = self._bank.nearest(**coords)
        self.swap_table(self._bank.tables[key])
        return key

    def snapshot(self) -> dict:
        return {"phase": self.phase}

    def restore(self, state: dict) -> None:
        self.phase = int(state.get("phase", 0))


class SMDPSchedulerBank:
    """Keyed bank of solved SMDP action tables (one sweep, many regimes).

    ``tables`` maps key tuples (aligned with ``key_names``, e.g. (lam, w2))
    to dense action tables.  ``nearest`` picks the entry closest to an
    observed operating point so the serving layer can hot-swap policies as
    traffic or the energy price shifts, without re-solving online.
    """

    def __init__(
        self,
        tables: Dict[Tuple[float, ...], np.ndarray],
        key_names: Tuple[str, ...] = ("lam", "w2"),
    ):
        if not tables:
            raise ValueError("empty scheduler bank")
        self.key_names = tuple(key_names)
        self.tables = {
            tuple(float(v) for v in k): np.asarray(t, dtype=np.int64)
            for k, t in tables.items()
        }
        for key, t in self.tables.items():
            if len(key) != len(self.key_names):
                raise ValueError(f"key {key} does not match {self.key_names}")
            if t.ndim not in (1, 2):
                raise ValueError(f"table for {key} must be 1-D or (K, L)")
        ndims = {t.ndim for t in self.tables.values()}
        phase_counts = {
            t.shape[0] for t in self.tables.values() if t.ndim == 2
        }
        if len(ndims) > 1 or len(phase_counts) > 1:
            raise ValueError(
                "bank tables must agree on the phase axis (all 1-D, or all "
                f"(K, L) with one K); got ndims {ndims}, K {phase_counts}"
            )
        self.n_phases = phase_counts.pop() if phase_counts else 1
        # the key set is immutable after construction: cache the sorted key
        # list and point matrix once, so nearest()/distance() stay cheap
        self._sorted_keys = sorted(self.tables)
        self._key_index = {k: i for i, k in enumerate(self._sorted_keys)}
        self._pts = np.array(self._sorted_keys, dtype=np.float64)
        # per-dimension scale for the nearest-key metric (range, not |max|,
        # so sweeps over a narrow band around a large value still resolve)
        span = self._pts.max(axis=0) - self._pts.min(axis=0)
        self._scales = np.where(span > 0, span, 1.0)

    def __len__(self) -> int:
        return len(self.tables)

    def keys(self):
        return list(self._sorted_keys)

    def distances(self, **coords: float) -> np.ndarray:
        """Scaled distance of every key (in keys() order) to the point."""
        dims, target = self._resolve_coords(coords)
        pts = self._pts[:, dims]
        return np.linalg.norm(
            (pts - target[None, :]) / self._scales[dims], axis=1
        )

    def nearest(self, **coords: float) -> Tuple[float, ...]:
        """Key closest to the given operating point (subset of dims OK)."""
        return self._sorted_keys[int(np.argmin(self.distances(**coords)))]

    def distance(self, key: Tuple[float, ...], **coords: float) -> float:
        """Scaled distance of a bank key to an operating point."""
        key = tuple(float(v) for v in key)
        if key not in self.tables:
            raise KeyError(f"{key} not in bank")
        return float(self.distances(**coords)[self._key_index[key]])

    def _resolve_coords(self, coords: Dict[str, float]):
        unknown = set(coords) - set(self.key_names)
        if unknown:
            raise ValueError(f"unknown key dims {unknown}; have {self.key_names}")
        if not coords:
            raise ValueError("need at least one coordinate")
        dims = [i for i, n in enumerate(self.key_names) if n in coords]
        target = np.array([coords[self.key_names[i]] for i in dims])
        return dims, target

    def scheduler(self, **coords: float) -> SMDPScheduler:
        """Mint an SMDPScheduler on the nearest entry, wired for retune()."""
        key = self.nearest(**coords)
        sch = SMDPScheduler.from_table(self.tables[key])
        sch._bank = self
        return sch

    def stacked(self, keys=None):
        """(keys, stacked array): the bank as a dense policy axis.

        Tables shorter than the longest are padded by repeating their last
        entry — exactly the eq.-(30) extension decide() applies, so the
        padded row is decision-for-decision the same scheduler.  Row order
        follows ``keys`` (default: sorted keys()): a (P, L) array for
        queue-indexed banks, (P, K, L) for phase-indexed ones.
        """
        ks = [
            tuple(float(v) for v in k)
            for k in (self._sorted_keys if keys is None else keys)
        ]
        if not ks:
            raise ValueError("stacked() with an empty key list")
        missing = [k for k in ks if k not in self.tables]
        if missing:
            raise KeyError(f"keys not in bank: {missing}")
        L = max(self.tables[k].shape[-1] for k in ks)
        return ks, np.stack([_extend_last(self.tables[k], L) for k in ks])


class AdaptiveController(Scheduler):
    """Online regime adaptation: rate estimator -> bank retune, hysteresis.

    Wraps a bank-minted SMDPScheduler.  Every observed arrival updates a
    RateEstimator (serving.metrics); when the estimate drifts toward a
    different bank entry the controller retunes the scheduler onto it,
    guarded by a relative-margin hysteresis (the candidate key must be
    closer than (1 - margin) x the current key's distance) and a minimum
    dwell time between switches, so the table does not thrash at regime
    boundaries.  This is the paper's Sec.-VIII "detect the phase, apply
    the per-phase policy" run against a solved lambda x w2 sweep bank
    (core.sweep.sweep_bank).  A phase-axis bank serves its pinned phase
    row, or with ``phase_filter=`` (an arrivals.PhaseBeliefFilter) the row
    of the filter's argmax phase.
    """

    name = "smdp_adaptive"

    def __init__(
        self,
        bank: "SMDPSchedulerBank",
        *,
        estimator=None,
        ewma: float = 0.1,
        margin: float = 0.25,
        min_dwell: float = 0.0,
        init_rate: Optional[float] = None,
        phase_filter=None,  # arrivals.PhaseBeliefFilter for phase-axis banks
        **fixed: float,  # pinned non-rate coords, e.g. w2=1.0
    ):
        from .metrics import RateEstimator

        if "lam" not in bank.key_names:
            raise ValueError(f"bank has no 'lam' axis: {bank.key_names}")
        lam_keys = sorted({k[bank.key_names.index("lam")] for k in bank.keys()})
        if init_rate is None:
            init_rate = float(np.mean(lam_keys))
        self.bank = bank
        self.fixed = {k: float(v) for k, v in fixed.items()}
        self.estimator = estimator if estimator is not None else RateEstimator(
            ewma=ewma, init=init_rate
        )
        self.margin = margin
        self.min_dwell = min_dwell
        self.phase_filter = phase_filter
        rate0 = self.estimator.rate
        if not np.isfinite(rate0):  # custom estimator with no data yet
            rate0 = init_rate
        self.key = bank.nearest(lam=rate0, **self.fixed)
        self.scheduler = SMDPScheduler.from_table(bank.tables[self.key])
        self.scheduler._bank = bank
        if phase_filter is not None:
            self.scheduler.phase = phase_filter.phase
        self._last_switch = -float("inf")
        self.n_switches = 0

    def observe_arrival(self, t: float) -> None:
        self.estimator.observe(t)
        if self.phase_filter is not None:
            # belief row selection and lambda retuning move independently:
            # the filter reacts within a few gaps, the estimator/hysteresis
            # pair guards the (slower) bank-entry swap
            self.phase_filter.observe(t)
            self.scheduler.phase = self.phase_filter.phase
        self._maybe_retune(t)

    def _maybe_retune(self, t: float) -> None:
        if t - self._last_switch < self.min_dwell:
            return
        est = self.estimator.rate
        if not np.isfinite(est):
            return
        d = self.bank.distances(lam=est, **self.fixed)
        i_cand = int(np.argmin(d))
        cand = self.bank._sorted_keys[i_cand]
        if cand == self.key:
            return
        d_cur = float(d[self.bank._key_index[self.key]])
        d_cand = float(d[i_cand])
        if d_cand < (1.0 - self.margin) * d_cur:
            self.key = cand
            self.scheduler.swap_table(self.bank.tables[cand])
            self._last_switch = t
            self.n_switches += 1

    def decide(self, queue_len: int) -> int:
        return self.scheduler.decide(queue_len)

    def snapshot(self) -> dict:
        snap = {
            "estimator": self.estimator.snapshot(),
            "key": self.key,
            "last_switch": self._last_switch,
            "n_switches": self.n_switches,
            "phase": self.scheduler.phase,
        }
        if self.phase_filter is not None:
            snap["phase_filter"] = self.phase_filter.snapshot()
        return snap

    def restore(self, state: dict) -> None:
        self.estimator.restore(state["estimator"])
        self.key = tuple(float(v) for v in state["key"])
        self.scheduler.swap_table(self.bank.tables[self.key])
        self.scheduler.phase = int(state.get("phase", 0))
        if self.phase_filter is not None and "phase_filter" in state:
            self.phase_filter.restore(state["phase_filter"])
        self._last_switch = state["last_switch"]
        self.n_switches = state["n_switches"]


def _extend_last(t: np.ndarray, length: int) -> np.ndarray:
    """Extend a table along its last axis by repeating the final entry.

    The eq.-(30) infinite-state extension, so padded rows stay
    decision-for-decision identical to their originals.
    """
    width = length - t.shape[-1]
    if width <= 0:
        return t
    return np.concatenate([t, np.repeat(t[..., -1:], width, axis=-1)], axis=-1)


def _phase_stack(tables: Dict[int, np.ndarray]) -> np.ndarray:
    """(K, L) stack from a {phase: table} dict (contiguous 0..K-1 keys)."""
    keys = sorted(tables)
    if keys != list(range(len(keys))):
        raise ValueError(f"phase keys must be 0..K-1, got {keys}")
    tabs = [np.asarray(tables[k], dtype=np.int64) for k in keys]
    L = max(len(t) for t in tabs)
    return np.stack([_extend_last(t, L) for t in tabs])


def solve_phase_policies(base, rates: Dict[int, float], **solve_kw):
    """Offline: one SMDP solution per phase rate (paper Sec. VIII).

    The *heuristic* per-phase decomposition — each phase solved as an
    independent Poisson queue at its own rate.  The exact alternative is
    core.solve_modulated, which optimizes the (phase, queue) product chain
    jointly.  ``solve_kw`` goes to core.solve (``backup=``, ``device=``).
    """
    from ..core.solve import solve

    tables = {}
    for phase, lam in rates.items():
        spec = dataclasses.replace(base, lam=lam)
        tables[phase] = solve(spec, **solve_kw).action_table(spec.s_max)
    return tables


class PhaseAwareScheduler(AdaptiveController):
    """Per-phase SMDP tables selected by an EWMA rate estimator.

    A thin shim: the phase tables become a lambda-keyed SMDPSchedulerBank
    and AdaptiveController does the estimation + table swapping (margin 0 =
    always track the nearest phase rate, the original behaviour).
    """

    name = "smdp_phase"

    def __init__(self, tables: Dict[int, np.ndarray], rates: Dict[int, float],
                 ewma: float = 0.2):
        from .metrics import RateEstimator

        bank = SMDPSchedulerBank(
            {(float(rates[k]),): np.asarray(tables[k], dtype=np.int64)
             for k in rates},
            key_names=("lam",),
        )
        self._phase_of = {(float(lam),): phase for phase, lam in rates.items()}
        init = float(np.mean(list(rates.values())))
        super().__init__(
            bank,
            estimator=RateEstimator(ewma=ewma, init=init),
            margin=0.0,
            min_dwell=0.0,
            init_rate=init,
        )

    def current_phase(self) -> int:
        return self._phase_of[self.key]


class OraclePhaseScheduler(Scheduler):
    """Phase-aware with the true phase trace (estimation-free upper bound).

    Runs on both backends: the Python engine updates ``phase`` per admitted
    arrival (observe_arrival), and the compiled lane consumes the same
    information as a per-arrival phase array via ``phase_at`` +
    ``as_action_table`` (the (K, L) stack).
    """

    name = "smdp_oracle"

    def __init__(
        self,
        tables: Dict[int, np.ndarray],
        switch_log: Sequence[Tuple[float, int]],
    ):
        self.tables = {
            k: np.asarray(v, dtype=np.int64) for k, v in tables.items()
        }
        log = sorted(switch_log)
        self._switch_times = np.asarray([t for t, _ in log])
        self._phases = [p for _, p in log]
        self.phase = self._phases[0] if self._phases else 0

    def observe_arrival(self, t: float) -> None:
        if not self._phases:
            return
        i = int(np.searchsorted(self._switch_times, t, side="right")) - 1
        self.phase = self._phases[max(i, 0)]

    def phase_at(self, times) -> np.ndarray:
        """Vectorized phase lookup (the compiled lane's arrival phases)."""
        if not self._phases:
            return np.zeros(len(times), dtype=np.int64)
        i = np.searchsorted(self._switch_times, times, side="right") - 1
        return np.asarray(self._phases, dtype=np.int64)[np.maximum(i, 0)]

    def decide(self, queue_len: int) -> int:
        table = self.tables[self.phase]
        return int(table[min(queue_len, len(table) - 1)])

    def snapshot(self) -> dict:
        return {"phase": self.phase}

    def restore(self, state: dict) -> None:
        self.phase = state["phase"]


class BeliefPhaseScheduler(Scheduler):
    """Phase-indexed tables selected by the filtered phase posterior.

    The non-oracle counterpart of OraclePhaseScheduler: an MMPP forward
    filter (arrivals.PhaseBeliefFilter) turns observed inter-arrival gaps
    into a posterior over the hidden phase.  Two action rules:

      * ``mode="argmax"`` (default) — each decision uses the argmax-phase
        row of the (K, L) stack;
      * ``mode="mix"`` — the decision is the posterior-weighted mixture
        of the per-phase actions, ``round(sum_k b_k table[k, q])`` — a
        soft blend that hedges near-uniform beliefs instead of snapping
        to a row.

    Runs on both backends: the Python engine folds the filter per
    admitted arrival; the compiled lane precomputes the posterior rows in
    one launch of the belief kernel (arrivals.belief_forward) and rows /
    blends the stack inside the event kernel (serving.compiled
    ``phase_mode="belief_argmax"`` / ``"belief_mix"``) — the engine does
    this lowering for backend="compiled".
    """

    name = "smdp_belief"

    def __init__(self, tables, phase_filter, mode: str = "argmax"):
        if isinstance(tables, dict):
            tables = _phase_stack(tables)
        self.tables = np.asarray(tables, dtype=np.int64)
        if self.tables.ndim != 2:
            raise ValueError("BeliefPhaseScheduler needs a (K, L) stack")
        if mode not in ("argmax", "mix"):
            raise ValueError(f'mode must be "argmax" or "mix", got {mode!r}')
        self.filter = phase_filter
        self.mode = mode
        if mode == "mix":
            self.name = "smdp_belief_mix"

    @property
    def phase(self) -> int:
        return min(self.filter.phase, self.tables.shape[0] - 1)

    def observe_arrival(self, t: float) -> None:
        self.filter.observe(t)

    def decide(self, queue_len: int) -> int:
        col = min(queue_len, self.tables.shape[1] - 1)
        if self.mode == "mix":
            # same op order as the event kernel's mix rule (round of the
            # posterior-weighted action), so both backends agree
            return int(np.round(np.dot(self.filter.belief,
                                       self.tables[:, col])))
        return int(self.tables[self.phase, col])

    def snapshot(self) -> dict:
        return {"filter": self.filter.snapshot()}

    def restore(self, state: dict) -> None:
        self.filter.restore(state["filter"])


class StaticScheduler(Scheduler):
    """Fixed batch size b; waits until b requests are queued (Def. 1)."""

    def __init__(self, b: int):
        self.b = b
        self.name = f"static_{b}"

    def decide(self, queue_len: int) -> int:
        return self.b if queue_len >= self.b else 0


class GreedyScheduler(Scheduler):
    """Largest feasible batch now (Def. 2)."""

    name = "greedy"

    def __init__(self, b_min: int = 1, b_max: int = 32):
        self.b_min, self.b_max = b_min, b_max

    def decide(self, queue_len: int) -> int:
        if queue_len < self.b_min:
            return 0
        return min(queue_len, self.b_max)


class QPolicyScheduler(Scheduler):
    """Control-limit policy (Def. 3): serve min(s, B_max) iff s >= Q."""

    def __init__(self, q: int, b_max: int = 32):
        self.q, self.b_max = q, b_max
        self.name = f"qpolicy_{q}"

    def decide(self, queue_len: int) -> int:
        return min(queue_len, self.b_max) if queue_len >= self.q else 0


def as_action_table(scheduler: Scheduler, b_max: int) -> np.ndarray:
    """Lower a stateless scheduler to the dense table decide() implements.

    The compiled simulator indexes ``table[min(s, len - 1)]`` — identical
    to each scheduler's decide() for every queue length, because all
    these families are constant beyond their largest interesting state.
    Phase-indexed schedulers lower to their (K, L) stack.  Schedulers with
    no static table raise: they stay on the Python backend.
    """
    if isinstance(scheduler, OraclePhaseScheduler):
        return _phase_stack(scheduler.tables)
    if isinstance(scheduler, SMDPScheduler):
        return np.asarray(scheduler.table, dtype=np.int64)
    if isinstance(scheduler, StaticScheduler):
        s = np.arange(max(scheduler.b, b_max) + 1)
        return np.where(s >= scheduler.b, scheduler.b, 0).astype(np.int64)
    if isinstance(scheduler, GreedyScheduler):
        cap = min(scheduler.b_max, b_max)
        s = np.arange(max(scheduler.b_min, cap) + 1)
        return np.where(
            s >= scheduler.b_min, np.minimum(s, cap), 0
        ).astype(np.int64)
    if isinstance(scheduler, QPolicyScheduler):
        cap = min(scheduler.b_max, b_max)
        s = np.arange(max(scheduler.q, cap) + 1)
        return np.where(s >= scheduler.q, np.minimum(s, cap), 0).astype(
            np.int64
        )
    raise TypeError(
        f"{type(scheduler).__name__} has no static action table; "
        "online-adaptive schedulers lower through the engine's compiled "
        "belief/adaptive lanes (ServingEngine.run(backend='compiled'), "
        "serving.compiled AdaptiveLane / phase_mode) instead"
    )
