"""Pluggable arrival processes for the unified serving kernel, both backends.

The serving engine (serving.engine) is one event-driven loop; what differs
between scenarios is *where the next request comes from*.  An
ArrivalProcess answers exactly that — `next(rng)` yields the next
ArrivalEvent (time, optional payload/deadline) or None when the stream is
exhausted — and carries its own snapshot()/restore() state so every arrival
mode is restart-safe through the engine's checkpointing.

Implemented processes:
  * PoissonProcess — the paper's M/G^[b]/1 arrival side (rate lambda);
  * MMPP2Process   — two-phase Markov-modulated Poisson (paper Sec. VIII's
    "temporal composition of Poisson periods"); MMPP2 holds the parameters;
  * DiurnalProcess — time-varying rate (sinusoidal or piecewise-linear
    ramp), sampled exactly by thinning against the peak rate;
  * TraceProcess   — replay of recorded arrival times or Request objects
    (executor mode and like-for-like scheduler comparisons).

`as_process` coerces a rate, an MMPP2, an array of times, or a Request list
into the right process, so engine call-sites stay terse.

PhaseBeliefFilter is the MMPP forward filter (posterior over the hidden
phase from observed inter-arrival gaps) behind the non-oracle
phase-indexed schedulers (scheduler.BeliefPhaseScheduler and
AdaptiveController(phase_filter=...)); `belief_forward` folds it over whole
traces in one launch of the belief kernel (kernels/belief_forward.py).

The compiled backend (serving.compiled) replays every mode as a padded
sorted arrival array, pre-generated eagerly: `take(process, rng, ...)`
drains the stateful numpy process up to a horizon/count, consuming exactly
the draws the lazy engine path would (draw-for-draw parity with
backend="python", and with the reference package at equal seeds).

The on-device samplers -- `poisson_times`, `mmpp2_times` and
`diurnal_times`, the reference's ``*_times_jax`` -- draw whole traces on
the device from a ``torch.Generator`` (or a seed), a leading lane axis
standing in for the reference's vmap over keys; `mmpp2_times` walks its
phase chain in one launch of the MMPP sampler kernel
(kernels/mmpp_sample.py).  They agree with the numpy processes in
distribution, not draw for draw (another generator).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import belief_forward as _bf
from ..kernels import mmpp_sample as _mmpp


@dataclasses.dataclass
class ArrivalEvent:
    """One arrival: absolute time plus optional request attributes."""

    time: float
    payload: object = None
    deadline: Optional[float] = None  # absolute-time SLO; None = engine default
    rid: Optional[int] = None  # None = engine assigns the next id


class ArrivalProcess:
    """Stateful generator of successive arrivals (monotone in time)."""

    name = "base"

    def next(self, rng: np.random.Generator) -> Optional[ArrivalEvent]:
        raise NotImplementedError  # pragma: no cover - interface

    @property
    def mean_rate(self) -> float:
        raise NotImplementedError  # pragma: no cover - interface

    def snapshot(self) -> dict:
        return {}

    def restore(self, state: dict) -> None:
        pass


class PoissonProcess(ArrivalProcess):
    """Homogeneous Poisson arrivals at rate lam (i.i.d. exponential gaps)."""

    name = "poisson"

    def __init__(self, lam: float):
        if lam <= 0:
            raise ValueError(f"lam must be positive, got {lam}")
        self.lam = float(lam)
        self._t = 0.0

    def next(self, rng: np.random.Generator) -> ArrivalEvent:
        self._t += rng.exponential(1.0 / self.lam)
        return ArrivalEvent(self._t)

    @property
    def mean_rate(self) -> float:
        return self.lam

    def snapshot(self) -> dict:
        return {"t": self._t}

    def restore(self, state: dict) -> None:
        self._t = state["t"]


@dataclasses.dataclass(frozen=True)
class MMPP2:
    """Two-phase MMPP: rates lam1 < lam2, mean phase dwell times t1, t2."""

    lam1: float
    lam2: float
    dwell1: float
    dwell2: float

    @property
    def mean_rate(self) -> float:
        p1 = self.dwell1 / (self.dwell1 + self.dwell2)
        return p1 * self.lam1 + (1 - p1) * self.lam2

    def process(self) -> "MMPP2Process":
        return MMPP2Process(self)

    def sample_arrivals(self, horizon: float, rng: np.random.Generator):
        """Arrival times in [0, horizon) and the phase trace.

        Thin wrapper over MMPP2Process so the eager and lazy paths share one
        generator (identical draws for every arrival below the horizon).
        """
        proc = MMPP2Process(self, log_switches=True)
        arrivals: List[float] = []
        while True:
            ev = proc.next(rng)
            if ev.time >= horizon:
                break
            arrivals.append(ev.time)
        return np.asarray(arrivals), list(proc.switch_log)


class MMPP2Process(ArrivalProcess):
    """Lazy MMPP(2) arrival generator; state = (phase, next switch time)."""

    name = "mmpp2"

    def __init__(self, mmpp: MMPP2, log_switches: bool = False):
        self.mmpp = mmpp
        self._t = 0.0
        self.phase = 0
        self._next_switch: Optional[float] = None  # drawn on first next()
        self.switch_log: List[Tuple[float, int]] = [(0.0, 0)] if log_switches else []
        self._log = log_switches

    def _rate(self) -> float:
        return self.mmpp.lam1 if self.phase == 0 else self.mmpp.lam2

    def _dwell(self) -> float:
        return self.mmpp.dwell1 if self.phase == 0 else self.mmpp.dwell2

    def next(self, rng: np.random.Generator) -> ArrivalEvent:
        if self._next_switch is None:
            self._next_switch = rng.exponential(self._dwell())
        while True:
            dt = rng.exponential(1.0 / self._rate())
            if self._t + dt >= self._next_switch:
                self._t = self._next_switch
                self.phase ^= 1
                if self._log:
                    self.switch_log.append((self._t, self.phase))
                self._next_switch = self._t + rng.exponential(self._dwell())
                continue
            self._t += dt
            return ArrivalEvent(self._t)

    @property
    def mean_rate(self) -> float:
        return self.mmpp.mean_rate

    def snapshot(self) -> dict:
        return {
            "t": self._t,
            "phase": self.phase,
            "next_switch": self._next_switch,
            "switch_log": list(self.switch_log),
        }

    def restore(self, state: dict) -> None:
        self._t = state["t"]
        self.phase = state["phase"]
        self._next_switch = state["next_switch"]
        self.switch_log = [tuple(x) for x in state["switch_log"]]


class DiurnalProcess(ArrivalProcess):
    """Time-varying Poisson arrivals: sinusoidal or piecewise-linear rate.

    rate(t) = base + amp * sin(2 pi (t + phase0) / period), or — when
    ``ramp`` is given — the cyclic piecewise-linear interpolation of
    [(tau_i, rate_i)] breakpoints over one period.  Sampling is exact via
    thinning against the peak rate (candidate gaps at rate_max, accepted
    with probability rate(t)/rate_max), so snapshot state is just the
    clock.
    """

    name = "diurnal"

    def __init__(
        self,
        base: float = 1.0,
        amp: float = 0.0,
        period: float = 86400.0,
        phase0: float = 0.0,
        ramp: Optional[Sequence[Tuple[float, float]]] = None,
    ):
        if period <= 0:
            raise ValueError(f"period must be positive, got {period}")
        self.period = float(period)
        self.phase0 = float(phase0)
        self.base = float(base)
        self.amp = float(amp)
        if ramp is not None:
            pts = sorted((float(t), float(r)) for t, r in ramp)
            if not pts:
                raise ValueError("ramp needs at least one breakpoint")
            if pts[0][0] < 0 or pts[-1][0] >= self.period:
                raise ValueError("ramp breakpoints must lie in [0, period)")
            self._taus = np.array([t for t, _ in pts])
            self._vals = np.array([r for _, r in pts])
            self.rate_max = float(self._vals.max())
            rate_min = float(self._vals.min())
        else:
            self._taus = self._vals = None
            self.rate_max = self.base + abs(self.amp)
            rate_min = self.base - abs(self.amp)
        if rate_min <= 0:
            raise ValueError("rate must stay positive over the whole cycle")
        self._t = 0.0

    def rate(self, t) -> np.ndarray:
        """Instantaneous arrival rate at (absolute) time t."""
        tau = np.mod(np.asarray(t, dtype=np.float64) + self.phase0, self.period)
        if self._taus is None:
            return self.base + self.amp * np.sin(2.0 * np.pi * tau / self.period)
        # cyclic linear interpolation: wrap the first breakpoint past the end
        taus = np.concatenate([self._taus, [self._taus[0] + self.period]])
        vals = np.concatenate([self._vals, [self._vals[0]]])
        return np.interp(
            np.where(tau < taus[0], tau + self.period, tau), taus, vals
        )

    @property
    def mean_rate(self) -> float:
        if self._taus is None:
            return self.base  # sine integrates to zero over a cycle
        grid = np.linspace(0.0, self.period, 4097)
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(self.rate(grid - self.phase0), grid) / self.period)

    def next(self, rng: np.random.Generator) -> ArrivalEvent:
        while True:
            self._t += rng.exponential(1.0 / self.rate_max)
            if rng.uniform() * self.rate_max < float(self.rate(self._t)):
                return ArrivalEvent(self._t)

    def snapshot(self) -> dict:
        return {"t": self._t}

    def restore(self, state: dict) -> None:
        self._t = state["t"]


class TraceProcess(ArrivalProcess):
    """Replay a recorded arrival trace (times, or Request-like objects).

    Accepts an array of arrival times or a sequence of objects exposing
    .arrival (and optionally .payload / .deadline / .rid, e.g. engine
    Requests).  The same trace through two engine modes yields the same
    admission sequence — the basis of like-for-like scheduler comparisons.
    """

    name = "trace"

    def __init__(self, trace: Sequence):
        events: List[ArrivalEvent] = []
        for item in trace:
            if hasattr(item, "arrival"):
                events.append(
                    ArrivalEvent(
                        time=float(item.arrival),
                        payload=getattr(item, "payload", None),
                        deadline=getattr(item, "deadline", None),
                        rid=getattr(item, "rid", None),
                    )
                )
            else:
                events.append(ArrivalEvent(float(item)))
        self.events = sorted(events, key=lambda e: e.time)
        self._i = 0

    def next(self, rng: np.random.Generator) -> Optional[ArrivalEvent]:
        if self._i >= len(self.events):
            return None
        ev = self.events[self._i]
        self._i += 1
        return ev

    def drain(self) -> List[ArrivalEvent]:
        """Consume and return every remaining event (cursor to the end).

        The compiled backend materializes the whole remaining trace at
        once; paired with rewind() it is the batch equivalent of repeated
        next() calls, keeping the cursor authoritative.
        """
        evs = self.events[self._i:]
        self._i = len(self.events)
        return evs

    def rewind(self, n: int) -> None:
        """Push the last n consumed events back onto the stream."""
        if not 0 <= n <= self._i:
            raise ValueError(f"cannot rewind {n} of {self._i} consumed")
        self._i -= n

    @property
    def mean_rate(self) -> float:
        if len(self.events) < 2:
            return float("nan")
        span = self.events[-1].time - self.events[0].time
        return (len(self.events) - 1) / span if span > 0 else float("inf")

    def snapshot(self) -> dict:
        return {"i": self._i}

    def restore(self, state: dict) -> None:
        self._i = state["i"]


# Posterior-mass floor below which a propagated belief counts as degenerate
# (shared by the numpy filter and the belief kernel with its plain version).
_BELIEF_TINY = _bf.BELIEF_TINY


class PhaseBeliefFilter:
    """Forward filter for the hidden MMPP phase from observed arrivals.

    The exact Bayesian posterior over the modulating phase given the
    arrival times seen so far:  between arrivals the belief evolves by
    exp((R - Lambda) * gap) (phase diffusion weighted by "no arrival
    occurred"), and each arrival multiplies in the per-phase rates:

        b'  propto  b @ expm((R - Lambda) gap) @ Lambda.

    The matrix exponential is precomputed as an eigendecomposition of
    (R - Lambda), so each observation costs O(K^2).  This is the
    non-oracle counterpart of the true-phase trace: schedulers select the
    argmax-phase table (scheduler.BeliefPhaseScheduler,
    AdaptiveController(phase_filter=...)).
    """

    def __init__(self, rates, gen, t0: float = 0.0, b0=None):
        self.rates = np.asarray(rates, dtype=np.float64)
        self.gen = np.asarray(gen, dtype=np.float64)
        K = len(self.rates)
        if self.gen.shape != (K, K):
            raise ValueError(f"gen shape {self.gen.shape} != ({K}, {K})")
        sub = self.gen - np.diag(self.rates)  # (R - Lambda)
        d, V = np.linalg.eig(sub)
        self._d, self._V = d, V
        self._Vinv = np.linalg.inv(V)
        if b0 is None:
            # stationary phase distribution of the modulating chain
            a = self.gen.T.copy()
            a[-1, :] = 1.0
            rhs = np.zeros(K)
            rhs[-1] = 1.0
            try:
                b0 = np.clip(np.linalg.solve(a, rhs), 0.0, None)
            except np.linalg.LinAlgError:
                b0 = np.ones(K)
        self._b0 = np.asarray(b0, dtype=np.float64) / np.sum(b0)
        self.belief = self._b0.copy()
        self._last = float(t0)
        self._t0 = float(t0)
        self.n_observed = 0

    def _propagate(self, gap: float) -> np.ndarray:
        e = (self._V * np.exp(self._d * gap)) @ self._Vinv
        return np.real(self.belief @ e)

    def observe(self, t: float) -> None:
        """Fold in one arrival at absolute time t (monotone in t).

        Long inter-arrival gaps drive exp((R - Lambda) gap) toward zero
        and round-off can leave tiny negative / non-finite entries, so
        the propagated mass is clipped and renormalized *before* the
        rate reweighting; if the whole vector degenerates the belief
        falls back to the stationary phase distribution instead of
        emitting NaNs.
        """
        gap = max(float(t) - self._last, 0.0)
        p = self._propagate(gap)
        p = np.where(np.isfinite(p), np.clip(p, 0.0, None), 0.0)
        s = float(p.sum())
        if not np.isfinite(s) or s <= _BELIEF_TINY:
            p = self._b0  # degenerate propagation: stationary fallback
            s = float(p.sum())
        b = (p / s) * self.rates
        s2 = float(b.sum())
        if not np.isfinite(s2) or s2 <= _BELIEF_TINY:
            b = self._b0 * self.rates
            s2 = float(b.sum())
        self.belief = b / s2
        self._last = float(t)
        self.n_observed += 1

    @property
    def phase(self) -> int:
        """MAP phase under the current belief."""
        return int(np.argmax(self.belief))

    def consts(self, device: torch.device) -> _bf.FilterConsts:
        """The filter's constants as the belief kernel's f64 tensors."""
        def f64(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                                   device=device)

        d, V, Vi = (np.asarray(x, dtype=np.complex128)
                    for x in (self._d, self._V, self._Vinv))
        return _bf.FilterConsts(f64(d.real), f64(d.imag), f64(V.real), f64(V.imag),
                                f64(Vi.real), f64(Vi.imag), f64(self.rates),
                                f64(self._b0))

    def snapshot(self) -> dict:
        return {
            "belief": self.belief.tolist(),
            "last": self._last,
            "n_observed": self.n_observed,
        }

    def restore(self, state: dict) -> None:
        self.belief = np.asarray(state["belief"], dtype=np.float64)
        self._last = state["last"]
        self.n_observed = state["n_observed"]


def belief_forward(times, filt: PhaseBeliefFilter, *, device: DeviceLike = None):
    """Phase-belief posteriors for a (padded) arrival-time vector, one launch.

    The counterpart of the reference's ``belief_forward_jax``: the fold of
    ``PhaseBeliefFilter.observe`` over ``times`` in one launch of the
    belief kernel on ``device`` (CUDA unless ``device="cpu"``, which runs
    its plain version).  It starts from ``filt``'s *current* (belief,
    last) state without mutating it, which is what an engine run that
    resumes mid-stream needs.

    ``times`` may be 1-D ``(N,)`` or 2-D ``(S, N)`` (a seeds axis, every
    trace from the same state); +inf / NaN padded slots keep the carry
    unchanged and repeat the previous belief row, so padded tails are
    harmless.  Returns ``(beliefs, (b_final, t_final))`` as float64
    tensors on ``device``, where ``beliefs[..., i, :]`` is the posterior
    just after observing ``times[..., i]``.  Feed ``beliefs`` to the
    compiled serving lane (`serving.compiled` ``phase_mode=
    "belief_argmax"`` / ``"belief_mix"``).
    """
    dev = resolve_device(device)
    t = (times.to(device=dev, dtype=torch.float64) if isinstance(times, torch.Tensor)
         else torch.as_tensor(np.asarray(times, dtype=np.float64), device=dev))
    if t.dim() not in (1, 2):
        raise ValueError(f"times must be 1-D or 2-D, got shape {tuple(t.shape)}")
    one = t.dim() == 1
    b_init = torch.as_tensor(np.asarray(filt.belief, dtype=np.float64), device=dev)
    beliefs, b_fin, t_fin = _bf.belief_forward(
        t[None] if one else t, b_init, float(filt._last), filt.consts(dev)
    )
    if one:
        return beliefs[0], (b_fin[0], t_fin[0])
    return beliefs, (b_fin, t_fin)


def take(
    process: ArrivalProcess,
    rng: np.random.Generator,
    *,
    horizon: Optional[float] = None,
    n: Optional[int] = None,
) -> Tuple[List[ArrivalEvent], Optional[ArrivalEvent]]:
    """Eagerly drain a process: events below the bound + the first beyond.

    With ``horizon``, draws until the first event at or past it (that event
    is returned separately so the caller can push it back — exactly the
    peek-and-hold discipline of the lazy engine path, consuming exactly the
    same rng draws).  With ``n``, draws n events (or until exhaustion).
    """
    if (horizon is None) == (n is None):
        raise ValueError("exactly one of horizon= or n= required")
    events: List[ArrivalEvent] = []
    overshoot: Optional[ArrivalEvent] = None
    while True:
        ev = process.next(rng)
        if ev is None:
            break
        if horizon is not None and ev.time >= horizon:
            overshoot = ev
            break
        events.append(ev)
        if n is not None and len(events) >= n:
            break
    return events, overshoot


# ---------------------------------------------------------------------------
# On-device samplers (compiled-backend seed sweeps)
# ---------------------------------------------------------------------------


def _generator(gen, dev: torch.device) -> torch.Generator:
    """A torch.Generator on ``dev``: ``gen`` itself, or one seeded by it."""
    if isinstance(gen, torch.Generator):
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, sampling on {dev}")
        return gen
    g = torch.Generator(device=dev)
    g.manual_seed(int(gen))
    return g


def _lead(lanes: Optional[int]) -> Tuple[int, ...]:
    return () if lanes is None else (int(lanes),)


def _exponentials(g, shape, dev) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float64, device=dev).exponential_(
        generator=g)


def poisson_times(gen, lam: float, n: int, *, lanes: Optional[int] = None,
                  device: DeviceLike = None) -> torch.Tensor:
    """(n,) sorted Poisson arrival times: the cumulative sum of Exp(lam) gaps.

    The reference's ``poisson_times_jax`` with a ``torch.Generator`` (or a
    seed) in place of the key; ``lanes=S`` gives (S, n), one independent
    trace a lane (the reference's vmap over keys).  Draws are on
    ``device`` (CUDA unless ``device="cpu"``); statistically equivalent to
    PoissonProcess, not bit-equal -- use `take` for draw-for-draw parity
    with the Python loop.
    """
    dev = resolve_device(device)
    g = _generator(gen, dev)
    gaps = _exponentials(g, _lead(lanes) + (int(n),), dev) / float(lam)
    return torch.cumsum(gaps, dim=-1)


def mmpp2_times(gen, mmpp: "MMPP2", n_steps: int, with_phases: bool = False, *,
                lanes: Optional[int] = None, device: DeviceLike = None):
    """MMPP(2) arrival times from one launch of the MMPP sampler kernel.

    Each step draws one candidate exponential gap at the current phase's
    rate; if it crosses the pending phase switch the step emits no arrival
    and draws the dwell of the new phase (the competing-clocks
    construction of MMPP2Process.next), as the reference's
    ``mmpp2_times_jax`` steps.  Every lane takes ``1 + 2 * n_steps`` unit
    exponentials from ``gen`` (a ``torch.Generator`` on ``device``, or a
    seed) and the kernel walks them (kernels/mmpp_sample.py).

    Returns (times, mask): ``times`` sorted ascending with non-arrivals
    pushed to +inf (a ``torch.sort`` on the device, as the reference sorts
    outside its scan), ``mask`` marking the real arrivals (expected count
    about n_steps * P(no switch per step)).  ``with_phases=True`` also
    returns the sampler-carry phase at each arrival (same order, int32) --
    what the compiled phase-indexed lanes (``phases=``) consume.
    ``lanes=S`` gives a leading (S,) axis, one independent trace a lane.
    """
    dev = resolve_device(device)
    g = _generator(gen, dev)
    L = 1 if lanes is None else int(lanes)
    draws = _exponentials(g, (L, 1 + 2 * int(n_steps)), dev)
    times, emitted, phases = _mmpp.mmpp_sample(
        draws, (mmpp.lam1, mmpp.lam2), (mmpp.dwell1, mmpp.dwell2))
    key = torch.where(emitted, times, torch.full_like(times, float("inf")))
    key, order = torch.sort(key, dim=-1, stable=True)
    out = (key, torch.gather(emitted, -1, order))
    if with_phases:
        out = out + (torch.gather(phases, -1, order),)
    return out if lanes is not None else tuple(x[0] for x in out)


def diurnal_rate(proc: "DiurnalProcess", t: torch.Tensor) -> torch.Tensor:
    """``proc.rate`` in torch ops on ``t``'s device: the sinusoid, or the
    cyclic piecewise-linear ramp through ``torch.searchsorted`` (linear
    between breakpoints, clamped outside them, as ``np.interp``)."""
    tau = torch.remainder(t + proc.phase0, proc.period)
    if proc._taus is None:
        return proc.base + proc.amp * torch.sin(2.0 * np.pi * tau / proc.period)
    xp = torch.as_tensor(np.concatenate([proc._taus, [proc._taus[0] + proc.period]]),
                         dtype=torch.float64, device=t.device)
    fp = torch.as_tensor(np.concatenate([proc._vals, [proc._vals[0]]]),
                         dtype=torch.float64, device=t.device)
    x = torch.where(tau < xp[0], tau + proc.period, tau)
    i = (torch.searchsorted(xp, x, right=True) - 1).clamp(0, len(xp) - 2)
    x0, x1, f0, f1 = xp[i], xp[i + 1], fp[i], fp[i + 1]
    w = ((x - x0) / (x1 - x0)).clamp(0.0, 1.0)
    return f0 + w * (f1 - f0)


def diurnal_times(gen, proc: "DiurnalProcess", n_steps: int, *,
                  lanes: Optional[int] = None, device: DeviceLike = None):
    """Diurnal arrival times by thinning (the reference's
    ``diurnal_times_jax``), in plain torch ops on the device.

    Candidate times are the cumulative sum of Exp(rate_max) gaps (no
    serial carry beyond it), each accepted with probability
    rate(t) / rate_max; a tabulated ramp interpolates through
    ``torch.searchsorted``.  Returns (times, mask) like `mmpp2_times`
    (expected count about n_steps * mean_rate / rate_max).
    """
    dev = resolve_device(device)
    g = _generator(gen, dev)
    shape = _lead(lanes) + (int(n_steps),)
    rmax = float(proc.rate_max)
    t = torch.cumsum(_exponentials(g, shape, dev) / rmax, dim=-1)
    u = torch.rand(shape, dtype=torch.float64, device=dev, generator=g)
    rate = diurnal_rate(proc, t)
    emitted = u * rmax < rate
    key = torch.where(emitted, t, torch.full_like(t, float("inf")))
    key, order = torch.sort(key, dim=-1, stable=True)
    return key, torch.gather(emitted, -1, order)


def as_process(x) -> ArrivalProcess:
    """Coerce a rate / MMPP2 / trace / process into an ArrivalProcess."""
    if isinstance(x, ArrivalProcess):
        return x
    if isinstance(x, MMPP2):
        return MMPP2Process(x)
    if isinstance(x, (int, float)):
        return PoissonProcess(float(x))
    if isinstance(x, (list, tuple, np.ndarray)):
        return TraceProcess(x)
    raise TypeError(f"cannot coerce {type(x).__name__} into an ArrivalProcess")
