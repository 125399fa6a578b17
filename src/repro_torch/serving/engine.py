"""Batch-service engine: ONE event semantics, two backends.

The paper's queue (M/G^[b]/1 under a batching policy), run as a serving
system.  A single Python kernel (`_run_events`) owns the queue / admission
/ drain / SLO / energy / metrics logic; the modes differ only in their
clock and in where arrivals come from (serving.arrivals.ArrivalProcess):

  * run()          — virtual clock, service times drawn from the profiled
    ServiceModel (G_b); arrivals from any ArrivalProcess (Poisson by
    default, MMPP2 or a recorded trace via `arrivals=`).
  * run_executor() — the wall-clock instance of the same loop: service time
    is the measured duration of a real model call, arrivals are replayed in
    real time.  The timer/sleeper pair is injectable.

run(backend="compiled") executes the same decision-epoch semantics as one
launch of the CUDA event kernel (serving.compiled) on the engine's device:
arrivals are pre-generated from the engine's own numpy rng (draw-for-draw
the stream the lazy path would consume, and the stream the reference
package's compiled run draws at the same seed; over-drawn events are
buffered and replayed to later runs), the scheduler is lowered to its
dense action table — phase-indexed (K, L) stacks (OraclePhaseScheduler)
lower together with their per-arrival phase stream via the scheduler's
phase_at — and the report is decision-for-decision identical to the
Python loop on the same trace; `verify_backends` is the harness that
asserts exactly that.

Every mode streams per-batch observations into ServingMetrics (P² latency
quantiles, power; the compiled path reports quantiles from its fixed-bin
histogram sketch) and supports snapshot()/restore().  Admission control
(``buffer=`` / ``shed_expired=``) runs on both backends (the compiled one
through the kernel's managed-queue lane), an AdaptiveController lowers
to the kernel's adaptive lane, and a BeliefPhaseScheduler (or a controller
with ``phase_filter=``) to one belief-kernel launch and the event kernel's
belief lanes; after a compiled run the engine, its queue, the controller
and the filter are where the Python loop would have left them.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from ..core.service_models import ServiceModel
from ..device import DeviceLike, resolve_device
from .arrivals import (
    ArrivalEvent,
    ArrivalProcess,
    PoissonProcess,
    TraceProcess,
    as_process,
    take,
)
from .metrics import ServingMetrics, histogram_quantiles
from .scheduler import Scheduler


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    deadline: Optional[float] = None  # absolute time SLO
    payload: object = None  # e.g. prompt tokens for a real executor


@dataclasses.dataclass
class EngineReport:
    latencies: np.ndarray
    energy: float
    span: float
    n_served: int
    n_slo_miss: int
    mean_batch: float
    batch_sizes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_shed: int = 0  # arrivals refused by the finite waiting room
    n_expired: int = 0  # queued requests shed past their deadline

    @property
    def power(self) -> float:
        return self.energy / self.span if self.span > 0 else float("nan")

    def percentile(self, q):
        return np.percentile(self.latencies, q) if len(self.latencies) else np.nan

    def weighted_cost(self, w2: float) -> float:
        """The paper's objective: mean latency + w2 * power.

        w2 = 0 is pure latency and stays finite even when no energy source
        was configured (power = NaN).
        """
        w = float(np.mean(self.latencies)) if len(self.latencies) else float("nan")
        return w if w2 == 0 else w + w2 * self.power


class ServingEngine:
    def __init__(
        self,
        scheduler: Scheduler,
        *,
        b_max: int,
        lam: Optional[float] = None,
        arrivals: Optional[ArrivalProcess] = None,
        service: Optional[ServiceModel] = None,
        energy_table: Optional[np.ndarray] = None,  # zeta(a), a = 0..b_max
        energy_model: Optional[Callable[[int, float], float]] = None,
        executor: Optional[Callable[[List[Request]], None]] = None,
        slo: Optional[float] = None,  # relative deadline per request
        buffer: Optional[int] = None,  # finite waiting room B (None = inf)
        shed_expired: bool = False,  # drop queued requests past deadline
        seed: int = 0,
        timer: Callable[[], float] = time.perf_counter,
        sleeper: Callable[[float], None] = time.sleep,
        device: DeviceLike = None,  # where backend="compiled" runs
    ):
        self.device = resolve_device(device)
        if (service is None) == (executor is None):
            raise ValueError("exactly one of service= or executor= required")
        if arrivals is None:
            if lam is None:
                raise ValueError("either lam= or arrivals= required")
            arrivals = PoissonProcess(lam)
        else:
            arrivals = as_process(arrivals)
        self.scheduler = scheduler
        self.arrivals = arrivals
        self.lam = float(lam) if lam is not None else arrivals.mean_rate
        self.b_max = b_max
        self.service = service
        self.energy_table = energy_table
        self.energy_model = energy_model
        self.executor = executor
        self.slo = slo
        if buffer is not None and buffer < 0:
            raise ValueError("buffer must be >= 0 (B = 0 sheds everything)")
        self.buffer = buffer
        self.shed_expired = bool(shed_expired)
        self.rng = np.random.default_rng(seed)
        self.queue: List[Request] = []
        self.t = 0.0
        self.next_rid = 0
        self._pending: Optional[Request] = None  # peeked, not yet admitted
        # events the compiled backend pre-drew from the process but did not
        # consume; replayed before the process is asked again, so the
        # arrival stream the engine sees stays identical to the lazy path
        # (a deque: a compiled run can buffer ~n_epochs events, and the
        # python loop then consumes them one per arrival)
        self._future: Deque[ArrivalEvent] = collections.deque()
        self._timer = timer
        self._sleeper = sleeper

    # --- state for restart (fault tolerance) ---------------------------
    def snapshot(self) -> dict:
        return {
            "t": self.t,
            "queue": [dataclasses.asdict(r) for r in self.queue],
            "pending": (
                dataclasses.asdict(self._pending) if self._pending else None
            ),
            "future": [dataclasses.asdict(ev) for ev in self._future],
            "next_rid": self.next_rid,
            "rng": self.rng.bit_generator.state,
            "sched": self.scheduler.snapshot(),
            "arrivals": self.arrivals.snapshot(),
        }

    def restore(self, snap: dict) -> None:
        self.t = snap["t"]
        self.queue = [Request(**r) for r in snap["queue"]]
        self._pending = Request(**snap["pending"]) if snap["pending"] else None
        self._future = collections.deque(
            ArrivalEvent(**ev) for ev in snap.get("future", [])
        )
        self.next_rid = snap["next_rid"]
        self.rng.bit_generator.state = snap["rng"]
        self.scheduler.restore(snap["sched"])
        self.arrivals.restore(snap["arrivals"])

    # --- arrival plumbing ------------------------------------------------
    def _to_request(self, ev) -> Request:
        rid = ev.rid if ev.rid is not None else self.next_rid
        deadline = ev.deadline
        if deadline is None and self.slo is not None:
            deadline = ev.time + self.slo
        self.next_rid = max(self.next_rid, rid + 1)
        return Request(rid, ev.time, deadline, ev.payload)

    def _peek(self) -> Optional[Request]:
        """Next un-admitted arrival (generated lazily, held until due)."""
        if self._pending is None:
            ev = (
                self._future.popleft()
                if self._future
                else self.arrivals.next(self.rng)
            )
            if ev is not None:
                self._pending = self._to_request(ev)
        return self._pending

    def _admit(self, r: Request) -> None:
        self.queue.append(r)
        observe = getattr(self.scheduler, "observe_arrival", None)
        if observe is not None:
            observe(r.arrival)

    def _zeta(self, a: int, svc: float) -> Optional[float]:
        if self.energy_model is not None:
            return float(self.energy_model(a, svc))
        if self.energy_table is not None:
            return float(self.energy_table[a])
        return None

    # --- the unified kernel ----------------------------------------------
    def _run_events(
        self,
        *,
        max_epochs: Optional[int],
        horizon: Optional[float],
        wall: bool,
        poll: float,
        drain: bool,
    ) -> EngineReport:
        """One event loop for every mode.

        Virtual clock (wall=False): time jumps between arrivals and sampled
        service completions.  Wall clock (wall=True): `now` is the injected
        timer, idle waits sleep, and service time is the executor's measured
        duration.  Everything else — admission, decision epochs, the capped
        drain, SLO / energy / metrics accounting — is shared.
        """
        lat: List[float] = []
        batches: List[int] = []
        metrics = ServingMetrics()
        energy = 0.0
        have_energy = False
        slo_miss = 0
        n_shed = 0
        n_expired = 0
        t0 = self.t
        wall0 = self._timer() if wall else 0.0
        epochs = 0
        while max_epochs is None or epochs < max_epochs:
            now = t0 + (self._timer() - wall0) if wall else self.t
            # admit every arrival due by `now` (bounded by the horizon)
            while True:
                nxt = self._peek()
                if (
                    nxt is None
                    or nxt.arrival > now
                    or (horizon is not None and nxt.arrival >= horizon)
                ):
                    break
                if self.buffer is not None and len(self.queue) >= self.buffer:
                    # finite waiting room: refused at the door, never seen
                    # by the scheduler (offered load, not admitted load)
                    n_shed += 1
                else:
                    self._admit(nxt)
                self._pending = None
            if self.shed_expired:
                keep = []
                for r in self.queue:
                    if r.deadline is not None and r.deadline <= now:
                        n_expired += 1  # unmeetable even with zero service
                    else:
                        keep.append(r)
                self.queue = keep
            a = self.scheduler.decide(len(self.queue))
            a = max(0, min(a, len(self.queue), self.b_max))
            epochs += 1
            if a == 0:
                nxt = self._peek()
                live = nxt is not None and (horizon is None or nxt.arrival < horizon)
                if live:
                    if wall:
                        self._sleeper(min(poll, max(0.0, nxt.arrival - now)))
                    else:
                        self.t = nxt.arrival
                    continue
                if not self.queue or not drain:
                    break
                a = min(len(self.queue), self.b_max)  # capped tail drain
            batch, self.queue = self.queue[:a], self.queue[a:]
            if wall:
                start = t0 + (self._timer() - wall0)  # not `now`: exclude
                self.executor(batch)                  # scheduling overhead
                done = t0 + (self._timer() - wall0)
                svc = done - start
            else:
                svc = float(self.service.sample(a, self.rng, 1)[0])
                done = self.t + svc
            self.t = done
            zeta = self._zeta(a, svc)
            if zeta is not None:
                energy += zeta
                have_energy = True
            batch_lats = []
            for r in batch:
                batch_lats.append(done - r.arrival)
                if r.deadline is not None and done > r.deadline:
                    slo_miss += 1
            lat.extend(batch_lats)
            batches.append(a)
            metrics.observe_batch(
                batch_lats,
                zeta if zeta is not None else float("nan"),
                done - t0,
            )
        return EngineReport(
            latencies=np.asarray(lat),
            energy=energy if have_energy else float("nan"),
            span=self.t - t0,
            n_served=len(lat),
            n_slo_miss=slo_miss,
            mean_batch=float(np.mean(batches)) if batches else 0.0,
            batch_sizes=np.asarray(batches, dtype=np.int64),
            metrics=metrics.report(),
            n_shed=n_shed,
            n_expired=n_expired,
        )

    # --- public modes ----------------------------------------------------
    def run(
        self,
        n_epochs: Optional[int] = 100_000,
        *,
        horizon: Optional[float] = None,
        drain: Optional[bool] = None,
        backend: str = "python",
    ) -> EngineReport:
        """Virtual-clock batch service loop (decision-epoch faithful).

        Runs for `n_epochs` decision epochs, or — with n_epochs=None — until
        the arrival stream ends (trace exhausted / `horizon` reached) and the
        queue has drained in b_max-capped batches.

        ``backend="compiled"`` executes the identical decision-epoch
        semantics as one event-kernel launch on the engine's device
        (serving.compiled): same decisions, same per-request latencies,
        same energy on the same arrival stream.  Requirements: a
        table-representable scheduler (SMDP / static / greedy / Q-policy /
        oracle-phase) or an online one the kernels lower (AdaptiveController,
        BeliefPhaseScheduler), and zeta-table (or absent) energy accounting.  With
        deterministic service the two backends are draw-for-draw
        reproductions of each other at equal seeds; stochastic service
        draws the same law from a differently-ordered stream (the compiled
        path blocks its unit draws up front).
        """
        if self.service is None:
            raise RuntimeError("run() needs service=; use run_executor()")
        if n_epochs is None and horizon is None and not isinstance(
            self.arrivals, TraceProcess
        ):
            raise ValueError("unbounded run: pass n_epochs= or horizon=")
        if drain is None:
            drain = n_epochs is None
        if backend == "compiled":
            return self._run_compiled(
                max_epochs=n_epochs, horizon=horizon, drain=drain
            )
        if backend != "python":
            raise ValueError(f"unknown backend {backend!r}")
        return self._run_events(
            max_epochs=n_epochs, horizon=horizon, wall=False, poll=0.0,
            drain=drain,
        )

    # --- the compiled backend --------------------------------------------
    def _collect_events(
        self, max_epochs: Optional[int], horizon: Optional[float],
        extend_from: Optional[int] = None,
    ) -> List[ArrivalEvent]:
        """Materialize the arrival stream the lazy path would consume.

        Buffered (`_future`) and already-peeked events come first; a trace
        contributes its remaining events; an infinite process is drained
        eagerly from the engine rng — up to the horizon (the overshoot
        event is buffered, mirroring the lazy peek-and-hold), or in bounded
        chunks that `_run_compiled` grows until the epoch budget is met.
        """
        events: List[ArrivalEvent] = []
        if self._pending is not None:
            r = self._pending
            events.append(
                ArrivalEvent(r.arrival, r.payload, r.deadline, r.rid)
            )
            self._pending = None
        events.extend(self._future)
        self._future.clear()
        proc = self.arrivals
        if isinstance(proc, TraceProcess):
            events.extend(proc.drain())
        elif horizon is not None:
            drawn, overshoot = take(proc, self.rng, horizon=horizon)
            events.extend(drawn)
            if overshoot is not None:
                events.append(overshoot)
        else:
            assert max_epochs is not None
            base = extend_from if extend_from is not None else 0
            target = max(1024, 2 * max_epochs)
            if extend_from is not None:
                target = max(target, 2 * extend_from)
            drawn, _ = take(proc, self.rng, n=max(target - base, 1024))
            events.extend(drawn)
        return events

    def _run_compiled(
        self,
        *,
        max_epochs: Optional[int],
        horizon: Optional[float],
        drain: bool,
        unit_draws: Optional[np.ndarray] = None,
    ) -> EngineReport:
        from .arrivals import belief_forward
        from .compiled import AdaptiveLane, simulate_compiled
        from .scheduler import (
            AdaptiveController, BeliefPhaseScheduler, as_action_table,
        )

        if self.energy_model is not None and self.energy_table is None:
            raise ValueError(
                "compiled backend accounts energy via energy_table=; "
                "per-batch energy_model callbacks need backend='python'"
            )
        # online-adaptive schedulers lower to the compiled lanes: the
        # bank-retuning controller to the kernel's adaptive lane, the phase
        # posterior to one belief-kernel launch per run -- both resumed from
        # the live object's state and synced back after the run
        sched = self.scheduler
        lane = None
        belief_filter = None
        belief_mode = "argmax"
        phase_fn = None
        if isinstance(sched, AdaptiveController):
            lane = AdaptiveLane.from_controller(sched)
            table = None
            belief_filter = sched.phase_filter
            if belief_filter is None and lane.tables.shape[1] > 1:
                # phase-axis bank without a filter: the pinned phase row
                phase_fn = sched.scheduler.phase_at
        elif isinstance(sched, BeliefPhaseScheduler):
            table = sched.tables
            belief_filter = sched.filter
            belief_mode = sched.mode
        else:
            table = as_action_table(sched, self.b_max)
            # phase-indexed stacks need the per-arrival phase stream: the
            # scheduler provides it (oracle switch trace via phase_at, or
            # the pinned phase of a plain 2-D SMDP table)
            if table.ndim == 2:
                phase_fn = getattr(sched, "phase_at", None)
                if phase_fn is None:
                    raise TypeError(
                        f"{type(sched).__name__} has a phase-indexed "
                        "table but no phase_at(times); run backend='python'"
                    )
        if self.buffer is not None and belief_filter is not None:
            raise NotImplementedError(
                "buffer= with a belief-filtered scheduler needs "
                "backend='python': the posterior folds admitted arrivals "
                "only, and admission under a finite waiting room is "
                "decision-dependent (the compiled lane precomputes the "
                "posterior per arrival)"
            )
        means = np.asarray(
            [0.0]
            + [float(self.service.mean(b)) for b in range(1, self.b_max + 1)]
        )
        t0 = self.t
        queue0 = list(self.queue)
        self.queue = []
        queued_events = [
            ArrivalEvent(r.arrival, r.payload, r.deadline, r.rid)
            for r in queue0
        ]
        events = queued_events + self._collect_events(max_epochs, horizon)
        infinite = not isinstance(self.arrivals, TraceProcess) and (
            horizon is None
        )
        # the extension loop below only triggers on epoch-budgeted runs
        # (max_epochs set), so the budget — and hence the one unit-draw
        # block — is fixed up front: re-dispatches replay the exact same
        # service times, and the rng advances once per run, not per retry
        draws = unit_draws
        if draws is None:
            budget0 = (
                2 * len(events) + 2 if max_epochs is None else max_epochs
            )
            draws = self.service.unit_draws(self.rng, budget0)
        while True:
            n_arr = len(events)
            budget = 2 * n_arr + 2 if max_epochs is None else max_epochs
            times = np.asarray([ev.time for ev in events])
            deadlines = np.asarray(
                [
                    ev.deadline
                    if ev.deadline is not None
                    else (ev.time + self.slo if self.slo is not None
                          else np.inf)
                    for ev in events
                ]
            )
            # recomputed every extension pass: extended streams get their
            # phases from the same (stateful) trace the python path reads,
            # and the belief rows from the filter's unchanged start state
            ph = None if phase_fn is None else phase_fn(times)
            bel = None
            pm = "oracle"
            if belief_filter is not None:
                bel = belief_forward(times, belief_filter, device=self.device)[0]
                bel = bel.cpu().numpy()
                pm = "belief_mix" if belief_mode == "mix" else "belief_argmax"
            res = simulate_compiled(
                table, times,
                means=means, zeta=self.energy_table, draws=draws,
                b_max=self.b_max, max_epochs=budget, t0=t0,
                horizon=horizon, drain=drain, deadlines=deadlines,
                phases=ph, phase_mode=pm, beliefs=bel, adaptive=lane,
                buffer=self.buffer,
                shed_expired=self.shed_expired, record=True,
                device=self.device,
            )
            if not (infinite and res.n_admitted >= n_arr):
                break
            # the pre-drawn stream ran dry: every event was admitted, so
            # some suffix of the run decided against a truncated future (a
            # frozen phase row, a drain instead of a wait) that a lazy
            # engine — which keeps drawing — would never see.  Extend
            # the stream and re-run until a tail of events stays un-admitted
            # (the scan is deterministic, so the prefix replays identically;
            # arrival processes carry their own state — e.g. the MMPP2
            # phase — so the extension continues the exact same stream)
            events.extend(self._collect_events(
                max_epochs, None, extend_from=n_arr
            ))

        # --- sync engine state so later runs continue the same stream ----
        self.t = res.t_final
        admitted, future = events[: res.n_admitted], events[res.n_admitted:]
        # surviving queue: without shedding it is exactly the un-served
        # suffix; the managed-queue lane reports the survivors' slots
        # (door-refused and expired requests are gone).  rids count every
        # door-seen arrival either way: the Python loop assigns the rid at
        # peek, before the buffer check.
        if res.queue_slots is not None:
            surv = [int(i) for i in res.queue_slots]
        else:
            surv = list(range(res.n_served, len(admitted)))
        if any(ev.rid is not None for ev in admitted):
            reqs = [self._to_request(ev) for ev in admitted]
            self.queue = [reqs[i] for i in surv]
        else:
            base = self.next_rid
            self.next_rid = base + len(admitted)
            self.queue = [
                self._to_request(
                    dataclasses.replace(admitted[i], rid=base + i)
                )
                for i in surv
            ]
        if not isinstance(self.arrivals, TraceProcess):
            self._future = collections.deque(future)
        else:
            # un-admitted trace events stay in the trace: rewind its cursor
            # (the un-admitted tail is always a suffix of what drain() took,
            # since buffered/queued events precede trace events in time)
            self.arrivals.rewind(len(future))
        # the online scheduler ends the run where the Python backend would
        # have left it (belief / estimator state, bank entry, hysteresis
        # clock), so later runs continue identically
        if belief_filter is not None and res.n_admitted > 0:
            belief_filter.belief = bel[res.n_admitted - 1].copy()
            belief_filter._last = float(times[res.n_admitted - 1])
            belief_filter.n_observed += res.n_admitted
            if isinstance(sched, AdaptiveController):
                sched.scheduler.phase = belief_filter.phase
        if lane is not None:
            st = res.adaptive_state
            bank = sched.bank
            sched.key = bank._sorted_keys[st["sel"]]
            sched.scheduler.swap_table(bank.tables[sched.key])
            est = sched.estimator
            est._gap_bar = st["gap_bar"] if st["have_gap_bar"] else None
            est._last = st["last"] if st["have_last"] else None
            # door-refused arrivals were never observed by the estimator
            est.n_observed += res.n_admitted - res.n_shed
            sched._last_switch = st["last_switch"]
            sched.n_switches = st["n_switches"]
        lat = res.latencies
        # a run with no served batch accounted no energy (NaN, like the
        # Python kernel's have_energy flag)
        energy = (
            res.energy
            if self.energy_table is not None and res.n_batches > 0
            else float("nan")
        )
        span = res.t_final - t0
        qs = histogram_quantiles(
            res.hist, res.hist_edges, [0.5, 0.95, 0.99]
        )
        # count-zero lanes: NaN, matching ServingMetrics.report and the
        # grid runners' w_mean convention
        mean_batch = (
            res.n_served / res.n_batches if res.n_batches > 0 else float("nan")
        )
        metrics = {
            "W_mean": (
                res.lat_sum / res.n_served
                if res.n_served > 0
                else float("nan")
            ),
            "P50": float(qs[0]),
            "P95": float(qs[1]),
            "P99": float(qs[2]),
            "power": energy / span if span > 0 else float("nan"),
            "mean_batch": mean_batch,
            "n_served": float(res.n_served),
        }
        return EngineReport(
            latencies=lat,
            energy=energy,
            span=span,
            n_served=res.n_served,
            n_slo_miss=res.slo_miss,
            mean_batch=mean_batch,
            batch_sizes=res.batch_sizes,
            metrics=metrics,
            n_shed=res.n_shed,
            n_expired=res.n_expired,
        )

    def run_executor(
        self, requests: List[Request], *, poll: float = 1e-4
    ) -> EngineReport:
        """Replay `requests` (arrival times in seconds) against a real model.

        The wall-clock instance of the same kernel: the scheduler is
        consulted whenever the server is idle; service time is the
        executor's measured wall time.  Replaces the engine's arrival
        process with a trace of the given requests.  Arrival times are
        relative to THIS call: the trace is shifted onto the engine clock,
        so reusing an engine for a second replay behaves like a fresh one
        (while self.t stays monotone for snapshot coherence).
        """
        if self.executor is None:
            raise RuntimeError("run_executor() needs executor=; use run()")
        trace = TraceProcess(requests)
        if self.t != 0.0:
            for ev in trace.events:
                ev.time += self.t
                if ev.deadline is not None:
                    ev.deadline += self.t
        self.arrivals = trace
        self._pending = None
        self._future.clear()  # replay replaces the arrival source wholesale
        return self._run_events(
            max_epochs=None, horizon=None, wall=True, poll=poll, drain=True
        )


# ---------------------------------------------------------------------------
# Compiled-vs-Python equivalence harness
# ---------------------------------------------------------------------------


class _ScriptedService:
    """ServiceModel stand-in replaying a shared unit-draw sequence.

    Every ServiceModel family factors as mean(b) * unit_draw, so feeding
    one pre-drawn sequence to both backends makes their service times — and
    hence every decision — identical even for stochastic families.  One
    draw is consumed per serve call, the Python kernel's exact discipline.
    """

    def __init__(self, base: ServiceModel, draws: np.ndarray):
        self.base = base
        self.draws = np.asarray(draws, dtype=np.float64)
        self.k = 0

    def mean(self, b):
        return self.base.mean(b)

    def sample(self, b: int, rng: np.random.Generator, n: int) -> np.ndarray:
        out = float(self.base.mean(b)) * self.draws[self.k: self.k + n]
        self.k += n
        return out


def verify_backends(
    table: np.ndarray,
    trace,
    *,
    service: ServiceModel,
    energy_table: Optional[np.ndarray] = None,
    b_max: int,
    n_epochs: Optional[int] = None,
    horizon: Optional[float] = None,
    drain: Optional[bool] = None,
    slo: Optional[float] = None,
    buffer: Optional[int] = None,
    shed_expired: bool = False,
    phases=None,
    scheduler=None,
    seed: int = 0,
    atol: float = 1e-9,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """Decision-for-decision harness: both backends on one shared trace.

    Runs the Python event loop and the compiled backend (on ``device``) on
    the same arrival trace and the same unit service-draw sequence, then
    checks the batch schedule, per-request latencies, energy, SLO misses
    and span against each other.  Returns the two EngineReports plus the
    comparison verdict; raises AssertionError on any divergence.

    A (K, L) phase-indexed ``table`` plus per-arrival ``phases`` verifies
    the compiled phase lane: the Python side runs the oracle-phase path
    (OraclePhaseScheduler on the switch log the phase stream implies), the
    compiled side the phase-indexed table lookup.

    ``buffer=`` / ``shed_expired=`` arm the admission control on both
    backends and also assert the refusal and expiry counters match (the
    gate of the managed-queue lane).  ``scheduler`` -- a zero-argument
    factory returning a fresh scheduler per backend -- replaces
    ``table``/``phases``: a `BeliefPhaseScheduler` factory pits the Python
    filter fold against the belief kernel plus the event kernel's row /
    mixture selection, an `AdaptiveController` factory (with or without
    ``phase_filter=``) the Python estimator / hysteresis loop against the
    kernel's adaptive lane.

    Energy is a sum of per-batch terms, which both backends add in serve
    order; it is held at rtol 1e-12 (plus ``atol``), the bar the port
    keeps against the reference's tree-ordered sum.
    """
    from .scheduler import OraclePhaseScheduler, SMDPScheduler

    trace = list(np.asarray(trace, dtype=np.float64))
    if drain is None:
        drain = n_epochs is None
    budget = n_epochs if n_epochs is not None else 2 * len(trace) + 2
    draws = service.unit_draws(np.random.default_rng(seed), budget)
    if scheduler is not None:
        if table is not None or phases is not None:
            raise ValueError(
                "scheduler= (a fresh-instance factory) replaces "
                "table=/phases="
            )
        mk_sched = scheduler
    elif np.asarray(table).ndim == 2:
        table = np.asarray(table, dtype=np.int64)
        if phases is None:
            raise ValueError("a (K, L) table stack needs phases= per arrival")
        phases = np.asarray(phases, dtype=np.int64)
        if len(phases) != len(trace):
            raise ValueError("phases must align with the trace")
        # the switch log the per-arrival phase stream implies: an arrival's
        # phase is the phase at its own time, so logging changes *at*
        # arrival times reproduces the stream exactly on both backends
        log = [(trace[0], int(phases[0]))] if trace else []
        for t_a, p_a, p_prev in zip(trace[1:], phases[1:], phases[:-1]):
            if p_a != p_prev:
                log.append((float(t_a), int(p_a)))

        table_stack = table

        def mk_sched():
            return OraclePhaseScheduler(
                {z: table_stack[z] for z in range(table_stack.shape[0])}, log
            )
    else:
        table = np.asarray(table, dtype=np.int64)
        if phases is not None:
            raise ValueError("phases= needs a (K, L) phase-indexed table")

        def mk_sched():
            return SMDPScheduler.from_table(table)

    def engine(svc):
        return ServingEngine(
            mk_sched(),
            arrivals=TraceProcess(trace),
            b_max=b_max, service=svc, energy_table=energy_table,
            slo=slo, buffer=buffer, shed_expired=shed_expired, seed=seed,
            device=device,
        )

    rep_py = engine(_ScriptedService(service, draws)).run(
        n_epochs, horizon=horizon, drain=drain
    )
    rep_c = engine(service)._run_compiled(
        max_epochs=n_epochs, horizon=horizon, drain=drain, unit_draws=draws
    )
    np.testing.assert_array_equal(rep_py.batch_sizes, rep_c.batch_sizes)
    assert rep_py.n_served == rep_c.n_served
    np.testing.assert_allclose(rep_py.latencies, rep_c.latencies, atol=atol)
    assert rep_py.n_slo_miss == rep_c.n_slo_miss
    assert rep_py.n_shed == rep_c.n_shed
    assert rep_py.n_expired == rep_c.n_expired
    if energy_table is not None:
        np.testing.assert_allclose(
            rep_py.energy, rep_c.energy, rtol=1e-12, atol=atol
        )
    np.testing.assert_allclose(rep_py.span, rep_c.span, atol=atol)
    return {
        "python": rep_py,
        "compiled": rep_c,
        "n_decisions": int(len(rep_py.batch_sizes)),
        "max_latency_err": float(
            np.max(np.abs(rep_py.latencies - rep_c.latencies))
            if rep_py.n_served
            else 0.0
        ),
    }
