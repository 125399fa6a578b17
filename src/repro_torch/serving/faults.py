"""Fault injection for the serving lanes (degraded-mode serving).

FaultModel describes per-replica availability — a Markov up/down process
with exponential MTBF/MTTR — plus straggler service-time inflation (each
batch attempt independently straggles with probability ``p_straggle``,
multiplying its service draw by ``straggle_mult``).  ``materialize()``
freezes one sampled realization into a FaultSchedule: plain precomputed
arrays, so the SAME schedule drives the Python reference loop
(fleet.PythonFleet) and the fleet event kernel (kernels/csrc/fleet_scan.cu)
bit-identically — both sides index identical boundary times and
multipliers and neither draws randomness at run time.  The same
FaultModel and seed give the same arrays as the JAX package's.

Schedule layout (per replica m):

  ``bounds[m] = [d0_start, d0_end, d1_start, d1_end, ...]`` — sorted,
  +inf-padded; the replica is DOWN on ``[d_start, d_end)``.  The parity of
  the boundary cursor (count of boundaries <= t) gives availability:
  odd = down.

  ``mult[m, j]`` multiplies the j-th batch *attempt*'s service draw on
  replica m (clipped to the last slot, mirroring the kernel's unit-draw
  stream clip).

Semantics contract (shared by both backends, certified by verify_faults):

  * a batch whose service would complete at t_done crashes iff a down
    interval starts strictly before t_done; the in-flight requests requeue
    to the FRONT of that replica's queue and retry.  After ``max_retries``
    consecutive crashes on the same replica the batch is dropped (counted,
    never served).
  * routers never dispatch to a DOWN replica; if every replica is down the
    arrival still queues (rr falls back to its own slot, score-based
    routers to the least-loaded replica).
  * the energy of a crashed attempt is prorated:
    zeta(a) * elapsed / service.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """One frozen fault realization (module docstring for the layout)."""

    bounds: np.ndarray  # (M, 2F): down-start/down-end pairs, +inf padded
    mult: np.ndarray  # (M, D): per-attempt service multipliers
    max_retries: int = 2  # consecutive crashes before the batch drops

    def __post_init__(self):
        b = np.ascontiguousarray(np.asarray(self.bounds, dtype=np.float64))
        m = np.ascontiguousarray(np.asarray(self.mult, dtype=np.float64))
        if b.ndim != 2 or b.shape[1] % 2 != 0:
            raise ValueError(f"bounds must be (M, 2F); got {b.shape}")
        if m.ndim != 2 or m.shape[0] != b.shape[0] or m.shape[1] < 1:
            raise ValueError(f"mult must be (M, >= 1); got {m.shape}")
        with np.errstate(invalid="ignore"):  # inf-padded tails: inf - inf
            if b.size and np.any(np.diff(b, axis=1) < 0):
                raise ValueError("bounds rows must be non-decreasing")
        if not np.all(m > 0):
            raise ValueError("service multipliers must be > 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        object.__setattr__(self, "bounds", b)
        object.__setattr__(self, "mult", m)

    @property
    def n_replicas(self) -> int:
        return self.bounds.shape[0]

    @classmethod
    def none(cls, n_replicas: int, max_retries: int = 2) -> "FaultSchedule":
        """The empty schedule: always up, unit multipliers."""
        return cls(
            bounds=np.zeros((n_replicas, 0)),
            mult=np.ones((n_replicas, 1)),
            max_retries=max_retries,
        )

    def down_at(self, t: float) -> np.ndarray:
        """(M,) bool: which replicas are DOWN at time t (start-inclusive)."""
        if self.bounds.shape[1] == 0:
            return np.zeros(self.n_replicas, dtype=bool)
        count = (self.bounds <= t).sum(axis=1)
        return (count % 2).astype(bool)

    def boundary(self, m: int, cursor: int) -> float:
        """Boundary time at ``cursor`` for replica m (+inf past the end)."""
        if cursor >= self.bounds.shape[1]:
            return float("inf")
        return float(self.bounds[m, cursor])

    def attempt_mult(self, m: int, attempt: int) -> float:
        """Service multiplier of batch attempt ``attempt`` (clipped stream)."""
        return float(self.mult[m, min(attempt, self.mult.shape[1] - 1)])


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Availability / straggler law; materialize() samples a schedule."""

    mtbf: float = float("inf")  # mean up-time (exponential)
    mttr: float = 1.0  # mean repair time (exponential)
    p_straggle: float = 0.0  # per-attempt straggler probability
    straggle_mult: float = 4.0  # service multiplier when straggling
    max_retries: int = 2

    def __post_init__(self):
        if self.mtbf <= 0 or self.mttr <= 0:
            raise ValueError("mtbf and mttr must be > 0")
        if not (0.0 <= self.p_straggle <= 1.0):
            raise ValueError("p_straggle must be in [0, 1]")
        if self.straggle_mult <= 0:
            raise ValueError("straggle_mult must be > 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def materialize(
        self,
        n_replicas: int,
        horizon: float,
        n_attempts: int = 4096,
        seed: int = 0,
    ) -> FaultSchedule:
        """Sample one realization on [0, horizon) as a FaultSchedule.

        Down intervals start up and alternate Exp(mtbf) up / Exp(mttr)
        down per replica until the next failure would start past the
        horizon (a repair may end beyond it).  ``n_attempts`` sizes the
        straggler-multiplier stream; attempts past it reuse the last slot.
        """
        if not np.isfinite(horizon) or horizon <= 0:
            raise ValueError("materialize needs a finite horizon > 0")
        rng = np.random.default_rng(seed)
        rows = []
        for _ in range(n_replicas):
            ts, t = [], 0.0
            while np.isfinite(self.mtbf):
                t += rng.exponential(self.mtbf)
                if t >= horizon:
                    break
                ts.append(t)  # down start
                t += rng.exponential(self.mttr)
                ts.append(t)  # down end (may exceed the horizon)
            rows.append(ts)
        width = max((len(r) for r in rows), default=0)
        bounds = np.full((n_replicas, width), np.inf)
        for m, r in enumerate(rows):
            bounds[m, : len(r)] = r
        if self.p_straggle > 0.0:
            straggles = rng.random((n_replicas, n_attempts)) < self.p_straggle
            mult = np.where(straggles, float(self.straggle_mult), 1.0)
        else:
            mult = np.ones((n_replicas, 1))
        return FaultSchedule(
            bounds=bounds, mult=mult, max_retries=self.max_retries
        )


def verify_faults(
    tables,
    trace,
    *,
    faults: FaultSchedule,
    service,
    b_max: int,
    router="jsq",
    buffer=None,
    energy_table=None,
    slo=None,
    phases=None,
    phase_mode: str = "oracle",
    beliefs=None,
    seed: int = 0,
    atol: float = 1e-9,
    device=None,
):
    """Certify the degraded-mode lanes: PythonFleet vs the compiled kernel
    under one shared fault schedule, decision-for-decision.

    A thin front over `fleet.verify_fleet` that requires a FaultSchedule
    (use ``FaultSchedule.none(M)`` for the no-fault rail) and returns its
    harness dict plus degraded-mode counters.  Both backends must agree on
    the full decision log, per-arrival served/dropped/shed flags,
    latencies, energy (prorated crash attempts included), SLO misses and
    final queue state — per router and per arrival family (the caller
    sweeps those axes).  ``device=None`` means CUDA (the fleet kernel);
    ``device="cpu"`` runs its plain version.
    """
    from .fleet import verify_fleet

    if not isinstance(faults, FaultSchedule):
        raise TypeError("verify_faults needs a FaultSchedule")
    out = verify_fleet(
        tables, trace, router=router, service=service, b_max=b_max,
        energy_table=energy_table, slo=slo, phases=phases,
        phase_mode=phase_mode, beliefs=beliefs,
        faults=faults, buffer=buffer, seed=seed, atol=atol, device=device,
    )
    py = out["python"]
    comp = out["compiled"]
    out["n_crashes"] = int(comp.n_crashes)
    out["n_dropped"] = int(comp.n_dropped)
    out["n_shed"] = int(comp.n_shed)
    assert py.n_crashes == comp.n_crashes
    return out
