"""Fleet serving simulator: M routed replicas, one CUDA event kernel launch.

`serving.compiled` simulates the paper's single batch-service queue; real
deployments put M replicas behind a router.  This module runs the same
event semantics for a fleet: one step of the walk is one *event* -- a
fault boundary, an arrival admission (routed to a replica), a decision
epoch on one replica, or a clock advance -- and every lane of
(traces x table stacks x routers) walks in one launch of
``kernels/csrc/fleet_scan.cu`` (``device="cpu"`` runs its plain version).

Routers:

  * ``rr``          round-robin -- arrival i goes to server (i + rr0) % M.
  * ``jsq``         join-shortest-queue on ``2*qlen + busy`` (index order
                    breaks exact ties).
  * ``pow2``        power-of-two-choices: two candidates from pre-drawn
                    uniforms (shared with `PythonFleet`), the better JSQ
                    score wins, a tie goes to the first.
  * ``batch_aware`` the server whose queue is *closest to its SMDP table's
                    next admission threshold* (`threshold_gaps`), a busy
                    server's gap plus its backlog.

Each replica runs its own (optionally heterogeneous) policy table -- a
(M, K, L) stack, phase row selected by the phase of the last admitted
arrival fleet-wide.  An M=1 fleet is decision-for-decision the
single-server event kernel (`verify_fleet` asserts it; `PythonFleet`, the
certifying Python loop, replays every router tie-break).

Streaming (`FleetStream` / `simulate_fleet_stream`) runs the arrival
stream in chunks, one launch each, carrying per-replica queues, busy
clocks, pending-decision flags, fault cursors, retry counters and
in-flight requeues across chunk seams, and folds each chunk into O(1)
aggregates (P² quantiles, the fixed-bin histogram).  Completions later
than a chunk's last arrival are deferred to the next chunk; latencies are
accounted at serve start.  Belief row selection streams too: the MMPP
posterior is forwarded chunk by chunk through `arrivals.belief_forward`,
resumed from the carried filter state.

Degraded mode (`serving.faults`): a frozen `FaultSchedule` threads replica
outage boundaries and per-attempt straggler multipliers through the
kernel.  Routers mask DOWN replicas, a down-start strictly before an
in-flight batch's completion crashes it -- the requests requeue to the
FRONT with bounded retries, then drop -- crashed attempts burn prorated
energy, and ``buffer=B`` bounds each replica's waiting room.

`FleetStream.save` / `FleetStream.resume` persist the whole chunk seam
through `checkpoint.CheckpointManager` under the reference's keys, so a
stream saved by either package resumes in the other.  Not ported:
`run_fleet_grid(mesh=)` (the distributed layer is not ported); it raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.service_models import ServiceModel
from ..device import DeviceLike, resolve_device
from ..kernels import fleet_scan as fk
from .arrivals import PhaseBeliefFilter, belief_forward
from .compiled import (
    _PAD_MARGIN,
    _bucket,
    _check_phase_mode,
    _zeta_table,
    default_hist_edges,
    pad_arrivals,
)
from .metrics import P2Quantile

#: router name -> kernel id
ROUTERS: Dict[str, int] = {"rr": 0, "jsq": 1, "pow2": 2, "batch_aware": 3}

#: JSQ score = 2*min(qlen, _SCORE_QCAP) + busy_flag; the cap keeps the
#: batch-aware combined score (gap * _GAP_SHIFT + jsq) inside int32
_SCORE_QCAP = fk.SCORE_QCAP
_GAP_SHIFT = fk.GAP_SHIFT
#: additive routing penalty for DOWN replicas: healthy scores stay below
#: 2^30, so one penalty puts every DOWN replica behind every UP one while
#: keeping the among-down order
_DOWN_PENALTY = fk.DOWN_PENALTY
#: buf_cap sentinel for "no finite waiting room" (queues never reach it)
_NO_BUFFER = 1 << 30

def router_id(router) -> int:
    """Resolve a router name (or already-an-id) to its kernel id."""
    if isinstance(router, str):
        try:
            return ROUTERS[router]
        except KeyError:
            raise ValueError(
                f"unknown router {router!r}; one of {sorted(ROUTERS)}"
            ) from None
    rid = int(router)
    if rid not in ROUTERS.values():
        raise ValueError(f"router id {rid} not in {sorted(ROUTERS.values())}")
    return rid


def _jsq_score(qlen: int, busy: bool) -> int:
    return 2 * min(int(qlen), _SCORE_QCAP) + int(busy)


def _belief_phases(phase_mode, beliefs, phases, n_phases):
    """Resolve the fleet's phase stream from a belief posterior.

    Returns ``(phases, bel)``: the argmax phase stream, plus the posterior
    rows for the mix rule (``bel`` is None for ``belief_argmax``; the
    batch-aware router's gaps follow the MAP phase in both modes).
    """
    bel = _check_phase_mode(phase_mode, beliefs, n_phases)
    if bel is None:
        return phases, None
    if phases is not None:
        raise ValueError("phases= and beliefs= are mutually exclusive")
    if bel.ndim not in (2, 3):  # (N, K) per-lane or (S, N, K) grids
        raise ValueError(f"beliefs must be (N, K) or (S, N, K); got {bel.shape}")
    phases = np.argmax(bel, axis=-1)
    return phases, (bel if phase_mode == "belief_mix" else None)


def threshold_gaps(tables: np.ndarray) -> np.ndarray:
    """Distance-to-next-admission-threshold per (server, phase, queue).

    ``gaps[m, k, q]`` is how many arrivals *beyond the incoming one* server
    m (in phase k, with q currently queued) still needs before its table
    first serves: 0 means this arrival lands in a queue state whose action
    is a serve.  States past the table end follow the eq.-30 extension (the
    last column repeats), and a row that never serves gets the max gap L
    (routed last).
    """
    tables = np.asarray(tables, dtype=np.int64)
    if tables.ndim == 2:
        tables = tables[:, None, :]
    if tables.ndim != 3:
        raise ValueError(f"tables must be (M, L) or (M, K, L); got {tables.shape}")
    M, K, L = tables.shape
    gaps = np.empty((M, K, L), dtype=np.int64)
    for m in range(M):
        for k in range(K):
            row = tables[m, k]
            # nxt[s] = smallest serving state >= s (within the table; the
            # eq.-30 extension makes every state >= L serve iff row[-1] > 0)
            nxt = np.full(L, L + 1, dtype=np.int64)  # L+1 == "never"
            nn = L if row[L - 1] > 0 else L + 1  # first serve state past the end
            for s in range(L - 1, -1, -1):
                if row[s] > 0:
                    nn = s
                nxt[s] = nn
            for q in range(L):
                tgt = q + 1  # queue length after this arrival joins
                if tgt >= L:
                    g = 0 if row[L - 1] > 0 else L
                else:
                    ns = nxt[tgt]
                    if ns <= L:
                        g = min(ns, L) - tgt if ns > tgt else 0
                    else:
                        g = L  # never serves: max gap, routed last
                gaps[m, k, q] = min(g, L)
    return gaps


@dataclasses.dataclass
class FleetResult:
    """Aggregates of one fleet run (arrays already on host)."""

    t_final: float
    n_served: int  # total over replicas (carried q0 + this run's arrivals)
    n_batches: int
    n_epochs: int
    n_admitted: int
    energy: float
    lat_sum: float
    slo_miss: int
    terminated: bool  # stream exhausted and every replica drained/stopped
    hist: np.ndarray  # (n_bins + 2,) counts; [0]=underflow, [-1]=overflow
    hist_edges: np.ndarray
    # degraded-mode counters (zero on fault-free, unbuffered runs)
    n_crashes: int = 0  # batch attempts killed by a replica down-start
    n_dropped: int = 0  # requests dropped after max_retries crashes
    n_shed: int = 0  # arrivals rejected by the finite waiting room
    # per-replica state (all (M,))
    qlen: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    busy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    n_routed: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    n_served_m: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    # record=True only:
    actions: Optional[np.ndarray] = None  # (n_epochs,) batch size, 0 = wait
    servers: Optional[np.ndarray] = None  # (n_epochs,) deciding replica
    latencies: Optional[np.ndarray] = None  # (n,) arrival-indexed (NaN unserved)
    served: Optional[np.ndarray] = None  # (n,) bool, arrival served this run
    arr_server: Optional[np.ndarray] = None  # (n,) replica each arrival joined
    dropped: Optional[np.ndarray] = None  # (n,) bool, crash-dropped this run
    shed: Optional[np.ndarray] = None  # (n,) bool, rejected at admission

    @property
    def batch_sizes(self) -> np.ndarray:
        if self.actions is None:
            raise ValueError("run with record=True for per-epoch decisions")
        return self.actions[self.actions > 0]

    @property
    def w_mean(self) -> float:
        return self.lat_sum / self.n_served if self.n_served else float("nan")


# ---------------------------------------------------------------------------
# The kernel launch and its host-side reading
# ---------------------------------------------------------------------------


def _final_steps(step0: int, cap: int, need: int) -> int:
    """The reference's last scan length: step0 doubled (capped) until it
    covers the ``need`` steps of its slowest lane."""
    n = min(step0, cap)
    while n < need and n < cap:
        n = min(2 * n, cap)
    return n


def _budgets(n_arr: int, M: int, n_bnd: int = 0, max_epochs: Optional[int] = None):
    """(max_eps, cap, step0) of a fresh run of ``n_arr`` arrivals on M
    replicas with ``n_bnd`` finite fault boundaries."""
    # crashes re-serve their batch and repairs wake queued replicas --
    # at most two extra epochs per finite fault boundary
    max_eps = (
        (2 * n_arr + M + 4 + 2 * n_bnd)
        if max_epochs is None
        else int(max_epochs)
    )
    # one step per admission, epoch, boundary, or advance; each of those
    # is preceded by at most one advance, so 2x is a hard cap
    cap = _bucket(2 * (n_arr + max_eps + n_bnd) + 2 * M + 8)
    step0 = min(_bucket(max(256, (3 * n_arr) // 2 + 2 * M + 8)), cap)
    return max_eps, cap, step0


def _kernel_args(dev, tables, thr, rids, arr, dl, ph, ru, draws, means, zeta,
                 edges, fb, fmult, q0_t, q0_d, busy0, state0, bel, bel0, *,
                 t0, horizon, max_eps, drain, b_max, buf_cap, max_retries,
                 rr0=0, ph0=0, more_coming=False, t_last=np.inf, cap,
                 record=False):
    """The fleet kernel's (args, kwargs) on ``dev`` from the host arrays of
    (S, P, R) lanes; ``cap`` is the reference's hard step cap."""

    def on_dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    f64, i64 = torch.float64, torch.int64
    args = (
        on_dev(tables, i64), on_dev(thr, i64), on_dev(rids, i64),
        on_dev(arr, f64), on_dev(dl, f64), on_dev(ph, i64), on_dev(ru, f64),
        on_dev(draws, f64), on_dev(means, f64), on_dev(zeta, f64),
        on_dev(edges, f64), on_dev(fb, f64), on_dev(fmult, f64),
        on_dev(q0_t, f64), on_dev(q0_d, f64), on_dev(busy0, f64),
        on_dev(state0, i64),
        None if bel is None else on_dev(bel, f64),
        None if bel is None else on_dev(bel0, f64),
    )
    kw = dict(
        t0=float(t0), horizon=float(horizon), max_eps=int(max_eps),
        step_cap=int(cap), drain=bool(drain), b_max=int(b_max),
        buf_cap=int(buf_cap), max_retries=int(max_retries), rr0=int(rr0),
        ph0=int(ph0), more_coming=bool(more_coming), t_last=float(t_last),
        record=record,
    )
    return args, kw


def _run_lanes(dev, tables, thr, rids, arr, *lanes, step0, **opts):
    """One fleet-kernel launch over (S, P, R) lanes (`_kernel_args`'
    arguments, and ``step0``, the reference's first scan length); returns
    the per-lane aggregate dict (numpy, lane axis first) and the record,
    if asked."""
    args, kw = _kernel_args(dev, tables, thr, rids, arr, *lanes, **opts)
    out = fk.fleet_scan(*args, **kw)
    horizon, more_coming, drain = kw["horizon"], kw["more_coming"], kw["drain"]
    max_eps, cap, record = kw["max_eps"], kw["step_cap"], kw["record"]
    agg_i = out.agg_i.cpu().numpy()  # the sync with the kernel
    i = {k: agg_i[:, n] for n, k in enumerate(fk.AGG_I)}
    f = {k: v for k, v in zip(fk.AGG_F, out.agg_f.cpu().numpy().T)}
    rep = {k: v for k, v in zip(fk.REP_I, out.rep_i.cpu().numpy().transpose(1, 0, 2))}
    busy = out.busy.cpu().numpy()
    done = i["done"].astype(bool)
    needs = rep["needs"].astype(bool)
    # The reference's scan runs a fixed number of steps; once a lane has
    # spent its epoch budget the steps left still wake idle UP replicas for
    # the tail drain.  The kernel stops at the budget, so that wake is
    # applied here, where the reference's scan had steps left over.
    final = _final_steps(step0, cap, int(i["n_steps_used"].max()))
    spare = ~done & (i["n_steps_used"] < final)
    if spare.any():
        S, size = arr.shape
        s_of = np.arange(len(done)) // (len(done) // S)
        x = arr[s_of, np.minimum(i["n_admitted"], size - 1)]
        dead = ~(x < horizon) & (not more_coming)
        wake = (spare & dead & bool(drain))[:, None] & np.isinf(busy) & (
            rep["qlen"] > 0) & (rep["fcur"] % 2 == 0) & (rep["infl"] == 0)
        needs = needs | wake
    agg = {
        "t_final": f["t_final"], "n_admitted": i["n_admitted"],
        "n_served": rep["n_srv"].sum(axis=-1), "n_batches": i["n_batches"],
        # crashes are counted at dispatch (the chunk that launched the
        # attempt), matching the serve-start accounting discipline
        "n_crashes": i["n_attempts"] - i["n_batches"],
        "n_dropped": rep["ndrop_m"].sum(axis=-1),
        "n_shed": rep["nshed_m"].sum(axis=-1),
        "n_epochs": i["n_epochs"], "n_steps_used": i["n_steps_used"],
        "terminated": done & (not more_coming),
        "parked": done & bool(more_coming),
        "incomplete": ~done & (i["n_epochs"] < max_eps),
        "energy": f["energy"], "lat_sum": f["lat_sum"],
        "slo_miss": i["slo_miss"], "hist": out.hist.cpu().numpy(),
        "qlen": rep["qlen"], "busy": busy, "n_route": rep["n_route"],
        "n_srv": rep["n_srv"], "nbat": rep["nbat"], "rr": i["rr"],
        "ph": i["ph"], "needs": needs, "fcur": rep["fcur"],
        "rty": rep["rty"], "infl": rep["infl"],
        "ndrop_m": rep["ndrop_m"], "nshed_m": rep["nshed_m"],
    }
    rec = None
    if record:
        rec = fk.FleetRecord(*(x.cpu().numpy() for x in out.rec))
    return agg, rec


# ---------------------------------------------------------------------------
# Host-side wrappers
# ---------------------------------------------------------------------------


def _norm_tables(tables, *, want_m: Optional[int] = None) -> np.ndarray:
    """(L,) / (M, L) / (M, K, L) -> (M, K, L) int64."""
    t = np.asarray(tables, dtype=np.int64)
    if t.ndim == 1:
        t = t[None, None, :]
    elif t.ndim == 2:
        t = t[:, None, :]
    elif t.ndim != 3:
        raise ValueError(
            f"tables must be (L,), (M, L) or (M, K, L); got {t.shape}"
        )
    if want_m is not None and t.shape[0] != want_m:
        raise ValueError(f"expected {want_m} replica tables, got {t.shape[0]}")
    return t


def _prep_faults(faults, M: int):
    """FaultSchedule | None -> (fb, fmult, max_retries) kernel arrays.

    ``fb`` always ships >= 1 column (all-+inf when fault-free) so the
    kernel's boundary read never indexes an empty axis.
    """
    if faults is None:
        return np.full((M, 1), np.inf), np.ones((M, 1)), 0
    from .faults import FaultSchedule

    if not isinstance(faults, FaultSchedule):
        raise TypeError(
            "faults= must be a FaultSchedule (FaultModel.materialize())"
        )
    if faults.n_replicas != M:
        raise ValueError(
            f"fault schedule covers {faults.n_replicas} replicas, fleet has {M}"
        )
    fb = faults.bounds
    if fb.shape[1] == 0:
        fb = np.full((M, 1), np.inf)
    return fb, faults.mult, int(faults.max_retries)


def _prep_inputs(
    tables, arrivals, *, means, zeta, draws, b_max, deadlines, phases,
    slo, hist_edges, router_u, router_seed, bel=None,
):
    """Shared normalization for simulate_fleet / FleetStream / the grid."""
    tables = _norm_tables(tables)
    M, K, L = tables.shape
    arr = np.asarray(arrivals, dtype=np.float64)
    if slo is not None:
        if deadlines is not None:
            raise ValueError("pass slo= or deadlines=, not both")
        deadlines = np.where(np.isfinite(arr), arr + slo, np.inf)
    if len(arr) < _PAD_MARGIN or not np.isinf(arr[-_PAD_MARGIN:]).all():
        raw = arr
        padded = pad_arrivals(
            arr, deadlines,
            phases=phases if phases is not None else None,
        )
        if phases is None:
            arr, dl = padded
            ph = np.zeros(len(arr), dtype=np.int64)
        else:
            arr, dl, ph = padded
        if bel is not None:
            # co-sort/pad the posterior rows exactly like pad_arrivals
            finite = np.isfinite(raw)
            kept = bel[finite]
            order = np.argsort(raw[finite], kind="stable")
            bel_p = np.zeros((len(arr), bel.shape[1]))
            bel_p[: len(kept)] = kept[order]
            bel = bel_p
    else:
        dl = (
            np.asarray(deadlines, dtype=np.float64)
            if deadlines is not None
            else np.full(len(arr), np.inf)
        )
        ph = (
            np.asarray(phases, dtype=np.int64)
            if phases is not None
            else np.zeros(len(arr), dtype=np.int64)
        )
    if len(dl) != len(arr) or len(ph) != len(arr):
        raise ValueError("padded deadlines/phases must align with arrivals")
    if bel is not None and len(bel) != len(arr):
        raise ValueError("padded beliefs must align with arrivals")
    if phases is not None and K > 1 and (ph.min() < 0 or ph.max() >= K):
        raise ValueError(f"phases outside the table stack [0, {K})")
    if K > 1 and phases is None:
        raise ValueError("phase-indexed (M, K, L) tables need phases=")
    if router_u is None:
        router_u = np.random.default_rng(router_seed).random((len(arr), 2))
    router_u = np.asarray(router_u, dtype=np.float64)
    if router_u.shape != (len(arr), 2):
        # raw (n, 2) uniforms are padded alongside the arrivals (padded
        # slots are never admitted, so their draws are never consumed)
        ru = np.full((len(arr), 2), 0.5)
        ru[: len(router_u)] = router_u
        router_u = ru
    means = np.asarray(means, dtype=np.float64)
    zeta_a = _zeta_table(zeta, b_max)
    if draws is None:
        draws = np.ones(1)
    draws = np.asarray(draws, dtype=np.float64)
    edges = (
        default_hist_edges(means)
        if hist_edges is None
        else np.asarray(hist_edges, dtype=np.float64)
    )
    return tables, arr, dl, ph, bel, router_u, means, zeta_a, draws, edges


def _fresh_state(M: int):
    """(busy0, state0) of a fresh run: idle replicas, every one armed."""
    state0 = np.zeros((len(fk.STATE0), M), dtype=np.int64)
    state0[fk.STATE0.index("needs")] = 1
    return np.full(M, np.inf), state0


def simulate_fleet(
    tables,
    arrivals,
    *,
    router="jsq",
    means,
    zeta=None,
    draws=None,
    b_max: int,
    max_epochs: Optional[int] = None,
    t0: float = 0.0,
    horizon: Optional[float] = None,
    drain: bool = True,
    deadlines=None,
    phases=None,
    phase_mode: str = "oracle",
    beliefs=None,
    slo: Optional[float] = None,
    hist_edges=None,
    record: bool = False,
    router_u=None,
    router_seed: int = 0,
    faults=None,
    buffer: Optional[int] = None,
    device: DeviceLike = None,
) -> FleetResult:
    """Run M replica policy tables over one routed arrival trace, one launch.

    ``tables`` is (M, L) -- one action table per replica, heterogeneous
    allowed -- or (M, K, L) phase-indexed stacks with ``phases`` per arrival
    (the phase of the last admitted arrival selects the row fleet-wide).
    ``phase_mode="belief_argmax"`` with ``beliefs`` (n, K) posterior rows
    (`arrivals.belief_forward`) derives the phase stream from the filter
    posterior; ``"belief_mix"`` blends the per-phase actions per decision
    (the batch-aware router's gaps follow the MAP phase).  ``router`` is
    one of ``rr | jsq | pow2 | batch_aware``; pow2 consumes ``router_u``
    ((n, 2) uniforms, drawn from ``router_seed`` when absent).

    Degraded mode: ``faults`` is a `serving.faults.FaultSchedule` (routers
    mask DOWN replicas; a mid-service down-start crashes the in-flight
    batch, which requeues to the front and -- after the schedule's
    ``max_retries`` consecutive crashes -- is dropped); ``buffer`` a finite
    waiting room B (a routed arrival finding B requests waiting is shed).

    Service/energy conventions are `simulate_compiled`'s: service time of a
    batch of a is ``means[a] * draws[k]`` with one draw consumed per batch
    attempt *per replica*, energy ``zeta[a]`` summed over serves.
    ``record=True`` also returns the per-epoch decision log and the
    per-arrival latencies, routing and dropped / shed flags.

    ``device=None`` means CUDA (the fleet kernel); ``device="cpu"`` runs
    its plain version.  At most `kernels.fleet_scan.MAX_REPLICAS` replicas.
    """
    rid = router_id(router)
    dev = resolve_device(device)
    bel = None
    if phase_mode != "oracle" or beliefs is not None:
        if beliefs is not None and (
            np.asarray(beliefs).ndim != 2
            or len(np.asarray(beliefs)) != len(np.asarray(arrivals))
        ):
            raise ValueError("beliefs must be (n, K) aligned with arrivals")
        phases, bel = _belief_phases(
            phase_mode, beliefs, phases, _norm_tables(tables).shape[1]
        )
    (tables, arr, dl, ph, bel, router_u, means, zeta_a, draws, edges) = (
        _prep_inputs(
            tables, arrivals, means=means, zeta=zeta, draws=draws,
            b_max=b_max, deadlines=deadlines, phases=phases, slo=slo,
            hist_edges=hist_edges, router_u=router_u,
            router_seed=router_seed, bel=bel,
        )
    )
    M = tables.shape[0]
    thr = threshold_gaps(tables)
    fb, fmult, max_retries = _prep_faults(faults, M)
    n_bnd = int(np.isfinite(fb).sum())
    if buffer is not None and int(buffer) < 0:
        raise ValueError("buffer must be >= 0")
    buf_cap = _NO_BUFFER if buffer is None else int(buffer)
    max_eps, cap, step0 = _budgets(
        int(np.sum(np.isfinite(arr))), M, n_bnd, max_epochs
    )
    busy0, state0 = _fresh_state(M)
    q0 = np.full((M, 1), np.inf)
    agg, rec = _run_lanes(
        dev, tables[None], thr[None], np.array([rid]), arr[None], dl[None],
        ph[None], router_u[None], draws[None], means, zeta_a, edges, fb, fmult,
        q0, q0, busy0, state0,
        None if bel is None else bel[None], None if bel is None else bel[:1],
        t0=t0, horizon=np.inf if horizon is None else float(horizon),
        max_eps=max_eps, drain=drain, b_max=b_max, buf_cap=buf_cap,
        max_retries=max_retries, step0=step0, cap=cap, record=record,
    )
    res = FleetResult(
        t_final=float(agg["t_final"][0]),
        n_served=int(agg["n_served"][0]),
        n_batches=int(agg["n_batches"][0]),
        n_epochs=int(agg["n_epochs"][0]),
        n_admitted=int(agg["n_admitted"][0]),
        energy=float(agg["energy"][0]),
        lat_sum=float(agg["lat_sum"][0]),
        slo_miss=int(agg["slo_miss"][0]),
        terminated=bool(agg["terminated"][0]),
        hist=agg["hist"][0],
        hist_edges=edges,
        n_crashes=int(agg["n_crashes"][0]),
        n_dropped=int(agg["n_dropped"][0]),
        n_shed=int(agg["n_shed"][0]),
        qlen=agg["qlen"][0],
        busy=agg["busy"][0],
        n_routed=agg["n_route"][0],
        n_served_m=agg["n_srv"][0],
    )
    if record:
        neps = res.n_epochs
        res.actions = rec.rec_a[0, :neps].astype(np.int64)
        res.servers = rec.rec_m[0, :neps].astype(np.int64)
        n = len(np.asarray(arrivals))
        st = rec.arr_state[0, :n]
        res.served = (st & fk.SERVED) != 0
        res.latencies = np.where(res.served, rec.arr_lat[0, :n], np.nan)
        srv = rec.arr_server[0, :n]
        res.arr_server = np.where(srv < M, srv, -1).astype(np.int64)
        res.dropped = (st & fk.DROPPED) != 0
        res.shed = (st & fk.SHED) != 0
    return res


# ---------------------------------------------------------------------------
# Python reference router loop (the certifying side of verify_fleet)
# ---------------------------------------------------------------------------


class PythonFleet:
    """Reference M-replica router loop, event-for-event the fleet kernel.

    Same step priority (fault boundary -> admit due arrival -> decide
    lowest-index pending replica -> advance the clock, arrivals winning
    ties), same router tie-breaks (shared ``router_u`` uniforms for pow2),
    same draw cursor discipline (one unit draw per batch attempt per
    replica, indexed by that replica's attempt count).  Interpreter-speed
    numpy on the host: it certifies the kernel (`verify_fleet`) and tests
    snapshot()/restore() through the router state.
    """

    def __init__(
        self,
        tables,
        arrivals,
        *,
        router="jsq",
        means,
        zeta=None,
        draws=None,
        b_max: int,
        t0: float = 0.0,
        horizon: Optional[float] = None,
        drain: bool = True,
        deadlines=None,
        phases=None,
        phase_mode: str = "oracle",
        beliefs=None,
        slo: Optional[float] = None,
        router_u=None,
        router_seed: int = 0,
        faults=None,
        buffer: Optional[int] = None,
    ):
        self.tables = _norm_tables(tables)
        self.M, self.K, self.L = self.tables.shape
        self.rid = router_id(router)
        self.thr = threshold_gaps(self.tables)
        bel = None
        if phase_mode != "oracle" or beliefs is not None:
            phases, bel = _belief_phases(phase_mode, beliefs, phases, self.K)
        times = np.asarray(arrivals, dtype=np.float64)
        finite = np.isfinite(times)
        times = times[finite]
        order = np.argsort(times, kind="stable")
        self.times = times[order]
        if slo is not None and deadlines is not None:
            raise ValueError("pass slo= or deadlines=, not both")
        if deadlines is not None:
            d = np.asarray(deadlines, dtype=np.float64)[finite][order]
        elif slo is not None:
            d = self.times + slo
        else:
            d = np.full(len(self.times), np.inf)
        self.deadlines = d
        if phases is not None:
            self.phases = np.asarray(phases, dtype=np.int64)[finite][order]
        else:
            self.phases = np.zeros(len(self.times), dtype=np.int64)
        self.bel = None if bel is None else bel[finite][order]
        if self.K > 1 and phases is None:
            raise ValueError("phase-indexed (M, K, L) tables need phases=")
        if horizon is not None:
            keep = self.times < horizon
            self.times, self.deadlines = self.times[keep], self.deadlines[keep]
            self.phases = self.phases[keep]
            if self.bel is not None:
                self.bel = self.bel[keep]
        self.n = len(self.times)
        if router_u is None:
            router_u = np.random.default_rng(router_seed).random((self.n, 2))
        self.router_u = np.asarray(router_u, dtype=np.float64)
        self.means = np.asarray(means, dtype=np.float64)
        self.zeta = _zeta_table(zeta, b_max)
        self.draws = (
            np.ones(1) if draws is None else np.asarray(draws, np.float64)
        )
        self.b_max = int(b_max)
        self.drain = bool(drain)
        self.fb, self.fmult, self.max_retries = _prep_faults(faults, self.M)
        if buffer is not None and int(buffer) < 0:
            raise ValueError("buffer must be >= 0")
        self.buf_cap = _NO_BUFFER if buffer is None else int(buffer)
        # --- mutable run state -----------------------------------------
        self.t = float(t0)
        self.i = 0  # arrival cursor
        self.rr = 0
        self.ph = 0
        self.busy = [float("inf")] * self.M
        self.queues: List[List[int]] = [[] for _ in range(self.M)]
        self.needs = [True] * self.M  # initial decision round, like t0 wait
        self.nbat = [0] * self.M
        self.n_srv = [0] * self.M
        self.neps = 0
        self.done = False
        # degraded-mode state: boundary cursor (odd parity = DOWN),
        # consecutive-crash counter, the crashed in-flight batch
        self.fcur = [0] * self.M
        self.rty = [0] * self.M
        self.infl_req: List[List[int]] = [[] for _ in range(self.M)]
        self.ndrop = [0] * self.M
        self.nshed = [0] * self.M
        # --- outputs ---------------------------------------------------
        self.decisions: List[tuple] = []  # (replica, action) incl. waits
        self.latencies = np.full(self.n, np.nan)
        self.served = np.zeros(self.n, dtype=bool)
        self.dropped = np.zeros(self.n, dtype=bool)
        self.shed = np.zeros(self.n, dtype=bool)
        self.arr_server = np.full(self.n, -1, dtype=np.int64)
        self.energy = 0.0
        self.slo_miss = 0
        self.n_crashes = 0

    # --- fault helpers ---------------------------------------------------
    def _down(self, m: int) -> bool:
        return self.fcur[m] % 2 == 1

    def _next_bound(self, m: int) -> float:
        if self.fcur[m] >= self.fb.shape[1]:
            return float("inf")
        return float(self.fb[m, self.fcur[m]])

    # --- router ---------------------------------------------------------
    def _route(self, i: int) -> int:
        qeff = [
            len(self.queues[m]) + len(self.infl_req[m])
            for m in range(self.M)
        ]
        base = [
            _jsq_score(
                qeff[m],
                np.isfinite(self.busy[m]) or bool(self.infl_req[m]),
            )
            for m in range(self.M)
        ]
        pen = [
            _DOWN_PENALTY if self._down(m) else 0 for m in range(self.M)
        ]
        if self.rid == 0:
            # rr scans forward from its slot for the first UP replica;
            # with every replica down it falls back to its own slot
            for k in range(self.M):
                c = (self.rr + k) % self.M
                if not self._down(c):
                    return c
            return self.rr % self.M
        if self.rid == 1:
            return int(np.argmin([base[m] + pen[m] for m in range(self.M)]))
        if self.rid == 2:
            u = self.router_u[i]
            c1 = min(int(u[0] * self.M), self.M - 1)
            c2 = min(int(u[1] * self.M), self.M - 1)
            return c1 if base[c1] + pen[c1] <= base[c2] + pen[c2] else c2
        ph_arr = int(self.phases[i])
        score = []
        for m in range(self.M):
            q = qeff[m]
            gap = int(self.thr[m, ph_arr, min(q, self.L - 1)])
            if np.isfinite(self.busy[m]) or self.infl_req[m]:
                gap += min(q, _SCORE_QCAP)  # mid-batch: backlog penalty
            score.append(
                min(gap, _SCORE_QCAP) * _GAP_SHIFT + base[m] + pen[m]
            )
        return int(np.argmin(score))

    # --- snapshot / restore (router state round-trips exactly) ----------
    def snapshot(self) -> dict:
        return {
            "t": self.t, "i": self.i, "rr": self.rr, "ph": self.ph,
            "busy": list(self.busy),
            "queues": [list(q) for q in self.queues],
            "needs": list(self.needs), "nbat": list(self.nbat),
            "n_srv": list(self.n_srv), "neps": self.neps,
            "done": self.done, "decisions": list(self.decisions),
            "latencies": self.latencies.copy(),
            "served": self.served.copy(),
            "dropped": self.dropped.copy(),
            "shed": self.shed.copy(),
            "arr_server": self.arr_server.copy(),
            "energy": self.energy, "slo_miss": self.slo_miss,
            "fcur": list(self.fcur), "rty": list(self.rty),
            "infl_req": [list(q) for q in self.infl_req],
            "ndrop": list(self.ndrop), "nshed": list(self.nshed),
            "n_crashes": self.n_crashes,
        }

    def restore(self, snap: dict) -> None:
        self.t, self.i = snap["t"], snap["i"]
        self.rr, self.ph = snap["rr"], snap["ph"]
        self.busy = list(snap["busy"])
        self.queues = [list(q) for q in snap["queues"]]
        self.needs = list(snap["needs"])
        self.nbat = list(snap["nbat"])
        self.n_srv = list(snap["n_srv"])
        self.neps, self.done = snap["neps"], snap["done"]
        self.decisions = list(snap["decisions"])
        self.latencies = snap["latencies"].copy()
        self.served = snap["served"].copy()
        self.dropped = snap["dropped"].copy()
        self.shed = snap["shed"].copy()
        self.arr_server = snap["arr_server"].copy()
        self.energy, self.slo_miss = snap["energy"], snap["slo_miss"]
        self.fcur = list(snap["fcur"])
        self.rty = list(snap["rty"])
        self.infl_req = [list(q) for q in snap["infl_req"]]
        self.ndrop = list(snap["ndrop"])
        self.nshed = list(snap["nshed"])
        self.n_crashes = snap["n_crashes"]

    # --- the loop --------------------------------------------------------
    def step(self, max_epochs: Optional[int] = None) -> bool:
        """One event; returns False once the run is finished."""
        if self.done or (max_epochs is not None and self.neps >= max_epochs):
            return False
        nxt = self.times[self.i] if self.i < self.n else float("inf")
        live = self.i < self.n
        # (0) replay the lowest-index due fault boundary (before any
        # admission or decision at the same clock: routing masks and the
        # crash bookkeeping always see fresh parity)
        nb = [self._next_bound(m) for m in range(self.M)]
        for m in range(self.M):
            if nb[m] <= self.t:
                is_start = self.fcur[m] % 2 == 0
                if is_start and self.infl_req[m]:
                    # the down-start catches a crashed in-flight batch
                    if self.rty[m] + 1 > self.max_retries:
                        for j in self.infl_req[m]:
                            self.dropped[j] = True
                        self.ndrop[m] += len(self.infl_req[m])
                        self.rty[m] = 0
                    else:  # requeue to the FRONT, keeping positions
                        self.queues[m] = self.infl_req[m] + self.queues[m]
                        self.rty[m] += 1
                    self.infl_req[m] = []
                if is_start:
                    self.needs[m] = False  # silence any pending decision
                elif (
                    self.queues[m]
                    and np.isinf(self.busy[m])
                    and not self.infl_req[m]
                ):
                    self.needs[m] = True  # repair re-arms queued work
                self.fcur[m] += 1
                return True
        # (1) admit one due arrival (shed if the waiting room is full)
        if nxt <= self.t:
            m = self._route(self.i)
            self.arr_server[self.i] = m
            qeff = len(self.queues[m]) + len(self.infl_req[m])
            if qeff >= self.buf_cap:
                self.shed[self.i] = True
                self.nshed[m] += 1
            else:
                self.queues[m].append(self.i)
                if (
                    np.isinf(self.busy[m])
                    and not self._down(m)
                    and not self.infl_req[m]
                ):
                    self.needs[m] = True
            self.ph = int(self.phases[self.i])
            self.rr += 1
            self.i += 1
            return True
        # wake idle parked UP replicas for the tail drain
        if not live and self.drain:
            for m in range(self.M):
                if (
                    np.isinf(self.busy[m])
                    and self.queues[m]
                    and not self._down(m)
                    and not self.infl_req[m]
                ):
                    self.needs[m] = True
        # (2) decision epoch on the lowest-index pending replica
        if any(self.needs):
            m = self.needs.index(True)
            self.needs[m] = False
            q = len(self.queues[m])
            if self.bel is not None:
                # belief-mixture rule: blend the per-phase actions under
                # the last admitted arrival's posterior row
                row = self.bel[min(max(self.i - 1, 0), self.n - 1)]
                a = int(np.round(np.sum(
                    row * self.tables[m, :, min(q, self.L - 1)]
                )))
            else:
                a = int(self.tables[m, self.ph, min(q, self.L - 1)])
            a = max(0, min(a, q, self.b_max))
            if a == 0 and not live and q > 0 and self.drain:
                a = min(q, self.b_max)  # capped tail drain
            self.neps += 1
            if a == 0:
                self.decisions.append((m, 0))
                return True  # wait (or terminal no-op)
            svc = (
                self.means[a]
                * self.draws[min(self.nbat[m], len(self.draws) - 1)]
                * self.fmult[m, min(self.nbat[m], self.fmult.shape[1] - 1)]
            )
            done_t = self.t + svc
            batch, self.queues[m] = self.queues[m][:a], self.queues[m][a:]
            self.nbat[m] += 1
            self.decisions.append((m, a))
            # crash pre-resolution: the batch fails iff the replica's next
            # down interval starts strictly before its completion
            ds = self._next_bound(m)
            if ds < done_t:
                self.infl_req[m] = batch
                self.energy += float(self.zeta[a] * (ds - self.t) / svc)
                self.n_crashes += 1
                return True
            for j in batch:
                self.latencies[j] = done_t - self.times[j]
                self.served[j] = True
                if done_t > self.deadlines[j]:
                    self.slo_miss += 1
            self.busy[m] = done_t
            self.n_srv[m] += a
            self.rty[m] = 0
            self.energy += float(self.zeta[a])
            return True
        # (3) advance the clock: arrival > completion > fault boundary.
        # A boundary only matters to a replica with queued or crashed
        # work (its repair must wake it / resolve the crash); empty idle
        # replicas' boundaries replay lazily when the clock passes them
        t_c = min(self.busy)
        m_c = int(np.argmin(self.busy))
        t_b = min(
            (
                nb[m]
                for m in range(self.M)
                if self.queues[m] or self.infl_req[m]
            ),
            default=float("inf"),
        )
        if live and nxt <= t_c and nxt <= t_b:
            self.t = nxt
            return True
        if np.isfinite(t_c) and t_c <= t_b:
            self.t = t_c
            self.busy[m_c] = float("inf")
            self.needs[m_c] = True
            return True
        if np.isfinite(t_b):
            self.t = t_b  # the boundary itself replays next step
            return True
        self.done = True  # drained: nothing due, pending, or in flight
        return False

    def run(self, max_epochs: Optional[int] = None) -> "PythonFleet":
        while self.step(max_epochs):
            pass
        return self

    @property
    def qlen(self) -> np.ndarray:
        return np.asarray([len(q) for q in self.queues], dtype=np.int64)


def verify_fleet(
    tables,
    trace,
    *,
    router="jsq",
    service: ServiceModel,
    energy_table=None,
    b_max: int,
    n_epochs: Optional[int] = None,
    horizon: Optional[float] = None,
    drain: bool = True,
    slo: Optional[float] = None,
    phases=None,
    phase_mode: str = "oracle",
    beliefs=None,
    faults=None,
    buffer: Optional[int] = None,
    seed: int = 0,
    atol: float = 1e-9,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """Decision-for-decision harness: PythonFleet vs the fleet kernel.

    Both backends run the same sorted trace, the same shared unit-draw
    block and the same router uniforms, and the full decision log --
    (replica, action) per epoch, waits included -- plus per-arrival
    latencies / routing / drop + shed flags / energy / SLO misses must
    agree.  ``faults`` (a FaultSchedule) and ``buffer`` exercise the
    degraded-mode lanes on both sides; ``phase_mode``/``beliefs`` the belief
    row-selection rules.  With M = 1 (and no degraded-mode knobs, which the
    single-server kernel lacks) the fleet lane is also checked against
    `simulate_compiled` (the event kernel): identical batch sizes,
    latencies, final clock and epoch count, energy at rtol 1e-12 (the two
    kernels add it in the same order, the reference's two scans do not).
    ``device=None`` means CUDA; ``device="cpu"`` runs the plain versions.
    """
    from .compiled import simulate_compiled

    tables = _norm_tables(tables)
    M = tables.shape[0]
    trace = np.sort(np.asarray(trace, dtype=np.float64))
    n = len(trace)
    budget = n_epochs if n_epochs is not None else 2 * n + M + 4
    draws = service.unit_draws(np.random.default_rng(seed), budget)
    means = np.asarray(
        [0.0] + [float(service.mean(b)) for b in range(1, b_max + 1)]
    )
    router_u = np.random.default_rng(seed + 1).random((n, 2))
    kw = dict(
        router=router, means=means, zeta=energy_table, draws=draws,
        b_max=b_max, horizon=horizon, drain=drain, slo=slo, phases=phases,
        phase_mode=phase_mode, beliefs=beliefs, router_u=router_u,
        faults=faults, buffer=buffer,
    )
    py = PythonFleet(tables, trace, **kw).run(max_epochs=n_epochs)
    comp = simulate_fleet(
        tables, trace, max_epochs=n_epochs, record=True, device=device, **kw
    )
    dec_py = np.asarray(py.decisions, dtype=np.int64).reshape(-1, 2)
    dec_c = np.stack([comp.servers, comp.actions], axis=1)
    np.testing.assert_array_equal(dec_py, dec_c)
    assert py.neps == comp.n_epochs, (py.neps, comp.n_epochs)
    # the python reference drops post-horizon arrivals; the kernel keeps
    # full-length arrays where they are simply never admitted
    n_eff = py.n
    assert not comp.served[n_eff:].any()
    assert (comp.arr_server[n_eff:] == -1).all()
    np.testing.assert_array_equal(py.served, comp.served[:n_eff])
    np.testing.assert_array_equal(py.arr_server, comp.arr_server[:n_eff])
    np.testing.assert_array_equal(py.dropped, comp.dropped[:n_eff])
    np.testing.assert_array_equal(py.shed, comp.shed[:n_eff])
    assert int(py.n_crashes) == comp.n_crashes
    assert int(sum(py.ndrop)) == comp.n_dropped
    assert int(sum(py.nshed)) == comp.n_shed
    np.testing.assert_allclose(
        py.latencies[py.served], comp.latencies[comp.served], atol=atol
    )
    assert int(py.slo_miss) == comp.slo_miss
    np.testing.assert_allclose(py.energy, comp.energy, atol=atol)
    np.testing.assert_allclose(py.t, comp.t_final, atol=atol)
    np.testing.assert_array_equal(py.qlen, comp.qlen)
    out = {
        "python": py, "compiled": comp,
        "n_decisions": int(len(py.decisions)),
    }
    if M == 1 and faults is None and buffer is None:
        single = simulate_compiled(
            tables[0], trace, means=means, zeta=energy_table, draws=draws,
            b_max=b_max, max_epochs=n_epochs, horizon=horizon, drain=drain,
            deadlines=None if slo is None else trace + slo,
            phases=phases, phase_mode=phase_mode, beliefs=beliefs,
            record=True, device=device,
        )
        np.testing.assert_array_equal(single.batch_sizes, comp.batch_sizes)
        assert single.n_served == comp.n_served
        np.testing.assert_allclose(
            single.latencies, comp.latencies[comp.served], atol=atol
        )
        np.testing.assert_allclose(
            single.energy, comp.energy, rtol=1e-12, atol=atol
        )
        assert single.slo_miss == comp.slo_miss
        np.testing.assert_allclose(single.t_final, comp.t_final, atol=atol)
        assert single.n_epochs == comp.n_epochs, (
            single.n_epochs, comp.n_epochs,
        )
        out["single"] = single
    return out


# ---------------------------------------------------------------------------
# Chunked streaming: O(chunk) memory at any horizon
# ---------------------------------------------------------------------------


class FleetStream:
    """Chunked fleet simulation folding into O(1)-memory aggregates.

    Feed the (globally time-sorted) arrival stream through `push` in
    chunks, one kernel launch each; per-replica leftover queues, busy
    clocks, router and phase state, pending-decision flags, fault cursors,
    retry counters and in-flight requeues carry across chunk boundaries,
    and each chunk's latencies / SLO misses / energy fold into streaming
    aggregates (P² quantile estimators + the fixed-bin histogram sketch).
    `finish` runs the b_max-capped tail drain and returns a `FleetResult`
    whose aggregates match a one-shot `simulate_fleet` of the concatenated
    stream exactly (decision-for-decision, `n_epochs` included).

    ``device=None`` means CUDA; ``device="cpu"`` runs the plain versions
    (of the fleet kernel, and of the belief kernel for the belief modes).
    `save` / `resume` persist and restore the complete seam state.
    """

    def __init__(
        self,
        tables,
        *,
        router="jsq",
        means,
        zeta=None,
        draws=None,
        b_max: int,
        drain: bool = True,
        slo: Optional[float] = None,
        hist_edges=None,
        quantiles: Sequence[float] = (0.5, 0.95, 0.99),
        router_seed: int = 0,
        t0: float = 0.0,
        phase_mode: str = "oracle",
        belief_filter=None,
        faults=None,
        buffer: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.tables = _norm_tables(tables)
        self.M, self.K, self.L = self.tables.shape
        self.rid = router_id(router)
        self.thr = threshold_gaps(self.tables)
        self.means = np.asarray(means, dtype=np.float64)
        self.zeta = _zeta_table(zeta, b_max)
        self.draws = (
            np.ones(1) if draws is None else np.asarray(draws, np.float64)
        )
        self.b_max = int(b_max)
        self.drain = bool(drain)
        self.slo = slo
        self.edges = (
            default_hist_edges(self.means)
            if hist_edges is None
            else np.asarray(hist_edges, dtype=np.float64)
        )
        self._rng = np.random.default_rng(router_seed)
        # belief phase modes run the forward filter per chunk, carrying
        # the posterior across chunk boundaries (aggregates == one-shot)
        if phase_mode not in ("oracle", "belief_argmax", "belief_mix"):
            raise ValueError(f"unknown phase_mode {phase_mode!r}")
        if (phase_mode != "oracle") != (belief_filter is not None):
            raise ValueError(
                'belief phase modes need belief_filter= (an '
                'arrivals.PhaseBeliefFilter) and vice versa'
            )
        if belief_filter is not None and len(belief_filter.rates) != self.K:
            raise ValueError(
                f"belief filter K={len(belief_filter.rates)} != table "
                f"phase axis K={self.K}"
            )
        self.phase_mode = phase_mode
        self._filt = belief_filter
        self._bel0 = (
            None
            if belief_filter is None
            else np.asarray(belief_filter.belief, dtype=np.float64).copy()
        )
        self.fb, self.fmult, self.max_retries = _prep_faults(faults, self.M)
        if buffer is not None and int(buffer) < 0:
            raise ValueError("buffer must be >= 0")
        self.buf_cap = _NO_BUFFER if buffer is None else int(buffer)
        # --- carried state --------------------------------------------
        self.t0 = float(t0)
        self.t = float(t0)
        self.rr = 0
        self.ph = 0
        self.busy = np.full(self.M, np.inf)
        self.nbat = np.zeros(self.M, dtype=np.int64)
        self.queues = [
            (np.zeros(0), np.zeros(0)) for _ in range(self.M)
        ]  # (times, deadlines) per replica, admission order
        # degraded-mode carry: the first infl[m] entries of queues[m] are
        # the crashed in-flight batch (front-requeue keeps them there)
        self.fcur = np.zeros(self.M, dtype=np.int64)
        self.rty = np.zeros(self.M, dtype=np.int64)
        self.infl = np.zeros(self.M, dtype=np.int64)
        # pending-decision flags carry exactly: a parked wait is not
        # re-decided at the chunk seam
        self.needs = np.ones(self.M, dtype=bool)
        self._t_hwm = -np.inf  # high-water mark: chunks must be sorted
        self._finished = False
        # --- streaming aggregates -------------------------------------
        self.quantiles = {q: P2Quantile(q) for q in quantiles}
        self.hist = np.zeros(len(self.edges) + 1, dtype=np.int64)
        self.n_admitted = 0
        self.n_served = 0
        self.n_batches = 0
        self.n_epochs = 0
        self.energy = 0.0
        self.lat_sum = 0.0
        self.slo_miss = 0
        self.n_crashes = 0
        self.n_dropped = 0
        self.n_shed = 0
        self.n_routed = np.zeros(self.M, dtype=np.int64)
        self.n_served_m = np.zeros(self.M, dtype=np.int64)

    def push(self, times, deadlines=None, *, phases=None, router_u=None):
        """Simulate one chunk of arrivals (must not precede earlier ones)."""
        if self._finished:
            raise RuntimeError("push() after finish()")
        times = np.asarray(times, dtype=np.float64)
        if len(times) == 0:
            return self
        if times.min() < self._t_hwm:
            raise ValueError(
                "chunks must be globally time-sorted: arrival "
                f"{times.min():g} precedes an earlier chunk's last arrival "
                f"{self._t_hwm:g}"
            )
        self._t_hwm = float(times.max())
        self._run_chunk(
            times, deadlines, phases, router_u, more_coming=True,
            t_last=self._t_hwm,
        )
        return self

    def finish(self) -> FleetResult:
        """Drain the carried queues (b_max-capped) and return the totals."""
        if not self._finished:
            self._run_chunk(
                np.zeros(0), None, None, None, more_coming=False,
                t_last=np.inf,
            )
            self._finished = True
        return self.result()

    def result(self) -> FleetResult:
        return FleetResult(
            t_final=self.t,
            n_served=self.n_served,
            n_batches=self.n_batches,
            n_epochs=self.n_epochs,
            n_admitted=self.n_admitted,
            energy=self.energy,
            lat_sum=self.lat_sum,
            slo_miss=self.slo_miss,
            terminated=self._finished,
            hist=self.hist.copy(),
            hist_edges=self.edges,
            n_crashes=self.n_crashes,
            n_dropped=self.n_dropped,
            n_shed=self.n_shed,
            # queues carry the crashed in-flight batch at the front; the
            # kernel's qlen convention counts only the waiting part
            qlen=np.asarray(
                [len(q[0]) for q in self.queues], np.int64
            ) - self.infl,
            busy=self.busy.copy(),
            n_routed=self.n_routed.copy(),
            n_served_m=self.n_served_m.copy(),
        )

    def report(self) -> Dict[str, float]:
        """ServingMetrics-style summary (NaN-with-count-zero on empties)."""
        span = self.t - self.t0
        out = {
            "W_mean": (
                self.lat_sum / self.n_served
                if self.n_served
                else float("nan")
            ),
            "power": (
                self.energy / span
                if self.n_batches and span > 0
                else float("nan")
            ),
            "mean_batch": (
                self.n_served / self.n_batches
                if self.n_batches
                else float("nan")
            ),
            "n_served": float(self.n_served),
            "slo_miss": float(self.slo_miss),
            # degraded-mode counters: goodput is the served-through rate
            # (NaN on an empty span, like the other rate metrics)
            "goodput": (
                self.n_served / span if span > 0 else float("nan")
            ),
            "drop_rate": (
                (self.n_dropped + self.n_shed) / self.n_admitted
                if self.n_admitted
                else float("nan")
            ),
            "n_dropped": float(self.n_dropped),
            "n_shed": float(self.n_shed),
            "n_crashes": float(self.n_crashes),
        }
        for q, est in self.quantiles.items():
            out[f"P{round(q * 100)}"] = est.value
        return out

    #: phase_mode <-> checkpoint integer code
    _PHASE_MODES = ("oracle", "belief_argmax", "belief_mix")

    def save(self, path) -> None:
        """Persist the stream durably: config, chunk-seam carry, aggregates.

        Written through checkpoint.CheckpointManager (atomic rename +
        per-array CRC) with an incrementing step per save, so a crash
        mid-save can never shadow the previous good snapshot.  The payload
        is the *complete* seam state -- per-replica queues, busy clocks,
        pending-decision flags, fault cursors, P² marker sketches, the
        histogram, the belief posterior and the router RNG state -- under
        the reference's keys, so a killed-and-resumed stream matches the
        uninterrupted one on every aggregate, n_epochs included, in either
        package (see resume()).
        """
        from ..checkpoint import CheckpointManager

        cfg = {
            "version": np.int64(1),
            "tables": self.tables,
            "means": self.means,
            "zeta": self.zeta,
            "draws": self.draws,
            "edges": self.edges,
            "b_max": np.int64(self.b_max),
            "drain": np.bool_(self.drain),
            "slo": np.float64(np.nan if self.slo is None else self.slo),
            "rid": np.int64(self.rid),
            "fb": self.fb,
            "fmult": self.fmult,
            "max_retries": np.int64(self.max_retries),
            "buf_cap": np.int64(self.buf_cap),
            "t0": np.float64(self.t0),
            "phase_mode": np.int64(self._PHASE_MODES.index(self.phase_mode)),
            "qprobs": np.asarray(list(self.quantiles), dtype=np.float64),
            # PCG64 state holds 128-bit ints -- json round-trips them exactly
            "rng": np.frombuffer(
                json.dumps(self._rng.bit_generator.state).encode(), np.uint8
            ),
        }
        carry = {
            "t": np.float64(self.t),
            "rr": np.int64(self.rr),
            "ph": np.int64(self.ph),
            "busy": self.busy,
            "nbat": self.nbat,
            "needs": self.needs,
            "fcur": self.fcur,
            "rty": self.rty,
            "infl": self.infl,
            "t_hwm": np.float64(self._t_hwm),
            "finished": np.bool_(self._finished),
            "q_lens": np.asarray(
                [len(q[0]) for q in self.queues], dtype=np.int64
            ),
            "q_times": np.concatenate([q[0] for q in self.queues]),
            "q_deads": np.concatenate([q[1] for q in self.queues]),
        }
        agg = {
            "hist": self.hist,
            "n_admitted": np.int64(self.n_admitted),
            "n_served": np.int64(self.n_served),
            "n_batches": np.int64(self.n_batches),
            "n_epochs": np.int64(self.n_epochs),
            "energy": np.float64(self.energy),
            "lat_sum": np.float64(self.lat_sum),
            "slo_miss": np.int64(self.slo_miss),
            "n_crashes": np.int64(self.n_crashes),
            "n_dropped": np.int64(self.n_dropped),
            "n_shed": np.int64(self.n_shed),
            "n_routed": self.n_routed,
            "n_served_m": self.n_served_m,
        }
        tree = {
            "cfg": cfg,
            "carry": carry,
            "agg": agg,
            "p2": {
                str(k): est.snapshot()
                for k, est in enumerate(self.quantiles.values())
            },
        }
        if self.phase_mode != "oracle":
            tree["bel"] = {
                "rates": self._filt.rates,
                "gen": self._filt.gen,
                "b0": self._filt._b0,
                "belief": self._filt.belief,
                "last": np.float64(self._filt._last),
                "n_observed": np.int64(self._filt.n_observed),
                "bel0": self._bel0,
            }
        mgr = CheckpointManager(path, keep_last_k=2)
        last = mgr.latest_step()
        mgr.save(0 if last is None else last + 1, tree)

    @classmethod
    def resume(cls, path, *, device: DeviceLike = None) -> "FleetStream":
        """Reconstruct a saved stream; the seam contract survives the trip.

        Every aggregate of resume(path) -> push...(rest) -> finish() equals
        the uninterrupted stream's: queues, clocks, decision flags, fault
        cursors, sketches, posterior and RNG all restore exactly, so the
        continuation replays decision-for-decision.  A step saved by the
        reference package resumes here too.  ``device`` is where the
        resumed stream runs (CUDA unless ``device="cpu"``).
        """
        from ..checkpoint import CheckpointManager

        device = resolve_device(device)
        flat = CheckpointManager(path).restore_flat()
        pm = cls._PHASE_MODES[int(flat["cfg//phase_mode"])]
        filt = None
        if pm != "oracle":
            filt = PhaseBeliefFilter(
                flat["bel//rates"], flat["bel//gen"], b0=flat["bel//b0"]
            )
            filt.restore(
                {
                    "belief": flat["bel//belief"],
                    "last": float(flat["bel//last"]),
                    "n_observed": int(flat["bel//n_observed"]),
                }
            )
        slo = float(flat["cfg//slo"])
        self = cls(
            flat["cfg//tables"],
            means=flat["cfg//means"],
            zeta=flat["cfg//zeta"],
            draws=flat["cfg//draws"],
            b_max=int(flat["cfg//b_max"]),
            drain=bool(flat["cfg//drain"]),
            slo=None if np.isnan(slo) else slo,
            hist_edges=flat["cfg//edges"],
            quantiles=tuple(float(q) for q in flat["cfg//qprobs"]),
            t0=float(flat["cfg//t0"]),
            phase_mode=pm,
            belief_filter=filt,
            device=device,
        )
        # fields the constructor derives from args we did not persist in
        # their original form (router name, faults spec, buffer flag)
        self.rid = int(flat["cfg//rid"])
        self.fb = flat["cfg//fb"]
        self.fmult = flat["cfg//fmult"]
        self.max_retries = int(flat["cfg//max_retries"])
        self.buf_cap = int(flat["cfg//buf_cap"])
        self._rng = np.random.default_rng(0)
        self._rng.bit_generator.state = json.loads(
            bytes(bytearray(flat["cfg//rng"])).decode()
        )
        if pm != "oracle":
            self._bel0 = np.asarray(flat["bel//bel0"], dtype=np.float64)
        # --- carried seam state ---------------------------------------
        self.t = float(flat["carry//t"])
        self.rr = int(flat["carry//rr"])
        self.ph = int(flat["carry//ph"])
        self.busy = np.asarray(flat["carry//busy"], dtype=np.float64)
        self.nbat = np.asarray(flat["carry//nbat"], dtype=np.int64)
        self.needs = np.asarray(flat["carry//needs"], dtype=bool)
        self.fcur = np.asarray(flat["carry//fcur"], dtype=np.int64)
        self.rty = np.asarray(flat["carry//rty"], dtype=np.int64)
        self.infl = np.asarray(flat["carry//infl"], dtype=np.int64)
        self._t_hwm = float(flat["carry//t_hwm"])
        self._finished = bool(flat["carry//finished"])
        lens = flat["carry//q_lens"]
        qt, qd = flat["carry//q_times"], flat["carry//q_deads"]
        queues, off = [], 0
        for m in range(self.M):
            ln = int(lens[m])
            queues.append((qt[off : off + ln].copy(), qd[off : off + ln].copy()))
            off += ln
        self.queues = queues
        # --- streaming aggregates -------------------------------------
        self.hist = np.asarray(flat["agg//hist"], dtype=np.int64)
        self.n_admitted = int(flat["agg//n_admitted"])
        self.n_served = int(flat["agg//n_served"])
        self.n_batches = int(flat["agg//n_batches"])
        self.n_epochs = int(flat["agg//n_epochs"])
        self.energy = float(flat["agg//energy"])
        self.lat_sum = float(flat["agg//lat_sum"])
        self.slo_miss = int(flat["agg//slo_miss"])
        self.n_crashes = int(flat["agg//n_crashes"])
        self.n_dropped = int(flat["agg//n_dropped"])
        self.n_shed = int(flat["agg//n_shed"])
        self.n_routed = np.asarray(flat["agg//n_routed"], dtype=np.int64)
        self.n_served_m = np.asarray(flat["agg//n_served_m"], dtype=np.int64)
        for k, est in enumerate(self.quantiles.values()):
            est.restore(
                {
                    f: flat[f"p2//{k}//{f}"]
                    for f in ("q", "init", "n", "ns", "heights")
                }
            )
        return self

    def _run_chunk(self, times, deadlines, phases, router_u, *,
                   more_coming, t_last):
        order = np.argsort(times, kind="stable")
        times = times[order]
        if deadlines is not None:
            deadlines = np.asarray(deadlines, np.float64)[order]
        elif self.slo is not None:
            deadlines = times + self.slo
        bel = None
        if self.phase_mode != "oracle":
            if phases is not None:
                raise ValueError(
                    "belief phase modes derive phases from the filter; "
                    "don't pass phases= per chunk"
                )
            # forward-filter this chunk from the carried posterior, then
            # advance the filter state so the next chunk resumes exactly
            if len(times):
                rows, (b_f, t_f) = belief_forward(
                    times, self._filt, device=self.device
                )
                rows = rows.cpu().numpy()
                phases = np.argmax(rows, axis=-1).astype(np.int64)
                if self.phase_mode == "belief_mix":
                    bel = rows
                self._filt.belief = b_f.cpu().numpy().astype(np.float64)
                self._filt._last = float(t_f)
                self._filt.n_observed += len(times)
            else:
                phases = np.zeros(0, dtype=np.int64)
        elif phases is not None:
            phases = np.asarray(phases, np.int64)[order]
        elif self.K > 1 and len(times):
            # the finish() drain pushes zero arrivals and needs no phases
            raise ValueError("phase-indexed tables need phases= per chunk")
        n = len(times)
        padded = pad_arrivals(times, deadlines, phases=phases)
        if phases is None:
            arr, dl = padded
            ph_arr = np.zeros(len(arr), dtype=np.int64)
        else:
            arr, dl, ph_arr = padded
        mix = self.phase_mode == "belief_mix"
        bel_p = bel0 = None
        if mix:
            bel_p = np.zeros((len(arr), self.K))
            if bel is not None:
                bel_p[:n] = bel
            bel0 = self._bel0
        if router_u is None:
            router_u = self._rng.random((len(arr), 2))
        else:
            ru = np.full((len(arr), 2), 0.5)
            ru[:len(router_u)] = np.asarray(router_u, np.float64)[order]
            router_u = ru
        # carried queues -> (M, Q0) +inf-padded arrays
        c0 = max([len(q[0]) for q in self.queues] + [1])
        Q0 = _bucket(c0, floor=16)
        q0_t = np.full((self.M, Q0), np.inf)
        q0_d = np.full((self.M, Q0), np.inf)
        for m, (qt, qd) in enumerate(self.queues):
            q0_t[m, : len(qt)] = qt
            q0_d[m, : len(qd)] = qd
        q0_total = int(sum(len(q[0]) for q in self.queues))
        # boundaries not yet replayed can each cost a step (and a crash
        # re-decision): budget them alongside arrivals and epochs
        n_bnd = int(np.isfinite(self.fb).sum() - self.fcur.sum())
        n_bnd = max(n_bnd, 0)
        max_eps = 2 * (n + q0_total) + 2 * self.M + 8 + 2 * n_bnd
        cap = _bucket(2 * (n + max_eps + n_bnd) + 2 * self.M + 8)
        step0 = min(
            _bucket(max(256, 2 * n + 2 * q0_total + 2 * self.M + 8)), cap
        )
        state0 = np.stack([self.nbat, self.needs.astype(np.int64), self.fcur,
                           self.rty, self.infl]).astype(np.int64)
        agg, rec = _run_lanes(
            self.device, self.tables[None], self.thr[None],
            np.array([self.rid]), arr[None], dl[None], ph_arr[None],
            router_u[None], self.draws[None], self.means, self.zeta,
            self.edges, self.fb, self.fmult, q0_t, q0_d, self.busy, state0,
            None if bel_p is None else bel_p[None],
            None if bel0 is None else bel0[None],
            t0=self.t, horizon=np.inf, max_eps=max_eps, drain=self.drain,
            b_max=self.b_max, buf_cap=self.buf_cap,
            max_retries=self.max_retries, rr0=self.rr, ph0=self.ph,
            more_coming=more_coming, t_last=t_last, step0=step0, cap=cap,
            record=True,
        )
        agg = {k: v[0] for k, v in agg.items()}
        st = rec.arr_state[0]
        arr_served = (st & fk.SERVED) != 0
        arr_dropped = (st & fk.DROPPED) != 0
        arr_shed = (st & fk.SHED) != 0
        arr_server = rec.arr_server[0]
        arr_lat = rec.arr_lat[0]
        q0_lat = rec.q0_lat[0]
        q0_served = (rec.q0_state[0] & fk.SERVED) != 0
        q0_dropped = (rec.q0_state[0] & fk.DROPPED) != 0
        if int(agg["n_admitted"]) != n:
            raise RuntimeError(
                f"chunk admitted {int(agg['n_admitted'])}/{n} arrivals "
                "(epoch budget bound mid-chunk; this is a bug)"
            )
        if mix and n:
            self._bel0 = np.asarray(self._filt.belief, dtype=np.float64)
        # --- fold aggregates ------------------------------------------
        self.n_admitted += n
        self.n_served += int(agg["n_served"])
        self.n_batches += int(agg["n_batches"])
        self.n_epochs += int(agg["n_epochs"])
        self.energy += float(agg["energy"])
        self.lat_sum += float(agg["lat_sum"])
        self.slo_miss += int(agg["slo_miss"])
        self.n_crashes += int(agg["n_crashes"])
        self.n_dropped += int(agg["n_dropped"])
        self.n_shed += int(agg["n_shed"])
        self.hist += agg["hist"]
        # P2 updates in a fixed order: carried queues (replica-major,
        # position order), then this chunk's arrivals in time order
        for m in range(self.M):
            for lat in q0_lat[m][q0_served[m]]:
                for est in self.quantiles.values():
                    est.update(float(lat))
        for lat in arr_lat[arr_served]:
            for est in self.quantiles.values():
                est.update(float(lat))
        # --- carry state ----------------------------------------------
        new_queues = []
        for m in range(self.M):
            qt, qd = self.queues[m]
            keep = ~(q0_served[m] | q0_dropped[m])[: len(qt)]
            # shed arrivals record their would-be replica but never queue
            mask = (
                (arr_server[:len(arr)] == m)
                & ~arr_served & ~arr_dropped & ~arr_shed
            )
            new_queues.append((
                np.concatenate([qt[keep], arr[mask]]),
                np.concatenate([qd[keep], dl[mask]]),
            ))
        self.queues = new_queues
        # a crashed in-flight batch stays in the carried queue (front,
        # unresolved positions) but outside the kernel's qlen count
        assert int(sum(len(q[0]) for q in self.queues)) == int(
            agg["qlen"].sum() + agg["infl"].sum()
        )
        self.t = float(agg["t_final"])
        self.busy = agg["busy"].copy()
        self.rr = int(agg["rr"])
        self.ph = int(agg["ph"])
        self.nbat = agg["nbat"].copy()
        self.needs = agg["needs"].copy()
        self.fcur = agg["fcur"].copy()
        self.rty = agg["rty"].copy()
        self.infl = agg["infl"].copy()
        # the kernel's n_route carry starts at the carried-queue count
        # (substream positions offset past q0) -- only the excess is new
        self.n_routed += agg["n_route"] - np.sum(
            np.isfinite(q0_t), axis=1
        ).astype(np.int64)
        self.n_served_m += agg["n_srv"]


def simulate_fleet_stream(
    tables,
    arrivals,
    *,
    chunk_size: int = 65536,
    deadlines=None,
    phases=None,
    router_u=None,
    **kwargs,
) -> FleetResult:
    """Stream a long arrival array through `FleetStream` in fixed chunks.

    ``arrivals`` may be one sorted array (sliced into ``chunk_size``
    windows) or an iterable of chunk arrays.  Accepts `FleetStream`'s
    keyword arguments (``device=`` included); per-arrival ``deadlines`` /
    ``phases`` / ``router_u`` are sliced alongside when given as arrays.
    """
    fs = FleetStream(tables, **kwargs)
    if isinstance(arrivals, np.ndarray) or (
        isinstance(arrivals, (list, tuple))
        and arrivals
        and np.isscalar(arrivals[0])
    ):
        arrivals = np.asarray(arrivals, dtype=np.float64)
        n = len(arrivals)
        for lo in range(0, n, chunk_size):
            hi = min(lo + chunk_size, n)
            fs.push(
                arrivals[lo:hi],
                None if deadlines is None else deadlines[lo:hi],
                phases=None if phases is None else phases[lo:hi],
                router_u=None if router_u is None else router_u[lo:hi],
            )
    else:
        for chunk in arrivals:
            fs.push(np.asarray(chunk, dtype=np.float64))
    return fs.finish()


# ---------------------------------------------------------------------------
# The (seeds x scenarios) x policies x routers grid, one launch
# ---------------------------------------------------------------------------


def run_fleet_grid(
    tables,
    arrivals,
    *,
    routers: Sequence = ("jsq",),
    n_replicas: Optional[int] = None,
    means,
    zeta=None,
    draws=None,
    b_max: int,
    max_epochs: Optional[int] = None,
    t0: float = 0.0,
    horizon: Optional[float] = None,
    drain: bool = True,
    deadlines=None,
    phases=None,
    phase_mode: str = "oracle",
    beliefs=None,
    hist_edges=None,
    router_seed: int = 0,
    mesh=None,
    device: DeviceLike = None,
):
    """The fleet sweep: (seeds x scenarios) traces x policies x routers.

    ``tables`` -- (P, M, L) per-policy per-replica action tables (or
    (P, M, K, L) phase-indexed stacks with ``phases`` = (S, N) ints, or
    ``phase_mode="belief_argmax"`` / ``"belief_mix"`` + ``beliefs`` =
    (S, N, K) posterior rows); a (P, L) array plus ``n_replicas=M`` runs
    each policy homogeneously on M replicas.  ``arrivals`` -- (S, N)
    padded sorted traces (`pad_arrivals_batch`); ``draws`` -- (S, D) unit
    service draws per lane.  ``routers`` -- router names (or kernel ids).
    Every (s, p, r) lane walks in one launch of the fleet kernel, fault
    free and unbuffered.

    Returns a dict of (S, P, R) aggregate arrays -- plus (S, P, R, M)
    per-replica queue/served/routed counts -- and the derived ``w_mean``
    (NaN on starved lanes), ``power``, and ``q_time_avg`` (time-averaged
    total backlog, ``lat_sum / span`` by Little's law).

    ``mesh=`` (sharding S over devices) is not ported and raises
    NotImplementedError.  ``device=None`` means CUDA; ``device="cpu"``
    runs the plain version.
    """
    if mesh is not None:
        raise NotImplementedError(
            "run_fleet_grid(mesh=) needs the distributed layer, which the "
            "port does not have yet (ROADMAP.md, queue 1 item 7); one launch "
            "already runs every lane on one card"
        )
    dev = resolve_device(device)
    tables = np.asarray(tables, dtype=np.int64)
    if tables.ndim == 2:
        if n_replicas is None:
            raise ValueError(
                "(P, L) tables need n_replicas=M (or pass (P, M, L))"
            )
        tables = np.repeat(tables[:, None, :], n_replicas, axis=1)
    if tables.ndim == 3:
        tables = tables[:, :, None, :]
    if tables.ndim != 4:
        raise ValueError(
            f"tables must be (P, L), (P, M, L) or (P, M, K, L); "
            f"got {tables.shape}"
        )
    if n_replicas is not None and tables.shape[1] != n_replicas:
        raise ValueError(
            f"tables have {tables.shape[1]} replicas, n_replicas={n_replicas}"
        )
    Pn, M, K, L = tables.shape
    arr = np.asarray(arrivals, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError("run_fleet_grid wants (S, N) arrivals")
    bel = None
    if phase_mode != "oracle" or beliefs is not None:
        if beliefs is not None and np.asarray(beliefs).shape[:2] != arr.shape:
            raise ValueError(
                "beliefs must be (S, N, K) aligned with arrivals"
            )
        phases, bel = _belief_phases(phase_mode, beliefs, phases, K)
    if arr.shape[1] < _PAD_MARGIN or not np.isinf(arr[:, -_PAD_MARGIN:]).all():
        raise ValueError("pad each trace with pad_arrivals first")
    S, N = arr.shape
    dl = (
        np.asarray(deadlines, dtype=np.float64)
        if deadlines is not None
        else np.full_like(arr, np.inf)
    )
    if phases is not None:
        ph = np.asarray(phases, dtype=np.int64)
        if ph.shape != arr.shape:
            raise ValueError(f"phases shape {ph.shape} != arrivals {arr.shape}")
        if ph.min() < 0 or ph.max() >= K:
            raise ValueError(f"phases outside the table stack [0, {K})")
    else:
        if K > 1:
            raise ValueError("phase-indexed tables need phases= (S, N) ints")
        ph = np.zeros(arr.shape, dtype=np.int64)
    rids = np.asarray([router_id(r) for r in routers], dtype=np.int64)
    ru = np.random.default_rng(router_seed).random((S, N, 2))
    means = np.asarray(means, dtype=np.float64)
    zeta_a = _zeta_table(zeta, b_max)
    if draws is None:
        draws = np.ones((S, 1))
    draws = np.asarray(draws, dtype=np.float64)
    if draws.ndim == 1:  # one shared draw stream -> every lane
        draws = np.tile(draws[None, :], (S, 1))
    if draws.shape[0] != S:
        raise ValueError(f"draws lane axis {draws.shape[0]} != S={S}")
    edges = (
        default_hist_edges(means)
        if hist_edges is None
        else np.asarray(hist_edges, dtype=np.float64)
    )
    thrs = np.stack([threshold_gaps(tables[p]) for p in range(Pn)])
    mix = bel is not None
    bel_g = np.asarray(bel, dtype=np.float64) if mix else None
    max_eps, cap, step0 = _budgets(
        int(np.isfinite(arr).sum(axis=1).max()), M, max_epochs=max_epochs
    )
    busy0, state0 = _fresh_state(M)
    q0 = np.full((M, 1), np.inf)
    agg, _ = _run_lanes(
        dev, tables, thrs, rids, arr, dl, ph, ru, draws, means, zeta_a, edges,
        np.full((M, 1), np.inf), np.ones((M, 1)), q0, q0, busy0, state0,
        bel_g, None if bel_g is None else bel_g[:, 0],
        t0=t0, horizon=np.inf if horizon is None else float(horizon),
        max_eps=max_eps, drain=drain, b_max=b_max, buf_cap=_NO_BUFFER,
        max_retries=0, step0=step0, cap=cap,
    )
    R = len(rids)
    out = {k: v.reshape((S, Pn, R) + v.shape[1:]) for k, v in agg.items()}
    out["hist_edges"] = edges
    with np.errstate(invalid="ignore", divide="ignore"):
        span = out["t_final"] - t0
        # a starved lane (no served request) has no mean latency: NaN
        out["w_mean"] = np.where(
            out["n_served"] > 0,
            out["lat_sum"] / np.maximum(out["n_served"], 1),
            np.nan,
        )
        have_energy = zeta is not None
        out["power"] = np.where(
            have_energy & (out["n_batches"] > 0) & (span > 0),
            out["energy"] / span,
            np.nan,
        )
        # time-averaged total backlog (Little): integral of queue+in-
        # service size over time / span == sum of latencies / span
        out["q_time_avg"] = np.where(
            span > 0, out["lat_sum"] / np.where(span > 0, span, 1.0), np.nan
        )
        out["events_total"] = int(
            out["n_served"].sum() + out["n_epochs"].sum()
        )
    return out
