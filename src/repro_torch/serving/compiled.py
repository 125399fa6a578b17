"""Compiled serving backend: the event loop as one CUDA kernel launch.

The same decision-epoch semantics as the Python engine
(serving.engine._run_events) and as the reference's jitted ``lax.scan``:
arrivals are a pre-sorted, +inf-padded array served FIFO; the policy is a
(K, L) table indexed by the phase of the last admitted arrival and
``min(queue, L - 1)``; service time is ``means[a] * draws[n_batches]``.

One lane walks its events in one thread of ``kernels/csrc/serve_scan.cu``
and accounts every served request as it goes (latency sum, SLO misses,
the log-spaced histogram sketch, energy), so a lane returns O(bins)
aggregates whatever the horizon; ``record=True`` adds the per-epoch
decisions and the per-request slots and completion times.  The lane's
options are the reference's:

  * the managed queue (``buffer=`` / ``shed_expired=``): door refusals
    past a finite waiting room, the sweep of expired requests before every
    decision, and the surviving queue (``queue_slots``);
  * the adaptive lane (``adaptive=``): an `AdaptiveController` lowered to
    `AdaptiveLane` retunes the bank entry inside the kernel, and the
    result carries the controller's final state;
  * the belief lanes (``phase_mode="belief_argmax"`` / ``"belief_mix"``
    with ``beliefs=``, the phase posterior per arrival from
    arrivals.belief_forward): argmax lowers on the host to a phase stream
    for the oracle lane, as the reference does; mix is the event kernel's
    mix rule, ``round(sum_k b_k table[k, q])``.

`run_grid` (traces x tables) and `run_grid_adaptive` (traces, each over a
whole bank) are one launch over all their lanes.  The kernel runs every
lane to its end, so there is no step budget to escalate: the reference's
``n_steps_used``, ``max_record_slots`` and step cache have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.serve_scan import AGG_F, AGG_I, serve_scan

#: default fixed-bin latency sketch resolution (log-spaced bins)
DEFAULT_N_BINS = 256

#: +inf sentinels at the end of every padded arrival array; the reference
#: pads with the same margin, so padded arrays are interchangeable
_PAD_MARGIN = 4


def default_hist_edges(
    means: np.ndarray, n_bins: int = DEFAULT_N_BINS,
    lo_scale: float = 0.25, hi_scale: float = 2000.0,
) -> np.ndarray:
    """Log-spaced latency bin edges from the service-mean scale.

    Latencies are bounded below by (a fraction of) the single-request
    service time and above by queueing delay; ~4%-wide log bins over
    [means[1]/4, 2000 * means[b_max]] keep the sketch quantile error well
    inside the tolerance band tested against np.percentile.
    """
    lo = max(float(means[1]) * lo_scale, 1e-9)
    hi = max(float(means[-1]) * hi_scale, lo * 10.0)
    return np.geomspace(lo, hi, n_bins + 1)


def _bucket(n: int, floor: int = 256) -> int:
    """Smallest size >= n from {2^k, 3*2^k} (the reference's pad sizes)."""
    b = floor
    while b < n:
        h = (b * 3) // 2
        if h >= n:
            return h
        b <<= 1
    return b


def pad_arrivals(
    times, deadlines=None, size: Optional[int] = None, *, phases=None
):
    """Sort + pad an arrival-time array with +inf to a bucketed size.

    Returns (arrivals, deadlines) float64 arrays of length ``size`` (or the
    bucketed size above len(times) plus the sentinel margin).  Padded
    deadlines are +inf (never miss).  With ``phases`` (per-arrival phase
    ints for the phase-indexed table lane) a co-sorted, zero-padded int
    array is returned as a third element.
    """
    t = np.asarray(times, dtype=np.float64)
    finite = np.isfinite(t)  # idempotent: +inf padding is re-derived
    d = p = None
    if deadlines is not None:
        d = np.asarray(deadlines, dtype=np.float64)
        if len(d) != len(t):
            raise ValueError("deadlines must align with times")
        d = d[finite]
    if phases is not None:
        p = np.asarray(phases, dtype=np.int64)
        if len(p) != len(t):
            raise ValueError("phases must align with times")
        p = p[finite]
    t = t[finite]
    order = np.argsort(t, kind="stable")
    t = t[order]
    n = len(t)
    size = _bucket(n + _PAD_MARGIN) if size is None else size
    if size < n + _PAD_MARGIN:
        raise ValueError(
            f"pad size {size} < n_arrivals + {_PAD_MARGIN} = {n + _PAD_MARGIN}"
        )
    arr = np.full(size, np.inf)
    arr[:n] = t
    dl = np.full(size, np.inf)
    if d is not None:
        dl[:n] = d[order]
    if p is None:
        return arr, dl
    ph = np.zeros(size, dtype=np.int64)
    ph[:n] = p[order]
    return arr, dl, ph


def pad_arrivals_batch(traces, size: Optional[int] = None):
    """Pad several traces to one shared bucketed size: the (S, N) array
    `run_grid` wants for its seeds/scenarios axis."""
    traces = [np.asarray(t, dtype=np.float64) for t in traces]
    if not traces:
        raise ValueError("pad_arrivals_batch needs at least one trace")
    if size is None:
        size = _bucket(max(len(t) for t in traces) + _PAD_MARGIN)
    return np.stack([pad_arrivals(t, size=size)[0] for t in traces])


@dataclasses.dataclass
class CompiledResult:
    """Aggregates of one compiled run (arrays already on host)."""

    t_final: float
    n_served: int
    n_batches: int
    n_epochs: int
    n_admitted: int
    energy: float
    lat_sum: float
    slo_miss: int
    terminated: bool  # stream exhausted (vs epoch budget reached)
    hist: np.ndarray  # (n_bins + 2,) counts; [0]=underflow, [-1]=overflow
    hist_edges: np.ndarray  # (n_bins + 1,)
    # record=True only:
    actions: Optional[np.ndarray] = None  # (n_epochs,) batch size, 0 = wait
    serve: Optional[np.ndarray] = None  # (n_epochs,) bool
    latencies: Optional[np.ndarray] = None  # (n_served,) in service order
    # adaptive lane only: final controller carry (engine state sync)
    adaptive_state: Optional[dict] = None
    # managed-queue lane (buffer= / shed_expired=) only:
    n_shed: int = 0  # arrivals refused by the finite waiting room
    n_expired: int = 0  # queued requests shed past their deadline
    queue_slots: Optional[np.ndarray] = None  # surviving queue, slot idxs

    @property
    def batch_sizes(self) -> np.ndarray:
        if self.actions is None:
            raise ValueError("run with record=True for per-epoch decisions")
        return self.actions[self.serve]


@dataclasses.dataclass
class AdaptiveLane:
    """Host-side lowering of an `AdaptiveController` for the event kernel.

    Everything the in-kernel controller needs, precomputed once: the bank
    stacked in sorted-key order, the per-key lambda coordinate plus the
    *pinned*-dimension squared scaled offsets (so the kernel's distance is
    ``sqrt(((lam_i - est) * inv_scale)^2 + aux_sq_i)`` -- the scaled
    Euclidean metric of `SMDPSchedulerBank.distances` over the
    {lam, **fixed} coordinate set), the EWMA constants, and the initial
    state extracted from the live controller (so a mid-stream engine run
    resumes exactly).  Window-mode estimators have no O(1) state and stay
    on the Python backend.
    """

    tables: np.ndarray  # (P, K, L) bank stack, sorted-key order
    lam_keys: np.ndarray  # (P,) lambda coordinate per key
    aux_sq: np.ndarray  # (P,) pinned-dims squared scaled distance
    inv_scale: float  # 1 / lambda-dimension scale
    ewma: float
    margin: float
    min_dwell: float
    min_gap: float
    init_est: float  # estimator rate before any gap (NaN if none)
    sel0: int  # initial bank entry (index into sorted keys)
    gap_bar0: float  # NaN when the estimator has no gap average yet
    have_gap_bar0: bool
    last0: float  # NaN when no arrival observed yet
    have_last0: bool
    last_switch0: float
    n_switches0: int

    @classmethod
    def from_controller(cls, ctrl) -> "AdaptiveLane":
        est = ctrl.estimator
        if getattr(est, "window", None) is not None:
            raise TypeError(
                "compiled adaptive lane needs an EWMA RateEstimator; "
                "window-mode estimators stay on the Python backend"
            )
        bank = ctrl.bank
        unknown = set(ctrl.fixed) - set(bank.key_names)
        if unknown:
            raise ValueError(
                f"unknown key dims {unknown}; have {bank.key_names}"
            )
        _, stacked = bank.stacked()
        if stacked.ndim == 2:
            stacked = stacked[:, None, :]
        i_lam = bank.key_names.index("lam")
        pts, scales = bank._pts, bank._scales
        aux = np.zeros(len(pts))
        for i, name in enumerate(bank.key_names):
            if i != i_lam and name in ctrl.fixed:
                aux += ((pts[:, i] - ctrl.fixed[name]) / scales[i]) ** 2
        gap_bar = est._gap_bar
        last = est._last
        return cls(
            tables=stacked,
            lam_keys=pts[:, i_lam].copy(),
            aux_sq=aux,
            inv_scale=1.0 / float(scales[i_lam]),
            ewma=float(est.ewma),
            margin=float(ctrl.margin),
            min_dwell=float(ctrl.min_dwell),
            min_gap=float(est.min_gap),
            init_est=(
                float(est._init_rate) if est._init_rate else float("nan")
            ),
            sel0=int(bank._key_index[ctrl.key]),
            gap_bar0=float("nan") if gap_bar is None else float(gap_bar),
            have_gap_bar0=gap_bar is not None,
            last0=float("nan") if last is None else float(last),
            have_last0=last is not None,
            last_switch0=float(ctrl._last_switch),
            n_switches0=int(ctrl.n_switches),
        )

    def lowered(self):
        """(f64 vector, int64 vector): the constants and initial state the
        kernel takes (layouts ``kernels.serve_scan.AD_F`` / ``AD_I``)."""
        ad_f = np.concatenate([
            [self.inv_scale, self.ewma, self.margin, self.min_dwell,
             self.min_gap, self.init_est, self.gap_bar0, self.last0,
             self.last_switch0],
            np.asarray(self.lam_keys, dtype=np.float64),
            np.asarray(self.aux_sq, dtype=np.float64),
        ]).astype(np.float64)
        ad_i = np.array(
            [self.sel0, self.n_switches0, int(self.have_gap_bar0),
             int(self.have_last0)],
            dtype=np.int64,
        )
        return ad_f, ad_i


#: the phase_mode knob shared by simulate_compiled / run_grid: "oracle"
#: rows tables by the per-arrival true-phase ints, the belief modes by the
#: filtered posterior (argmax row / mixture action)
PHASE_MODES = ("oracle", "belief_argmax", "belief_mix")


def _check_phase_mode(phase_mode: str, beliefs, n_phases: int):
    """Validate the phase_mode / beliefs pairing; returns belief ndarray."""
    if phase_mode not in PHASE_MODES:
        raise ValueError(f"phase_mode must be one of {PHASE_MODES}")
    if phase_mode == "oracle":
        if beliefs is not None:
            raise ValueError('beliefs= needs phase_mode="belief_*"')
        return None
    if beliefs is None:
        raise ValueError(f'phase_mode="{phase_mode}" needs beliefs=')
    if isinstance(beliefs, torch.Tensor):
        beliefs = beliefs.cpu().numpy()
    bel = np.asarray(beliefs, dtype=np.float64)
    if bel.shape[-1] != n_phases:
        raise ValueError(
            f"beliefs K={bel.shape[-1]} != table phase axis K={n_phases}"
        )
    return bel


def _coerce_adaptive(adaptive) -> Optional[AdaptiveLane]:
    if adaptive is None or isinstance(adaptive, AdaptiveLane):
        return adaptive
    return AdaptiveLane.from_controller(adaptive)


def _zeta_table(zeta, b_max: int) -> np.ndarray:
    z = (
        np.zeros(b_max + 1)
        if zeta is None
        else np.asarray(zeta, dtype=np.float64).copy()
    )
    z[0] = 0.0  # a = 0 never accounts energy
    return z


def _launch(dev, tables, arr, dl, ph, draws, means, zeta_a, edges, *, lane,
            buffer, shed_expired, record, bel=None, **kw):
    """One event-kernel launch over (S traces) x (P tables, or the bank)."""

    def on_dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    # +inf deadlines never miss: with no other the kernel skips their loads
    need_dl = bool(shed_expired) or not np.all(dl == np.inf)
    ad = None
    if lane is not None:
        ad_f, ad_i = lane.lowered()
        ad = (on_dev(ad_f, torch.float64), on_dev(ad_i, torch.int64))
    return serve_scan(
        on_dev(tables, torch.int64), on_dev(arr, torch.float64),
        on_dev(dl, torch.float64) if need_dl else None,
        on_dev(ph, torch.int64), on_dev(draws, torch.float64),
        on_dev(means, torch.float64), on_dev(zeta_a, torch.float64),
        on_dev(edges, torch.float64),
        buffer=buffer, shed=bool(shed_expired), adaptive=ad,
        beliefs=None if bel is None else on_dev(bel, torch.float64),
        record=record, **kw,
    )


def simulate_compiled(
    table,
    arrivals,
    *,
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
    adaptive=None,
    buffer: Optional[int] = None,
    shed_expired: bool = False,
    hist_edges=None,
    record: bool = False,
    device: DeviceLike = None,
) -> CompiledResult:
    """Run one policy table over one arrival trace on ``device``.

    ``arrivals``/``deadlines`` may be raw times (padded internally) or
    already-padded arrays from `pad_arrivals`.  ``draws`` are unit-scale
    service draws (ones for deterministic service); service time of a batch
    of size a is ``means[a] * draws[n_batches_so_far]`` — one draw per
    serve epoch, the Python engine's rng discipline.  ``table`` may be a
    (K, L) phase-indexed stack with ``phases`` the per-arrival phase ints
    (the row is the phase of the last admitted arrival).  ``record=True``
    returns the per-epoch decisions and per-request latencies too.

    Who rows the phase axis is the ``phase_mode`` knob: ``"oracle"`` (the
    ``phases`` ints), ``"belief_argmax"`` (``beliefs`` (N, K) posterior rows
    aligned with ``arrivals``, arrivals.belief_forward; the argmax phase
    rows the stack, lowered to a phase stream on the host) or
    ``"belief_mix"`` (the same ``beliefs``; the action is
    ``round(sum_k b_k table[k, q])``, the event kernel's mix rule).

    ``adaptive`` (an `AdaptiveLane` or the `AdaptiveController` to lower)
    runs the bank-retuning controller inside the kernel: ``table`` may then
    be None (the lane's (P, K, L) bank stack is used) and the result
    carries ``adaptive_state``, the controller's final state.

    ``buffer=B`` bounds the waiting room: arrivals finding B requests
    queued are refused at the door (``n_shed``, never observed by the
    adaptive estimator).  ``shed_expired=True`` drops queued requests whose
    deadline has passed before every decision epoch (``n_expired``); it
    needs deadlines nondecreasing in arrival order (``deadline = arrival +
    slo`` always is).  Either knob selects the managed-queue lane, and the
    result gains ``queue_slots``, the surviving queue as arrival-slot
    indices.  ``buffer`` composes with ``phase_mode="oracle"`` only (the
    posterior folds admitted arrivals, which a finite room makes
    decision-dependent).

    ``device=None`` means CUDA (the event kernel); ``device="cpu"`` runs
    the kernel's plain version.
    """
    lane = _coerce_adaptive(adaptive)
    if buffer is not None:
        if buffer < 0:
            raise ValueError("buffer must be >= 0 (B = 0 sheds everything)")
        if phase_mode != "oracle":
            raise ValueError(
                'buffer= composes with phase_mode="oracle" only: belief '
                "posteriors fold admitted arrivals, and admission under a "
                "finite waiting room is decision-dependent; run the "
                "Python backend"
            )
    dev = resolve_device(device)
    if lane is not None:
        table = lane.tables if table is None else np.asarray(table, dtype=np.int64)
        if table.ndim == 2:
            table = table[:, None, :]
        elif table.ndim != 3:
            raise ValueError(
                f"adaptive tables must be (P, L) or (P, K, L); got {table.shape}"
            )
        tables = table
    else:
        table = np.asarray(table, dtype=np.int64)
        if table.ndim == 1:
            table = table[None]
        elif table.ndim != 2:
            raise ValueError(f"table must be (L,) or (K, L); got {table.shape}")
        tables = table[None]
    n_phases = tables.shape[1]
    bel = _check_phase_mode(phase_mode, beliefs, n_phases)
    if bel is not None:
        if phases is not None:
            raise ValueError("phases= and beliefs= are mutually exclusive")
        if bel.ndim != 2:
            raise ValueError(f"beliefs must be (N, K); got {bel.shape}")
    elif n_phases > 1 and phases is None and lane is None:
        raise ValueError("phase-indexed table needs phases= per arrival")
    arr = np.asarray(arrivals, dtype=np.float64)
    if bel is not None and len(bel) != len(arr):
        raise ValueError("beliefs must align with arrivals")
    if phase_mode == "belief_argmax":
        # the argmax rule is an oracle-phase stream derived from the
        # posterior: the phases plumbing, no kernel change
        phases = np.argmax(bel, axis=-1)
        bel = None
    if len(arr) < _PAD_MARGIN or not np.isinf(arr[-_PAD_MARGIN:]).all():
        raw = arr
        padded = pad_arrivals(arr, deadlines, phases=phases)
        if phases is None:
            arr, dl = padded
            ph = np.zeros(len(arr), dtype=np.int64)
        else:
            arr, dl, ph = padded
        if bel is not None:
            # co-sort / pad the posterior rows exactly like pad_arrivals
            finite = np.isfinite(raw)
            kept = bel[finite]
            order = np.argsort(raw[finite], kind="stable")
            bel = np.zeros((len(arr), bel.shape[1]))
            bel[: len(kept)] = kept[order]
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
        if len(ph) != len(arr):
            raise ValueError("padded phases must align with arrivals")
    if ph.min() < 0 or ph.max() >= n_phases:
        raise ValueError(f"phases outside the table stack [0, {n_phases})")
    n_arr = int(np.sum(np.isfinite(arr)))
    if shed_expired:
        # expired requests must form a queue *prefix* (the kernel sheds
        # from the head): deadlines nondecreasing in arrival order.  inf -
        # inf is NaN and NaN < 0 is False, so all-inf runs pass.
        with np.errstate(invalid="ignore"):
            if np.any(np.diff(dl[:n_arr]) < 0):
                raise ValueError(
                    "shed_expired needs deadlines nondecreasing in arrival "
                    "order (deadline = arrival + slo always is); arbitrary "
                    "deadline orders run on the Python backend"
                )
    max_eps = 2 * n_arr + 2 if max_epochs is None else int(max_epochs)
    means = np.asarray(means, dtype=np.float64)
    draws = np.ones(1) if draws is None else np.asarray(draws, dtype=np.float64)
    edges = (
        default_hist_edges(means)
        if hist_edges is None
        else np.asarray(hist_edges, dtype=np.float64)
    )
    out = _launch(
        dev, tables, arr[None], dl[None], ph[None], draws[None], means,
        _zeta_table(zeta, b_max), edges, lane=lane, buffer=buffer,
        shed_expired=shed_expired, record=record,
        bel=None if bel is None else bel[None], t0=float(t0),
        horizon=np.inf if horizon is None else float(horizon),
        max_eps=max_eps, drain=bool(drain), b_max=int(b_max),
    )
    agg = dict(zip(AGG_I, out.agg_i[0].tolist()))  # the sync with the kernel
    aggf = dict(zip(AGG_F, out.agg_f[0].tolist()))
    res = CompiledResult(
        t_final=aggf["t_final"],
        n_served=agg["n_served"],
        n_batches=agg["n_batches"],
        n_epochs=agg["n_epochs"],
        n_admitted=agg["n_admitted"],
        energy=aggf["energy"],
        lat_sum=aggf["lat_sum"],
        slo_miss=agg["slo_miss"],
        terminated=bool(agg["terminated"]),
        hist=out.hist[0].cpu().numpy(),
        hist_edges=edges,
    )
    if out.queue is not None:
        res.n_shed = agg["n_shed"]
        res.n_expired = agg["n_expired"]
        res.queue_slots = (
            out.queue[0, agg["head"]: agg["tail"]].cpu().numpy().astype(np.int64)
        )
    if lane is not None:
        res.adaptive_state = {
            "sel": agg["sel"],
            "gap_bar": aggf["gap_bar"],
            "have_gap_bar": bool(agg["have_gap_bar"]),
            "last": aggf["last"],
            "have_last": bool(agg["have_last"]),
            "last_switch": aggf["last_switch"],
            "n_switches": agg["n_switches"],
        }
    if record:
        n_srv = res.n_served
        res.actions = out.rec_a[0, : res.n_epochs].cpu().numpy().astype(np.int64)
        res.serve = res.actions > 0
        slots = out.rec_slot[0, :n_srv].cpu().numpy().astype(np.int64)
        res.latencies = out.rec_done[0, :n_srv].cpu().numpy() - arr[slots]
    return res


def _grid_inputs(arr, phases, deadlines, draws, n_phases: int,
                 need_phases: bool):
    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError("run_grid wants (S, N) arrivals")
    if arr.shape[1] < _PAD_MARGIN or not np.isinf(arr[:, -_PAD_MARGIN:]).all():
        raise ValueError("pad each trace with pad_arrivals first")
    if need_phases and n_phases > 1 and phases is None:
        raise ValueError("phase-indexed tables need phases= (S, N) ints")
    dl = (
        np.asarray(deadlines, dtype=np.float64)
        if deadlines is not None
        else np.full_like(arr, np.inf)
    )
    if phases is not None:
        ph = np.asarray(phases, dtype=np.int64)
        if ph.shape != arr.shape:
            raise ValueError(f"phases shape {ph.shape} != arrivals {arr.shape}")
        if ph.min() < 0 or ph.max() >= n_phases:
            raise ValueError(f"phases outside the table stack [0, {n_phases})")
    else:
        ph = np.zeros(arr.shape, dtype=np.int64)
    draws = (
        np.ones((arr.shape[0], 1)) if draws is None
        else np.asarray(draws, dtype=np.float64)
    )
    return arr, dl, ph, draws


def _grid_beliefs(phase_mode, beliefs, phases, arr_shape, n_phases):
    """(phases, beliefs) of a grid call: argmax lowers to a phase stream,
    mix keeps the (S, N, K) rows for the kernel."""
    bel = _check_phase_mode(phase_mode, beliefs, n_phases)
    if bel is None:
        return phases, None
    if phases is not None:
        raise ValueError("phases= and beliefs= are mutually exclusive")
    if bel.ndim != 3 or bel.shape[:2] != arr_shape:
        raise ValueError(
            f"beliefs must be (S, N, K) aligned with arrivals {arr_shape}; "
            f"got {bel.shape}"
        )
    if phase_mode == "belief_argmax":
        return np.argmax(bel, axis=-1), None
    return None, bel


def _grid_run(dev, tables, arr, dl, ph, draws, *, means, zeta, b_max,
              max_epochs, t0, horizon, drain, hist_edges, lane, bel=None):
    means = np.asarray(means, dtype=np.float64)
    n_arr_max = int(np.isfinite(arr).sum(axis=1).max())
    max_eps = 2 * n_arr_max + 2 if max_epochs is None else int(max_epochs)
    edges = (
        default_hist_edges(means)
        if hist_edges is None
        else np.asarray(hist_edges, dtype=np.float64)
    )
    out = _launch(
        dev, tables, arr, dl, ph, draws, means, _zeta_table(zeta, b_max),
        edges, lane=lane, buffer=None, shed_expired=False, record=False,
        bel=bel, t0=float(t0),
        horizon=np.inf if horizon is None else float(horizon),
        max_eps=max_eps, drain=bool(drain), b_max=int(b_max),
    )
    S = arr.shape[0]
    lanes = (S,) if lane is not None else (S, tables.shape[0])
    agg_i = out.agg_i.cpu().numpy().reshape(*lanes, len(AGG_I))
    agg_f = out.agg_f.cpu().numpy().reshape(*lanes, len(AGG_F))
    i = {k: agg_i[..., n] for n, k in enumerate(AGG_I)}
    f = {k: agg_f[..., n] for n, k in enumerate(AGG_F)}
    terminated = i["terminated"].astype(bool)
    res = {
        "t_final": f["t_final"], "n_served": i["n_served"],
        "n_admitted": i["n_admitted"], "n_batches": i["n_batches"],
        "n_epochs": i["n_epochs"], "terminated": terminated,
        # every lane runs to its end: a lane stops terminated or at its
        # epoch budget, never for want of steps
        "incomplete": ~terminated & (i["n_epochs"] < max_eps),
        "energy": f["energy"], "lat_sum": f["lat_sum"],
        "slo_miss": i["slo_miss"],
        "hist": out.hist.cpu().numpy().reshape(*lanes, -1),
    }
    if lane is not None:
        res.update(
            ad_gap_bar=f["gap_bar"],
            ad_have_gap_bar=i["have_gap_bar"].astype(bool),
            ad_last=f["last"], ad_have_last=i["have_last"].astype(bool),
            ad_sel=i["sel"], ad_last_switch=f["last_switch"],
            ad_n_switches=i["n_switches"],
        )
    return _grid_post(res, edges, t0, zeta is not None)


def run_grid(
    tables,
    arrivals,
    *,
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
    device: DeviceLike = None,
):
    """The sweep: (seeds x scenarios) traces x policy tables, one launch.

    ``tables`` -- (P, L) stacked action tables (SMDPSchedulerBank.stacked()
    or scheduler.as_action_table per contender), or (P, K, L) phase-indexed
    stacks with ``phases`` = (S, N) per-arrival phase ints, or with
    ``phase_mode="belief_argmax"`` / ``"belief_mix"`` and ``beliefs`` =
    (S, N, K) posterior rows per trace (arrivals.belief_forward over the
    padded batch): the deployable, non-oracle policy sweep;
    ``arrivals`` -- (S, N) padded sorted traces (`pad_arrivals_batch`);
    ``draws`` -- (S, D) unit service draws per trace (ones for det
    service).  Lane (s, p) runs table p over trace s; all S x P lanes are
    one launch of the event kernel.

    Returns the reference's dict of (S, P) aggregate arrays plus the
    (S, P, n_bins + 2) histogram sketch, ``w_mean``, ``power`` and
    ``events_total``.  It has no ``n_steps_used``: that counts the steps of
    the reference's fixed-length scan, and the kernel runs each lane to its
    end.  ``device=None`` means CUDA; ``device="cpu"`` runs the plain
    version.
    """
    tables = np.asarray(tables, dtype=np.int64)
    if tables.ndim == 2:
        tables = tables[:, None, :]
    elif tables.ndim != 3:
        raise ValueError(f"tables must be (P, L) or (P, K, L); got {tables.shape}")
    dev = resolve_device(device)
    arr_shape = np.shape(arrivals)
    phases, bel = _grid_beliefs(phase_mode, beliefs, phases,
                                arr_shape, tables.shape[1])
    arr, dl, ph, draws = _grid_inputs(arrivals, phases, deadlines, draws,
                                      tables.shape[1], need_phases=bel is None)
    return _grid_run(
        dev, tables, arr, dl, ph, draws, means=means, zeta=zeta, b_max=b_max,
        max_epochs=max_epochs, t0=t0, horizon=horizon, drain=drain,
        hist_edges=hist_edges, lane=None, bel=bel,
    )


def _grid_post(out, edges, t0, have_energy):
    """Host-side aggregate post-processing shared by the grid entries."""
    out = {k: np.asarray(v) for k, v in out.items()}
    out["hist_edges"] = edges
    with np.errstate(invalid="ignore", divide="ignore"):
        span = out["t_final"] - t0
        # starved lane (n_served == 0) -> NaN mean latency, not 0.0: a
        # zero would win every frontier argmin and poison plots silently
        out["w_mean"] = np.where(
            out["n_served"] > 0,
            out["lat_sum"] / np.maximum(out["n_served"], 1),
            np.nan,
        )
        # same convention as the engine's have_energy flag: a lane with no
        # energy source or no served batch reports NaN power, not 0
        out["power"] = np.where(
            have_energy & (out["n_batches"] > 0) & (span > 0),
            out["energy"] / span,
            np.nan,
        )
        # served requests + decision epochs: the event count a throughput
        # figure divides by
        out["events_total"] = int(
            out["n_served"].sum() + out["n_epochs"].sum()
        )
    return out


def run_grid_adaptive(
    arrivals,
    *,
    adaptive,
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
    device: DeviceLike = None,
):
    """One controller config over S traces, one launch.

    The adaptive analogue of `run_grid`: every trace lane runs the
    in-kernel `AdaptiveController` (``adaptive``, an `AdaptiveLane` or the
    controller to lower) over the *whole* bank stack, retuning live, so
    the policy axis collapses into the lane.  Each lane starts from the
    controller's current state (fresh controllers per seed, the
    replication-sweep semantics).  Returns the same dict as `run_grid`
    with (S,) aggregates plus the final per-lane controller state
    (``ad_*`` keys), and no ``n_steps_used`` (see `run_grid`).
    ``phase_mode`` / ``beliefs`` / ``phases`` row the bank entries' phase
    axis as in `run_grid` (a belief-tracked row on top of bank retuning is
    AdaptiveController(phase_filter=...)).
    """
    lane = _coerce_adaptive(adaptive)
    dev = resolve_device(device)
    phases, bel = _grid_beliefs(phase_mode, beliefs, phases,
                                np.shape(arrivals), lane.tables.shape[1])
    # a phase-axis bank without phases= rows every entry by phase 0
    arr, dl, ph, draws = _grid_inputs(arrivals, phases, deadlines, draws,
                                      lane.tables.shape[1], need_phases=False)
    return _grid_run(
        dev, lane.tables, arr, dl, ph, draws, means=means, zeta=zeta,
        b_max=b_max, max_epochs=max_epochs, t0=t0, horizon=horizon,
        drain=drain, hist_edges=hist_edges, lane=lane, bel=bel,
    )
