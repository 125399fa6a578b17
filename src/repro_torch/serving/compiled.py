"""Compiled serving backend: the event loop as one CUDA kernel launch.

The same decision-epoch semantics as the Python engine
(serving.engine._run_events) and as the reference's jitted ``lax.scan``:
arrivals are a pre-sorted, +inf-padded array served FIFO, so the queue is
the contiguous window ``arrivals[n_served : n_admitted]``; the policy is a
(K, L) table indexed by the phase of the last admitted arrival and
``min(queue, L - 1)``; service time is ``means[a] * draws[n_batches]``.

One lane walks its events in one thread of ``kernels/csrc/serve_scan.cu``
and writes one record (a, t_done) per decision epoch.  The per-request
accounting is then rebuilt on the device with batch tensor ops: the
request in FIFO slot j completed at the serve epoch whose cumulative batch
count first exceeds j (a searchsorted over the cumsum of the records), so
latencies, SLO misses, the log-spaced histogram sketch and the energy are
a handful of launches, whatever the horizon.

Not ported yet (they raise NotImplementedError): the belief-mixture and
adaptive lanes, the managed-queue lane (``buffer=`` / ``shed_expired=``)
and the vmapped grid runners -- see ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.serve_scan import serve_scan

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

    @property
    def batch_sizes(self) -> np.ndarray:
        if self.actions is None:
            raise ValueError("run with record=True for per-epoch decisions")
        return self.actions[self.serve]


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch backend yet (see ROADMAP.md); "
        "run it with the reference package"
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

    ``device=None`` means CUDA (the event kernel); ``device="cpu"`` runs
    the kernel's plain version.
    """
    if phase_mode != "oracle" or beliefs is not None:
        raise _not_ported(f"phase_mode={phase_mode!r} / beliefs=")
    if adaptive is not None:
        raise _not_ported("the adaptive lane")
    if buffer is not None or shed_expired:
        raise _not_ported("the managed-queue lane (buffer= / shed_expired=)")
    dev = resolve_device(device)
    table = np.asarray(table, dtype=np.int64)
    if table.ndim == 1:
        table = table[None]
    elif table.ndim != 2:
        raise ValueError(f"table must be (L,) or (K, L); got {table.shape}")
    n_phases = table.shape[0]
    if n_phases > 1 and phases is None:
        raise ValueError("phase-indexed table needs phases= per arrival")
    arr = np.asarray(arrivals, dtype=np.float64)
    if len(arr) < _PAD_MARGIN or not np.isinf(arr[-_PAD_MARGIN:]).all():
        padded = pad_arrivals(arr, deadlines, phases=phases)
        if phases is None:
            arr, dl = padded
            ph = np.zeros(len(arr), dtype=np.int64)
        else:
            arr, dl, ph = padded
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
    max_eps = 2 * n_arr + 2 if max_epochs is None else int(max_epochs)
    means = np.asarray(means, dtype=np.float64)
    zeta_a = (
        np.zeros(b_max + 1)
        if zeta is None
        else np.asarray(zeta, dtype=np.float64).copy()
    )
    zeta_a[0] = 0.0  # a = 0 never accounts energy
    draws = np.ones(1) if draws is None else np.asarray(draws, dtype=np.float64)
    edges = (
        default_hist_edges(means)
        if hist_edges is None
        else np.asarray(hist_edges, dtype=np.float64)
    )
    n_bins = len(edges) - 1

    def on_dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    arr_t = on_dev(arr, torch.float64)
    out = serve_scan(
        on_dev(table, torch.int64), arr_t, on_dev(ph, torch.int64),
        on_dev(draws, torch.float64), on_dev(means, torch.float64),
        t0=float(t0), horizon=np.inf if horizon is None else float(horizon),
        max_eps=max_eps, drain=bool(drain), b_max=int(b_max),
    )
    agg = out.agg.tolist()  # the one sync between the kernel and the rebuild
    n_srv, n_adm, n_bat, n_eps, done = agg

    # --- per-request rebuild from the epoch records, on the device --------
    a = out.rec_a[:n_eps].to(torch.int64)
    t_done = out.rec_t[:n_eps]
    energy = on_dev(zeta_a, torch.float64)[a].sum()
    slots = torch.arange(n_srv, device=dev)
    epoch_of = torch.searchsorted(torch.cumsum(a, 0), slots, right=True)
    completion = t_done[epoch_of]
    lat = completion - arr_t[:n_srv]
    miss = (completion > on_dev(dl[:n_srv], torch.float64)).sum()
    bins = torch.searchsorted(on_dev(edges, torch.float64), lat, right=True)
    hist = torch.bincount(bins.clamp(0, n_bins + 1), minlength=n_bins + 2)
    energy_f, lat_sum_f, t_final, miss_f = torch.stack(
        (energy, lat.sum(), out.t_final[0], miss.to(torch.float64))
    ).tolist()
    res = CompiledResult(
        t_final=t_final,
        n_served=n_srv,
        n_batches=n_bat,
        n_epochs=n_eps,
        n_admitted=n_adm,
        energy=energy_f,
        lat_sum=lat_sum_f,
        slo_miss=int(miss_f),
        terminated=bool(done),
        hist=hist.cpu().numpy(),
        hist_edges=edges,
    )
    if record:
        res.actions = a.cpu().numpy()
        res.serve = res.actions > 0
        res.latencies = lat.cpu().numpy()
    return res
