"""The serving event kernel: its wrapper and plain version.

One simulation lane walks the decision epochs of the compiled serving
backend (serving.compiled): admit every arrival due by the clock, look up
the action, apply the wait / terminate / capped-drain rules, draw the
service time, advance the clock, and account each served request as it
goes (latency sum, SLO misses, histogram row, energy).  Two options widen
the lane, as in the reference's ``_scan_core``:

* the managed queue (``buffer=`` / ``shed=``): an admitted-slot queue per
  lane, door refusals past ``buffer`` queued requests, and the sweep of
  the expired queue prefix before every decision;
* the adaptive lane (``adaptive=``): the AdaptiveController's EWMA
  estimate and hysteresis-guarded bank retune, folded per taken arrival;
* the mix rule (``beliefs=``): the action is the phase posterior of the
  last admitted arrival blended over the table's phase rows,
  ``round(sum_k beliefs[last, k] * table[k, min(q, L - 1)])``
  (BeliefPhaseScheduler(mode="mix")); it composes with both.

Many lanes go in one launch: lane = (trace s, table p) with
``s = lane // P``, ``p = lane % P`` over ``tables`` (P, K, L); the
adaptive lane runs over the whole bank, one lane per trace.

The kernel is ``csrc/serve_scan.cu`` (the device counterpart of the
reference's ``lax.scan``, not of a Pallas kernel).  Lanes given as CPU
tensors run the plain version below; CUDA tensors launch the kernel or
raise.  ``serve_scan.launches`` counts launches, and
``serve_scan.instance_launches`` splits them by template instance
(``plain`` / ``qman`` / ``adaptive`` / ``qman_adaptive``, each also with a
``_mix`` suffix -- ``mix`` alone for the plain lane -- and prefixed
``grid_`` for a launch of more than one lane).
"""
from __future__ import annotations

import bisect
import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _build

#: columns of ``ScanOut.agg_i`` (int64) and ``ScanOut.agg_f`` (f64)
AGG_I = ("n_served", "n_admitted", "n_batches", "n_epochs", "terminated",
         "slo_miss", "n_shed", "n_expired", "head", "tail", "sel",
         "n_switches", "have_gap_bar", "have_last")
AGG_F = ("t_final", "energy", "lat_sum", "gap_bar", "last", "last_switch")
#: the adaptive lane's f64 vector: these, then lam_keys[P], aux_sq[P]
AD_F = ("inv_scale", "ewma", "margin", "min_dwell", "min_gap", "init_est",
        "gap_bar0", "last0", "last_switch0")
#: the adaptive lane's int64 vector
AD_I = ("sel0", "n_switches0", "have_gap_bar0", "have_last0")
INSTANCES = ("plain", "qman", "adaptive", "qman_adaptive")


class ScanOut(NamedTuple):
    agg_i: torch.Tensor  # (lanes, len(AGG_I)) int64
    agg_f: torch.Tensor  # (lanes, len(AGG_F)) f64
    hist: torch.Tensor  # (lanes, n_bins + 2) int64; [0] underflow, [-1] overflow
    queue: Optional[torch.Tensor]  # (lanes, size) int32 admitted slots (managed queue)
    rec_a: Optional[torch.Tensor]  # (lanes, >= n_epochs) int32 action per epoch (record)
    rec_slot: Optional[torch.Tensor]  # (lanes, >= n_served) int32 served slots, service order
    rec_done: Optional[torch.Tensor]  # (lanes, >= n_served) f64 their completion times


def instance_name(qman: bool, adaptive: bool, n_lanes: int,
                  mix: bool = False) -> str:
    inst = INSTANCES[int(qman) + 2 * int(adaptive)]
    if mix:
        inst = "mix" if inst == "plain" else f"{inst}_mix"
    return f"grid_{inst}" if n_lanes > 1 else inst


def _walk(tab, arr, dl, ph, dr, mu, zeta, edges, ad, bel, *, t0, horizon,
          max_eps, drain, b_max, buffer_cap, qman, shed, check_dl, record):
    """One lane in Python floats (IEEE f64, each operation rounded on its
    own, as in the kernel)."""
    L = len(tab[0])
    size = len(arr)
    n_draws = len(dr)
    n_edges = len(edges)
    due = [x if x < horizon else math.inf for x in arr] + [math.inf]
    if ad is not None:
        ad_f, ad_i, n_tab, bank = ad
        inv_scale, ewma, margin, min_dwell, min_gap, init_est, gap_bar, last, last_sw = (
            ad_f[:len(AD_F)])
        lam_keys = ad_f[len(AD_F): len(AD_F) + n_tab]
        aux_sq = ad_f[len(AD_F) + n_tab: len(AD_F) + 2 * n_tab]
        sel, n_sw, have_gb, have_last = ad_i
        have_gb, have_last = bool(have_gb), bool(have_last)
        tab = bank[sel]
    else:
        gap_bar = last = last_sw = 0.0
        sel = n_sw = 0
        have_gb = have_last = False

    def dist(i, est):
        x = (lam_keys[i] - est) * inv_scale
        return math.sqrt(x * x + aux_sq[i])

    t = float(t0)
    energy = lat_sum = 0.0
    n_srv = n_adm = n_bat = n_eps = miss = 0
    n_shed = n_exp = 0
    queue, head, last_adm = [], 0, -1
    hist = [0] * (n_edges + 1)
    rec_a, rec_slot, rec_done = [], [], []
    done = False
    while not done and n_eps < max_eps:
        while n_adm < size and due[n_adm] <= t:
            x = due[n_adm]
            n_adm += 1
            if qman:
                if len(queue) - head >= buffer_cap:
                    n_shed += 1
                    continue
                queue.append(n_adm - 1)
                last_adm = n_adm - 1
            if ad is not None:
                if have_last:
                    gap = max(x - last, min_gap)
                    gap_bar = (1.0 - ewma) * gap_bar + ewma * gap if have_gb else gap
                    have_gb = True
                last = x
                have_last = True
                est = 1.0 / max(gap_bar, min_gap) if have_gb else init_est
                if x - last_sw >= min_dwell and math.isfinite(est):
                    d = [dist(i, est) for i in range(n_tab)]
                    cand = d.index(min(d))
                    if cand != sel and d[cand] < (1.0 - margin) * d[sel]:
                        sel, last_sw, n_sw = cand, x, n_sw + 1
                        tab = bank[sel]
        if qman and shed:
            while head < len(queue) and dl[queue[head]] <= t:
                head += 1
                n_exp += 1
        q = len(queue) - head if qman else n_adm - n_srv
        li = max(last_adm, 0) if qman else max(n_adm - 1, 0)
        cap = min(q, b_max)
        col = min(q, L - 1)
        if bel is not None:  # posterior-weighted blend, half to even
            acc = bel[li][0] * tab[0][col]
            for k in range(1, len(tab)):
                acc = acc + bel[li][k] * tab[k][col]
            a = min(max(round(acc), 0), cap)
        else:
            a = min(max(tab[ph[li]][col], 0), cap)
        nxt = due[n_adm]
        live = math.isfinite(nxt)
        wait = a == 0 and live
        term = a == 0 and not live and (q == 0 or not drain)
        if a == 0 and not live and not term:
            a = cap
        serve = not wait and not term
        if not serve:
            a = 0
        if record:
            rec_a.append(a)
        n_eps += 1
        if wait:
            t = nxt
        elif serve:
            t_done = t + mu[a] * dr[min(n_bat, n_draws - 1)]
            energy += zeta[a]
            for i in range(a):
                slot = queue[head + i] if qman else n_srv + i
                lat = t_done - arr[slot]
                lat_sum += lat
                if check_dl and t_done > dl[slot]:
                    miss += 1
                hist[bisect.bisect_right(edges, lat)] += 1
                if record:
                    rec_slot.append(slot)
                    rec_done.append(t_done)
            if qman:
                head += a
            n_srv += a
            n_bat += 1
            t = t_done
        done = term
    agg_i = [n_srv, n_adm, n_bat, n_eps, int(done), miss, n_shed, n_exp,
             head, len(queue), sel, n_sw, int(have_gb), int(have_last)]
    agg_f = [t, energy, lat_sum, gap_bar, last, last_sw]
    return agg_i, agg_f, hist, queue, rec_a, rec_slot, rec_done


def serve_scan_ref(tables, arrivals, deadlines, phases, draws, means, zeta,
                   edges, *, t0: float, horizon: float, max_eps: int,
                   drain: bool, b_max: int, buffer: Optional[int] = None,
                   shed: bool = False, adaptive=None, beliefs=None,
                   record: bool = False) -> ScanOut:
    """Plain version: the same lanes walked in Python floats.

    Python float arithmetic is IEEE f64 with every operation rounded on
    its own, as in the kernel (built with -fmad=false), so decisions,
    counts, histograms and the sequential sums match bit for bit.
    """
    tabs = tables.tolist()
    n_pol = 1 if adaptive is not None else len(tabs)
    S, size = arrivals.shape
    arr_all = arrivals.tolist()
    dl_all = deadlines.tolist() if deadlines is not None else None
    ph_all = phases.tolist()
    dr_all = draws.tolist()
    mu, zt, ed = means.tolist(), zeta.tolist(), edges.tolist()
    qman = buffer is not None or bool(shed)
    buffer_cap = size + 1 if buffer is None else int(buffer)
    ad = None
    if adaptive is not None:
        ad = (adaptive[0].tolist(), adaptive[1].tolist(), len(tabs), tabs)
    bel_all = beliefs.tolist() if beliefs is not None else None
    lanes = [
        _walk(tabs[lane % n_pol], arr_all[lane // n_pol],
              dl_all[lane // n_pol] if dl_all is not None else None,
              ph_all[lane // n_pol], dr_all[lane // n_pol], mu, zt, ed, ad,
              bel_all[lane // n_pol] if bel_all is not None else None,
              t0=t0, horizon=horizon, max_eps=max_eps, drain=drain,
              b_max=b_max, buffer_cap=buffer_cap, qman=qman, shed=shed,
              check_dl=deadlines is not None, record=record)
        for lane in range(S * n_pol)
    ]

    def col(k, dtype, width):
        rows = [(x[k] + [0] * width)[:width] for x in lanes]
        return torch.tensor(rows, dtype=dtype).reshape(len(lanes), width)

    rec_cap = max(int(max_eps), 1)
    return ScanOut(
        torch.tensor([x[0] for x in lanes], dtype=torch.int64),
        torch.tensor([x[1] for x in lanes], dtype=torch.float64),
        torch.tensor([x[2] for x in lanes], dtype=torch.int64),
        col(3, torch.int32, size) if qman else None,
        col(4, torch.int32, rec_cap) if record else None,
        col(5, torch.int32, size) if record else None,
        col(6, torch.float64, size) if record else None,
    )


def _check(tables, arrivals, deadlines, phases, draws, means, zeta, edges,
           b_max: int, adaptive, beliefs) -> None:
    want = [
        ("tables", tables, torch.int64, 3),
        ("arrivals", arrivals, torch.float64, 2),
        ("phases", phases, torch.int64, 2),
        ("draws", draws, torch.float64, 2),
        ("means", means, torch.float64, 1),
        ("zeta", zeta, torch.float64, 1),
        ("edges", edges, torch.float64, 1),
    ]
    if deadlines is not None:
        want.append(("deadlines", deadlines, torch.float64, 2))
    if adaptive is not None:
        want += [("adaptive f64", adaptive[0], torch.float64, 1),
                 ("adaptive int64", adaptive[1], torch.int64, 1)]
    if beliefs is not None:
        want.append(("beliefs", beliefs, torch.float64, 3))
    for name, x, dtype, nd in want:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dtype != dtype or x.dim() != nd:
            raise TypeError(
                f"{name} must be {nd}-d {dtype}, got {x.dim()}-d {x.dtype}"
            )
        if x.device != arrivals.device:
            raise ValueError(f"{name} on {x.device}, arrivals on {arrivals.device}")
    S, size = arrivals.shape
    if phases.shape != arrivals.shape or (
            deadlines is not None and deadlines.shape != arrivals.shape):
        raise ValueError("phases and deadlines must align with arrivals (S, size)")
    if beliefs is not None and beliefs.shape != (S, size, tables.shape[1]):
        raise ValueError(
            f"beliefs must be (S, size, K) = {(S, size, tables.shape[1])}, "
            f"got {tuple(beliefs.shape)}")
    if size >= 2 ** 31:
        raise ValueError("arrival slots are int32: at most 2^31 - 1 per trace")
    if draws.shape[0] != S or draws.shape[1] < 1:
        raise ValueError("draws must be (S, >= 1), one row per trace")
    if means.numel() != b_max + 1 or zeta.numel() != b_max + 1:
        raise ValueError(f"means and zeta need b_max + 1 = {b_max + 1} entries")
    if tables.shape[0] < 1 or tables.shape[1] < 1 or tables.shape[2] < 1:
        raise ValueError("empty action table")
    if edges.numel() < 1:
        raise ValueError("need at least one histogram edge")
    if adaptive is not None and adaptive[0].numel() != len(AD_F) + 2 * tables.shape[0]:
        raise ValueError("adaptive f64 vector does not match the bank size")
    if adaptive is not None and adaptive[1].numel() != len(AD_I):
        raise ValueError(f"adaptive int64 vector needs {len(AD_I)} entries")


class _Params(ctypes.Structure):
    """ScanParams of csrc/serve_scan.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "tables", "arrivals", "deadlines", "phases", "draws", "means",
            "zeta", "edges", "ad_f", "ad_i", "agg_i", "agg_f", "hist",
            "queue", "rec_a", "rec_slot", "rec_done", "beliefs")]
        + [(n, ctypes.c_longlong) for n in (
            "n_lanes", "n_pol", "n_tables", "K", "L", "size", "n_draws",
            "n_edges", "max_eps", "rec_cap", "b_max", "buffer_cap")]
        + [("t0", ctypes.c_double), ("horizon", ctypes.c_double)]
        + [(n, ctypes.c_int) for n in (
            "drain", "shed", "check_deadlines", "qman", "adaptive", "mix")]
    )


#: the shared memory a block may use (H100: 227 KB); it holds the
#: histogram edges and counts, so this bounds the number of bins
MAX_SMEM_BYTES = 227 * 1024


def _launcher(n_edges: int):
    size_fn = _build.function("serve_scan", "serve_scan_params_bytes",
                              ctypes.c_longlong, [])
    if size_fn() != ctypes.sizeof(_Params):
        raise RuntimeError(
            f"ScanParams is {size_fn()} bytes in serve_scan.cu, "
            f"{ctypes.sizeof(_Params)} in the wrapper"
        )
    smem = _build.function("serve_scan", "serve_scan_smem_bytes",
                           ctypes.c_longlong, [ctypes.c_longlong])(n_edges)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{n_edges} histogram edges need {smem} B of shared memory a "
            f"lane, above {MAX_SMEM_BYTES}: use fewer bins"
        )
    return _build.function("serve_scan", "serve_scan_launch", ctypes.c_int,
                           [ctypes.POINTER(_Params), ctypes.c_void_p])


def serve_scan(tables, arrivals, deadlines, phases, draws, means, zeta, edges,
               *, t0: float, horizon: float, max_eps: int, drain: bool,
               b_max: int, buffer: Optional[int] = None, shed: bool = False,
               adaptive=None, beliefs=None, record: bool = False) -> ScanOut:
    """Walk every lane: ``tables`` (P, K, L) int64, ``arrivals`` /
    ``deadlines`` (S, size) f64 sorted and +inf padded (``deadlines=None``:
    no deadline anywhere), ``phases`` (S, size) int64 rows of ``tables``
    (checked by the caller), ``draws`` (S, D) f64, ``means`` / ``zeta``
    (b_max + 1,) f64 with ``zeta[0] = 0``, ``edges`` (n_bins + 1,) f64.

    ``buffer`` / ``shed`` select the managed-queue lane; ``adaptive`` is
    the (f64, int64) pair of ``AdaptiveLane.lowered()`` and makes each
    trace one lane over the whole bank ``tables``.  ``beliefs`` (S, size, K)
    f64, the phase posterior per arrival, selects the mix rule (``phases``
    are then unread).  ``record`` also returns every epoch's action and
    every served request's slot and completion.
    """
    _check(tables, arrivals, deadlines, phases, draws, means, zeta, edges,
           b_max, adaptive, beliefs)
    if shed and deadlines is None:
        raise ValueError("shed needs deadlines")
    kw = dict(t0=t0, horizon=horizon, max_eps=max_eps, drain=drain,
              b_max=b_max, buffer=buffer, shed=shed, adaptive=adaptive,
              beliefs=beliefs, record=record)
    if arrivals.device.type == "cpu":
        return serve_scan_ref(tables, arrivals, deadlines, phases, draws,
                              means, zeta, edges, **kw)
    if arrivals.device.type != "cuda":
        raise ValueError(f"unsupported device {arrivals.device}")
    dev = arrivals.device
    qman = buffer is not None or bool(shed)
    S, size = arrivals.shape
    P, K, L = tables.shape
    n_pol = 1 if adaptive is not None else P
    n_lanes = S * n_pol
    ins = [x.contiguous() for x in (tables, arrivals, phases, draws, means, zeta, edges)]
    tables, arrivals, phases, draws, means, zeta, edges = ins
    deadlines = deadlines.contiguous() if deadlines is not None else None
    ad = [x.contiguous() for x in adaptive] if adaptive is not None else None
    beliefs = beliefs.contiguous() if beliefs is not None else None
    rec_cap = max(int(max_eps), 1)
    n_edges = edges.numel()

    def empty(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=dev)

    out = ScanOut(
        empty(n_lanes, len(AGG_I), dtype=torch.int64),
        empty(n_lanes, len(AGG_F), dtype=torch.float64),
        empty(n_lanes, n_edges + 1, dtype=torch.int64),
        empty(n_lanes, size, dtype=torch.int32) if qman else None,
        empty(n_lanes, rec_cap, dtype=torch.int32) if record else None,
        empty(n_lanes, size, dtype=torch.int32) if record else None,
        empty(n_lanes, size, dtype=torch.float64) if record else None,
    )

    def ptr(x):
        return x.data_ptr() if x is not None else None

    params = _Params(
        ptr(tables), ptr(arrivals), ptr(deadlines) or ptr(arrivals),
        ptr(phases), ptr(draws), ptr(means), ptr(zeta), ptr(edges),
        ptr(ad[0]) if ad else None, ptr(ad[1]) if ad else None,
        *(ptr(x) for x in out), ptr(beliefs),
        n_lanes, n_pol, P, K, L, size, draws.shape[1], n_edges,
        int(max_eps), rec_cap, int(b_max),
        size + 1 if buffer is None else int(buffer),
        float(t0), float(horizon),
        int(bool(drain)), int(bool(shed)), int(deadlines is not None),
        int(qman), int(adaptive is not None), int(beliefs is not None),
    )
    rc = _launcher(n_edges)(ctypes.byref(params),
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"serve_scan launch failed: CUDA error {rc}")
    serve_scan.launches += 1
    name = instance_name(qman, adaptive is not None, n_lanes, beliefs is not None)
    serve_scan.instance_launches[name] = serve_scan.instance_launches.get(name, 0) + 1
    return out


serve_scan.launches = 0
serve_scan.instance_launches = {}
