"""The fleet event kernel: its wrapper and plain version.

One simulation lane walks the events of M routed replicas (serving.fleet),
one event a step, in the reference's step priority:

  (0) a due fault boundary replays (the lowest replica index, one a step):
      a down-start catches a crashed in-flight batch, which requeues to
      the front of its replica's queue or, after ``max_retries``
      consecutive crashes, drops; a down-start silences a pending
      decision, the repair re-arms a replica with queued work;
  (1) else one due arrival is routed (rr / jsq / pow2 / batch_aware, DOWN
      replicas masked) and admitted, or shed by a full waiting room;
  (2) else the lowest-index replica with a pending decision decides: the
      action table[m, phase, min(q, L - 1)] (a phase outside the stack
      reads its nearest row, as the reference's clamped gathers do; or
      the belief-mixture blend),
      clipped, the b_max-capped tail drain; a dispatched batch crashes iff
      its replica's next down-start is strictly before its completion;
  (3) else the clock advances to the next arrival, completion or relevant
      fault boundary (arrivals win ties, completions beat boundaries),
      or the lane stops.

Every served request is accounted at serve start, inside the walk: each
replica keeps a FIFO of the arrival slots routed to it (positions
``[0, c0)`` are the carried queue ``q0``), a serve resolves positions
``[n_srv + n_drop, ... + a)`` -- latency, SLO miss, histogram bin, the
record rows -- and a crash leaves its positions in place, so a requeue
to the front costs nothing.  Energy and the latency sum add in step
order.

Lanes: lane = (s * P + p) * R + r over S traces, P table stacks
(``tables`` (P, M, K, L)) and R router ids; the carried replica state and
the fault schedule are shared by all lanes.

The kernel is ``csrc/fleet_scan.cu``, the device counterpart of the
reference's ``lax.scan`` in ``_fleet_scan_core`` (not of a Pallas
kernel).  Lanes given as CPU tensors run the plain version below; CUDA
tensors launch the kernel or raise.  ``fleet_scan.launches`` counts
launches, ``fleet_scan.instance_launches`` splits them by instance
(``plain`` / ``mix``, prefixed ``grid_`` for a launch of more than one
lane).
"""
from __future__ import annotations

import bisect
import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ..device import refuse_grad
from . import _build

#: columns of ``FleetOut.agg_i`` (int64) and ``FleetOut.agg_f`` (f64)
AGG_I = ("n_admitted", "rr", "ph", "n_epochs", "n_steps_used", "done",
         "n_batches", "n_attempts", "slo_miss")
AGG_F = ("t_final", "energy", "lat_sum")
#: rows of ``FleetOut.rep_i`` (int64, one column per replica)
REP_I = ("qlen", "n_route", "n_srv", "nbat", "needs", "fcur", "rty", "infl",
         "ndrop_m", "nshed_m")
#: rows of the carried int64 state ``state0`` (one column per replica)
STATE0 = ("nbat", "needs", "fcur", "rty", "infl")
#: bits of the record's per-request state
SERVED, DROPPED, SHED = 1, 2, 4
#: replica state lives in the block's shared memory up to this many replicas
MAX_REPLICAS = 64
#: JSQ score = 2 * min(qlen, SCORE_QCAP) + busy; the cap keeps the
#: batch-aware score gap * GAP_SHIFT + jsq inside int32
SCORE_QCAP = (1 << 14) - 1
GAP_SHIFT = 1 << 15
#: added to a DOWN replica's score: healthy scores stay below 2^30
DOWN_PENALTY = 1 << 30


class FleetRecord(NamedTuple):
    rec_a: torch.Tensor  # (lanes, >= n_epochs) int32 action per epoch
    rec_m: torch.Tensor  # (lanes, >= n_epochs) int32 deciding replica
    arr_lat: torch.Tensor  # (lanes, size) f64 latency (0 unless served)
    arr_state: torch.Tensor  # (lanes, size) int8 SERVED | DROPPED | SHED bits
    arr_server: torch.Tensor  # (lanes, size) int32 replica joined (M: never routed)
    arr_pos: torch.Tensor  # (lanes, size) int32 substream position (0 if shed)
    q0_lat: torch.Tensor  # (lanes, M, Q0) f64 carried requests' latencies
    q0_state: torch.Tensor  # (lanes, M, Q0) int8 SERVED | DROPPED bits


class FleetOut(NamedTuple):
    agg_i: torch.Tensor  # (lanes, len(AGG_I)) int64
    agg_f: torch.Tensor  # (lanes, len(AGG_F)) f64
    rep_i: torch.Tensor  # (lanes, len(REP_I), M) int64
    busy: torch.Tensor  # (lanes, M) f64 busy clocks (+inf idle)
    hist: torch.Tensor  # (lanes, n_edges + 1) int64
    rec: Optional[FleetRecord]


def instance_name(mix: bool, n_lanes: int) -> str:
    inst = "mix" if mix else "plain"
    return f"grid_{inst}" if n_lanes > 1 else inst


def _walk(tab, thr, rid, arr, dl, ph, ru, dr, bel, bel0, c, *, record):
    """One lane in Python numbers (IEEE f64, each operation rounded on its
    own, as in the kernel built with -fmad=false)."""
    M, K, L = len(tab), len(tab[0]), len(tab[0][0])
    size, n_draws = len(arr), len(dr)
    fb, fmult, q0t, q0d = c["fb"], c["fmult"], c["q0t"], c["q0d"]
    nfb, n_mult = len(fb[0]), len(fmult[0])
    means, zeta, edges = c["means"], c["zeta"], c["edges"]
    horizon, max_eps, cap_steps = c["horizon"], c["max_eps"], c["step_cap"]
    drain, more, t_last = c["drain"], c["more_coming"], c["t_last"]
    b_max, buf_cap, max_retries = c["b_max"], c["buf_cap"], c["max_retries"]
    inf = math.inf
    due = [x if x < horizon else inf for x in arr]
    c0 = [sum(1 for x in row if x < inf) for row in q0t]
    nbat, needs0, fcur, rty, infl = (list(r) for r in c["state0"])
    busy = list(c["busy0"])
    qlen = [c0[m] - infl[m] for m in range(M)]
    nroute = list(c0)
    nsrv, ndrop, nshed = [0] * M, [0] * M, [0] * M
    needs = [bool(needs0[m]) and busy[m] == inf and infl[m] == 0 and fcur[m] % 2 == 0
             for m in range(M)]
    nb = [fb[m][fcur[m]] if fcur[m] < nfb else inf for m in range(M)]
    fifo = [[] for _ in range(M)]
    t, n_adm, rr, phc = c["t0"], 0, c["rr0"], c["ph0"]
    neps = nuse = n_bat = miss = 0
    energy = lat_sum = 0.0
    done = False
    hist = [0] * (len(edges) + 1)
    q0w = len(q0t[0])
    rec_a, rec_m = [], []
    arr_lat, arr_state = [0.0] * size, [0] * size
    arr_server, arr_pos = [M] * size, [0] * size
    q0_lat = [[0.0] * q0w for _ in range(M)]
    q0_state = [[0] * q0w for _ in range(M)]

    def resolve(m, pos, bit, t_done):
        nonlocal miss, lat_sum
        if pos < c0[m]:
            q0_state[m][pos] |= bit
            if bit == SERVED:
                lat = t_done - q0t[m][pos]
                q0_lat[m][pos] = lat
                miss += t_done > q0d[m][pos]
        else:
            i = fifo[m][pos - c0[m]]
            arr_state[i] |= bit
            if bit == SERVED:
                lat = t_done - arr[i]
                arr_lat[i] = lat
                miss += t_done > dl[i]
        if bit == SERVED:
            lat_sum += lat
            hist[bisect.bisect_right(edges, lat)] += 1

    while not done and neps < max_eps and nuse < cap_steps:
        ia = min(n_adm, size - 1)
        nxt = due[ia]
        dead = nxt == inf and not more
        if dead and drain:
            for m in range(M):
                if busy[m] == inf and qlen[m] > 0 and fcur[m] % 2 == 0 and infl[m] == 0:
                    needs[m] = True
        nuse += 1
        m_b = next((m for m in range(M) if nb[m] <= t), -1)
        if m_b >= 0:  # (0) a fault boundary
            m = m_b
            start = fcur[m] % 2 == 0
            if start and infl[m] > 0:
                if rty[m] + 1 > max_retries:  # give up: the batch drops
                    base = nsrv[m] + ndrop[m]
                    for k in range(infl[m]):
                        resolve(m, base + k, DROPPED, 0.0)
                    ndrop[m] += infl[m]
                    rty[m] = 0
                else:  # requeue to the front, positions kept
                    qlen[m] += infl[m]
                    rty[m] += 1
                infl[m] = 0
            if start:
                needs[m] = False
            elif qlen[m] > 0 and busy[m] == inf and infl[m] == 0:
                needs[m] = True
            fcur[m] += 1
            nb[m] = fb[m][fcur[m]] if fcur[m] < nfb else inf
            continue
        if nxt <= t:  # (1) route one due arrival
            qeff = [qlen[m] + infl[m] for m in range(M)]
            bflag = [int(busy[m] != inf or infl[m] > 0) for m in range(M)]
            score = [2 * min(qeff[m], SCORE_QCAP) + bflag[m]
                     + (DOWN_PENALTY if fcur[m] % 2 else 0) for m in range(M)]
            if rid == 0:
                m_r = rr % M
                for k in range(M):
                    cand = (rr + k) % M
                    if fcur[cand] % 2 == 0:
                        m_r = cand
                        break
            elif rid == 1:
                m_r = score.index(min(score))
            elif rid == 2:
                c1 = min(int(ru[ia][0] * M), M - 1)
                c2 = min(int(ru[ia][1] * M), M - 1)
                m_r = c1 if score[c1] <= score[c2] else c2
            else:
                pa = min(max(ph[ia], 0), K - 1)
                sc = []
                for m in range(M):
                    g = thr[m][pa][min(max(qeff[m], 0), L - 1)]
                    g = min(g + bflag[m] * min(qeff[m], SCORE_QCAP), SCORE_QCAP)
                    sc.append(g * GAP_SHIFT + score[m])
                m_r = sc.index(min(sc))
            arr_server[ia] = m_r
            if qeff[m_r] >= buf_cap:
                nshed[m_r] += 1
                arr_state[ia] |= SHED
            else:
                arr_pos[ia] = nroute[m_r]
                fifo[m_r].append(ia)
                qlen[m_r] += 1
                nroute[m_r] += 1
                if busy[m_r] == inf and fcur[m_r] % 2 == 0 and infl[m_r] == 0:
                    needs[m_r] = True
            phc = ph[ia]
            rr += 1
            n_adm += 1
            continue
        if any(needs):  # (2) the lowest-index pending replica decides
            m = needs.index(True)
            q = qlen[m]
            col = min(q, L - 1)
            if bel is not None:  # posterior-weighted blend, half to even
                row = bel[min(max(n_adm - 1, 0), size - 1)] if n_adm > 0 else bel0
                acc = row[0] * tab[m][0][col]
                for k in range(1, K):
                    acc = acc + row[k] * tab[m][k][col]
                a = round(acc)
            else:
                a = tab[m][min(max(phc, 0), K - 1)][col]
            cap = min(q, b_max)
            a = min(max(a, 0), cap)
            if a == 0 and dead and q > 0 and drain:
                a = cap  # the b_max-capped tail drain
            if record:
                rec_a.append(a)
                rec_m.append(m)
            neps += 1
            needs[m] = False
            if a > 0:
                nbm = nbat[m]
                svc = means[a] * dr[min(nbm, n_draws - 1)] * fmult[m][min(nbm, n_mult - 1)]
                t_done = t + svc
                ds = nb[m]
                qlen[m] -= a
                if ds < t_done:  # the batch crashes at the down-start
                    infl[m] += a
                    energy += zeta[a] * (ds - t) / svc
                else:
                    base = nsrv[m] + ndrop[m]
                    for k in range(a):
                        resolve(m, base + k, SERVED, t_done)
                    busy[m] = t_done
                    nsrv[m] += a
                    rty[m] = 0
                    energy += zeta[a]
                    n_bat += 1
                nbat[m] += 1
            continue
        # (3) advance the clock: arrival > completion > fault boundary
        fin = nxt != inf
        m_c, t_c, t_b = 0, inf, inf
        for m in range(M):
            be = busy[m] if (fin or dead or busy[m] < t_last) else inf
            if be < t_c:
                m_c, t_c = m, be
            if (qlen[m] > 0 or infl[m] > 0) and (fin or dead or nb[m] < t_last):
                t_b = min(t_b, nb[m])
        if fin and nxt <= t_c and nxt <= t_b:
            t = nxt
        elif t_c != inf and t_c <= t_b:
            t = t_c
            busy[m_c] = inf
            needs[m_c] = True
        elif t_b != inf:
            t = t_b
        else:
            done = True
    n_att = sum(nbat) - sum(c["state0"][0])
    agg_i = [n_adm, rr, phc, neps, nuse, int(done), n_bat, n_att, miss]
    rep = [qlen, nroute, nsrv, nbat, [int(x) for x in needs], fcur, rty, infl, ndrop, nshed]
    recs = (rec_a, rec_m, arr_lat, arr_state, arr_server, arr_pos, q0_lat, q0_state)
    return agg_i, [t, energy, lat_sum], rep, busy, hist, recs


def fleet_scan_ref(tables, thr, rids, arrivals, deadlines, phases, router_u,
                   draws, means, zeta, edges, fb, fmult, q0_times, q0_dl,
                   busy0, state0, beliefs=None, bel0=None, *, t0: float,
                   horizon: float, max_eps: int, step_cap: int, drain: bool,
                   b_max: int, buf_cap: int, max_retries: int, rr0: int,
                   ph0: int, more_coming: bool, t_last: float,
                   record: bool = False) -> FleetOut:
    """Plain version: the same lanes walked in Python numbers.

    Python float arithmetic is IEEE f64 with every operation rounded on
    its own, as in the kernel (built with -fmad=false), so decisions,
    counts, histograms, records and the step-order sums match bit for bit.
    """
    for x in (tables, arrivals, state0):
        if x.device.type != "cpu":
            raise ValueError(f"the plain version takes CPU tensors, got {x.device}")
    tabs, thrs = tables.tolist(), thr.tolist()
    P, R = len(tabs), rids.numel()
    S, size = arrivals.shape
    M = tables.shape[1]
    c = dict(fb=fb.tolist(), fmult=fmult.tolist(), q0t=q0_times.tolist(),
             q0d=q0_dl.tolist(), means=means.tolist(), zeta=zeta.tolist(),
             edges=edges.tolist(), horizon=float(horizon), max_eps=int(max_eps),
             step_cap=int(step_cap), drain=bool(drain),
             more_coming=bool(more_coming), t_last=float(t_last), b_max=int(b_max),
             buf_cap=int(buf_cap), max_retries=int(max_retries), t0=float(t0),
             rr0=int(rr0), ph0=int(ph0), state0=state0.tolist(),
             busy0=busy0.tolist())
    arr_all, dl_all, ph_all = arrivals.tolist(), deadlines.tolist(), phases.tolist()
    ru_all, dr_all = router_u.tolist(), draws.tolist()
    bel_all = beliefs.tolist() if beliefs is not None else None
    bel0_all = bel0.tolist() if beliefs is not None else None
    rid_l = rids.tolist()
    lanes = []
    for lane in range(S * P * R):
        s, p, r = lane // (P * R), (lane // R) % P, lane % R
        lanes.append(_walk(
            tabs[p], thrs[p], rid_l[r], arr_all[s], dl_all[s], ph_all[s], ru_all[s],
            dr_all[s], None if bel_all is None else bel_all[s],
            None if bel_all is None else bel0_all[s], c, record=record))
    n = len(lanes)
    rec = None
    if record:
        cap = max(int(max_eps), 1)

        def col(k, dtype, width):
            rows = [(x[5][k] + [0] * width)[:width] for x in lanes]
            return torch.tensor(rows, dtype=dtype).reshape(n, width)

        rec = FleetRecord(
            col(0, torch.int32, cap), col(1, torch.int32, cap),
            torch.tensor([x[5][2] for x in lanes], dtype=torch.float64).reshape(n, size),
            torch.tensor([x[5][3] for x in lanes], dtype=torch.int8).reshape(n, size),
            torch.tensor([x[5][4] for x in lanes], dtype=torch.int32).reshape(n, size),
            torch.tensor([x[5][5] for x in lanes], dtype=torch.int32).reshape(n, size),
            torch.tensor([x[5][6] for x in lanes], dtype=torch.float64).reshape(
                n, M, q0_times.shape[1]),
            torch.tensor([x[5][7] for x in lanes], dtype=torch.int8).reshape(
                n, M, q0_times.shape[1]),
        )
    return FleetOut(
        torch.tensor([x[0] for x in lanes], dtype=torch.int64).reshape(n, len(AGG_I)),
        torch.tensor([x[1] for x in lanes], dtype=torch.float64).reshape(n, len(AGG_F)),
        torch.tensor([x[2] for x in lanes], dtype=torch.int64).reshape(n, len(REP_I), M),
        torch.tensor([x[3] for x in lanes], dtype=torch.float64).reshape(n, M),
        torch.tensor([x[4] for x in lanes], dtype=torch.int64).reshape(n, -1),
        rec,
    )


def _check(tables, thr, rids, arrivals, deadlines, phases, router_u, draws,
           means, zeta, edges, fb, fmult, q0_times, q0_dl, busy0, state0,
           beliefs, bel0, b_max: int) -> None:
    want = [
        ("tables", tables, torch.int64, 4), ("thr", thr, torch.int64, 4),
        ("rids", rids, torch.int64, 1), ("arrivals", arrivals, torch.float64, 2),
        ("deadlines", deadlines, torch.float64, 2), ("phases", phases, torch.int64, 2),
        ("router_u", router_u, torch.float64, 3), ("draws", draws, torch.float64, 2),
        ("means", means, torch.float64, 1), ("zeta", zeta, torch.float64, 1),
        ("edges", edges, torch.float64, 1), ("fb", fb, torch.float64, 2),
        ("fmult", fmult, torch.float64, 2), ("q0_times", q0_times, torch.float64, 2),
        ("q0_dl", q0_dl, torch.float64, 2), ("busy0", busy0, torch.float64, 1),
        ("state0", state0, torch.int64, 2),
    ]
    if beliefs is not None:
        want += [("beliefs", beliefs, torch.float64, 3), ("bel0", bel0, torch.float64, 2)]
    for name, x, dtype, nd in want:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dtype != dtype or x.dim() != nd:
            raise TypeError(f"{name} must be {nd}-d {dtype}, got {x.dim()}-d {x.dtype}")
        if x.device != arrivals.device:
            raise ValueError(f"{name} on {x.device}, arrivals on {arrivals.device}")
    P, M, K, L = tables.shape
    S, size = arrivals.shape
    if M > MAX_REPLICAS:
        raise ValueError(
            f"{M} replicas: the fleet kernel keeps at most {MAX_REPLICAS} "
            "replicas' state on chip")
    if min(P, M, K, L) < 1 or rids.numel() < 1:
        raise ValueError("empty table stack or router list")
    bad = sorted(set(rids.tolist()) - {0, 1, 2, 3})
    if bad:
        raise ValueError(f"router ids {bad} outside 0..3 (rr, jsq, pow2, batch_aware)")
    if thr.shape != tables.shape:
        raise ValueError("thr must match tables (threshold_gaps of each stack)")
    if size < 1 or size >= 2 ** 31:
        raise ValueError("arrival slots are int32: 1 .. 2^31 - 1 per trace")
    if deadlines.shape != arrivals.shape or phases.shape != arrivals.shape:
        raise ValueError("deadlines and phases must align with arrivals (S, size)")
    if router_u.shape != (S, size, 2):
        raise ValueError("router_u must be (S, size, 2)")
    if draws.shape[0] != S or draws.shape[1] < 1:
        raise ValueError("draws must be (S, >= 1), one row per trace")
    if means.numel() != b_max + 1 or zeta.numel() != b_max + 1:
        raise ValueError(f"means and zeta need b_max + 1 = {b_max + 1} entries")
    if edges.numel() < 1:
        raise ValueError("need at least one histogram edge")
    if fb.shape[0] != M or fb.shape[1] < 1 or fmult.shape[0] != M or fmult.shape[1] < 1:
        raise ValueError("fb and fmult must be (M, >= 1)")
    if q0_times.shape != q0_dl.shape or q0_times.shape[0] != M or q0_times.shape[1] < 1:
        raise ValueError("q0_times and q0_dl must be (M, >= 1)")
    if busy0.shape != (M,) or state0.shape != (len(STATE0), M):
        raise ValueError(f"busy0 must be (M,) and state0 ({len(STATE0)}, M)")
    if beliefs is not None and (beliefs.shape != (S, size, K) or bel0.shape != (S, K)):
        raise ValueError("beliefs must be (S, size, K) and bel0 (S, K)")


class _Params(ctypes.Structure):
    """FleetParams of csrc/fleet_scan.cu, field for field."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "tables", "thr", "rids", "arrivals", "deadlines", "phases", "router_u",
            "draws", "means", "zeta", "edges", "fb", "fmult", "q0_times", "q0_dl",
            "busy0", "state0", "beliefs", "bel0", "agg_i", "agg_f", "rep_i", "busy",
            "hist", "fifo", "rec_a", "rec_m", "arr_lat", "arr_state", "arr_server",
            "arr_pos", "q0_lat", "q0_state")]
        + [(n, ctypes.c_longlong) for n in (
            "n_lanes", "P", "R", "M", "K", "L", "size", "n_draws", "n_edges", "nfb",
            "n_mult", "q0w", "max_eps", "step_cap", "rec_cap", "b_max", "buf_cap",
            "max_retries", "rr0", "ph0")]
        + [(n, ctypes.c_double) for n in ("t0", "horizon", "t_last")]
        + [(n, ctypes.c_int) for n in ("drain", "more_coming", "mix", "record")]
    )


#: the shared memory a block may use (H100: 227 KB)
MAX_SMEM_BYTES = 227 * 1024


def _launcher(n_edges: int, M: int):
    size_fn = _build.function("fleet_scan", "fleet_scan_params_bytes",
                              ctypes.c_longlong, [])
    if size_fn() != ctypes.sizeof(_Params):
        raise RuntimeError(
            f"FleetParams is {size_fn()} bytes in fleet_scan.cu, "
            f"{ctypes.sizeof(_Params)} in the wrapper"
        )
    smem = _build.function("fleet_scan", "fleet_scan_smem_bytes", ctypes.c_longlong,
                           [ctypes.c_longlong, ctypes.c_longlong])(n_edges, M)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{n_edges} histogram edges need {smem} B of shared memory a lane, "
            f"above {MAX_SMEM_BYTES}: use fewer bins"
        )
    return _build.function("fleet_scan", "fleet_scan_launch", ctypes.c_int,
                           [ctypes.POINTER(_Params), ctypes.c_void_p])


def fleet_scan(tables, thr, rids, arrivals, deadlines, phases, router_u, draws,
               means, zeta, edges, fb, fmult, q0_times, q0_dl, busy0, state0,
               beliefs=None, bel0=None, *, t0: float, horizon: float,
               max_eps: int, step_cap: int, drain: bool, b_max: int,
               buf_cap: int, max_retries: int, rr0: int = 0, ph0: int = 0,
               more_coming: bool = False, t_last: float = math.inf,
               record: bool = False) -> FleetOut:
    """Walk every lane: ``tables`` / ``thr`` (P, M, K, L) int64 (the action
    stacks and their threshold_gaps), ``rids`` (R,) router ids,
    ``arrivals`` / ``deadlines`` (S, size) f64 sorted and +inf padded,
    ``phases`` (S, size) int64 rows of the stacks (checked by the caller),
    ``router_u`` (S, size, 2) f64 pow2 uniforms, ``draws`` (S, D) f64,
    ``means`` / ``zeta`` (b_max + 1,) f64 with ``zeta[0] = 0``, ``edges``
    (n_bins + 1,) f64, ``fb`` (M, >= 1) +inf-padded fault boundaries,
    ``fmult`` (M, >= 1) per-attempt service multipliers, ``q0_times`` /
    ``q0_dl`` (M, >= 1) +inf-padded carried queues, ``busy0`` (M,) f64
    and ``state0`` (len(STATE0), M) int64 the carried replica state.

    ``beliefs`` (S, size, K) with ``bel0`` (S, K) select the mix rule.
    ``step_cap`` bounds the steps of a lane (the reference's hard cap);
    a lane otherwise runs until it stops or spends ``max_eps`` epochs.
    ``record`` also returns every epoch's (action, replica) and every
    request's latency, state, replica and position.
    """
    dev = arrivals.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check(tables, thr, rids, arrivals, deadlines, phases, router_u, draws,
           means, zeta, edges, fb, fmult, q0_times, q0_dl, busy0, state0,
           beliefs, bel0, b_max)
    kw = dict(t0=t0, horizon=horizon, max_eps=max_eps, step_cap=step_cap,
              drain=drain, b_max=b_max, buf_cap=buf_cap, max_retries=max_retries,
              rr0=rr0, ph0=ph0, more_coming=more_coming, t_last=t_last,
              record=record)
    if dev.type == "cpu":
        return fleet_scan_ref(tables, thr, rids, arrivals, deadlines, phases,
                              router_u, draws, means, zeta, edges, fb, fmult,
                              q0_times, q0_dl, busy0, state0, beliefs, bel0, **kw)
    refuse_grad("fleet_scan", arrivals, deadlines, draws, means, zeta, edges, fb,
                fmult, q0_times, q0_dl, busy0, beliefs, bel0)
    P, M, K, L = tables.shape
    S, size = arrivals.shape
    R = rids.numel()
    n_lanes = S * P * R
    ins = [x.contiguous() for x in (
        tables, thr, rids, arrivals, deadlines, phases, router_u, draws, means,
        zeta, edges, fb, fmult, q0_times, q0_dl, busy0, state0)]
    mix = beliefs is not None
    bels = (beliefs.contiguous(), bel0.contiguous()) if mix else (None, None)
    rec_cap = max(int(max_eps), 1)
    q0w = q0_times.shape[1]

    def empty(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=dev)

    out = FleetOut(
        empty(n_lanes, len(AGG_I), dtype=torch.int64),
        empty(n_lanes, len(AGG_F), dtype=torch.float64),
        empty(n_lanes, len(REP_I), M, dtype=torch.int64),
        empty(n_lanes, M, dtype=torch.float64),
        empty(n_lanes, edges.numel() + 1, dtype=torch.int64),
        FleetRecord(
            empty(n_lanes, rec_cap, dtype=torch.int32),
            empty(n_lanes, rec_cap, dtype=torch.int32),
            torch.zeros(n_lanes, size, dtype=torch.float64, device=dev),
            torch.zeros(n_lanes, size, dtype=torch.int8, device=dev),
            torch.full((n_lanes, size), M, dtype=torch.int32, device=dev),
            torch.zeros(n_lanes, size, dtype=torch.int32, device=dev),
            torch.zeros(n_lanes, M, q0w, dtype=torch.float64, device=dev),
            torch.zeros(n_lanes, M, q0w, dtype=torch.int8, device=dev),
        ) if record else None,
    )
    fifo = empty(n_lanes, M, size, dtype=torch.int32)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    rec_ptrs = [ptr(x) for x in out.rec] if record else [None] * 8
    params = _Params(
        *(ptr(x) for x in ins), ptr(bels[0]), ptr(bels[1]),
        *(ptr(x) for x in out[:5]), ptr(fifo), *rec_ptrs,
        n_lanes, P, R, M, K, L, size, draws.shape[1], edges.numel(), fb.shape[1],
        fmult.shape[1], q0w, int(max_eps), int(step_cap), rec_cap, int(b_max),
        int(buf_cap), int(max_retries), int(rr0), int(ph0),
        float(t0), float(horizon), float(t_last),
        int(bool(drain)), int(bool(more_coming)), int(mix), int(bool(record)),
    )
    rc = _launcher(edges.numel(), M)(ctypes.byref(params),
                                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fleet_scan launch failed: CUDA error {rc}")
    fleet_scan.launches += 1
    name = instance_name(mix, n_lanes)
    fleet_scan.instance_launches[name] = fleet_scan.instance_launches.get(name, 0) + 1
    return out


fleet_scan.launches = 0
fleet_scan.instance_launches = {}
