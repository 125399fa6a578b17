"""The serving event kernel: its wrapper and plain version.

One simulation lane walks the decision epochs of the compiled serving
backend (serving.compiled): admit every arrival due by the clock, look up
the action, apply the wait / terminate / capped-drain rules, draw the
service time, advance the clock.  It writes one record (a, t_done) per
decision epoch; serving.compiled rebuilds latencies, SLO misses, the
histogram and energy from those records.

The kernel is ``csrc/serve_scan.cu`` (the device counterpart of the
reference's ``lax.scan``, not of a Pallas kernel).  A lane given as CPU
tensors runs the plain version below; CUDA tensors launch the kernel
(counted in ``serve_scan.launches``) or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build


class ScanOut(NamedTuple):
    rec_a: torch.Tensor  # (>= n_epochs,) int32 batch size per epoch, 0 = none
    rec_t: torch.Tensor  # (>= n_epochs,) f64 clock + service time per epoch
    agg: torch.Tensor  # (5,) int64: n_served, n_admitted, n_batches, n_epochs, terminated
    t_final: torch.Tensor  # (1,) f64


def serve_scan_ref(table, arrivals, phases, draws, means, *, t0: float,
                   horizon: float, max_eps: int, drain: bool,
                   b_max: int) -> ScanOut:
    """Plain version: the same event walk in Python floats.

    Python float arithmetic is IEEE f64 with the product rounded before
    the sum, as in numpy and the kernel, so decisions match bit for bit.
    """
    tab = table.tolist()
    arr = arrivals.tolist()
    ph = phases.tolist()
    dr = draws.tolist()
    mu = means.tolist()
    L = len(tab[0])
    n_draws = len(dr)
    # arrivals at or past the horizon are never admitted; one sentinel
    # past the end keeps the admission loop in range
    due = [x if x < horizon else math.inf for x in arr] + [math.inf]
    t = float(t0)
    n_srv = n_adm = n_bat = 0
    done = False
    rec_a, rec_t = [], []
    while not done and len(rec_a) < max_eps:
        while due[n_adm] <= t:
            n_adm += 1
        q = n_adm - n_srv
        cap = min(q, b_max)
        a = tab[ph[max(n_adm - 1, 0)]][min(q, L - 1)]
        a = min(max(a, 0), cap)
        nxt = due[n_adm]
        live = math.isfinite(nxt)
        wait = a == 0 and live
        term = a == 0 and not live and (q == 0 or not drain)
        if a == 0 and not live and not term:
            a = cap
        serve = not wait and not term
        if not serve:
            a = 0
        t_done = t + mu[a] * dr[min(n_bat, n_draws - 1)]
        rec_a.append(a)
        rec_t.append(t_done)
        if wait:
            t = nxt
        elif serve:
            t = t_done
            n_srv += a
            n_bat += 1
        done = term
    return ScanOut(
        torch.tensor(rec_a, dtype=torch.int32),
        torch.tensor(rec_t, dtype=torch.float64),
        torch.tensor([n_srv, n_adm, n_bat, len(rec_a), int(done)], dtype=torch.int64),
        torch.tensor([t], dtype=torch.float64),
    )


def _check(table, arrivals, phases, draws, means, b_max: int) -> None:
    want = (
        ("table", table, torch.int64, 2),
        ("arrivals", arrivals, torch.float64, 1),
        ("phases", phases, torch.int64, 1),
        ("draws", draws, torch.float64, 1),
        ("means", means, torch.float64, 1),
    )
    for name, x, dtype, nd in want:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dtype != dtype or x.dim() != nd:
            raise TypeError(
                f"{name} must be {nd}-d {dtype}, got {x.dim()}-d {x.dtype}"
            )
        if x.device != arrivals.device:
            raise ValueError(f"{name} on {x.device}, arrivals on {arrivals.device}")
    if phases.shape != arrivals.shape:
        raise ValueError("phases must align with arrivals")
    if draws.numel() < 1:
        raise ValueError("need at least one service draw")
    if means.numel() != b_max + 1:
        raise ValueError(f"means needs b_max + 1 = {b_max + 1} entries")
    if table.shape[1] < 1:
        raise ValueError("empty action table")


def serve_scan(table, arrivals, phases, draws, means, *, t0: float,
               horizon: float, max_eps: int, drain: bool,
               b_max: int) -> ScanOut:
    """Walk one lane.  ``phases`` must index rows of ``table`` (checked by
    the caller); ``arrivals`` sorted and +inf padded past the real ones."""
    _check(table, arrivals, phases, draws, means, b_max)
    kw = dict(t0=t0, horizon=horizon, max_eps=max_eps, drain=drain, b_max=b_max)
    if arrivals.device.type == "cpu":
        return serve_scan_ref(table, arrivals, phases, draws, means, **kw)
    if arrivals.device.type != "cuda":
        raise ValueError(f"unsupported device {arrivals.device}")
    dev = arrivals.device
    table, arrivals, phases, draws, means = (
        x.contiguous() for x in (table, arrivals, phases, draws, means)
    )
    rec_cap = max(int(max_eps), 1)  # one record per epoch, at most max_eps
    rec_a = torch.empty(rec_cap, dtype=torch.int32, device=dev)
    rec_t = torch.empty(rec_cap, dtype=torch.float64, device=dev)
    agg = torch.empty(5, dtype=torch.int64, device=dev)
    t_final = torch.empty(1, dtype=torch.float64, device=dev)
    fn = _build.load("serve_scan").serve_scan_launch
    fn.restype = ctypes.c_int
    P, I, LL, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    fn.argtypes = [P, I, P, P, LL, P, LL, P, D, D, LL, I, LL, I, P, P, LL, P, P, P]
    rc = fn(
        table.data_ptr(), table.shape[1], arrivals.data_ptr(),
        phases.data_ptr(), arrivals.numel(), draws.data_ptr(), draws.numel(),
        means.data_ptr(), float(t0), float(horizon), int(max_eps),
        int(bool(drain)), int(b_max), 1, rec_a.data_ptr(), rec_t.data_ptr(),
        rec_cap, agg.data_ptr(), t_final.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"serve_scan launch failed: CUDA error {rc}")
    serve_scan.launches += 1
    return ScanOut(rec_a, rec_t, agg, t_final)


serve_scan.launches = 0
