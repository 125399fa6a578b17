"""The paper's own figures and tables through the port: Figs. 3, 4, 7-10,
Tables II-III and App. E.

One function per benchmark of ``benchmarks/`` (named after its file), on
the same library calls: ``solve`` (Figs. 3, App. E; Table III's oracle),
``relative_value_iteration`` (Fig. 10 / Table II, Table III's RVI rows),
``sweep_solve`` through ``core.tradeoff`` (Figs. 4, 7, 8) or directly
(Fig. 9), ``relative_value_iteration_batched`` (Table III's accel
ladder).  Each takes its grid as arguments, defaulting to the benchmark's
full size (``smoke=True``: its reduced grid), and ``backup`` / ``device``:
with ``backup="pallas"`` every scalar RVI backup is one launch of the
Bellman kernel and every lockstep backup of a sweep one launch of the
spec-batched kernel.  Each returns the figure's numbers; ``rows`` formats
them as the benchmark's ``name,us_per_call,derived`` lines.

Table III's AVI / API rows stay host numpy, as in the reference: they are
the paper's baselines (App. F), not a path to the card.

    PYTHONPATH=src python -m repro_torch.launch.paper_figures [--only NAME]
        [--smoke] [--device cpu|cuda] [--backup banded|pallas]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    IDEAL_PARALLEL_LATENCY,
    LOG_ENERGY,
    ConstantProfile,
    ServiceModel,
    SMDPSpec,
    build_smdp,
    build_smdp_batched,
    evaluate_policy,
    optimal_q_closed_form,
)
from ..core import rvi as _rvi
from ..core import sweep as _sweep
from ..core import tradeoff as _tradeoff
from ..core.policies import is_control_limit
from ..core.solve import solve
from ..device import DeviceLike

#: benchmarks/common.py
BMAX = 32

#: benchmarks/fig3_policies.py and appE_structure_breaks.py: B = 8, s_max
#: 100 grown until Delta < 1e-3, up to 1024
STRUCTURE_B = 8
STRUCTURE_DELTA = 1e-3
STRUCTURE_MAX_S_MAX = 1024
FIG3_CASES = (
    ("case1_det", ConstantProfile(2.4252), "det"),
    ("case2_expo", ConstantProfile(2.4252), "expo"),
    ("case3_expo", ConstantProfile(1.7465), "expo"),
)
FIG3_RHOS, FIG3_RHOS_SMOKE = (0.1, 0.3, 0.5, 0.7, 0.9), (0.3, 0.7)
FIG3_W2S, FIG3_W2S_SMOKE = (0.0, 0.5, 1.0, 100.0), (0.0, 1.0)
APPE_CASES = (
    # case 4: B_min = 5 (violates Assumption 2)
    ("case4_bmin5", dict(latency=ConstantProfile(2.4252), family="det", b_min=5,
                         energy=GOOGLENET_P4_ENERGY)),
    # case 5: log energy (violates Assumption 3)
    ("case5_log_energy", dict(latency=ConstantProfile(2.4252), family="det", b_min=1,
                              energy=LOG_ENERGY)),
    # cases 6 / 7: size-dependent service time (violates Assumption 1)
    ("case6_size_dep", dict(latency=GOOGLENET_P4_LATENCY, family="det", b_min=1,
                            energy=GOOGLENET_P4_ENERGY)),
    ("case7_general", dict(latency=GOOGLENET_P4_LATENCY, family="expo", b_min=3,
                           energy=LOG_ENERGY)),
)
APPE_RHOS, APPE_RHOS_SMOKE = FIG3_RHOS, FIG3_RHOS_SMOKE
APPE_W2S, APPE_W2S_SMOKE = (0.0, 0.5, 1.0), (0.0, 1.0)
#: fig4_cost.py
FIG4_RHOS, FIG4_RHOS_SMOKE = (0.1, 0.3, 0.7), (0.3, 0.7)
FIG4_W2S, FIG4_W2S_SMOKE = (0.0, 1.0, 3.0, 7.0, 15.0), (0.0, 1.0, 7.0)
#: fig7_ideal_parallel.py, fig8_log_energy.py (both rhos in either mode)
TRADEOFF_RHOS = (0.3, 0.7)
FIG7_W2S, FIG7_W2S_SMOKE = (0.0, 0.5, 1.5, 5.0, 20.0), (0.0, 1.5, 20.0)
FIG8_W2S, FIG8_W2S_SMOKE = (0.0, 0.3, 1.0, 3.0, 10.0), (0.0, 1.0, 10.0)
#: fig9_cov.py
FAMILIES = ("det", "erlang", "expo", "hyperexpo")
FIG9_RHOS, FIG9_RHOS_SMOKE = (0.3, 0.7), (0.3,)
FIG9_S_MAX, FIG9_S_MAX_SMOKE = 192, 128
#: fig10_abstract_cost.py
FIG10_DELTA = 1e-3
FIG10_S_GRID = tuple(range(36, 260, 8))
FIG10_C_OS, FIG10_C_OS_SMOKE = (10000.0, 1000.0, 100.0, 10.0, 0.0), (100.0, 0.0)
#: table3_iteration_algos.py
ACCEL_RHOS = (0.3, 0.7, 0.85)
ACCEL_MODES = ("none", "mpi", "anderson")
ACCEL_S_MAX, ACCEL_S_MAX_SMOKE = 128, 96
BASELINE = dict(rho=0.5, s_max=160, avi_outer=400, api_outer=8)


def paper_spec(rho=0.7, w2=1.0, s_max=128, b_max=BMAX, c_o=100.0,
               family="det", latency=None, energy=None, b_min=1) -> SMDPSpec:
    """benchmarks/common.py's scenario: GoogLeNet on a Tesla P4 at load rho."""
    svc = ServiceModel(latency=latency or GOOGLENET_P4_LATENCY, family=family)
    lam = rho * b_max / float(svc.mean(b_max))
    return SMDPSpec(
        lam=lam, service=svc, energy=energy or GOOGLENET_P4_ENERGY,
        b_min=b_min, b_max=b_max, w1=1.0, w2=w2, s_max=s_max, c_o=c_o,
    )


def _pick(value, full, smoke_value, smoke):
    if value is not None:
        return tuple(value)
    return smoke_value if smoke else full


def _structure_grid(latency, family, energy, b_min, rhos, w2s, backup, device):
    """Solve B = 8 specs over rhos x w2s with the Delta-acceptance loop
    (Figs. 3 and App. E); one record per spec."""
    svc = ServiceModel(latency=latency, family=family)
    mu = 1.0 / float(svc.mean(STRUCTURE_B))
    out = []
    for rho in rhos:
        for w2 in w2s:
            spec = SMDPSpec(
                lam=rho * STRUCTURE_B * mu, service=svc, energy=energy,
                b_min=b_min, b_max=STRUCTURE_B, w1=1.0, w2=w2, s_max=100,
                c_o=100.0,
            )
            res = solve(spec, delta=STRUCTURE_DELTA, max_s_max=STRUCTURE_MAX_S_MAX,
                        backup=backup, device=device)
            is_cl, q = is_control_limit(res.rvi.policy, res.spec.s_max, STRUCTURE_B)
            out.append(dict(
                rho=rho, w2=w2, mu=mu, spec=res.spec, s_max=res.spec.s_max,
                iterations=res.rvi.iterations, converged=res.rvi.converged,
                g=res.eval.g, delta=res.eval.delta, policy=res.policy,
                control_limit=is_cl, q=q,
            ))
    return out


def fig3_policies(rhos: Optional[Sequence[float]] = None,
                  w2s: Optional[Sequence[float]] = None, *, smoke: bool = False, backup: str = "banded",
                  device: DeviceLike = None) -> Dict:
    """Fig. 3: control-limit structure in Cases 1-3, and Prop. 4's closed
    form Q* against the solved threshold for the exponential cases."""
    rhos = _pick(rhos, FIG3_RHOS, FIG3_RHOS_SMOKE, smoke)
    w2s = _pick(w2s, FIG3_W2S, FIG3_W2S_SMOKE, smoke)
    t0 = time.perf_counter()
    specs = []
    for name, lat, family in FIG3_CASES:
        for r in _structure_grid(lat, family, GOOGLENET_P4_ENERGY, 1, rhos, w2s,
                                 backup, device):
            r["case"] = name
            if family == "expo":
                r["q_star"] = optimal_q_closed_form(
                    r["spec"].lam, r["mu"], STRUCTURE_B, w1=1.0, w2=r["w2"],
                    zeta0=GOOGLENET_P4_ENERGY.intercept,
                )
                r["prop4"] = bool(r["control_limit"] and r["q"] == r["q_star"])
            specs.append(r)
    us = (time.perf_counter() - t0) * 1e6
    expo = [r for r in specs if "prop4" in r]
    return dict(
        specs=specs, total=len(specs),
        control_limit=sum(r["control_limit"] for r in specs),
        prop4_applicable=len(expo), prop4_match=sum(r["prop4"] for r in expo),
        us=us / max(len(specs), 1),
    )


def appE_structure_breaks(rhos: Optional[Sequence[float]] = None,
                          w2s: Optional[Sequence[float]] = None, *, smoke: bool = False, backup: str = "banded",
                          device: DeviceLike = None) -> Dict:
    """App. E: Cases 4-7 break the assumptions behind Fig. 3; count the
    solutions that are not control-limit policies."""
    rhos = _pick(rhos, APPE_RHOS, APPE_RHOS_SMOKE, smoke)
    w2s = _pick(w2s, APPE_W2S, APPE_W2S_SMOKE, smoke)
    out = {}
    for name, kw in APPE_CASES:
        t0 = time.perf_counter()
        specs = _structure_grid(kw["latency"], kw["family"], kw["energy"],
                                kw["b_min"], rhos, w2s, backup, device)
        us = (time.perf_counter() - t0) * 1e6
        out[name] = dict(
            specs=specs, total=len(specs),
            non_control_limit=sum(not r["control_limit"] for r in specs),
            us=us / max(len(specs), 1),
        )
    return out


def fig4_cost(rhos: Optional[Sequence[float]] = None,
              w2s: Optional[Sequence[float]] = None, *, s_max: int = 128, smoke: bool = False, backup: str = "banded",
              device: DeviceLike = None) -> Dict:
    """Fig. 4: average cost of the SMDP policy against greedy / static-b,
    one batched sweep per rho (core.tradeoff.average_cost_grid)."""
    rhos = _pick(rhos, FIG4_RHOS, FIG4_RHOS_SMOKE, smoke)
    w2s = list(_pick(w2s, FIG4_W2S, FIG4_W2S_SMOKE, smoke))
    out = {}
    for rho in rhos:
        t0 = time.perf_counter()
        grid = _tradeoff.average_cost_grid(paper_spec(rho=rho, s_max=s_max),
                                           w2s, backup=backup, device=device)
        us = (time.perf_counter() - t0) * 1e6
        smdp = np.asarray(grid["smdp"])
        worst, best_gap = 0.0, 0.0
        for name, costs in grid.items():
            if name == "smdp":
                continue
            c = np.asarray(costs)
            worst = max(worst, float((smdp - c).max()))
            best_gap = max(best_gap, float(np.nanmax((c - smdp) / smdp)))
        out[rho] = dict(grid=grid, worst_violation=worst,
                        smdp_always_best=worst <= 1e-9, max_bench_excess=best_gap,
                        us=us / len(w2s))
    return out


def _tradeoff_figure(spec_of, rhos, w2s, backup, device):
    """Figs. 7-8: one SMDP curve per rho (one sweep) and the benchmark
    points; ``dominated`` counts (curve point, benchmark) pairs where the
    benchmark is better in both W and P."""
    out = {}
    for rho in rhos:
        spec = spec_of(rho)
        t0 = time.perf_counter()
        curve = _tradeoff.smdp_tradeoff_curve(spec, w2s, backup=backup, device=device)
        us = (time.perf_counter() - t0) * 1e6
        bench = _tradeoff.benchmark_points(spec)
        dominated = sum(
            1 for pt in curve for (w_b, p_b) in bench.values()
            if w_b < pt.w_bar - 1e-6 and p_b < pt.p_bar - 1e-6
        )
        out[rho] = dict(curve=curve, bench=bench, dominated=dominated,
                        us=us / len(w2s))
    return out


def fig7_ideal_parallel(w2s: Optional[Sequence[float]] = None,
                        rhos: Sequence[float] = TRADEOFF_RHOS, *, s_max: int = 128,
                        smoke: bool = False, backup: str = "banded",
                        device: DeviceLike = None) -> Dict:
    """Fig. 7: batch-size-independent service time (ideal parallelism)."""
    w2s = list(_pick(w2s, FIG7_W2S, FIG7_W2S_SMOKE, smoke))
    out = _tradeoff_figure(
        lambda rho: paper_spec(rho=rho, latency=IDEAL_PARALLEL_LATENCY, s_max=s_max),
        rhos, w2s, backup, device)
    for r in out.values():
        r["greedy_W"] = r["bench"].get("greedy", (float("nan"),) * 2)[0]
        r["max_batch_W"] = r["bench"].get("static_32", (float("nan"),) * 2)[0]
    return out


def fig8_log_energy(w2s: Optional[Sequence[float]] = None,
                    rhos: Sequence[float] = TRADEOFF_RHOS, *, s_max: int = 128,
                    smoke: bool = False, backup: str = "banded",
                    device: DeviceLike = None) -> Dict:
    """Fig. 8: logarithmic energy; the tradeoff's power range."""
    w2s = list(_pick(w2s, FIG8_W2S, FIG8_W2S_SMOKE, smoke))
    out = _tradeoff_figure(
        lambda rho: paper_spec(rho=rho, energy=LOG_ENERGY, s_max=s_max),
        rhos, w2s, backup, device)
    for r in out.values():
        p = [pt.p_bar for pt in r["curve"]]
        r["power_range"] = max(p) - min(p)
    return out


def fig9_cov(rhos: Optional[Sequence[float]] = None, s_max: Optional[int] = None, *,
             smoke: bool = False, backup: str = "banded",
             device: DeviceLike = None) -> Dict:
    """Fig. 9: W across service-time distributions, one sweep per rho."""
    rhos = _pick(rhos, FIG9_RHOS, FIG9_RHOS_SMOKE, smoke)
    if s_max is None:
        s_max = FIG9_S_MAX_SMOKE if smoke else FIG9_S_MAX
    out = {}
    for rho in rhos:
        specs = [paper_spec(rho=rho, family=fam, s_max=s_max) for fam in FAMILIES]
        t0 = time.perf_counter()
        results = _sweep.sweep_solve(specs, backup=backup, device=device)
        us = (time.perf_counter() - t0) * 1e6
        w = {fam: res.eval.w_bar for fam, res in zip(FAMILIES, results)}
        vals = list(w.values())
        out[rho] = dict(
            w=w, monotone=all(a <= b for a, b in zip(vals, vals[1:])),
            s_max={fam: res.spec.s_max for fam, res in zip(FAMILIES, results)},
            policies=[res.policy for res in results], us=us / len(FAMILIES),
        )
    return out


def min_smax(c_o: float, rho: float = 0.9, w2: float = 1.0, *,
             s_grid: Sequence[int] = FIG10_S_GRID, b_max: int = BMAX,
             backup: str = "banded", device: DeviceLike = None,
             searched: Optional[list] = None):
    """Smallest s_max of ``s_grid`` whose solution is Delta-acceptable
    (paper Sec. V-A): (s_max, RVIResult, PolicyEval), or (None,) * 3.
    ``searched`` receives one record per solve tried."""
    for s_max in s_grid:
        mdp = build_smdp(paper_spec(rho=rho, w2=w2, s_max=s_max, c_o=c_o, b_max=b_max))
        res = _rvi.relative_value_iteration(mdp, eps=1e-2, max_iter=10_000,
                                            backup=backup, device=device)
        ev = evaluate_policy(mdp, res.policy)
        if searched is not None:
            searched.append(dict(s_max=s_max, iterations=res.iterations,
                                 converged=res.converged, delta=ev.delta))
        if ev.delta < FIG10_DELTA:
            return s_max, res, ev
    return None, None, None


def fig10_abstract_cost(c_os: Optional[Sequence[float]] = None, *, rho: float = 0.9,
                        s_grid: Sequence[int] = FIG10_S_GRID, b_max: int = BMAX,
                        smoke: bool = False, backup: str = "banded",
                        device: DeviceLike = None) -> Dict:
    """Fig. 10 / Table II: the smallest acceptable s_max per abstract cost
    c_o, and the space and time that c_o = 100 saves against c_o = 0."""
    c_os = _pick(c_os, FIG10_C_OS, FIG10_C_OS_SMOKE, smoke)
    per = {}
    for c_o in c_os:
        searched = []
        t0 = time.perf_counter()
        s_min, res, ev = min_smax(c_o, rho, s_grid=s_grid, b_max=b_max, backup=backup,
                                  device=device, searched=searched)
        us = (time.perf_counter() - t0) * 1e6
        per[c_o] = dict(min_smax=s_min, searched=searched, us=us)
        if s_min is not None:
            per[c_o].update(
                iterations=res.iterations, g=ev.g, delta=ev.delta, policy=res.policy,
                space=(res.policy.shape[0] - 1) * (b_max + 1) * 2,  # ~ B_max s_max 2
                time=res.iterations * (b_max + 1) * s_min ** 2,
            )
    reduction = None
    if per.get(0.0, {}).get("min_smax") and per.get(100.0, {}).get("min_smax"):
        a, b = per[0.0], per[100.0]
        reduction = dict(smax_from=a["min_smax"], smax_to=b["min_smax"],
                         space_saved=1 - b["space"] / a["space"],
                         time_saved=1 - b["time"] / a["time"])
    return dict(c_o=per, reduction=reduction)


def table3_iteration_algos(rhos: Sequence[float] = ACCEL_RHOS,
                           s_max: Optional[int] = None,
                           baselines: Optional[bool] = None, baseline=BASELINE, *,
                           b_max: int = BMAX, smoke: bool = False, backup: str = "banded",
                           device: DeviceLike = None) -> Dict:
    """Table III: RVI (c_o 0 and 100) against the AVI / API baselines, each
    policy evaluated on the same c_o = 0 chain (skipped with ``smoke``, as
    the benchmark does); then the accel ladder per rho, every mode's
    batched solve held against the scalar float64 ``solve()`` oracle at the
    same truncation (the oracle stays on the banded float64 path)."""
    if s_max is None:
        s_max = ACCEL_S_MAX_SMOKE if smoke else ACCEL_S_MAX
    if baselines is None:
        baselines = not smoke
    out = dict(baselines=None, accel={})
    if baselines:
        spec = paper_spec(rho=baseline["rho"], w2=1.0, s_max=baseline["s_max"], c_o=0.0,
                          b_max=b_max)
        mdp0 = build_smdp(spec)
        mdp100 = build_smdp(dataclasses.replace(spec, c_o=100.0))
        runners = [
            ("rvi_co0", lambda: _rvi.relative_value_iteration(
                mdp0, eps=1e-2, backup=backup, device=device)),
            ("rvi_co100", lambda: _rvi.relative_value_iteration(
                mdp100, eps=1e-2, backup=backup, device=device)),
            ("avi_schemeI", lambda: _rvi.avi(spec, n_outer=baseline["avi_outer"],
                                             eval_s_max=baseline["s_max"])),
            ("api_schemeIV", lambda: _rvi.api(spec, n_outer=baseline["api_outer"],
                                              eval_s_max=baseline["s_max"])),
        ]
        out["baselines"] = {}
        for name, runner in runners:
            t0 = time.perf_counter()
            res = runner()
            us = (time.perf_counter() - t0) * 1e6
            ev = evaluate_policy(mdp0, res.policy)
            out["baselines"][name] = dict(g=ev.g, wall_s=res.wall_time_s,
                                          iterations=res.iterations,
                                          converged=res.converged, policy=res.policy,
                                          us=us)
    for rho in rhos:
        spec = paper_spec(rho=rho, w2=1.0, s_max=s_max, b_max=b_max)
        oracle = solve(spec, auto_c_o=False, delta=None, device=device)
        batch = build_smdp_batched([spec])
        rows = {}
        for mode in ACCEL_MODES:
            _rvi.relative_value_iteration_batched(batch, accel=mode, backup=backup,
                                                  device=device)  # warm, as the benchmark
            t0 = time.perf_counter()
            for _ in range(2):
                res = _rvi.relative_value_iteration_batched(batch, accel=mode,
                                                            backup=backup, device=device)
            us = (time.perf_counter() - t0) * 1e6 / 2
            rows[mode] = dict(
                iterations=int(res.iterations[0]), wall_s=us / 1e6,
                g_gap_vs_oracle=float(abs(res.g[0] - oracle.eval.g)),
                policy_match=bool(np.array_equal(res.policies[0], oracle.policy)),
                us=us,
            )
        rows["speedup_iters_mpi_vs_none"] = (
            rows["none"]["iterations"] / max(rows["mpi"]["iterations"], 1))
        out["accel"][rho] = rows
    return out


FIGURES = {
    "fig3_policies": fig3_policies,
    "fig4_cost": fig4_cost,
    "fig7_ideal_parallel": fig7_ideal_parallel,
    "fig8_log_energy": fig8_log_energy,
    "fig9_cov": fig9_cov,
    "fig10_abstract_cost": fig10_abstract_cost,
    "table3_iteration_algos": table3_iteration_algos,
    "appE_structure_breaks": appE_structure_breaks,
}


def rows(name: str, out: Dict) -> List[str]:
    """``out`` of FIGURES[name] as the benchmark's ``name,us_per_call,derived``
    lines (benchmarks/common.py's emit)."""
    def line(row, us, derived):
        return f"{row},{us:.1f},{derived}"

    if name == "fig3_policies":
        return [
            line("fig3_control_limit_structure", out["us"],
                 f"{out['control_limit']}/{out['total']}_control_limit"),
            line("fig3_prop4_agreement", out["us"],
                 f"{out['prop4_match']}/{out['prop4_applicable']}_Q_match"),
        ]
    if name == "appE_structure_breaks":
        return [line(f"appE_{case}", r["us"],
                     f"non_control_limit={r['non_control_limit']}/{r['total']}")
                for case, r in out.items()]
    if name == "fig4_cost":
        return [line(f"fig4_avg_cost_rho{rho}", r["us"],
                     f"smdp_always_best={r['smdp_always_best']};"
                     f"max_bench_excess={r['max_bench_excess']:.1%}")
                for rho, r in out.items()]
    if name == "fig7_ideal_parallel":
        return [line(f"fig7_ideal_parallel_rho{rho}", r["us"],
                     f"dominated={r['dominated']};greedy_W={r['greedy_W']:.2f};"
                     f"max_batch_W={r['max_batch_W']:.2f}")
                for rho, r in out.items()]
    if name == "fig8_log_energy":
        return [line(f"fig8_log_energy_rho{rho}", r["us"],
                     f"dominated={r['dominated']};power_range={r['power_range']:.2f}W")
                for rho, r in out.items()]
    if name == "fig9_cov":
        return [line(f"fig9_cov_rho{rho}", r["us"],
                     f"W_monotone_in_CoV={r['monotone']};"
                     + ";".join(f"{k}={v:.2f}ms" for k, v in r["w"].items()))
                for rho, r in out.items()]
    if name == "fig10_abstract_cost":
        lines = []
        for c_o, r in out["c_o"].items():
            if r["min_smax"] is None:
                lines.append(line(f"table2_co_{c_o:g}", r["us"], "no_acceptable_smax<=256"))
                continue
            lines.append(line(
                f"table2_co_{c_o:g}", r["us"],
                f"min_smax={r['min_smax']};iters={r['iterations']};"
                f"space~{r['space']};time~{r['time']:.2e};g={r['g']:.4f}"))
        red = out["reduction"]
        if red is not None:
            lines.append(line(
                "table2_reduction_co100_vs_co0", 0.0,
                f"smax:{red['smax_from']}->{red['smax_to']};"
                f"space_saved={red['space_saved']:.1%};time_saved={red['time_saved']:.1%}"))
        return lines
    if name == "table3_iteration_algos":
        lines = [line(f"table3_{k}", r["us"],
                      f"g={r['g']:.4f};wall={r['wall_s']:.2f}s;iters={r['iterations']}")
                 for k, r in (out["baselines"] or {}).items()]
        for rho, modes in out["accel"].items():
            lines += [line(f"table3_accel_rho{rho}_{mode}", r["us"],
                           f"iters={r['iterations']};g_gap={r['g_gap_vs_oracle']:.2e};"
                           f"policy_match={r['policy_match']}")
                      for mode, r in modes.items() if isinstance(r, dict)]
        return lines
    raise KeyError(f"unknown figure {name!r}")


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, help="substring filter on figure names")
    ap.add_argument("--smoke", action="store_true", help="the benchmarks' reduced grids")
    ap.add_argument("--backup", choices=("banded", "pallas"), default="banded")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived", flush=True)
    results = {}
    for name, fn in FIGURES.items():
        if args.only and args.only not in name:
            continue
        t0 = time.perf_counter()
        results[name] = fn(smoke=args.smoke, backup=args.backup, device=args.device)
        for ln in rows(name, results[name]):
            print(ln, flush=True)
        print(f"# {name} finished in {time.perf_counter() - t0:.1f}s", file=sys.stderr,
              flush=True)
    return results


if __name__ == "__main__":
    main()
