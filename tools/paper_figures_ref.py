"""The paper's figures and tables through the JAX reference (CPU), as numbers.

The same library calls as benchmarks/{fig3_policies,fig4_cost,
fig7_ideal_parallel,fig8_log_energy,fig9_cov,fig10_abstract_cost,
table3_iteration_algos,appE_structure_breaks}.py, with the grids as
arguments, returning what the benchmarks print before they round it.
tests/test_torch_figures.py holds the port's launch/paper_figures.py to
these functions at reduced grids; run as a script, it prints the
benchmarks' full-size numbers as one JSON object (the reference values
that chip_smoke.py's phase 4k holds the card to):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/paper_figures_ref.py
"""
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from benchmarks import (  # noqa: E402
    fig3_policies,
    fig7_ideal_parallel,
    fig8_log_energy,
    fig9_cov,
    fig10_abstract_cost,
    table3_iteration_algos,
)
from benchmarks.common import paper_spec  # noqa: E402
from repro.core import (  # noqa: E402
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
    relative_value_iteration,
    relative_value_iteration_batched,
    solve,
)
from repro.core.policies import is_control_limit  # noqa: E402
from repro.core.rvi import api, avi  # noqa: E402
from repro.core.sweep import sweep_solve  # noqa: E402
from repro.core.tradeoff import (  # noqa: E402
    average_cost_grid,
    benchmark_points,
    smdp_tradeoff_curve,
)

#: appE_structure_breaks.py's cases (defined inside its run())
APPE_CASES = {
    "case4_bmin5": dict(latency=ConstantProfile(2.4252), family="det", b_min=5,
                        energy=GOOGLENET_P4_ENERGY),
    "case5_log_energy": dict(latency=ConstantProfile(2.4252), family="det", b_min=1,
                             energy=LOG_ENERGY),
    "case6_size_dep": dict(latency=GOOGLENET_P4_LATENCY, family="det", b_min=1,
                           energy=GOOGLENET_P4_ENERGY),
    "case7_general": dict(latency=GOOGLENET_P4_LATENCY, family="expo", b_min=3,
                          energy=LOG_ENERGY),
}
B = fig3_policies.B


def _structure(latency, family, energy, b_min, rhos, w2s):
    svc = ServiceModel(latency=latency, family=family)
    mu = 1.0 / float(svc.mean(B))
    out = []
    for rho in rhos:
        for w2 in w2s:
            spec = SMDPSpec(lam=rho * B * mu, service=svc, energy=energy, b_min=b_min,
                            b_max=B, w1=1.0, w2=w2, s_max=100, c_o=100.0)
            res = solve(spec, delta=1e-3, max_s_max=1024)
            is_cl, q = is_control_limit(res.rvi.policy, res.spec.s_max, B)
            out.append(dict(rho=rho, w2=w2, mu=mu, lam=spec.lam, s_max=res.spec.s_max,
                            c_o=res.spec.c_o, iterations=res.rvi.iterations,
                            g=res.eval.g, delta=res.eval.delta,
                            policy=np.asarray(res.policy), control_limit=is_cl, q=q))
    return out


def fig3(rhos, w2s):
    specs = []
    for name, lat, family in fig3_policies.CASES:
        for r in _structure(lat, family, GOOGLENET_P4_ENERGY, 1, rhos, w2s):
            r["case"] = name
            if family == "expo":
                r["q_star"] = optimal_q_closed_form(
                    r["lam"], r["mu"], B, w1=1.0, w2=r["w2"],
                    zeta0=GOOGLENET_P4_ENERGY.intercept)
                r["prop4"] = bool(r["control_limit"] and r["q"] == r["q_star"])
            specs.append(r)
    expo = [r for r in specs if "prop4" in r]
    return dict(specs=specs, total=len(specs),
                control_limit=sum(r["control_limit"] for r in specs),
                prop4_applicable=len(expo), prop4_match=sum(r["prop4"] for r in expo))


def appE(rhos, w2s):
    out = {}
    for name, kw in APPE_CASES.items():
        specs = _structure(kw["latency"], kw["family"], kw["energy"], kw["b_min"],
                           rhos, w2s)
        out[name] = dict(specs=specs, total=len(specs),
                         non_control_limit=sum(not r["control_limit"] for r in specs))
    return out


def fig4(rhos, w2s, s_max=128):
    out = {}
    for rho in rhos:
        grid = average_cost_grid(paper_spec(rho=rho, s_max=s_max), list(w2s))
        smdp = np.asarray(grid["smdp"])
        worst, gap = 0.0, 0.0
        for name, costs in grid.items():
            if name != "smdp":
                c = np.asarray(costs)
                worst = max(worst, float((smdp - c).max()))
                gap = max(gap, float(np.nanmax((c - smdp) / smdp)))
        out[rho] = dict(grid={k: list(map(float, v)) for k, v in grid.items()},
                        worst_violation=worst, smdp_always_best=worst <= 1e-9,
                        max_bench_excess=gap)
    return out


def _tradeoff(spec_of, rhos, w2s):
    out = {}
    for rho in rhos:
        spec = spec_of(rho)
        curve = smdp_tradeoff_curve(spec, list(w2s))
        bench = benchmark_points(spec)
        dominated = sum(1 for pt in curve for (w_b, p_b) in bench.values()
                        if w_b < pt.w_bar - 1e-6 and p_b < pt.p_bar - 1e-6)
        p = [pt.p_bar for pt in curve]
        out[rho] = dict(
            curve=[dict(w2=pt.w2, w_bar=pt.w_bar, p_bar=pt.p_bar, g=pt.g,
                        policy=np.asarray(pt.policy)) for pt in curve],
            bench={k: list(v) for k, v in bench.items()}, dominated=dominated,
            power_range=max(p) - min(p),
            greedy_W=bench.get("greedy", (float("nan"),) * 2)[0],
            max_batch_W=bench.get("static_32", (float("nan"),) * 2)[0])
    return out


def fig7(w2s, rhos=(0.3, 0.7), s_max=128):
    return _tradeoff(lambda rho: paper_spec(rho=rho, latency=IDEAL_PARALLEL_LATENCY,
                                            s_max=s_max), rhos, w2s)


def fig8(w2s, rhos=(0.3, 0.7), s_max=128):
    return _tradeoff(lambda rho: paper_spec(rho=rho, energy=LOG_ENERGY, s_max=s_max),
                     rhos, w2s)


def fig9(rhos, s_max):
    families = fig9_cov.FAMILIES
    out = {}
    for rho in rhos:
        specs = [paper_spec(rho=rho, family=f, s_max=s_max) for f in families]
        results = sweep_solve(specs)
        w = {f: res.eval.w_bar for f, res in zip(families, results)}
        vals = list(w.values())
        out[rho] = dict(w=w, monotone=all(a <= b for a, b in zip(vals, vals[1:])),
                        s_max={f: res.spec.s_max for f, res in zip(families, results)},
                        policies=[np.asarray(res.policy) for res in results])
    return out


def fig10(c_os, rho=0.9, s_grid=fig10_abstract_cost.S_GRID, b_max=32):
    per = {}
    for c_o in c_os:
        per[c_o] = dict(min_smax=None, searched=[])
        for s_max in s_grid:
            mdp = build_smdp(paper_spec(rho=rho, w2=1.0, s_max=s_max, c_o=c_o, b_max=b_max))
            res = relative_value_iteration(mdp, eps=1e-2, max_iter=10_000)
            ev = evaluate_policy(mdp, res.policy)
            per[c_o]["searched"].append(dict(s_max=s_max, iterations=res.iterations,
                                             converged=bool(res.converged),
                                             delta=ev.delta))
            if ev.delta < fig10_abstract_cost.DELTA:
                pol = np.asarray(res.policy)
                per[c_o].update(min_smax=s_max, iterations=res.iterations, g=ev.g,
                                delta=ev.delta, policy=pol,
                                space=(pol.shape[0] - 1) * (b_max + 1) * 2,
                                time=res.iterations * (b_max + 1) * s_max ** 2)
                break
    red = None
    if per.get(0.0, {}).get("min_smax") and per.get(100.0, {}).get("min_smax"):
        a, b = per[0.0], per[100.0]
        red = dict(smax_from=a["min_smax"], smax_to=b["min_smax"],
                   space_saved=1 - b["space"] / a["space"],
                   time_saved=1 - b["time"] / a["time"])
    return dict(c_o=per, reduction=red)


def table3(rhos=table3_iteration_algos.ACCEL_RHOS, s_max=128, baselines=True, baseline=None, b_max=32):
    baseline = baseline or dict(rho=0.5, s_max=160, avi_outer=400, api_outer=8)
    out = dict(baselines=None, accel={})
    if baselines:
        spec = paper_spec(rho=baseline["rho"], w2=1.0, s_max=baseline["s_max"], c_o=0.0,
                          b_max=b_max)
        mdp0 = build_smdp(spec)
        mdp100 = build_smdp(dataclasses.replace(spec, c_o=100.0))
        out["baselines"] = {}
        for name, runner in [
            ("rvi_co0", lambda: relative_value_iteration(mdp0, eps=1e-2)),
            ("rvi_co100", lambda: relative_value_iteration(mdp100, eps=1e-2)),
            ("avi_schemeI", lambda: avi(spec, n_outer=baseline["avi_outer"],
                                        eval_s_max=baseline["s_max"])),
            ("api_schemeIV", lambda: api(spec, n_outer=baseline["api_outer"],
                                         eval_s_max=baseline["s_max"])),
        ]:
            res = runner()
            out["baselines"][name] = dict(g=evaluate_policy(mdp0, res.policy).g,
                                          iterations=int(res.iterations),
                                          policy=np.asarray(res.policy))
    for rho in rhos:
        spec = paper_spec(rho=rho, w2=1.0, s_max=s_max, b_max=b_max)
        oracle = solve(spec, auto_c_o=False, delta=None)
        batch = build_smdp_batched([spec])
        rows = {}
        for mode in table3_iteration_algos.ACCEL_MODES:
            res = relative_value_iteration_batched(batch, accel=mode)
            rows[mode] = dict(iterations=int(res.iterations[0]),
                              g_gap_vs_oracle=float(abs(res.g[0] - oracle.eval.g)),
                              policy_match=bool(np.array_equal(res.policies[0],
                                                               oracle.policy)),
                              policy=np.asarray(res.policies[0]))
        out["accel"][rho] = rows
    return out


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items() if k not in ("policy", "policies")}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.bool_):
        return bool(x)
    return x


def main():
    t0 = time.perf_counter()
    f3 = fig3((0.1, 0.3, 0.5, 0.7, 0.9), (0.0, 0.5, 1.0, 100.0))
    e = appE((0.1, 0.3, 0.5, 0.7, 0.9), (0.0, 0.5, 1.0))
    out = dict(
        fig10=fig10(fig10_abstract_cost.C_OS),
        fig3=dict(control_limit=f3["control_limit"], total=f3["total"],
                  prop4_match=f3["prop4_match"], prop4_applicable=f3["prop4_applicable"],
                  s_max=[[r["case"], r["rho"], r["w2"], r["s_max"], r["q"]]
                         for r in f3["specs"]]),
        appE={k: dict(non_control_limit=v["non_control_limit"], total=v["total"],
                      broken=[[r["rho"], r["w2"], r["s_max"]] for r in v["specs"]
                              if not r["control_limit"]]) for k, v in e.items()},
        fig4=fig4((0.1, 0.3, 0.7), (0.0, 1.0, 3.0, 7.0, 15.0)),
        fig7=fig7(fig7_ideal_parallel.W2S),
        fig8=fig8(fig8_log_energy.W2S),
        fig9=fig9((0.3, 0.7), 192),
        table3=table3(),
    )
    for k in ("fig7", "fig8"):
        for r in out[k].values():
            r.pop("curve")
    for r in out["fig10"]["c_o"].values():  # keep the solves that stopped at max_iter
        r["unconverged"] = [x["s_max"] for x in r.pop("searched") if not x["converged"]]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(_jsonable(out)))


if __name__ == "__main__":
    main()
