"""Port vs reference: the paper's figures and tables (launch/paper_figures.py).

Each figure runs at a reduced grid through the port (device="cpu", with
backup="banded" and with backup="pallas", the Bellman kernels' f32 plain
versions) and through the reference's own library calls on the same grid
(tools/paper_figures_ref.py: repro.core.solve, relative_value_iteration,
sweep_solve, tradeoff.*, policies.*, rvi.avi / api).  Held, with the
bars this repo already uses:

* policies equal (the scalar float64 path's, and the sweeps'), s_max after
  regrowth equal, g / W / P at rtol 1e-9;
* on the float64 scalar loop (backup="banded"), iteration counts equal;
  a path with an f32 phase is held to policies and s_max, not iteration
  counts (its sums run in another order);
* the verdicts: Fig. 3's and App. E's control-limit flags and thresholds q
  and Prop. 4's Q*; Fig. 9's order of W; Fig. 4's smdp_always_best; the
  dominated counts of Figs. 7-8; Fig. 10's smallest acceptable s_max per
  c_o (a grid where both c_o find one, and they differ) and its space and
  time cuts; Table III's policy matches against the oracle.

Then the port's CLI prints the benchmarks' own ``derived`` column, string
for string, on their reduced grids (``run(smoke=True)``; the timing column
left out).
"""
import dataclasses
import functools
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import paper_figures as P

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
BACKUPS = ["banded", "pallas"]


def _ref_module():
    spec = importlib.util.spec_from_file_location(
        "paper_figures_ref", REPO / "tools" / "paper_figures_ref.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _ref_module()

#: the reduced grids: each port call and its reference call
FIG3 = dict(rhos=(0.1, 0.7), w2s=(0.0,))  # the expo cases regrow 100 -> 150 at rho 0.7
APPE = dict(rhos=(0.1,), w2s=(0.0, 1.0))  # cases 4, 6, 7 break the structure at rho 0.1
FIG4 = dict(rhos=(0.3,), w2s=(0.0, 7.0), s_max=64)
FIG7 = dict(w2s=(0.0, 20.0), rhos=(0.7,), s_max=64)
FIG8 = dict(w2s=(0.0, 10.0), rhos=(0.3,), s_max=64)
FIG9 = dict(rhos=(0.3,), s_max=64)
#: b_max 8 at rho 0.5: c_o = 100 accepts s_max 16, c_o = 0 only 40
FIG10 = dict(c_os=(100.0, 0.0), rho=0.5, s_grid=tuple(range(8, 64, 4)), b_max=8)
TABLE3 = dict(rhos=(0.7,), s_max=32, b_max=16, baselines=True,
              baseline=dict(rho=0.5, s_max=40, avi_outer=60, api_outer=4))


GRIDS = dict(fig3=FIG3, appE=APPE, fig4=FIG4, fig7=FIG7, fig8=FIG8, fig9=FIG9,
             fig10=FIG10, table3=TABLE3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The scalar RVI loop runs thousands of small torch ops: with every
    test worker's OpenMP pool as wide as the machine they spin against each
    other (fig3 at its grid: 1 s alone, 340 s beside five busy workers).
    One intra-op thread for this module keeps it at its solo time."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's numbers on the reduced grid (once a module)."""
    return getattr(R, name)(**GRIDS[name])


def close(got, want, rtol=1e-9):
    np.testing.assert_allclose(got, want, rtol=rtol)


def same_structure_specs(got, want, backup):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        what = (g.get("case"), g["rho"], g["w2"])
        assert (g["rho"], g["w2"]) == (w["rho"], w["w2"])
        assert g["s_max"] == w["s_max"], what
        assert g["spec"].c_o == w["c_o"], what
        np.testing.assert_array_equal(g["policy"], w["policy"], err_msg=str(what))
        assert (g["control_limit"], g["q"]) == (w["control_limit"], w["q"]), what
        close(g["g"], w["g"])
        if backup == "banded":
            assert g["iterations"] == w["iterations"], what


@pytest.mark.parametrize("backup", BACKUPS)
def test_fig3_policies(backup):
    got = P.fig3_policies(**FIG3, backup=backup, device=CPU)
    want = reference("fig3")
    same_structure_specs(got["specs"], want["specs"], backup)
    for g, w in zip(got["specs"], want["specs"]):
        assert g["case"] == w["case"]
        assert (g.get("q_star"), g.get("prop4")) == (w.get("q_star"), w.get("prop4"))
    for k in ("total", "control_limit", "prop4_applicable", "prop4_match"):
        assert got[k] == want[k], k
    assert got["prop4_applicable"] == 4 and max(r["s_max"] for r in got["specs"]) > 100


@pytest.mark.parametrize("backup", BACKUPS)
def test_appE_structure_breaks(backup):
    got = P.appE_structure_breaks(**APPE, backup=backup, device=CPU)
    want = reference("appE")
    assert list(got) == list(want)
    for case in want:
        same_structure_specs(got[case]["specs"], want[case]["specs"], backup)
        assert (got[case]["non_control_limit"], got[case]["total"]) == (
            want[case]["non_control_limit"], want[case]["total"]), case
    assert sum(r["non_control_limit"] for r in got.values()) > 0


@pytest.mark.parametrize("backup", BACKUPS)
def test_fig4_cost(backup):
    got = P.fig4_cost(**FIG4, backup=backup, device=CPU)
    want = reference("fig4")
    assert list(got) == list(want)
    for rho, w in want.items():
        g = got[rho]
        assert g["grid"].keys() == w["grid"].keys()
        for k in w["grid"]:
            close(g["grid"][k], w["grid"][k])
        assert g["smdp_always_best"] == w["smdp_always_best"] is True
        close([g["worst_violation"], g["max_bench_excess"]],
              [w["worst_violation"], w["max_bench_excess"]])


@pytest.mark.parametrize("backup", BACKUPS)
@pytest.mark.parametrize("fig", ["fig7", "fig8"])
def test_tradeoff_figures(fig, backup):
    fn = {"fig7": P.fig7_ideal_parallel, "fig8": P.fig8_log_energy}[fig]
    kw = {"fig7": FIG7, "fig8": FIG8}[fig]
    got, want = fn(**kw, backup=backup, device=CPU), reference(fig)
    assert list(got) == list(want)
    for rho, w in want.items():
        g = got[rho]
        assert len(g["curve"]) == len(w["curve"])
        for pt, wp in zip(g["curve"], w["curve"]):
            assert pt.w2 == wp["w2"]
            np.testing.assert_array_equal(pt.policy, wp["policy"])
            close([pt.w_bar, pt.p_bar, pt.g], [wp["w_bar"], wp["p_bar"], wp["g"]])
        assert g["bench"].keys() == w["bench"].keys()
        for k in w["bench"]:
            close(g["bench"][k], w["bench"][k])
        assert g["dominated"] == w["dominated"]
        if fig == "fig7":
            close([g["greedy_W"], g["max_batch_W"]], [w["greedy_W"], w["max_batch_W"]])
        else:
            close(g["power_range"], w["power_range"])


@pytest.mark.parametrize("backup", BACKUPS)
def test_fig9_cov(backup):
    got, want = P.fig9_cov(**FIG9, backup=backup, device=CPU), reference("fig9")
    for rho, w in want.items():
        g = got[rho]
        assert list(g["w"]) == list(w["w"]) == list(P.FAMILIES)
        close(list(g["w"].values()), list(w["w"].values()))
        assert g["monotone"] == w["monotone"] is True
        assert g["s_max"] == w["s_max"]
        for a, b in zip(g["policies"], w["policies"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backup", BACKUPS)
def test_fig10_abstract_cost(backup):
    got, want = P.fig10_abstract_cost(**FIG10, backup=backup, device=CPU), reference("fig10")
    s_min = {c: r["min_smax"] for c, r in want["c_o"].items()}
    assert s_min[100.0] is not None and s_min[0.0] is not None
    assert s_min[100.0] != s_min[0.0]  # the search separates the two costs
    for c_o, w in want["c_o"].items():
        g = got["c_o"][c_o]
        assert g["min_smax"] == w["min_smax"], c_o
        assert [s["s_max"] for s in g["searched"]] == [s["s_max"] for s in w["searched"]]
        assert all(s["converged"] for s in g["searched"])
        np.testing.assert_array_equal(g["policy"], w["policy"])
        close([g["g"], g["delta"]], [w["g"], w["delta"]])
        assert g["space"] == w["space"]
        if backup == "banded":
            assert [s["iterations"] for s in g["searched"]] == [
                s["iterations"] for s in w["searched"]]
            assert (g["iterations"], g["time"]) == (w["iterations"], w["time"])
    gr, wr = got["reduction"], want["reduction"]
    assert (gr["smax_from"], gr["smax_to"]) == (wr["smax_from"], wr["smax_to"])
    close(gr["space_saved"], wr["space_saved"], rtol=1e-12)
    if backup == "banded":
        close(gr["time_saved"], wr["time_saved"], rtol=1e-12)


@pytest.mark.parametrize("backup", BACKUPS)
def test_table3_iteration_algos(backup):
    got = P.table3_iteration_algos(**TABLE3, backup=backup, device=CPU)
    want = reference("table3")
    assert list(got["baselines"]) == list(want["baselines"])
    for name, w in want["baselines"].items():
        g = got["baselines"][name]
        np.testing.assert_array_equal(g["policy"], w["policy"], err_msg=name)
        close(g["g"], w["g"])
        if backup == "banded" or name.startswith(("avi", "api")):
            assert g["iterations"] == w["iterations"], name
    for rho, modes in want["accel"].items():
        for mode, w in modes.items():
            g = got["accel"][rho][mode]
            # a batched solve has an f32 coarse phase: policies, not counts
            assert g["policy_match"] == w["policy_match"] is True, (rho, mode)
            assert g["g_gap_vs_oracle"] < 1e-4 and w["g_gap_vs_oracle"] < 1e-4
        assert got["accel"][rho]["speedup_iters_mpi_vs_none"] > 1


def _benchmark(name):
    """The reference benchmark module benchmarks/<name>.py."""
    sys.path.insert(0, str(REPO))
    try:
        return importlib.import_module(f"benchmarks.{name}")
    finally:
        sys.path.remove(str(REPO))


def test_defaults_are_the_benchmarks_full_grids():
    b = {n: _benchmark(n) for n in (
        "fig3_policies", "fig7_ideal_parallel", "fig8_log_energy", "fig9_cov",
        "fig10_abstract_cost", "table3_iteration_algos")}
    def fields(x):  # a profile of either package, by class name and fields
        if dataclasses.is_dataclass(x):
            return type(x).__name__, dataclasses.asdict(x)
        return x

    assert [tuple(map(fields, c)) for c in P.FIG3_CASES] == [
        tuple(map(fields, c)) for c in b["fig3_policies"].CASES]
    assert P.STRUCTURE_B == b["fig3_policies"].B
    assert [(k, {f: fields(v) for f, v in kw.items()}) for k, kw in P.APPE_CASES] == [
        (k, {f: fields(v) for f, v in kw.items()}) for k, kw in R.APPE_CASES.items()]
    assert P.FIG7_W2S == tuple(b["fig7_ideal_parallel"].W2S)
    assert P.FIG8_W2S == tuple(b["fig8_log_energy"].W2S)
    assert P.FAMILIES == b["fig9_cov"].FAMILIES
    f10 = b["fig10_abstract_cost"]
    assert (P.FIG10_DELTA, P.FIG10_S_GRID, P.FIG10_C_OS) == (
        f10.DELTA, tuple(f10.S_GRID), f10.C_OS)
    t3 = b["table3_iteration_algos"]
    assert (P.ACCEL_RHOS, P.ACCEL_MODES) == (t3.ACCEL_RHOS, t3.ACCEL_MODES)
    spec = P.paper_spec(rho=0.4, w2=2.0, family="erlang", b_min=2)
    want = _benchmark("common").paper_spec(rho=0.4, w2=2.0, family="erlang", b_min=2)
    assert (spec.lam, spec.b_min, spec.b_max, spec.w2, spec.s_max, spec.c_o) == (
        want.lam, want.b_min, want.b_max, want.w2, want.s_max, want.c_o)


@pytest.mark.parametrize("name", ["fig3_policies", "appE_structure_breaks", "fig9_cov"])
def test_cli_prints_the_benchmarks_derived_column(name, capsys):
    _benchmark(name).run(smoke=True)
    want = capsys.readouterr().out.splitlines()
    P.main(["--only", name, "--smoke", "--device", CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"

    def strip(rows):  # name and derived, without the timing column
        return [(r.split(",", 2)[0], r.split(",", 2)[2]) for r in rows]

    assert strip(lines[1:]) == strip(want)
    assert all(float(r.split(",", 2)[1]) > 0 for r in lines[1:])
