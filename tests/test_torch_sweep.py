"""Port vs reference: batched sweeps, scheduler banks and the Fig. 5 curve.

The cases of tests/test_sweep.py (serial equivalence, padding, the b_max
mismatch, auto-grow, policy structure, the scheduler bank) on the port,
each held against the reference's own result for the same specs (crossed
over by interop.spec_from_reference): the same final s_max, policies equal
to the reference's sweep and to its scalar float64 ``solve()`` oracle, and
W / P / g within rtol 1e-9.  Then the slice end to end on the CPU:
``sweep_bank`` -> ``SMDPSchedulerBank.scheduler`` -> the compiled serving
engine, and the port of examples/tradeoff_sweep.py.

Iteration counts are not compared: the default sweep path has a float32
coarse phase, whose sums torch and XLA take in different orders (see
tests/test_torch_accel.py).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ConstantProfile,
    ServiceModel,
    SMDPSpec,
    pad_specs,
    solve,
    sweep_solve,
)
from repro.core import tradeoff as ref_tradeoff
from repro.core.sweep import sweep_bank as ref_sweep_bank
from repro.serving import SMDPScheduler as RefScheduler
from repro_torch import core as pt
from repro_torch import interop
from repro_torch import serving as ps
from repro_torch.core import tradeoff as pt_tradeoff
from repro_torch.core.policies import is_control_limit
from repro_torch.launch import tradeoff_sweep

CPU = "cpu"


def spec_for(rho=0.3, w2=1.0, s_max=64, b_max=16, family="det", latency=None):
    svc = ServiceModel(latency=latency or GOOGLENET_P4_LATENCY, family=family)
    lam = rho * b_max / float(svc.mean(b_max))
    return SMDPSpec(
        lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY,
        b_min=1, b_max=b_max, w1=1.0, w2=w2, s_max=s_max, c_o=100.0,
    )


def port(specs):
    return [interop.spec_from_reference(sp) for sp in specs]


def assert_same_solution(got, want, rtol=1e-9):
    """A port SolveResult against a reference one (sweep or scalar)."""
    assert got.spec.s_max == want.spec.s_max
    assert got.spec.c_o == want.spec.c_o
    assert np.array_equal(got.policy, want.policy), got.spec.w2
    for f in ("g", "w_bar", "p_bar"):
        np.testing.assert_allclose(getattr(got.eval, f), getattr(want.eval, f),
                                   rtol=rtol, err_msg=f)


W2_GRID = [float(w) for w in np.linspace(0.0, 15.0, 16)]


class TestSerialEquivalence:
    def test_w2_grid_matches_serial_solve_and_reference_sweep(self):
        base = spec_for(rho=0.3)
        specs = [dataclasses.replace(base, w2=w2) for w2 in W2_GRID]
        got = pt.sweep_solve(port(specs), device=CPU)
        want = sweep_solve(specs)
        assert len(got) == len(specs)
        for sp, g, w in zip(specs, got, want):
            assert_same_solution(g, w)
            assert_same_solution(g, solve(sp))
            # the batched RVI's own gain estimate is eps-close to serial's
            np.testing.assert_allclose(g.rvi.g, w.rvi.g, rtol=1e-3)

    def test_mixed_s_max_is_padded(self):
        base = spec_for(rho=0.3)
        specs = [
            dataclasses.replace(base, w2=w2, s_max=s)
            for w2, s in [(0.0, 48), (1.0, 64), (5.0, 56)]
        ]
        padded = pt.pad_specs(port(specs))
        assert [sp.s_max for sp in padded] == [sp.s_max for sp in pad_specs(specs)]
        assert all(sp.s_max == 64 for sp in padded)
        for sp, res in zip(pad_specs(specs), pt.sweep_solve(port(specs), device=CPU)):
            assert_same_solution(res, solve(sp))

    def test_b_max_mismatch_rejected(self):
        specs = [spec_for(), spec_for(b_max=8)]
        with pytest.raises(ValueError, match="b_max") as want:
            sweep_solve(specs)
        with pytest.raises(ValueError, match="b_max") as got:
            pt.sweep_solve(port(specs), device=CPU)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("backup", ["banded", "pallas"])
    def test_auto_grow_matches_serial(self, backup):
        # rho high + tiny truncation: the delta rule must grow s_max
        base = spec_for(rho=0.85, s_max=16, b_max=16)
        specs = [dataclasses.replace(base, w2=w2) for w2 in (0.0, 1.0)]
        results = pt.sweep_solve(port(specs), delta=1e-3, backup=backup, device=CPU)
        for sp, res in zip(specs, results):
            serial = solve(sp, delta=1e-3)
            assert res.spec.s_max > 16
            assert res.eval.delta < 1e-3
            assert_same_solution(res, serial)


class TestPolicyStructure:
    def test_control_limit_and_monotone_in_w2(self):
        # Prop.-4 setting: size-independent exponential service
        base = spec_for(rho=0.5, b_max=8, s_max=64, family="expo",
                        latency=ConstantProfile(2.4252))
        specs = [dataclasses.replace(base, w2=w2) for w2 in np.linspace(0.0, 10.0, 11)]
        results = pt.sweep_solve(port(specs), device=CPU)
        want = sweep_solve(specs)
        qs, p_bars = [], []
        for res, w in zip(results, want):
            assert_same_solution(res, w)
            is_cl, q = is_control_limit(res.policy, res.spec.s_max, 8)
            assert is_cl, res.spec.w2
            qs.append(q)
            p_bars.append(res.eval.p_bar)
        assert all(q2 >= q1 for q1, q2 in zip(qs, qs[1:]))
        assert all(p2 <= p1 * (1.0 + 1e-4) for p1, p2 in zip(p_bars, p_bars[1:]))


@pytest.fixture(scope="module")
def bank_results():
    base = spec_for(rho=0.3, b_max=8, s_max=48)
    specs = [dataclasses.replace(base, w2=w2) for w2 in (0.0, 2.0, 8.0)]
    return pt.sweep_solve(port(specs), device=CPU), sweep_solve(specs)


class TestSchedulerBank:
    def test_bank_keys_and_nearest(self, bank_results):
        results, want = bank_results
        bank = ps.SMDPScheduler.bank(results)
        ref_bank = RefScheduler.bank(want)
        assert isinstance(bank, ps.SMDPSchedulerBank)
        assert len(bank) == len(ref_bank) == 3
        assert bank.keys() == ref_bank.keys()
        for k in bank.keys():
            np.testing.assert_array_equal(bank.tables[k], ref_bank.tables[k])
        lam = results[0].spec.lam
        assert bank.nearest(lam=lam, w2=1.9) == ref_bank.nearest(lam=lam, w2=1.9) == (lam, 2.0)
        assert bank.nearest(w2=100.0) == (lam, 8.0)
        assert bank.distance((lam, 2.0), w2=1.0) == ref_bank.distance((lam, 2.0), w2=1.0)
        with pytest.raises(ValueError):
            bank.nearest(nope=1.0)
        ks, stack = bank.stacked()
        ref_ks, ref_stack = ref_bank.stacked()
        assert ks == ref_ks
        np.testing.assert_array_equal(stack, ref_stack)

    def test_scheduler_hot_swap(self, bank_results):
        results, want = bank_results
        bank = ps.SMDPScheduler.bank(results)
        sch = bank.scheduler(w2=0.0)
        assert np.array_equal(sch.table, want[0].action_table())
        before = [sch.decide(s) for s in range(sch.s_max + 1)]
        key = sch.retune(w2=8.0)
        assert key[1] == 8.0
        assert np.array_equal(sch.table, want[2].action_table())
        after = [sch.decide(s) for s in range(sch.s_max + 1)]
        # a much higher energy price must not make batching less patient
        assert after != before

    def test_bank_requires_attachment(self, bank_results):
        results, _ = bank_results
        sch = ps.SMDPScheduler(results[0])
        with pytest.raises(RuntimeError):
            sch.retune(w2=1.0)

    def test_bank_rejects_duplicate_keys(self, bank_results):
        results, _ = bank_results
        with pytest.raises(ValueError, match="duplicate bank key"):
            ps.SMDPScheduler.bank([results[0], results[0]])
        bank = ps.SMDPScheduler.bank(
            [results[0], results[0]], keys=[(0.0,), (1.0,)], key_names=("profile",),
        )
        assert len(bank) == 2


def test_not_ported_options_raise():
    """checkpoint_dir= is still not ported (ROADMAP queue 1) and raises;
    phases= is, and its bank equals the reference's table for table."""
    from repro.core import PhaseConfig as RefPhaseConfig

    base = interop.spec_from_reference(spec_for())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.sweep_solve([base], checkpoint_dir="ckpt", device=CPU)
    ref_base = spec_for(w2=0.5, s_max=32)
    ph = RefPhaseConfig.mmpp2(0.5 * ref_base.lam, 2.0 * ref_base.lam, 400.0, 200.0)
    pph = pt.PhaseConfig(rates=ph.rates, gen=ph.gen)
    lams = [ph.mean_rate]
    got = pt.sweep_bank(interop.spec_from_reference(ref_base), lams, phases=pph, device=CPU)
    want = ref_sweep_bank(ref_base, lams, phases=ph)
    assert got.keys() == want.keys()
    for k in want.keys():
        np.testing.assert_array_equal(got.tables[k], want.tables[k])


def test_sweep_bank_serves_through_the_compiled_engine():
    """The slice end to end on the CPU: a lambda x w2 bank solved on the
    kernel path (its plain version here), equal to the reference's bank;
    the table it mints serves through the compiled engine decision for
    decision like the Python loop, near the analytic W and P."""
    base = spec_for(rho=0.5, b_max=16, s_max=64)
    svc = base.service
    lams = [r * 16 / float(svc.mean(16)) for r in (0.3, 0.6, 0.8)]
    w2s = [0.0, 1.6, 8.0]
    bank = pt.sweep_bank(interop.spec_from_reference(base), lams, w2s,
                         backup="pallas", device=CPU)
    ref_bank = ref_sweep_bank(base, lams, w2s)
    assert bank.keys() == ref_bank.keys() and len(bank) == 9
    for k in bank.keys():
        np.testing.assert_array_equal(bank.tables[k], ref_bank.tables[k])
    sch = bank.scheduler(lam=lams[1], w2=1.6)
    sol = pt.solve(interop.spec_from_reference(
        dataclasses.replace(base, lam=lams[1], w2=1.6)), device=CPU)
    np.testing.assert_array_equal(sch.table, sol.action_table())
    energy = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, 17)])
    psvc = interop.spec_from_reference(base).service
    eng = ps.ServingEngine(sch, lam=lams[1], b_max=16, service=psvc,
                           energy_table=energy, seed=0, device=CPU)
    rep = eng.run(20_000, backend="compiled")
    assert abs(rep.latencies.mean() - sol.eval.w_bar) < 0.05 * sol.eval.w_bar
    assert abs(rep.power - sol.eval.p_bar) < 0.05 * sol.eval.p_bar
    trace = np.cumsum(np.random.default_rng(2).exponential(1.0 / lams[1], 10_000))
    out = ps.verify_backends(sch.table, trace, service=psvc, energy_table=energy,
                             b_max=16, n_epochs=2_000, device=CPU)
    assert out["n_decisions"] > 0


class TestTradeoff:
    W2 = [0.0, 1.6, 8.0]

    def test_tradeoff_curve_and_cli_match_reference(self, capsys):
        spec = tradeoff_sweep.fig5_spec(rho=0.5, b_max=16)
        ref_spec = spec_for(rho=0.5, b_max=16, s_max=128, w2=0.0)
        assert interop.spec_from_reference(ref_spec) == dataclasses.replace(spec, c_o=100.0)
        want = ref_tradeoff.smdp_tradeoff_curve(ref_spec, self.W2)
        for backup in ("banded", "pallas"):
            got = pt_tradeoff.smdp_tradeoff_curve(spec, self.W2, backup=backup, device=CPU)
            for g, w in zip(got, want):
                assert g.w2 == w.w2 and np.array_equal(g.policy, w.policy)
                np.testing.assert_allclose([g.w_bar, g.p_bar, g.g],
                                           [w.w_bar, w.p_bar, w.g], rtol=1e-9)
        points = tradeoff_sweep.main(["--device", "cpu", "--rho", "0.5", "--b-max", "16",
                                      "--backup", "pallas", "--w2"]
                                     + [str(w) for w in self.W2])
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == "policy,w2,W_ms,P_watt"
        assert lines[1:4] == [f"smdp,{w.w2},{w.w_bar:.4f},{w.p_bar:.4f}" for w in want]
        bench = ref_tradeoff.benchmark_points(ref_spec)
        assert lines[4:] == [f"{n},,{w:.4f},{p:.4f}" for n, (w, p) in bench.items()]
        assert len(points) == 3

    def test_cost_grid_and_serial_match_reference(self):
        ref_spec = spec_for(rho=0.4, b_max=16, s_max=64, w2=0.0)
        spec = interop.spec_from_reference(ref_spec)
        got = pt_tradeoff.average_cost_grid(spec, self.W2, static_sizes=(4, 8, 16), device=CPU)
        want = ref_tradeoff.average_cost_grid(ref_spec, self.W2, static_sizes=(4, 8, 16))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9)
        serial = pt_tradeoff.solve_serial(spec, self.W2, device=CPU)
        for g, w in zip(serial, ref_tradeoff.solve_serial(ref_spec, self.W2)):
            assert_same_solution(g, w)
            assert g.rvi.iterations == w.rvi.iterations  # the f64 scalar loop
