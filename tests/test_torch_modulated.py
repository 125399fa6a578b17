"""Port vs reference: the exact phase-modulated (MMPP-aware) solve.

The port runs with device="cpu" (float64 torch ops, as on the card); the
reference runs its jitted float64 loops on the same numpy inputs.  Held:

* the K = 1 solve_modulated against the port's scalar solve(): policy
  equal, g and W at rtol 1e-9 (the reference's own bar,
  tests/test_modulated.py);
* the K = 2 solve, MPI and plain, against repro.core.solve_modulated:
  policies, s_max and iteration counts equal, g / W / P at rtol 1e-9 (both
  sum the phase-coupled correlation in float64, in other orders: the span
  residuals differ in the last bits, never across a threshold here);
* relative_value_iteration_modulated row for row (h at atol 1e-9, the
  accept / reject counts of the MPI polish exact), its guard ladder's
  report, the backup and the policy matrix at rtol 1e-12;
* sweep_solve_modulated against the serial solves in input order and
  against the reference's sweep, sweep_bank(phases=) table for table;
* evaluate_policy_modulated(_batched) at rtol 1e-12;
* avi / api: equal policies, g at rtol 1e-12.

Sizes stay at b_max 16, s_max <= 64.
"""
import numpy as np
import pytest
import torch

from repro.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    PhaseConfig as RefPhaseConfig,
    ServiceModel,
    SMDPSpec,
    build_smdp_modulated as ref_build_modulated,
    evaluate_policy_modulated as ref_eval_modulated,
    modulated_spec as ref_modulated_spec,
    solve_modulated as ref_solve_modulated,
    sweep_solve_modulated as ref_sweep_modulated,
)
from repro.core import evaluate as ref_evaluate
from repro.core import rvi as ref_rvi
from repro.core.sweep import sweep_bank as ref_sweep_bank
from repro_torch import core as pt
from repro_torch import interop
from repro_torch.core import evaluate as pe
from repro_torch.core import rvi as pr

CPU = "cpu"
SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
BMAX = 16


def spec_at(lam, w2=1.0, s_max=64):
    return SMDPSpec(lam=lam, service=SVC, energy=GOOGLENET_P4_ENERGY, b_min=1,
                    b_max=BMAX, w1=1.0, w2=w2, s_max=s_max)


def rho_lam(rho):
    return rho * BMAX / float(SVC.mean(BMAX))


def ref_mmpp(r1=0.15, r2=0.75, d1=600.0, d2=300.0):
    return RefPhaseConfig.mmpp2(rho_lam(r1), rho_lam(r2), d1, d2)


def fast_mixing_mmpp():
    """Short dwells: the plain lockstep loop converges in a few hundred
    backups instead of thousands, so the accel="none" comparisons stay
    cheap."""
    return ref_mmpp(0.15, 0.6, 60.0, 30.0)


def port_phases(ph):
    return pt.PhaseConfig(rates=tuple(ph.rates), gen=tuple(map(tuple, ph.gen)))


def port_spec(spec):
    return interop.spec_from_reference(spec)


def _same_eval(got, want, rtol):
    for k in ("g", "w_bar", "p_bar", "delta", "mean_batch", "throughput"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=rtol,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("rho", [0.3, 0.7])
def test_k1_equals_the_scalar_solve(rho):
    spec = port_spec(spec_at(rho_lam(rho)))
    scalar = pt.solve(spec, device=CPU)
    mod = pt.solve_modulated(spec, pt.PhaseConfig.poisson(spec.lam), device=CPU)
    assert mod.spec.s_max == scalar.spec.s_max
    np.testing.assert_array_equal(mod.policy[0], scalar.policy)
    np.testing.assert_allclose(mod.eval.g, scalar.eval.g, rtol=1e-9)
    np.testing.assert_allclose(mod.eval.w_bar, scalar.eval.w_bar, rtol=1e-9)
    assert mod.action_table().shape == (1, mod.spec.s_max + 1)


def test_k1_accel_none_equals_the_scalar_solve():
    spec = port_spec(spec_at(rho_lam(0.5)))
    scalar = pt.solve(spec, device=CPU)
    mod = pt.solve_modulated(spec, pt.PhaseConfig.poisson(spec.lam), accel="none",
                             device=CPU)
    np.testing.assert_array_equal(mod.policy[0], scalar.policy)


@pytest.mark.parametrize("accel", ["none", "mpi"])
def test_k2_solve_equals_the_reference(accel):
    ph = ref_mmpp() if accel == "mpi" else fast_mixing_mmpp()
    spec = ref_modulated_spec(spec_at(1.0, w2=0.5), ph)
    want = ref_solve_modulated(spec, ph, accel=accel)
    got = pt.solve_modulated(port_spec(spec), port_phases(ph), accel=accel, device=CPU)
    assert got.spec.s_max == want.spec.s_max
    assert got.rvi.iterations == want.rvi.iterations
    np.testing.assert_array_equal(got.policy, want.policy)
    np.testing.assert_array_equal(got.action_table(), want.action_table())
    _same_eval(got.eval, want.eval, rtol=1e-9)
    # the burst phase batches differently from the quiet one
    assert not np.array_equal(got.policy[0], got.policy[1])


@pytest.mark.parametrize("accel", ["none", "mpi"])
def test_rvi_modulated_row_for_row(accel):
    ph = ref_mmpp(0.2, 0.8) if accel == "mpi" else fast_mixing_mmpp()
    specs = [ref_modulated_spec(spec_at(1.0, w2=w, s_max=48), p)
             for w, p in ((0.5, ph), (2.0, ph.scaled(0.8)))]
    phs = [ph, ph.scaled(0.8)]
    mb_ref = ref_build_modulated_batched(specs, phs)
    mb = pt.build_smdp_modulated_batched([port_spec(s) for s in specs],
                                         [port_phases(p) for p in phs])
    want = ref_rvi.relative_value_iteration_modulated(mb_ref, accel=accel)
    got = pt.relative_value_iteration_modulated(mb, accel=accel, device=CPU)
    assert got.accel == want.accel == accel
    np.testing.assert_array_equal(got.policies, want.policies)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_allclose(got.g, want.g, rtol=1e-12)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=0, atol=1e-9)
    if accel == "mpi":
        np.testing.assert_array_equal(got.accel_accepts, want.accel_accepts)
        np.testing.assert_array_equal(got.accel_rejects, want.accel_rejects)


def ref_build_modulated_batched(specs, phs):
    from repro.core import build_smdp_modulated_batched

    return build_smdp_modulated_batched(specs, phs)


def test_guard_ladder_heals_a_poisoned_warm_start_as_the_reference():
    ph = fast_mixing_mmpp()
    spec = ref_modulated_spec(spec_at(1.0, w2=0.5, s_max=40), ph)
    mb_ref = ref_build_modulated(spec, ph)
    mb = pt.build_smdp_modulated(port_spec(spec), port_phases(ph))
    h0 = np.full((1, 2, 42), np.nan)
    want = ref_rvi.relative_value_iteration_modulated(mb_ref, accel="mpi", h0=h0, guard=True)
    got = pt.relative_value_iteration_modulated(mb, accel="mpi", h0=h0, guard=True,
                                                device=CPU)
    assert got.report.rungs == want.report.rungs == {"plain_restart": [0]}
    assert got.report.quarantined == want.report.quarantined == []
    np.testing.assert_array_equal(got.report.healthy, want.report.healthy)
    np.testing.assert_array_equal(got.policies, want.policies)
    np.testing.assert_allclose(got.g, want.g, rtol=1e-12)


def test_backup_and_policy_matrix_equal_the_reference():
    ph = ref_mmpp()
    spec = ref_modulated_spec(spec_at(1.0, w2=0.5, s_max=32), ph)
    mb = ref_build_modulated(spec, ph)
    rng = np.random.default_rng(0)
    K, S = mb.n_phases, mb.n_states
    h = rng.normal(size=(K, S))
    band = ref_rvi.trimmed_band_modulated(mb.pmfs_banded)
    assert pr.trimmed_band_modulated(mb.pmfs_banded) == band
    ins = (mb.c_tilde[0], mb.pmfs_banded[0, ..., :band], mb.tails[0], mb.wait_m[0],
           mb.scale[0])
    want = np.asarray(ref_rvi.banded_backup_modulated(*ins, mb.s_max, h))
    t = [torch.as_tensor(x) for x in ins]
    got = pr.banded_backup_modulated(*t, mb.s_max, torch.as_tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    pol = np.asarray(want.argmin(-1))
    m_want = np.asarray(ref_evaluate.policy_matrix_banded_modulated(
        *ins[1:], mb.s_max, pol))
    m_got = pe.policy_matrix_banded_modulated(
        *(x[None] for x in t[1:]), mb.s_max, torch.as_tensor(pol)[None])[0].numpy()
    np.testing.assert_allclose(m_got, m_want, rtol=1e-12, atol=0)


def test_sweep_equals_serial_solves_and_the_reference():
    ph = ref_mmpp()
    base = spec_at(1.0, w2=0.5, s_max=48)
    pairs = [(ref_modulated_spec(base, p), p) for p in (ph.scaled(f) for f in (1.2, 0.6, 1.0))]
    want = ref_sweep_modulated([s for s, _ in pairs], [p for _, p in pairs])
    sink = []
    got = pt.sweep_solve_modulated([port_spec(s) for s, _ in pairs],
                                   [port_phases(p) for _, p in pairs],
                                   report_sink=sink, device=CPU)
    assert not sink[0].any_fired and sink[0].healthy.all()
    for (sp, p), g, w in zip(pairs, got, want):
        assert g.spec.lam == sp.lam and g.spec.s_max == w.spec.s_max
        np.testing.assert_array_equal(g.action_table(), w.action_table())
        _same_eval(g.eval, w.eval, rtol=1e-9)
        serial = pt.solve_modulated(port_spec(sp), port_phases(p), device=CPU)
        np.testing.assert_array_equal(g.action_table(), serial.action_table())


def test_sweep_bank_phases_equals_the_reference():
    ph = ref_mmpp(0.1, 0.7)
    base = spec_at(1.0, w2=0.5, s_max=40)
    lams = [0.8 * ph.mean_rate, 1.2 * ph.mean_rate]
    want = ref_sweep_bank(base, lams, [0.5, 2.0], phases=ph)
    got = pt.sweep_bank(port_spec(base), lams, [0.5, 2.0], phases=port_phases(ph),
                        device=CPU)
    assert got.keys() == want.keys() and got.key_names == ("lam", "w2")
    for k in want.keys():
        assert got.tables[k].shape == (2, 41)
        np.testing.assert_array_equal(got.tables[k], want.tables[k])
    with pytest.raises(ValueError, match="mutually exclusive"):
        pt.sweep_bank(port_spec(base), lams, phases=port_phases(ph), profiles={0: {}},
                      device=CPU)


def test_evaluate_modulated_equals_the_reference():
    ph = ref_mmpp()
    spec = ref_modulated_spec(spec_at(1.0, w2=0.5, s_max=48), ph)
    mb_ref = ref_build_modulated(spec, ph)
    mb = pt.build_smdp_modulated(port_spec(spec), port_phases(ph))
    from repro.core.policies import q_policy

    pol = np.stack([q_policy(3, 48, BMAX), q_policy(9, 48, BMAX)])  # (K, S)
    _same_eval(pt.evaluate_policy_modulated(mb, 0, pol),
               ref_eval_modulated(mb_ref, 0, pol), rtol=1e-12)
    batched = pe.evaluate_policy_modulated_batched(mb, pol[None])
    _same_eval(batched[0], ref_evaluate.evaluate_policy_modulated_batched(
        mb_ref, pol[None])[0], rtol=1e-12)
    with pytest.raises(ValueError, match="infeasible"):
        bad = pol.copy()
        bad[0, 0] = 5  # serve 5 from an empty queue
        pt.evaluate_policy_modulated(mb, 0, bad)


@pytest.mark.parametrize("algo", ["avi", "api"])
def test_appendix_f_baselines_equal_the_reference(algo):
    spec = spec_at(rho_lam(0.5), s_max=40)
    kw = dict(n_outer=60, eval_s_max=40) if algo == "avi" else dict(n_outer=4, eval_s_max=40)
    want = getattr(ref_rvi, algo)(spec, **kw)
    got = getattr(pr, algo)(port_spec(spec), **kw)
    np.testing.assert_array_equal(got.policy, want.policy)
    np.testing.assert_allclose(got.g, want.g, rtol=1e-12)
    assert got.iterations == want.iterations


def test_checkpointed_modulated_sweep_equals_the_reference(tmp_path):
    """checkpoint_dir= on the modulated sweep: the port's checkpointed run
    equals the reference's checkpointed run (policies, s_max; g / W / P at
    rtol 1e-9), and a completed checkpoint restores bit for bit."""
    ph = fast_mixing_mmpp()
    ref_specs = [ref_modulated_spec(spec_at(1.0, w2=w, s_max=32), ph) for w in (0.5, 2.0)]
    specs = [port_spec(sp) for sp in ref_specs]
    d = str(tmp_path / "ck")
    kw = dict(chunk_size=1, delta=None)
    got = pt.sweep_solve_modulated(specs, port_phases(ph), checkpoint_dir=d, device=CPU,
                                   **kw)
    want = ref_sweep_modulated(ref_specs, ph, checkpoint_dir=str(tmp_path / "ref"), **kw)
    for a, b in zip(got, want):
        assert a.spec.s_max == b.spec.s_max
        np.testing.assert_array_equal(a.rvi.policy, b.rvi.policy)
        _same_eval(a.eval, b.eval, rtol=1e-9)
    again = pt.sweep_solve_modulated(specs, port_phases(ph), checkpoint_dir=d,
                                     device=CPU, **kw)
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.rvi.h, b.rvi.h)
        assert a.rvi.g == b.rvi.g


def test_dataclass_of_a_modulated_result():
    ph = ref_mmpp()
    spec = ref_modulated_spec(spec_at(1.0, w2=0.5, s_max=32), ph)
    got = pt.solve_modulated(port_spec(spec), port_phases(ph), device=CPU)
    assert isinstance(got, pt.ModulatedSolveResult)
    tab = got.action_table(40)
    assert tab.shape == (2, 41)
    s_max = got.spec.s_max
    np.testing.assert_array_equal(tab[:, s_max:], np.repeat(got.policy[:, s_max:s_max + 1],
                                                           41 - s_max, axis=1))
    assert got.action(1, s_max + 7) == got.policy[1, s_max]
