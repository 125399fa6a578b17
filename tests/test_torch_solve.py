"""Port vs reference: relative value iteration and solve() on the CPU.

Same problem in both packages (specs cross over through interop):

* banded / dense RVI (float64): policy equal, g within 1e-9 relative,
  iteration counts equal;
* the kernel path (backup="pallas", float32 core; the port's CPU plain
  version vs the reference's interpret-mode Pallas kernel): policy equal
  to the reference's pallas and banded results, g within eps;
* solve() with its auto-grown truncation: same s_max, policy equal, and
  W / P / g within 1e-9 relative.
"""
import numpy as np
import pytest
import torch

from repro.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ServiceModel,
    SMDPSpec,
    build_smdp,
    relative_value_iteration,
    solve,
)
from repro.core import rvi as ref_rvi
from repro_torch import interop
from repro_torch import core as pt
from repro_torch.core import rvi as pt_rvi


def paper_spec(rho=0.7, w2=1.6, s_max=128, b_max=32):
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    lam = rho * b_max / float(svc.mean(b_max))
    return SMDPSpec(lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY,
                    b_min=1, b_max=b_max, w1=1.0, w2=w2, s_max=s_max)


def _port_mdp(ref_spec):
    return pt.build_smdp(interop.spec_from_reference(ref_spec))


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("backup,spec_kw", [
    ("banded", dict()),  # the quickstart / Table-I point
    ("banded", dict(rho=0.9, w2=1.0, s_max=70)),
    ("dense", dict(rho=0.5, w2=1.0, s_max=64)),
])
def test_rvi_float64_matches_reference(backup, spec_kw):
    spec = paper_spec(**spec_kw)
    want = relative_value_iteration(build_smdp(spec), backup=backup)
    got = pt.relative_value_iteration(_port_mdp(spec), backup=backup, device="cpu")
    assert np.array_equal(got.policy, want.policy)
    assert got.policy.dtype == np.int64
    assert got.iterations == want.iterations
    assert _rel(got.g, want.g) < 1e-9
    np.testing.assert_allclose(got.h, want.h, rtol=1e-9, atol=1e-9)
    assert got.converged == want.converged


def test_rvi_kernel_path_matches_reference():
    """The test_kernels.py spec: rho = 0.3, s_max = 48, w2 = 1."""
    spec = paper_spec(rho=0.3, w2=1.0, s_max=48)
    mdp = build_smdp(spec)
    want_banded = relative_value_iteration(mdp, backup="banded")
    want_pallas = relative_value_iteration(mdp, backup="pallas", max_iter=2000)
    got = pt.relative_value_iteration(_port_mdp(spec), backup="pallas",
                                      max_iter=2000, device="cpu")
    assert np.array_equal(got.policy, want_pallas.policy)
    assert np.array_equal(got.policy, want_banded.policy)
    assert abs(got.g - want_pallas.g) < 1e-2  # eps
    assert abs(got.g - want_banded.g) < 1e-2


def test_single_backups_match_reference():
    spec = paper_spec(s_max=40)
    mdp = build_smdp(spec)
    pm, tails, scale = ref_rvi.make_banded_inputs(mdp)
    h = np.random.default_rng(0).normal(size=mdp.n_states) * 5
    want = np.asarray(ref_rvi.banded_backup(
        np.asarray(mdp.c_tilde), pm, tails, scale, spec.s_max, h))
    want_p = np.asarray(ref_rvi.pallas_backup(
        np.asarray(mdp.c_tilde), pm, tails, scale, spec.s_max, h))
    want_d = np.asarray(ref_rvi.dense_backup(mdp.c_tilde, mdp.m_tilde, h))

    pmdp = _port_mdp(spec)
    cpu = torch.device("cpu")
    t_pm, t_tails, t_scale = pt_rvi.make_banded_inputs(pmdp, device=cpu)
    for mine, theirs in zip((t_pm, t_tails, t_scale), (pm, tails, scale)):
        assert mine.dtype == torch.float64
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    c = torch.as_tensor(pmdp.c_tilde)
    th = torch.as_tensor(h)
    got = pt_rvi.banded_backup(c, t_pm, t_tails, t_scale, spec.s_max, th).numpy()
    got_p = pt_rvi.pallas_backup(c, t_pm, t_tails, t_scale, spec.s_max, th).numpy()
    got_d = pt_rvi.dense_backup(c, torch.as_tensor(pmdp.m_tilde), th).numpy()
    feas = np.isfinite(want)
    assert np.array_equal(feas, np.isfinite(got)) and np.array_equal(feas, np.isfinite(got_p))
    np.testing.assert_allclose(got[feas], want[feas], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_d[feas], want_d[feas], rtol=1e-12, atol=1e-12)
    # the f32 kernel core: its plain version vs the interpret-mode kernel
    np.testing.assert_allclose(got_p[feas], want_p[feas], rtol=1e-5, atol=1e-4)
    assert pt_rvi.trimmed_band(pmdp.arrival_pmfs) == ref_rvi.trimmed_band(mdp.arrival_pmfs)


@pytest.mark.parametrize("spec_kw,backup", [
    (dict(), "banded"),  # Table-I (rho = 0.7, w2 = 1.6): s_max stays 128
    (dict(), "pallas"),
    (dict(rho=0.9, w2=1.0, s_max=48), "banded"),  # grows s_max
])
def test_solve_matches_reference(spec_kw, backup):
    spec = paper_spec(**spec_kw)
    want = solve(spec, backup=backup)
    got = pt.solve(interop.spec_from_reference(spec), backup=backup, device="cpu")
    assert got.spec.s_max == want.spec.s_max
    assert got.spec.c_o == want.spec.c_o
    assert np.array_equal(got.policy, want.policy)
    assert np.array_equal(got.action_table(48), want.action_table(48))
    assert _rel(got.eval.w_bar, want.eval.w_bar) < 1e-9
    assert _rel(got.eval.p_bar, want.eval.p_bar) < 1e-9
    assert _rel(got.eval.g, want.eval.g) < 1e-9
    if backup == "banded":
        assert _rel(got.rvi.g, want.rvi.g) < 1e-9
    else:  # the f32 kernel core, summed in another order: g within eps
        assert abs(got.rvi.g - want.rvi.g) < 1e-2


def test_accelerated_rvi_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.relative_value_iteration(_port_mdp(paper_spec(s_max=40)),
                                    accel="mpi", device="cpu")


def test_table1_anchor_through_the_kernel_path():
    """Paper Table I (SMDP, w2 = 1.6): P = 44.96 W, W = 6.90 ms."""
    res = pt.solve(interop.spec_from_reference(paper_spec()), backup="pallas",
                   device="cpu")
    np.testing.assert_allclose(res.eval.p_bar, 44.96, atol=0.05)
    np.testing.assert_allclose(res.eval.w_bar, 6.90, atol=0.02)
