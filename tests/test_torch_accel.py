"""Port vs reference: the batched and accelerated RVI on the CPU.

The same specs go through both packages (interop.spec_from_reference); the
reference's Pallas kernel runs in interpret mode, the port's kernel path
(``backup="pallas"``) runs the kernel's CPU plain version.  Bars:

* policies equal to the reference's and to the scalar f64 ``solve()``
  oracle; the accelerated g within 1e-6 of the oracle (the bar of
  tests/test_accel.py);
* equal iteration counts on the float64-only paths (``mixed_precision=
  False``) of the plain and MPI loops, where both packages do the same
  f64 arithmetic;
* no exact iteration-count bar on paths with a float32 phase: torch and
  XLA sum the f32 correlation (and the f32 Gram / linear solves of the
  accelerants) in different orders, so a coarse phase may stop a few
  backups apart; those paths are held to policy equality and g within
  the reference's tolerances;
* Anderson, even in float64, within 2% of the reference's counts: its
  secant step solves a Gram system regularized at only 1e-8 of its
  trace, which amplifies last-bit differences of the two packages' f64
  sums into a spec stopping a backup early or late (seen: 302 vs 301
  backups at rho = 0.7, s_max = 64).  At rho = 0.85 the safeguarded
  count is chaotic in the reference itself (383 backups from h0 = 0,
  306 to 453 from starts perturbed by 1e-13), and the unsafeguarded
  variant is divergent by design, so there only convergence, policies
  and the qualitative failure are compared;
* the guard ladder: the same SolveReport rungs and quarantined rows.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ServiceModel,
    SMDPSpec,
    build_smdp,
    build_smdp_batched,
    relative_value_iteration,
    relative_value_iteration_batched,
    solve,
    sweep_solve,
)
from repro.core import evaluate as ref_eval
from repro.core.policies import greedy_policy
from repro_torch import core as pt
from repro_torch import interop
from repro_torch.core import evaluate as pt_eval
from repro_torch.core import rvi as pt_rvi

CPU = "cpu"


def spec_for(rho=0.3, w2=1.0, s_max=96, b_max=32, family="det"):
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family=family)
    lam = rho * b_max / float(svc.mean(b_max))
    return SMDPSpec(
        lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY,
        b_min=1, b_max=b_max, w1=1.0, w2=w2, s_max=s_max, c_o=100.0,
    )


def port(specs):
    return [interop.spec_from_reference(sp) for sp in specs]


def port_batch(specs):
    return pt.build_smdp_batched(port(specs))


W2S = (0.0, 1.0, 5.0)


@pytest.fixture(scope="module")
def grids():
    """Per rho: the reference batch, the port batch and the scalar f64
    oracle of every spec (computed once for the module)."""
    out = {}
    for rho in (0.3, 0.7, 0.9):
        base = spec_for(rho=rho, s_max=96, b_max=16)
        specs = [dataclasses.replace(base, w2=w) for w in W2S]
        oracles = [solve(sp, auto_c_o=False, delta=None) for sp in specs]
        out[rho] = (specs, build_smdp_batched(specs), port_batch(specs), oracles)
    return out


class TestAccelOracleGrid:
    @pytest.mark.parametrize("rho", [0.3, 0.7, 0.9])
    @pytest.mark.parametrize("accel", ["mpi", "anderson"])
    def test_matches_scalar_oracle_and_reference(self, grids, rho, accel):
        specs, ref_batch, batch, oracles = grids[rho]
        res = pt.relative_value_iteration_batched(batch, accel=accel, device=CPU)
        want = relative_value_iteration_batched(ref_batch, accel=accel)
        assert res.converged.all()
        assert res.accel == accel
        np.testing.assert_array_equal(res.policies, want.policies)
        for i, oracle in enumerate(oracles):
            assert np.array_equal(res.policies[i], oracle.policy), (rho, specs[i].w2)
            assert abs(res.g[i] - oracle.eval.g) < 1e-6

    def test_scalar_entry_point(self):
        sp = spec_for(rho=0.7, s_max=64, b_max=16)
        oracle = solve(sp, auto_c_o=False, delta=None)
        psp = interop.spec_from_reference(sp)
        mdp = pt.build_smdp(psp)
        for accel in ("mpi", "anderson"):
            res = pt.solve(psp, auto_c_o=False, delta=None, accel=accel, device=CPU)
            assert np.array_equal(res.policy, oracle.policy)
            assert abs(res.rvi.g - oracle.eval.g) < 1e-6
            assert res.rvi.converged
            # the scalar entry point (N = 1, float64) against the reference's
            want = relative_value_iteration(build_smdp(sp), accel=accel)
            got = pt.relative_value_iteration(mdp, accel=accel, device=CPU)
            assert np.array_equal(got.policy, want.policy)
            assert got.iterations == want.iterations
            assert abs(got.g - want.g) < 1e-9 * abs(want.g)
        with pytest.raises(ValueError, match="banded"):
            pt.relative_value_iteration(mdp, accel="mpi", backup="dense", device=CPU)

    def test_sweep_solve_accel_matches_plain(self):
        # accel="auto" -> "mpi" at this rho: the same solved sweep as the
        # plain path, auto-grow rounds included, and as the reference's
        base = spec_for(rho=0.85, s_max=32, b_max=16)
        specs = [dataclasses.replace(base, w2=w) for w in (0.0, 2.0)]
        plain = pt.sweep_solve(port(specs), accel="none", device=CPU)
        accel = pt.sweep_solve(port(specs), device=CPU)  # default "auto"
        want = sweep_solve(specs)
        for p, a, w in zip(plain, accel, want):
            assert p.spec.s_max == a.spec.s_max == w.spec.s_max
            assert np.array_equal(p.policy, a.policy)
            assert np.array_equal(a.policy, w.policy)
            np.testing.assert_allclose(p.eval.g, a.eval.g, rtol=1e-9)
            np.testing.assert_allclose(a.eval.g, w.eval.g, rtol=1e-9)


@pytest.mark.parametrize("accel", ["none", "mpi", "anderson"])
def test_float64_paths_match_reference_iteration_for_iteration(accel):
    """Single-phase float64: the same backups as the reference, so the
    same per-spec iteration counts (Anderson within 2%, see the module
    docstring), policies, and g to 1e-9."""
    base = spec_for(rho=0.7, s_max=64, b_max=16)
    specs = [dataclasses.replace(base, w2=w) for w in W2S]
    want = relative_value_iteration_batched(
        build_smdp_batched(specs), accel=accel, mixed_precision=False)
    got = pt.relative_value_iteration_batched(
        port_batch(specs), accel=accel, mixed_precision=False, device=CPU)
    np.testing.assert_array_equal(got.policies, want.policies)
    np.testing.assert_allclose(got.g, want.g, rtol=1e-9)
    np.testing.assert_array_equal(got.converged, want.converged)
    if accel == "anderson":
        np.testing.assert_allclose(got.iterations, want.iterations, rtol=0.02)
    else:
        np.testing.assert_array_equal(got.iterations, want.iterations)
    if accel == "mpi":
        np.testing.assert_array_equal(got.accel_accepts, want.accel_accepts)
        np.testing.assert_array_equal(got.accel_rejects, want.accel_rejects)


class TestIterationRegression:
    def test_mpi_beats_plain_by_3x_at_high_rho(self):
        base = spec_for(rho=0.85, s_max=128, b_max=32)
        specs = [dataclasses.replace(base, w2=w) for w in W2S]
        batch = port_batch(specs)
        plain = pt.relative_value_iteration_batched(batch, accel="none", device=CPU)
        mpi = pt.relative_value_iteration_batched(batch, accel="mpi", device=CPU)
        assert plain.converged.all() and mpi.converged.all()
        assert np.array_equal(plain.policies, mpi.policies)
        assert mpi.iterations.max() <= plain.iterations.max() / 3, (
            plain.iterations, mpi.iterations
        )
        want = relative_value_iteration_batched(build_smdp_batched(specs), accel="mpi")
        np.testing.assert_array_equal(mpi.policies, want.policies)


class TestAndersonSafeguard:
    def test_unsafeguarded_secant_increases_span_and_stalls(self):
        sp = spec_for(rho=0.85, w2=1.0, s_max=96)
        ref_batch = build_smdp_batched([sp])
        batch = port_batch([sp])
        kw = dict(accel="anderson", mixed_precision=False)
        unsafe = pt.relative_value_iteration_batched(
            batch, accel_safeguard=False, max_iter=600, device=CPU, **kw)
        # the unsafeguarded path TAKES span-increasing secant steps ...
        assert int(unsafe.accel_rejects[0]) > 0
        # ... and fails to converge within a budget the safe path beats
        assert not unsafe.converged[0]
        safe = pt.relative_value_iteration_batched(batch, device=CPU, **kw)
        assert safe.converged[0]
        assert int(safe.accel_rejects[0]) > 0
        assert int(safe.iterations[0]) < 600
        oracle = solve(sp, auto_c_o=False, delta=None)
        assert np.array_equal(safe.policies[0], oracle.policy)
        # the reference fails and recovers the same way (counts: see the
        # module docstring)
        want_unsafe = relative_value_iteration_batched(
            ref_batch, accel_safeguard=False, max_iter=600, **kw)
        want_safe = relative_value_iteration_batched(ref_batch, **kw)
        assert not want_unsafe.converged[0] and int(want_unsafe.accel_rejects[0]) > 0
        assert want_safe.converged[0]
        np.testing.assert_array_equal(safe.policies, want_safe.policies)


class TestMPIBuildingBlocks:
    def _batch(self):
        specs = [
            spec_for(rho=0.4, w2=0.5, s_max=48, b_max=16),
            spec_for(rho=0.7, w2=3.0, s_max=48, b_max=16, family="expo"),
        ]
        return build_smdp_batched(specs), port_batch(specs), specs

    def _policies(self, specs, S, seed):
        rng = np.random.default_rng(seed)
        pols = []
        for sp in specs:
            s_val = np.minimum(np.arange(S), sp.s_max)
            pol = np.where(rng.random(S) < 0.4, 0, rng.integers(1, 17, S))
            pols.append(np.minimum(pol, s_val).astype(np.int64))
        return np.stack(pols)

    @pytest.mark.parametrize("trim", [False, True])
    def test_policy_matrix_matches_reference(self, trim):
        ref_batch, batch, specs = self._batch()
        pm = batch.pmfs_banded
        kb = pt_rvi.trimmed_band(pm) if trim else pm.shape[-1]
        pols = self._policies(specs, batch.n_states, 1)
        got = pt_eval.policy_matrix_banded(
            torch.as_tensor(pm[:, :, :kb]), torch.as_tensor(batch.tails),
            torch.as_tensor(batch.scale), specs[0].s_max, torch.as_tensor(pols),
        ).numpy()
        for i in range(batch.n_specs):
            want = np.asarray(ref_eval.policy_matrix_banded(
                jnp.asarray(ref_batch.pmfs_banded[i, :, :kb]),
                jnp.asarray(ref_batch.tails[i]), jnp.asarray(ref_batch.scale[i]),
                specs[i].s_max, jnp.asarray(pols[i])))
            np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-15)
            dense = batch.m_tilde_dense(i)[np.arange(batch.n_states), pols[i], :]
            np.testing.assert_allclose(got[i], dense, atol=1e-12)

    def test_linear_eval_matches_reference_and_stationary_eval(self):
        ref_batch, batch, specs = self._batch()
        S = batch.n_states
        pols = np.stack([greedy_policy(sp.s_max, sp.b_min, sp.b_max) for sp in specs])
        m_pi = pt_eval.policy_matrix_banded(
            torch.as_tensor(batch.pmfs_banded), torch.as_tensor(batch.tails),
            torch.as_tensor(batch.scale), specs[0].s_max, torch.as_tensor(pols))
        c_pi = torch.as_tensor(np.take_along_axis(batch.c_tilde, pols[..., None], -1)[..., 0])
        g, h = pt_eval.policy_eval_linear(c_pi, m_pi)
        for i, sp in enumerate(specs):
            want_g, want_h = ref_eval.policy_eval_linear(
                jnp.asarray(ref_batch.c_tilde[i][np.arange(S), pols[i]]),
                jnp.asarray(m_pi[i].numpy()))
            np.testing.assert_allclose(float(g[i]), float(want_g), rtol=1e-12)
            np.testing.assert_allclose(h[i].numpy(), np.asarray(want_h), rtol=1e-9, atol=1e-9)
            assert float(h[i, 0]) == 0.0  # gauge pinned
            # the DTMDP gain of a policy equals its SMDP gain (eq. 21/25)
            ev = pt_eval.evaluate_policy_banded(batch, i, pols[i])
            np.testing.assert_allclose(float(g[i]), ev.g, rtol=1e-9)

    def test_singular_policy_surfaces_as_nan(self):
        # a policy that never serves has no unichain structure: the gauge
        # system is singular, and the row must come back non-finite
        _, batch, specs = self._batch()
        pols = np.zeros((batch.n_specs, batch.n_states), dtype=np.int64)
        m_pi = pt_eval.policy_matrix_banded(
            torch.as_tensor(batch.pmfs_banded), torch.as_tensor(batch.tails),
            torch.as_tensor(batch.scale), specs[0].s_max, torch.as_tensor(pols))
        m_pi[0] = torch.eye(batch.n_states, dtype=m_pi.dtype)
        c_pi = torch.ones((batch.n_specs, batch.n_states), dtype=torch.float64)
        g, h = pt_eval.policy_eval_linear(c_pi, m_pi)
        assert not np.isfinite(g[0].item()) and not torch.isfinite(h[0]).all()


class TestBatchedEvalInfrastructure:
    def _batch(self):
        specs = [
            spec_for(rho=0.3, w2=0.0, s_max=48, b_max=16),
            spec_for(rho=0.6, w2=2.0, s_max=48, b_max=16, family="erlang"),
            spec_for(rho=0.8, w2=5.0, s_max=48, b_max=16),
        ]
        return build_smdp_batched(specs), port_batch(specs), specs

    def test_stationary_batched_matches_reference(self):
        ref_batch, batch, specs = self._batch()
        pols = np.stack([greedy_policy(sp.s_max, sp.b_min, sp.b_max) for sp in specs])
        mu, ok = pt_eval.stationary_distribution_batched(
            batch.policy_transitions_batched(pols))
        want_mu, want_ok = ref_eval.stationary_distribution_batched(
            ref_batch.policy_transitions_batched(pols))
        assert ok.all() and np.array_equal(ok, want_ok)
        np.testing.assert_array_equal(mu, want_mu)
        for i in range(batch.n_specs):
            np.testing.assert_allclose(
                mu[i], pt_eval.stationary_distribution(
                    batch.policy_transitions(i, pols[i])), atol=1e-10)

    def test_evaluate_policy_batched_matches_reference(self):
        ref_batch, batch, specs = self._batch()
        pols = np.stack([greedy_policy(sp.s_max, sp.b_min, sp.b_max) for sp in specs])
        got = pt_eval.evaluate_policy_batched(batch, list(pols))
        want = ref_eval.evaluate_policy_batched(ref_batch, list(pols))
        for a, b in zip(got, want):
            for f in ("g", "delta", "w_bar", "p_bar", "mean_batch", "throughput"):
                assert getattr(a, f) == getattr(b, f), f
        with pytest.raises(ValueError, match="policies"):
            pt_eval.evaluate_policy_batched(batch, list(pols[:2]))


class TestPallasBatchedLoop:
    @pytest.mark.parametrize("accel,rho,rtol", [("none", 0.5, 1e-6), ("mpi", 0.7, 1e-9)])
    def test_loop_with_pallas_backup_matches_banded(self, accel, rho, rtol):
        base = spec_for(rho=rho, s_max=48, b_max=16)
        specs = [dataclasses.replace(base, w2=w) for w in (0.0, 2.0)]
        batch = port_batch(specs)
        banded = pt.relative_value_iteration_batched(batch, accel=accel, device=CPU)
        pallas = pt.relative_value_iteration_batched(
            batch, accel=accel, backup="pallas", device=CPU)
        assert np.array_equal(banded.policies, pallas.policies)
        np.testing.assert_allclose(banded.g, pallas.g, rtol=rtol)
        want = relative_value_iteration_batched(
            build_smdp_batched(specs), accel=accel, backup="pallas")
        np.testing.assert_array_equal(pallas.policies, want.policies)
        np.testing.assert_allclose(pallas.g, want.g, rtol=rtol)

    def test_batched_backups_match_reference(self):
        from repro.core import rvi as ref_rvi

        base = spec_for(rho=0.7, s_max=40, b_max=16)
        specs = [dataclasses.replace(base, w2=w) for w in (0.0, 3.0)]
        ref_batch, batch = build_smdp_batched(specs), port_batch(specs)
        h = np.random.default_rng(0).normal(size=(2, batch.n_states)) * 5
        kb = pt_rvi.trimmed_band(batch.pmfs_banded, tol=1e-8)
        args = (batch.c_tilde, batch.pmfs_banded[:, :, :kb], batch.tails, batch.scale)
        t_args = [torch.as_tensor(a) for a in args]
        got = pt_rvi.banded_backup(*t_args, 40, torch.as_tensor(h)).numpy()
        got_p = pt_rvi.pallas_backup_batched(*t_args, 40, torch.as_tensor(h)).numpy()
        for i in range(2):
            want = np.asarray(ref_rvi.banded_backup(
                *(jnp.asarray(a[i]) for a in args), 40, jnp.asarray(h[i])))
            feas = np.isfinite(want)
            assert np.array_equal(feas, np.isfinite(got[i]))
            assert np.array_equal(feas, np.isfinite(got_p[i]))
            np.testing.assert_allclose(got[i][feas], want[feas], rtol=1e-12, atol=1e-12)
            # the f32 kernel core (its plain version here): the kernel bar
            np.testing.assert_allclose(got_p[i][feas], want[feas], rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# The guard ladder (tests/test_resilience.py's cases, against its report)
# ---------------------------------------------------------------------------


def _grid(n=6, s_max=48):
    base = spec_for(s_max=s_max, b_max=16)
    return [dataclasses.replace(base, w2=float(w)) for w in np.linspace(0.0, 5.0, n)]


class TestGuardLadder:
    def test_healthy_batch_bitwise_identical_to_unguarded(self):
        batch = port_batch(_grid())
        plain = pt.relative_value_iteration_batched(batch, guard=False, device=CPU)
        guarded = pt.relative_value_iteration_batched(batch, guard=True, device=CPU)
        np.testing.assert_array_equal(guarded.policies, plain.policies)
        np.testing.assert_array_equal(guarded.g, plain.g)
        np.testing.assert_array_equal(guarded.h, plain.h)
        rep = guarded.report
        assert rep is not None and rep.healthy.all() and not rep.any_fired

    @pytest.mark.parametrize("backup", ["banded", "pallas"])
    def test_poisoned_warm_start_heals_via_plain_restart(self, backup):
        specs = _grid(4)
        batch = port_batch(specs)
        clean = pt.relative_value_iteration_batched(batch, device=CPU)
        h0 = np.zeros_like(clean.h)
        h0[1, :] = np.nan  # a poisoned anchor NaNs every backup of row 1
        res = pt.relative_value_iteration_batched(
            batch, h0=h0, guard=True, backup=backup, device=CPU)
        want = relative_value_iteration_batched(
            build_smdp_batched(specs), h0=h0, guard=True, backup=backup)
        rep = res.report
        assert rep.healthy.all()
        assert rep.rungs == want.report.rungs
        assert 1 in rep.rungs["plain_restart"]
        assert not rep.quarantined and not rep.failed
        np.testing.assert_array_equal(res.policies, clean.policies)
        np.testing.assert_array_equal(res.policies, want.policies)
        np.testing.assert_allclose(res.g, clean.g, rtol=1e-5)

    def test_nan_spec_quarantined_and_sweep_completes(self):
        specs = _grid(7)
        specs[3] = dataclasses.replace(specs[3], w2=float("nan"))
        sink, ref_sink = [], []
        kw = dict(delta=None, auto_c_o=False, chunk_size=4)
        res = pt.sweep_solve(port(specs), report_sink=sink, device=CPU, **kw)
        ref = sweep_solve(specs, report_sink=ref_sink, **kw)
        rep, want = sink[0], ref_sink[0]
        assert len(res) == len(specs)
        assert rep.rungs == want.rungs
        assert rep.quarantined == want.quarantined == [3]
        assert rep.failed == want.failed == [3]
        np.testing.assert_array_equal(rep.healthy, want.healthy)
        assert not np.isfinite(res[3].rvi.g) and np.isnan(res[3].eval.g)
        for i, (r, w) in enumerate(zip(res, ref)):
            if i == 3:
                continue
            assert rep.healthy[i]
            assert np.isfinite(r.rvi.g) and r.rvi.converged
            assert np.array_equal(r.policy, w.policy)

    @pytest.mark.parametrize("backup,mp,accel,h0,dev,want,checked", [
        # the reference's ladders, on every device
        ("banded", True, "mpi", None, "cpu", ["plain_restart", "float64"], False),
        ("pallas", True, "mpi", None, "cpu",
         ["backup_banded", "plain_restart", "float64"], False),
        ("pallas", True, "none", np.zeros(3), "cpu",
         ["backup_banded", "plain_restart", "float64"], False),
        ("banded", True, "none", None, "cuda", ["float64"], False),
        # the kernel on the card: the same rungs, the banded one checks it
        ("pallas", True, "mpi", None, "cuda",
         ["backup_banded", "plain_restart", "float64"], True),
        ("pallas", True, "none", np.zeros(3), "cuda",
         ["backup_banded", "plain_restart", "float64"], True),
        ("pallas", True, "none", None, "cuda", ["backup_banded", "float64"], True),
        ("pallas", False, "anderson", None, "cuda", ["backup_banded", "plain_restart"], True),
    ])
    def test_ladder_keeps_the_kernel_on_the_card(self, backup, mp, accel, h0, dev, want,
                                                 checked):
        """The reference's rungs on every device; on the card with the
        kernel the banded rung is the kernel's run with only the core
        swapped (same precision, accelerant and warm start)."""
        ladder, kernel_checked = pt_rvi._ladder(backup, mp, accel, h0, torch.device(dev))
        assert [name for name, _ in ladder] == want
        assert kernel_checked == checked
        on_cpu, _ = pt_rvi._ladder(backup, mp, accel, h0, torch.device("cpu"))
        assert ladder == on_cpu
        if backup == "pallas":
            assert ladder[0][1] == dict(mp=mp, ac=accel, bk="banded", drop_h0=False)
            assert all(opt["bk"] == "banded" for _, opt in ladder)

    @staticmethod
    def _on_cpu(monkeypatch, poison=None):
        """Solves run on the CPU while the ladder takes the device for
        CUDA; ``poison(b, accel, backup, res)`` may spoil a batched result.
        Returns the list of (n_specs, accel, backup) batched calls."""
        real = pt_rvi.relative_value_iteration_batched
        real_scalar = pt_rvi.relative_value_iteration
        seen = []

        def fake(b, *, accel, backup, device, **kw):
            seen.append((b.n_specs, accel, backup))
            res = real(b, accel=accel, backup=backup, device=CPU, **kw)
            if poison is not None:
                poison(b, accel, backup, res)
            return res

        monkeypatch.setattr(pt_rvi, "relative_value_iteration_batched", fake)
        monkeypatch.setattr(pt_rvi, "relative_value_iteration",
                            lambda mdp, *, device, **kw: real_scalar(mdp, device=CPU, **kw))
        return seen

    @pytest.mark.parametrize("heals", [True, False])
    def test_kernel_ladder_restarts_on_the_kernel_or_raises(self, monkeypatch, heals):
        """With the device taken for CUDA, a row the kernel run leaves
        unhealthy: if the banded rung (the same run on the plain core)
        heals it, the kernel disagrees with its plain version and the solve
        raises naming it; if no batched rung heals it, it rides the
        reference's rungs down to the quarantine, which heals it.  The
        solves run on the CPU (a stand-in that poisons row 1 of the kernel
        run, or of every batched solve)."""
        batch = port_batch(_grid(4))

        def poison(b, accel, backup, res):
            if b.n_specs == 4 or not heals:
                res.g[1 if b.n_specs == 4 else 0] = np.nan

        seen = self._on_cpu(monkeypatch, poison)
        run = lambda: pt_rvi._guarded_batched(  # noqa: E731
            batch, eps=1e-2, max_iter=10_000, eps_rel=2e-4, h0=None, mixed_precision=True,
            accel="mpi", backup="pallas", accel_kw={}, device=torch.device("cuda"))
        if heals:
            with pytest.raises(RuntimeError, match=r"rows \[1\] .*disagrees with its plain"):
                run()
            assert seen == [(4, "mpi", "pallas"), (1, "mpi", "banded")]
        else:
            rep = run().report
            assert rep.rungs == {name: [1] for name in
                                 ("backup_banded", "plain_restart", "float64", "quarantine")}
            assert rep.quarantined == [1] and not rep.failed and rep.healthy.all()
            assert seen == [(4, "mpi", "pallas"), (1, "mpi", "banded"),
                            (1, "none", "banded"), (1, "none", "banded")]

    @pytest.mark.parametrize("accel", ["none", "mpi"])
    def test_nan_spec_on_the_card_follows_the_reference(self, monkeypatch, accel):
        """A NaN spec with the device taken for CUDA and backup="pallas":
        the reference's rungs, quarantine and ``failed``, the same report
        as the reference's; the other rows equal the reference's."""
        specs = _grid(4)
        specs[2] = dataclasses.replace(specs[2], w2=float("nan"))
        seen = self._on_cpu(monkeypatch)
        got = pt_rvi._guarded_batched(
            port_batch(specs), eps=1e-2, max_iter=10_000, eps_rel=2e-4, h0=None,
            mixed_precision=True, accel=accel, backup="pallas", accel_kw={},
            device=torch.device("cuda"))
        want = relative_value_iteration_batched(
            build_smdp_batched(specs), guard=True, backup="pallas", accel=accel)
        rep, ref = got.report, want.report
        assert rep.rungs == ref.rungs and 2 in rep.rungs["backup_banded"]
        assert rep.quarantined == ref.quarantined == [2]
        assert rep.failed == ref.failed == [2]
        np.testing.assert_array_equal(rep.healthy, ref.healthy)
        assert seen[0] == (4, accel, "pallas") and seen[1] == (1, accel, "banded")
        keep = [0, 1, 3]
        np.testing.assert_array_equal(got.policies[keep], want.policies[keep])
