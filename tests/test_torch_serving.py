"""Port vs reference: the serving engine and the compiled backend on the CPU.

* The port's compiled run (the event kernel's plain version) against the
  reference's jitted scan at the same seed, on the Table-I point with the
  reference-solved policy carried across by interop: batch sizes equal,
  latencies within 1e-9, energy within rtol 1e-12 (sums in another
  order), sketch P50/P95/P99 equal.
* The port's own verify_backends (Python event loop vs compiled backend)
  on Poisson traces with deterministic and stochastic service, and with a
  (K, L) oracle-phase table.
"""
import numpy as np
import pytest

from repro.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ServiceModel,
    SMDPSpec,
    solve,
)
from repro.core.policies import q_policy
from repro.serving import ServingEngine as RefEngine
from repro.serving import SMDPScheduler as RefScheduler
from repro.serving import simulate_compiled as ref_simulate
from repro.serving.arrivals import MMPP2
from repro_torch import interop
from repro_torch import serving as ps

B_MAX = 32
SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
LAM = 0.7 * B_MAX / float(SVC.mean(B_MAX))
ENERGY = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, B_MAX + 1)])
MEANS = np.array([0.0] + [float(SVC.mean(b)) for b in range(1, B_MAX + 1)])
TABLE = q_policy(8, 128, B_MAX)


@pytest.fixture(scope="module")
def table1():
    spec = SMDPSpec(lam=LAM, service=SVC, energy=GOOGLENET_P4_ENERGY, b_min=1,
                    b_max=B_MAX, w1=1.0, w2=1.6, s_max=128)
    return solve(spec)


def _port_svc(family="det"):
    return interop.spec_from_reference(
        SMDPSpec(lam=LAM, service=ServiceModel(latency=GOOGLENET_P4_LATENCY,
                                               family=family),
                 energy=GOOGLENET_P4_ENERGY)
    ).service


def _compare_reports(got, want):
    np.testing.assert_array_equal(got.batch_sizes, want.batch_sizes)
    assert got.n_served == want.n_served
    np.testing.assert_allclose(got.latencies, want.latencies, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)
    np.testing.assert_allclose(got.span, want.span, rtol=0, atol=1e-9)
    assert got.n_slo_miss == want.n_slo_miss
    for key in ("P50", "P95", "P99", "mean_batch", "n_served"):
        assert got.metrics[key] == want.metrics[key], key
    np.testing.assert_allclose(got.metrics["W_mean"], want.metrics["W_mean"], rtol=1e-12)
    np.testing.assert_allclose(got.metrics["power"], want.metrics["power"], rtol=1e-12)


def test_compiled_engine_matches_reference_at_equal_seed(table1):
    sched = interop.table_from_reference(table1)
    assert np.array_equal(sched.table, table1.action_table())
    kw = dict(lam=LAM, b_max=B_MAX, energy_table=ENERGY, seed=0)
    ref = RefEngine(RefScheduler(table1), service=SVC, **kw)
    eng = ps.ServingEngine(sched, service=_port_svc(), device="cpu", **kw)
    # two consecutive runs: the second continues from buffered events
    for n in (5_000, 1_500):
        _compare_reports(eng.run(n, backend="compiled"),
                         ref.run(n, backend="compiled"))
        assert eng.t == ref.t and len(eng.queue) == len(ref.queue)
        assert [r.rid for r in eng.queue] == [r.rid for r in ref.queue]


def test_python_engine_matches_reference_at_equal_seed():
    kw = dict(lam=LAM, b_max=B_MAX, energy_table=ENERGY, seed=3, slo=9.0)
    ref = RefEngine(RefScheduler.from_table(TABLE),
                    service=ServiceModel(latency=GOOGLENET_P4_LATENCY, family="expo"), **kw)
    eng = ps.ServingEngine(ps.SMDPScheduler.from_table(TABLE),
                           service=_port_svc("expo"), device="cpu", **kw)
    got, want = eng.run(2_000), ref.run(2_000)
    np.testing.assert_array_equal(got.batch_sizes, want.batch_sizes)
    np.testing.assert_array_equal(got.latencies, want.latencies)
    assert got.energy == want.energy and got.n_slo_miss == want.n_slo_miss
    assert got.metrics == want.metrics


@pytest.mark.parametrize("mode", ["horizon", "budget_slo", "drain"])
def test_simulate_compiled_matches_reference(mode):
    rng = np.random.default_rng(7)
    trace = np.cumsum(rng.exponential(1.0 / LAM, 1500))
    kw = dict(means=MEANS, zeta=ENERGY, b_max=B_MAX, record=True)
    if mode == "horizon":
        kw.update(horizon=float(trace[900]), drain=False, max_epochs=None)
    elif mode == "budget_slo":
        kw.update(max_epochs=700, deadlines=trace + 8.0, drain=False,
                  draws=rng.exponential(size=700), t0=0.25)
    want = ref_simulate(TABLE, trace, **kw)
    got = ps.simulate_compiled(TABLE, trace, device="cpu", **kw)
    for field in ("n_served", "n_batches", "n_epochs", "n_admitted",
                  "slo_miss", "terminated"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.t_final == want.t_final
    np.testing.assert_array_equal(got.actions, want.actions)
    np.testing.assert_array_equal(got.hist, want.hist)
    np.testing.assert_allclose(got.latencies, want.latencies, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)
    np.testing.assert_allclose(got.lat_sum, want.lat_sum, rtol=1e-12)


def _poisson(n, seed=0):
    return np.cumsum(np.random.default_rng(seed).exponential(1.0 / LAM, n))


@pytest.mark.parametrize("family", ["det", "expo"])
def test_verify_backends_poisson(family):
    out = ps.verify_backends(TABLE, _poisson(2500), service=_port_svc(family),
                             energy_table=ENERGY, b_max=B_MAX, device="cpu")
    assert out["n_decisions"] > 0
    assert out["max_latency_err"] <= 1e-9


def test_verify_backends_budget_and_slo():
    out = ps.verify_backends(TABLE, _poisson(2500, seed=1), service=_port_svc(),
                             energy_table=ENERGY, b_max=B_MAX, n_epochs=900,
                             slo=8.0, device="cpu")
    assert out["python"].n_slo_miss == out["compiled"].n_slo_miss > 0


def test_verify_backends_oracle_phase_table():
    m = MMPP2(lam1=0.3 * LAM, lam2=1.3 * LAM, dwell1=60.0, dwell2=30.0)
    times, log = m.sample_arrivals(2000 / m.mean_rate, np.random.default_rng(5))
    switch_t = np.array([t for t, _ in log])
    phases = np.array([p for _, p in log])[
        np.searchsorted(switch_t, times, side="right") - 1
    ]
    assert 0 < phases.mean() < 1
    stack = np.stack([q_policy(4, 128, B_MAX), q_policy(12, 128, B_MAX)])
    out = ps.verify_backends(stack, times, phases=phases, service=_port_svc(),
                             energy_table=ENERGY, b_max=B_MAX, device="cpu")
    assert out["n_decisions"] > 0


def test_drain_capped_at_b_max():
    never = np.zeros(130, dtype=np.int64)  # always wait -> forced drain
    res = ps.simulate_compiled(never, np.full(20, 0.5), means=MEANS[:5], b_max=4,
                               record=True, device="cpu")
    assert res.n_served == 20
    assert res.batch_sizes.max() <= 4
    assert len(res.batch_sizes) == 5


def test_unported_lanes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ps.simulate_compiled(TABLE, _poisson(10), means=MEANS, b_max=B_MAX,
                             buffer=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ps.simulate_compiled(TABLE, _poisson(10), means=MEANS, b_max=B_MAX,
                             phase_mode="belief_mix", device="cpu")
    eng = ps.ServingEngine(ps.SMDPScheduler.from_table(TABLE), lam=LAM, b_max=B_MAX,
                           service=_port_svc(), buffer=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.run(100, backend="compiled")
    assert eng.run(100).n_served > 0  # the Python backend sheds fine
