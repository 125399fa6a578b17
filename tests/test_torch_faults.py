"""Port vs reference: degraded-mode serving (serving.faults on the fleet).

The port runs with device="cpu" (the fleet kernel's plain version and the
belief kernel's); the reference runs its jitted scans on the same numpy
inputs.  Held:

* FaultModel.materialize gives the same bounds and multipliers, bit for
  bit; FaultSchedule / FaultModel refuse the same inputs with the same
  errors; down_at / boundary / attempt_mult agree;
* simulate_fleet under the `moderate`-style schedule with buffer 24 and
  slo 2.0, every router on Poisson and MMPP2: decisions, flags, counts,
  the histogram exact, latencies within atol 1e-9, energy and lat_sum at
  rtol 1e-12; verify_faults (PythonFleet against the kernel) passes;
* the FaultSchedule.none rail, the handcrafted crash / bounded-retry /
  prorated-energy schedules, finite rooms down to buffer=0;
* FleetStream under faults and buffers, with the belief posterior
  forwarded chunk by chunk: equal to the one-shot run and to the
  reference's stream; PythonFleet snapshot / restore mid-outage.

Sizes are the reference tests' (tests/test_faults_serving.py).
"""
import numpy as np
import pytest

from repro.core import GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel, SMDPSpec
from repro.core.policies import q_policy
from repro.serving import faults as rfa
from repro.serving import fleet as rf
from repro.serving.arrivals import MMPP2, PhaseBeliefFilter
from repro_torch import interop
from repro_torch.serving import arrivals as pa
from repro_torch.serving import faults as pfa
from repro_torch.serving import fleet as pf

SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
BMAX = 16
LAM = 0.7 * BMAX / float(SVC.mean(BMAX))
ENERGY = np.array(
    [0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, BMAX + 1)]
)
MEANS = np.array([0.0] + [float(SVC.mean(b)) for b in range(1, BMAX + 1)])
TABLES = np.stack([q_policy(q, 96, BMAX) for q in (4, 6, 8)])
ROUTER_NAMES = ["rr", "jsq", "pow2", "batch_aware"]
FAULT_KW = dict(mtbf=40.0, mttr=6.0, p_straggle=0.1, straggle_mult=3.0)
#: benchmarks/degraded_frontier.py's `moderate` severity
MODERATE = dict(mtbf=60.0, mttr=5.0, p_straggle=0.05, straggle_mult=3.0)
CPU = dict(device="cpu")
PORT_SVC = interop.spec_from_reference(
    SMDPSpec(lam=LAM, service=SVC, energy=GOOGLENET_P4_ENERGY)).service


def _trace(mode: str, n: int = 1200, seed: int = 0, lam: float = 3 * LAM):
    rng = np.random.default_rng(seed)
    if mode == "poisson":
        return np.cumsum(rng.exponential(1.0 / lam, n))
    assert mode == "mmpp2"
    m = MMPP2(lam1=0.3 * lam, lam2=1.3 * lam, dwell1=60.0, dwell2=30.0)
    times, _ = m.sample_arrivals(n / m.mean_rate, rng)
    return times


def _schedules(trace, M=3, seed=1, model=FAULT_KW):
    """The same realization from both packages (asserted equal)."""
    h = float(trace[-1]) + 50.0
    ref = rfa.FaultModel(**model).materialize(M, h, seed=seed)
    got = pfa.FaultModel(**model).materialize(M, h, seed=seed)
    np.testing.assert_array_equal(got.bounds, ref.bounds)
    np.testing.assert_array_equal(got.mult, ref.mult)
    return got, ref


def same_result(got, want, record=True):
    for k in ("n_served", "n_batches", "n_epochs", "n_admitted", "slo_miss",
              "terminated", "n_crashes", "n_dropped", "n_shed", "t_final"):
        assert getattr(got, k) == getattr(want, k), (k, getattr(got, k), getattr(want, k))
    keys = ("hist", "qlen", "busy", "n_routed", "n_served_m")
    if record:
        keys += ("actions", "servers", "served", "dropped", "shed", "arr_server")
    for k in keys:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)
    np.testing.assert_allclose(got.lat_sum, want.lat_sum, rtol=1e-12)
    if record:
        np.testing.assert_allclose(got.latencies, want.latencies, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,M,horizon,seed", [
    (FAULT_KW, 3, 200.0, 0),
    (FAULT_KW, 4, 1000.0, 7),
    (dict(mtbf=60.0, mttr=5.0, p_straggle=0.05, straggle_mult=3.0), 3, 5000.0, 301),
    (dict(mtbf=25.0, mttr=8.0, p_straggle=0.15, straggle_mult=4.0), 1, 300.0, 3),
    (dict(), 2, 100.0, 0),  # mtbf inf: no outages, unit multipliers
])
def test_materialize_equals_reference_bit_for_bit(model, M, horizon, seed):
    got = pfa.FaultModel(**model).materialize(M, horizon, n_attempts=512, seed=seed)
    want = rfa.FaultModel(**model).materialize(M, horizon, n_attempts=512, seed=seed)
    assert got.bounds.tobytes() == want.bounds.tobytes()
    assert got.mult.tobytes() == want.mult.tobytes()
    assert got.max_retries == want.max_retries
    for t in (0.0, 10.0, horizon / 2, horizon):
        np.testing.assert_array_equal(got.down_at(t), want.down_at(t))
    for m in range(M):
        for c in range(got.bounds.shape[1] + 2):
            assert got.boundary(m, c) == want.boundary(m, c)
        for a in (0, 3, 10_000):
            assert got.attempt_mult(m, a) == want.attempt_mult(m, a)


BAD = [
    ("FaultSchedule", dict(bounds=np.array([[5.0, 2.0]]), mult=np.ones((1, 1)))),
    ("FaultSchedule", dict(bounds=np.zeros((1, 0)), mult=np.zeros((1, 1)))),
    ("FaultSchedule", dict(bounds=np.zeros((1, 3)), mult=np.ones((1, 1)))),
    ("FaultSchedule", dict(bounds=np.zeros((2, 2)), mult=np.ones((1, 1)))),
    ("FaultSchedule", dict(bounds=np.zeros((1, 2)), mult=np.ones((1, 1)), max_retries=-1)),
    ("FaultModel", dict(mtbf=-1.0)),
    ("FaultModel", dict(mttr=0.0)),
    ("FaultModel", dict(p_straggle=1.5)),
    ("FaultModel", dict(straggle_mult=0.0)),
    ("FaultModel", dict(max_retries=-2)),
]


@pytest.mark.parametrize("cls,kw", BAD)
def test_validation_raises_the_reference_errors(cls, kw):
    with pytest.raises(Exception) as want:
        getattr(rfa, cls)(**kw)
    with pytest.raises(type(want.value)) as got:
        getattr(pfa, cls)(**kw)
    assert str(got.value) == str(want.value)


def test_materialize_and_verify_faults_refusals():
    with pytest.raises(ValueError, match="finite horizon"):
        pfa.FaultModel().materialize(2, np.inf)
    with pytest.raises(TypeError, match="FaultSchedule"):
        pfa.verify_faults(TABLES, _trace("poisson", 50), faults=None,
                          service=PORT_SVC, b_max=BMAX, **CPU)
    with pytest.raises(ValueError, match="covers 3 replicas"):
        pf.simulate_fleet(TABLES[:2], _trace("poisson", 50), means=MEANS, b_max=BMAX,
                          faults=pfa.FaultSchedule.none(3), **CPU)


# ---------------------------------------------------------------------------
# the kernel under faults against the reference, and the certifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", [FAULT_KW, MODERATE], ids=["tests", "moderate"])
@pytest.mark.parametrize("mode", ["poisson", "mmpp2"])
@pytest.mark.parametrize("router", ROUTER_NAMES)
def test_degraded_fleet_matches_reference_and_certifies(router, mode, model):
    tr = _trace(mode)
    sch, ref_sch = _schedules(tr, model=model)
    kw = dict(router=router, means=MEANS, zeta=ENERGY, b_max=BMAX, slo=2.0,
              buffer=24, record=True)
    got = pf.simulate_fleet(TABLES, tr, faults=sch, **kw, **CPU)
    same_result(got, rf.simulate_fleet(TABLES, tr, faults=ref_sch, **kw))
    out = pfa.verify_faults(TABLES, tr, faults=sch, service=PORT_SVC, b_max=BMAX,
                            router=router, buffer=24, energy_table=ENERGY, slo=2.0,
                            **CPU)
    # the scenario must exercise the degraded paths (the benchmark's
    # moderate outages crash batches but leave the room of 24 unfilled)
    assert out["n_crashes"] > 0
    if model is FAULT_KW:
        assert out["n_shed"] > 0 or out["n_dropped"] > 0


def test_m1_certifies():
    tr = _trace("poisson", 600, lam=LAM)
    sch = pfa.FaultModel(**FAULT_KW).materialize(1, float(tr[-1]) + 50.0, seed=3)
    out = pfa.verify_faults(TABLES[:1], tr, faults=sch, service=PORT_SVC, b_max=BMAX,
                            energy_table=ENERGY, **CPU)
    assert out["n_crashes"] > 0


def test_none_schedule_matches_fault_free_run():
    tr = _trace("poisson", 600)
    base = pf.verify_fleet(TABLES, tr, router="jsq", service=PORT_SVC, b_max=BMAX,
                           energy_table=ENERGY, **CPU)
    none = pfa.verify_faults(TABLES, tr, faults=pfa.FaultSchedule.none(3),
                             service=PORT_SVC, b_max=BMAX, router="jsq",
                             energy_table=ENERGY, **CPU)
    assert none["n_crashes"] == 0
    assert none["n_dropped"] == 0 and none["n_shed"] == 0
    b, f = base["compiled"], none["compiled"]
    np.testing.assert_array_equal(b.batch_sizes, f.batch_sizes)
    assert b.energy == f.energy


# ---------------------------------------------------------------------------
# handcrafted schedules: the crash / requeue / drop contract
# ---------------------------------------------------------------------------


def _crash_run(bounds, max_retries, trace=(0.1, 0.2)):
    table = q_policy(2, 96, BMAX)
    kw = dict(router="jsq", means=MEANS, zeta=ENERGY, draws=np.ones(1), b_max=BMAX,
              record=True)
    b = np.asarray(bounds, dtype=np.float64)
    got = pf.simulate_fleet(
        table[None], np.asarray(trace),
        faults=pfa.FaultSchedule(bounds=b, mult=np.ones((1, 1)), max_retries=max_retries),
        **kw, **CPU)
    want = rf.simulate_fleet(
        table[None], np.asarray(trace),
        faults=rfa.FaultSchedule(bounds=b, mult=np.ones((1, 1)), max_retries=max_retries),
        **kw)
    same_result(got, want)
    return got


def test_down_interval_crashes_inflight_batch():
    res = _crash_run([[0.3, 5.0]], max_retries=2)
    assert (res.n_crashes, res.n_dropped, res.n_served) == (1, 0, 2)
    assert res.latencies.min() >= 5.0 - 0.2  # the retry serves at the repair


def test_bounded_retries_drop_the_batch():
    res = _crash_run([[0.3, 5.0]], max_retries=0)
    assert (res.n_crashes, res.n_dropped, res.n_served) == (1, 2, 0)
    assert res.dropped[:2].all() and not res.served[:2].any()


def test_crashed_attempt_energy_is_prorated():
    clean = _crash_run([[np.inf, np.inf]], max_retries=2)
    crashed = _crash_run([[0.3, 5.0]], max_retries=0)
    assert 0.0 < crashed.energy < float(ENERGY[2])
    assert clean.energy == pytest.approx(float(ENERGY[2]))


def test_retry_counter_resets_after_success():
    res = _crash_run([[0.3, 4.0, 10.25, 14.0]], max_retries=1,
                     trace=(0.1, 0.2, 10.05, 10.1))
    assert (res.n_crashes, res.n_dropped, res.n_served) == (2, 0, 4)


# ---------------------------------------------------------------------------
# finite waiting rooms
# ---------------------------------------------------------------------------


def test_buffer_sheds_only_when_full():
    tr = _trace("poisson", 800)
    kw = dict(router="jsq", means=MEANS, zeta=ENERGY, b_max=BMAX, record=True)
    full = pf.simulate_fleet(TABLES, tr, **kw, **CPU)
    finite = pf.simulate_fleet(TABLES, tr, buffer=4, **kw, **CPU)
    same_result(finite, rf.simulate_fleet(TABLES, tr, buffer=4, **kw))
    assert full.n_shed == 0 and finite.n_shed > 0
    assert finite.shed.sum() == finite.n_shed
    assert finite.n_served + finite.n_shed == len(tr)


def test_buffer_certified_python_vs_kernel():
    pf.verify_fleet(TABLES, _trace("poisson", 800), router="pow2", service=PORT_SVC,
                    b_max=BMAX, energy_table=ENERGY, buffer=6, **CPU)


def test_starved_b0_sheds_everything_like_the_reference():
    tr = _trace("poisson", 300)
    kw = dict(router="jsq", means=MEANS, zeta=ENERGY, b_max=BMAX, buffer=0)
    st = pf.FleetStream(TABLES, **kw, **CPU)
    ref = rf.FleetStream(TABLES, **kw)
    st.push(tr)
    ref.push(tr)
    res, want = st.finish(), ref.finish()
    assert res.n_served == 0 and res.n_shed == len(tr) == want.n_shed
    assert res.hist.sum() == 0
    rep = st.report()
    assert rep["drop_rate"] == 1.0 and rep["goodput"] == 0.0
    assert np.isnan(rep["W_mean"]) and np.isnan(rep["mean_batch"])
    assert rep.keys() == ref.report().keys()


# ---------------------------------------------------------------------------
# streaming under faults, beliefs forwarded chunk by chunk
# ---------------------------------------------------------------------------

FIELDS = ("n_served", "n_batches", "n_epochs", "slo_miss", "n_crashes",
          "n_dropped", "n_shed", "t_final")


def same_aggregates(got, want):
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), (f, getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)
    np.testing.assert_allclose(got.lat_sum, want.lat_sum, rtol=1e-12)
    np.testing.assert_array_equal(got.hist, want.hist)
    np.testing.assert_array_equal(got.qlen, want.qlen)


def test_chunked_matches_one_shot_under_faults():
    tr = _trace("poisson", 1000)
    sch, ref_sch = _schedules(tr)
    kw = dict(router="jsq", means=MEANS, zeta=ENERGY, b_max=BMAX, slo=2.0, buffer=24)
    st = pf.FleetStream(TABLES, faults=sch, **kw, **CPU)
    ref = rf.FleetStream(TABLES, faults=ref_sch, **kw)
    for i in range(0, len(tr), 97):  # 11 chunks
        st.push(tr[i:i + 97])
        ref.push(tr[i:i + 97])
    got = st.finish()
    same_aggregates(got, pf.simulate_fleet(TABLES, tr, faults=sch, **kw, **CPU))
    same_aggregates(got, ref.finish())
    assert got.n_crashes > 0


@pytest.mark.parametrize("mode", ["belief_argmax", "belief_mix"])
def test_chunked_belief_forwarding_matches_one_shot(mode):
    tr = _trace("mmpp2", 1000)
    lam = 3 * LAM
    rates = np.array([0.3 * lam, 1.3 * lam])
    gen = np.array([[-1 / 60, 1 / 60], [1 / 30, -1 / 30]])
    lo, hi = q_policy(4, 96, BMAX), q_policy(10, 96, BMAX)
    stacks = np.stack([np.stack([lo, hi]), np.stack([hi, lo]), np.stack([lo, lo])])
    sch, ref_sch = _schedules(tr)
    kw = dict(router="jsq", means=MEANS, zeta=ENERGY, b_max=BMAX, slo=2.0, buffer=24)
    st = pf.FleetStream(stacks, phase_mode=mode, faults=sch,
                        belief_filter=pa.PhaseBeliefFilter(rates=rates, gen=gen), **kw,
                        **CPU)
    ref = rf.FleetStream(stacks, phase_mode=mode, faults=ref_sch,
                         belief_filter=PhaseBeliefFilter(rates=rates, gen=gen), **kw)
    for i in range(0, len(tr), 97):
        st.push(tr[i:i + 97])
        ref.push(tr[i:i + 97])
    bel, _ = pa.belief_forward(tr, pa.PhaseBeliefFilter(rates=rates, gen=gen), **CPU)
    got = st.finish()
    same_aggregates(got, pf.simulate_fleet(stacks, tr, phase_mode=mode,
                                           beliefs=bel.numpy(), faults=sch, **kw, **CPU))
    same_aggregates(got, ref.finish())


def test_stream_filter_state_advances():
    tr = _trace("mmpp2", 400)
    lam = 3 * LAM
    filt = pa.PhaseBeliefFilter(rates=[0.3 * lam, 1.3 * lam],
                                gen=[[-1 / 60, 1 / 60], [1 / 30, -1 / 30]])
    st = pf.FleetStream(np.stack([np.stack([q_policy(4, 96, BMAX)] * 2)] * 2),
                        router="jsq", means=MEANS, b_max=BMAX,
                        phase_mode="belief_argmax", belief_filter=filt, **CPU)
    st.push(tr[:150]).push(tr[150:])
    assert filt.n_observed == len(tr)
    ref = pa.PhaseBeliefFilter(rates=filt.rates, gen=filt.gen)
    for t in tr:
        ref.observe(t)
    np.testing.assert_allclose(filt.belief, ref.belief, atol=1e-9)


@pytest.mark.parametrize("mode", ["poisson", "mmpp2"])
def test_restore_mid_outage_continues_exactly(mode):
    tr = _trace(mode, 600)
    sch, _ = _schedules(tr)
    kw = dict(router="jsq", means=MEANS, zeta=ENERGY, b_max=BMAX, slo=2.0,
              faults=sch, buffer=24)
    base = pf.PythonFleet(TABLES, tr, **kw).run()
    assert base.n_crashes > 0
    fleet = pf.PythonFleet(TABLES, tr, **kw)
    snap = None
    while fleet.step():
        crashed = fleet.n_crashes > 0 or any(fleet.infl_req)
        if snap is None and crashed and any(fleet._down(m) for m in range(fleet.M)):
            snap = fleet.snapshot()  # mid-outage, retry pending
    assert snap is not None
    resumed = pf.PythonFleet(TABLES, tr, **kw)
    resumed.restore(snap)
    resumed.run()
    np.testing.assert_array_equal(np.asarray(resumed.decisions), np.asarray(base.decisions))
    for k in ("served", "dropped", "shed"):
        np.testing.assert_array_equal(getattr(resumed, k), getattr(base, k))
    np.testing.assert_array_equal(resumed.latencies, base.latencies)
    assert (resumed.n_crashes, resumed.energy) == (base.n_crashes, base.energy)
