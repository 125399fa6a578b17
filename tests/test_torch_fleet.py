"""Port vs reference: the routed fleet (serving.fleet).

The port runs with device="cpu" (the fleet kernel's plain version); the
reference runs its jitted scan on the same numpy inputs.  Held:

* simulate_fleet(record=True) for every router on Poisson, MMPP2 and
  diurnal traces, homogeneous and heterogeneous tables, the epoch-budget
  and horizon cuts and stochastic service: decisions, servers, served /
  dropped / shed / arr_server, counts, the histogram, qlen, busy and
  t_final exact; latencies within atol 1e-9; energy and lat_sum at rtol
  1e-12 (the reference sums in a tree, the kernel in step order);
* the M = 1 fleet against the single-server event kernel of the port;
* the belief lanes (argmax and mix) with the reference's posteriors;
* verify_fleet (PythonFleet against the kernel) and PythonFleet's
  snapshot / restore;
* FleetStream: chunked equal to one-shot and to the reference's stream;
* run_fleet_grid: a cell equal to simulate_fleet, every key equal to the
  reference's unsharded grid;
* the refusals: save / resume / mesh=, M above the kernel's maximum and
  router ids outside the four.

Sizes are the reference tests' (tests/test_fleet.py): b_max 16, q_policy
tables, ~1200 arrivals, heterogeneous limits (4, 6, 8, 12).
"""
import numpy as np
import pytest

from repro.core import GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel
from repro.core.policies import q_policy
from repro.serving import fleet as rf
from repro.serving.arrivals import MMPP2, DiurnalProcess, PhaseBeliefFilter
from repro.serving.arrivals import belief_forward_jax
from repro_torch import interop
from repro_torch.kernels import fleet_scan as fk
from repro_torch.serving import compiled as pc
from repro_torch.serving import fleet as pf

SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
BMAX = 16
LAM = 0.7 * BMAX / float(SVC.mean(BMAX))
ENERGY = np.array(
    [0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, BMAX + 1)]
)
MEANS = np.array([0.0] + [float(SVC.mean(b)) for b in range(1, BMAX + 1)])
TABLE = q_policy(6, 96, BMAX)
HET_QS = (4, 6, 8, 12)
HET_TABLES = np.stack([q_policy(q, 96, BMAX) for q in HET_QS])
HOM_TABLES = np.tile(TABLE[None], (4, 1))
ROUTER_NAMES = ["rr", "jsq", "pow2", "batch_aware"]
CPU = dict(device="cpu")


def _trace(mode: str, n: int = 1200, seed: int = 0, lam: float = LAM):
    rng = np.random.default_rng(seed)
    if mode == "poisson":
        return np.cumsum(rng.exponential(1.0 / lam, n))
    if mode == "mmpp2":
        m = MMPP2(lam1=0.3 * lam, lam2=1.3 * lam, dwell1=60.0, dwell2=30.0)
        times, _ = m.sample_arrivals(n / m.mean_rate, rng)
        return times
    assert mode == "diurnal"
    proc = DiurnalProcess(base=lam, amp=0.6 * lam, period=120.0)
    return np.array([proc.next(rng).time for _ in range(n)])


def _port_svc(family="det"):
    from repro.core import SMDPSpec

    return interop.spec_from_reference(
        SMDPSpec(lam=LAM, service=ServiceModel(latency=GOOGLENET_P4_LATENCY,
                                               family=family),
                 energy=GOOGLENET_P4_ENERGY)
    ).service


EXACT = ("n_served", "n_batches", "n_epochs", "n_admitted", "slo_miss",
         "terminated", "n_crashes", "n_dropped", "n_shed", "t_final")
ARRAYS = ("hist", "qlen", "busy", "n_routed", "n_served_m")
RECORDS = ("actions", "servers", "served", "dropped", "shed", "arr_server")


def same_result(got, want, record=True):
    """The port's FleetResult against the reference's: exact but for the
    latencies (atol 1e-9) and the sums (rtol 1e-12)."""
    for k in EXACT:
        assert getattr(got, k) == getattr(want, k), (k, getattr(got, k), getattr(want, k))
    for k in ARRAYS + (RECORDS if record else ()):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)
    np.testing.assert_allclose(got.lat_sum, want.lat_sum, rtol=1e-12)
    if record:
        np.testing.assert_allclose(got.latencies, want.latencies, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# simulate_fleet against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tables", ["het", "hom"])
@pytest.mark.parametrize("mode", ["poisson", "mmpp2", "diurnal"])
@pytest.mark.parametrize("router", ROUTER_NAMES)
def test_simulate_fleet_matches_reference(router, mode, tables):
    tabs = HET_TABLES if tables == "het" else HOM_TABLES
    tr = _trace(mode, lam=4 * LAM)
    kw = dict(router=router, means=MEANS, zeta=ENERGY, b_max=BMAX, slo=3.0,
              record=True)
    got = pf.simulate_fleet(tabs, tr, **kw, **CPU)
    want = rf.simulate_fleet(tabs, tr, **kw)
    same_result(got, want)
    assert got.n_served == len(tr) and got.terminated


@pytest.mark.parametrize("router", ["jsq", "pow2"])
@pytest.mark.parametrize("cut", ["budget", "horizon"])
def test_budget_and_horizon_cuts_match_reference(router, cut):
    tr = _trace("poisson", lam=4 * LAM)
    kw = dict(router=router, means=MEANS, zeta=ENERGY, b_max=BMAX, record=True)
    if cut == "budget":
        kw.update(max_epochs=100, drain=False)
    else:
        kw.update(horizon=float(tr[len(tr) // 2]))
    got = pf.simulate_fleet(HET_TABLES, tr, **kw, **CPU)
    same_result(got, rf.simulate_fleet(HET_TABLES, tr, **kw))
    if cut == "budget":
        assert got.n_epochs == 100 and not got.terminated


@pytest.mark.parametrize("router", ["jsq", "batch_aware"])
def test_phases_past_a_single_row_read_it_like_the_reference(router):
    """K = 1 tables with stray phases: the reference's gathers clamp to the
    one row, and so do the kernel and its plain walk."""
    tr = _trace("poisson", n=400, lam=4 * LAM)
    ph = np.random.default_rng(1).integers(0, 3, len(tr))
    kw = dict(router=router, means=MEANS, zeta=ENERGY, b_max=BMAX, phases=ph,
              record=True)
    same_result(pf.simulate_fleet(HET_TABLES, tr, **kw, **CPU),
                rf.simulate_fleet(HET_TABLES, tr, **kw))


def test_stochastic_service_draws_match_reference():
    tr = _trace("poisson", lam=4 * LAM)
    draws = np.random.default_rng(3).exponential(1.0, 2 * len(tr))
    kw = dict(router="jsq", means=MEANS, zeta=ENERGY, b_max=BMAX, draws=draws,
              record=True)
    same_result(pf.simulate_fleet(HET_TABLES, tr, **kw, **CPU),
                rf.simulate_fleet(HET_TABLES, tr, **kw))


def test_threshold_gaps_match_reference():
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 3, size=(3, 2, 20)) * rng.integers(0, 2, size=(3, 2, 20))
    for tabs in (HET_TABLES, rand, np.zeros((1, 1, 8), np.int64), TABLE[None]):
        np.testing.assert_array_equal(pf.threshold_gaps(tabs), rf.threshold_gaps(tabs))


def test_m1_fleet_equals_the_single_server_kernel():
    """The M = 1 fleet (fleet kernel) against simulate_compiled (event
    kernel) of the port: both add energy in serve order, so even the sums
    agree here; the reference's two scans differ in the last bits."""
    tr = _trace("poisson")
    res = pf.simulate_fleet(TABLE, tr, router="rr", means=MEANS, zeta=ENERGY,
                            b_max=BMAX, record=True, **CPU)
    ref = pc.simulate_compiled(TABLE, tr, means=MEANS, zeta=ENERGY, b_max=BMAX,
                               record=True, **CPU)
    np.testing.assert_array_equal(res.batch_sizes, ref.batch_sizes)
    np.testing.assert_array_equal(res.latencies[res.served], ref.latencies)
    assert res.t_final == ref.t_final and res.n_epochs == ref.n_epochs
    np.testing.assert_allclose(res.energy, ref.energy, rtol=1e-12)


# ---------------------------------------------------------------------------
# the belief lanes
# ---------------------------------------------------------------------------


def _belief_case(n=900, seed=31):
    trace = _trace("mmpp2", n=n, seed=seed, lam=2 * LAM)
    filt = PhaseBeliefFilter(
        rates=[0.3 * 2 * LAM, 1.3 * 2 * LAM],
        gen=[[-1 / 60.0, 1 / 60.0], [1 / 30.0, -1 / 30.0]],
    )
    bel = np.asarray(belief_forward_jax(trace, filt)[0])
    stacks = np.stack([
        np.stack([q_policy(4, 96, BMAX), q_policy(10, 96, BMAX)]),
        np.stack([q_policy(10, 96, BMAX), q_policy(4, 96, BMAX)]),
    ])  # (M=2, K=2, L)
    return trace, bel, stacks


@pytest.mark.parametrize("router", ["jsq", "batch_aware"])
@pytest.mark.parametrize("phase_mode", ["belief_argmax", "belief_mix"])
def test_belief_lanes_match_reference(phase_mode, router):
    trace, bel, stacks = _belief_case()
    kw = dict(router=router, means=MEANS, zeta=ENERGY, b_max=BMAX, record=True,
              phase_mode=phase_mode, beliefs=bel)
    got = pf.simulate_fleet(stacks, trace, **kw, **CPU)
    same_result(got, rf.simulate_fleet(stacks, trace, **kw))
    if phase_mode == "belief_mix":
        amax = pf.simulate_fleet(stacks, trace, **dict(kw, phase_mode="belief_argmax"), **CPU)
        assert len(got.actions) != len(amax.actions) or (got.actions != amax.actions).any()


def test_belief_mix_certified_python_vs_kernel():
    trace, bel, stacks = _belief_case(n=500)
    for router in ("jsq", "batch_aware"):
        pf.verify_fleet(stacks, trace, router=router, service=_port_svc(),
                        energy_table=ENERGY, b_max=BMAX,
                        phase_mode="belief_mix", beliefs=bel, **CPU)


def test_oracle_mode_rejects_beliefs():
    trace, bel, stacks = _belief_case(n=50)
    with pytest.raises(ValueError, match="belief"):
        pf.simulate_fleet(stacks, trace, beliefs=bel, means=MEANS, b_max=BMAX, **CPU)


# ---------------------------------------------------------------------------
# the certifier and the Python loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router", ROUTER_NAMES)
def test_verify_fleet_every_router(router):
    out = pf.verify_fleet(HET_TABLES, _trace("poisson", lam=4 * LAM),
                          router=router, service=_port_svc(),
                          energy_table=ENERGY, b_max=BMAX, slo=3.0, **CPU)
    assert out["n_decisions"] > 0


@pytest.mark.parametrize("mode", ["poisson", "mmpp2", "diurnal"])
def test_verify_fleet_m1_rail(mode):
    out = pf.verify_fleet(TABLE, _trace(mode), router="jsq", service=_port_svc(),
                          energy_table=ENERGY, b_max=BMAX, **CPU)
    assert "single" in out and out["n_decisions"] > 0


def test_verify_fleet_budget_cut_and_expo_service():
    tr = _trace("poisson", lam=4 * LAM)
    pf.verify_fleet(HET_TABLES, tr, router="pow2", service=_port_svc(),
                    energy_table=ENERGY, b_max=BMAX, n_epochs=500, drain=False, **CPU)
    pf.verify_fleet(HET_TABLES, tr, router="jsq", service=_port_svc("expo"),
                    energy_table=ENERGY, b_max=BMAX, **CPU)


def test_python_fleet_equals_reference_python_fleet():
    tr = _trace("mmpp2", lam=4 * LAM)
    kw = dict(router="batch_aware", means=MEANS, zeta=ENERGY, b_max=BMAX, slo=3.0)
    got = pf.PythonFleet(HET_TABLES, tr, **kw).run()
    want = rf.PythonFleet(HET_TABLES, tr, **kw).run()
    assert got.decisions == want.decisions
    np.testing.assert_array_equal(got.latencies, want.latencies)
    assert (got.energy, got.slo_miss, got.t) == (want.energy, want.slo_miss, want.t)


@pytest.mark.parametrize("router", ["pow2", "batch_aware"])
def test_snapshot_restore_through_router_state(router):
    tr = _trace("poisson", lam=4 * LAM)
    fl = pf.PythonFleet(HET_TABLES, tr, router=router, means=MEANS, zeta=ENERGY,
                        b_max=BMAX, slo=3.0)
    for _ in range(400):
        if not fl.step():
            break
    snap = fl.snapshot()
    fl.run()
    ref = (list(fl.decisions), fl.latencies.copy(), fl.energy,
           fl.arr_server.copy(), fl.slo_miss, fl.t)
    fl.restore(snap)
    fl.run()
    assert list(fl.decisions) == ref[0]
    assert np.array_equal(fl.latencies, ref[1], equal_nan=True)
    assert fl.energy == ref[2]
    assert np.array_equal(fl.arr_server, ref[3])
    assert (fl.slo_miss, fl.t) == (ref[4], ref[5])


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

STREAM = ("n_served", "n_batches", "n_epochs", "n_admitted", "slo_miss",
          "n_crashes", "n_dropped", "n_shed", "t_final")


def same_aggregates(got, want):
    for k in STREAM:
        assert getattr(got, k) == getattr(want, k), (k, getattr(got, k), getattr(want, k))
    for k in ("hist", "qlen", "n_routed", "n_served_m"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)
    np.testing.assert_allclose(got.lat_sum, want.lat_sum, rtol=1e-12)


@pytest.mark.parametrize("router", ["jsq", "pow2"])
def test_stream_matches_one_shot_and_reference_stream(router):
    tr = _trace("poisson", n=3000, lam=4 * LAM)
    kw = dict(router=router, means=MEANS, zeta=ENERGY, b_max=BMAX, slo=3.0)
    st = pf.simulate_fleet_stream(HET_TABLES, tr, chunk_size=256, **kw, **CPU)
    one = pf.simulate_fleet(HET_TABLES, tr, **kw, **CPU)
    ref = rf.simulate_fleet_stream(HET_TABLES, tr, chunk_size=256, **kw)
    assert st.n_served == one.n_served == len(tr)
    same_aggregates(st, ref)
    if router == "jsq":  # pow2 draws its uniforms per chunk, one-shot at once
        same_aggregates(st, one)


def test_stream_shares_router_uniforms_and_reports_like_the_reference():
    tr = _trace("poisson", n=3000, lam=4 * LAM)
    ru = np.random.default_rng(5).random((len(tr), 2))
    kw = dict(router="pow2", means=MEANS, zeta=ENERGY, b_max=BMAX)
    one = pf.simulate_fleet(HET_TABLES, tr, router_u=ru, **kw, **CPU)
    fs = pf.FleetStream(HET_TABLES, **kw, **CPU)
    ref = rf.FleetStream(HET_TABLES, **kw)
    for lo in range(0, len(tr), 300):
        fs.push(tr[lo:lo + 300], router_u=ru[lo:lo + 300])
        ref.push(tr[lo:lo + 300], router_u=ru[lo:lo + 300])
    same_aggregates(fs.finish(), one)
    same_aggregates(fs.result(), ref.finish())
    got, want = fs.report(), ref.report()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_stream_refuses_save_resume_and_unsorted_chunks():
    fs = pf.FleetStream(HET_TABLES, means=MEANS, b_max=BMAX, **CPU)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        fs.save("somewhere")
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        pf.FleetStream.resume("somewhere")
    fs.push(np.array([1.0, 2.0]))
    with pytest.raises(ValueError, match="time-sorted"):
        fs.push(np.array([0.5]))


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def _grid_inputs():
    traces = [_trace("poisson", seed=s, lam=4 * LAM) for s in range(2)]
    return traces, pc.pad_arrivals_batch(traces)


def test_grid_cell_matches_simulate_fleet():
    traces, arr = _grid_inputs()
    policies = np.stack([TABLE, q_policy(10, 96, BMAX)])
    out = pf.run_fleet_grid(policies, arr, routers=ROUTER_NAMES, n_replicas=4,
                            means=MEANS, zeta=ENERGY, b_max=BMAX, router_seed=7, **CPU)
    ru = np.random.default_rng(7).random(arr.shape + (2,))
    for s, p, i in ((1, 1, 2), (0, 0, 3), (1, 0, 0)):
        ref = pf.simulate_fleet(
            np.tile(policies[p][None], (4, 1)), traces[s], router=ROUTER_NAMES[i],
            means=MEANS, zeta=ENERGY, b_max=BMAX, router_u=ru[s][: len(traces[s])],
            **CPU)
        for k in ("n_served", "n_batches", "n_epochs", "t_final", "slo_miss"):
            assert out[k][s, p, i] == getattr(ref, k), k
        np.testing.assert_array_equal(out["hist"][s, p, i], ref.hist)
        np.testing.assert_array_equal(out["n_route"][s, p, i], ref.n_routed)
        np.testing.assert_allclose(out["lat_sum"][s, p, i], ref.lat_sum, rtol=1e-12)
        np.testing.assert_allclose(out["energy"][s, p, i], ref.energy, rtol=1e-12)


FLOAT_KEYS = ("energy", "lat_sum", "w_mean", "power", "q_time_avg")


def same_grid(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        if k in FLOAT_KEYS:
            np.testing.assert_allclose(got[k], v, rtol=1e-12, equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["plain", "horizon", "budget"])
def test_grid_matches_reference_unsharded(case):
    traces, arr = _grid_inputs()
    policies = np.stack([TABLE, q_policy(10, 96, BMAX)])
    kw = dict(routers=ROUTER_NAMES, n_replicas=4, means=MEANS, zeta=ENERGY,
              b_max=BMAX, router_seed=7)
    if case == "horizon":
        kw.update(horizon=float(traces[0][800]), drain=False)
    elif case == "budget":
        kw.update(max_epochs=150)
    got = pf.run_fleet_grid(policies, arr, **kw, **CPU)
    same_grid(got, rf.run_fleet_grid(policies, arr, **kw))
    if case == "horizon":  # admitted = routed = served + still queued
        assert (got["n_route"].sum(axis=-1) == got["n_admitted"]).all()
        assert (got["n_served"] + got["qlen"].sum(axis=-1) == got["n_admitted"]).all()


@pytest.mark.parametrize("phase_mode", ["belief_argmax", "belief_mix"])
def test_grid_belief_lanes_match_reference(phase_mode):
    trace, bel, stacks = _belief_case(n=700)
    arr = pc.pad_arrivals_batch([trace])
    bels = np.zeros(arr.shape + (2,))
    bels[0, : len(trace)] = bel
    bels[0, len(trace):, 0] = 1.0
    kw = dict(routers=("jsq", "batch_aware"), means=MEANS, zeta=ENERGY,
              b_max=BMAX, phase_mode=phase_mode, beliefs=bels)
    same_grid(pf.run_fleet_grid(stacks[None], arr, **kw, **CPU),
              rf.run_fleet_grid(stacks[None], arr, **kw))


def test_grid_starved_lane_and_refusals():
    tr = 10.0 + np.cumsum(np.full(50, 0.1))
    out = pf.run_fleet_grid(TABLE[None], pc.pad_arrivals_batch([tr]), routers=("jsq",),
                            n_replicas=2, means=MEANS, zeta=ENERGY, b_max=BMAX,
                            horizon=1.0, drain=False, **CPU)
    assert out["n_served"][0, 0, 0] == 0
    assert np.isnan(out["w_mean"][0, 0, 0]) and np.isnan(out["power"][0, 0, 0])
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        pf.run_fleet_grid(TABLE[None], pc.pad_arrivals_batch([tr]), n_replicas=2,
                          means=MEANS, b_max=BMAX, mesh=object(), **CPU)
    with pytest.raises(ValueError, match="unknown router"):
        pf.simulate_fleet(TABLE, tr, router="random", means=MEANS, b_max=BMAX, **CPU)


def test_replicas_above_the_kernel_maximum_raise():
    M = fk.MAX_REPLICAS + 1
    tabs = np.tile(TABLE[None], (M, 1))
    with pytest.raises(ValueError, match=f"at most {fk.MAX_REPLICAS}"):
        pf.simulate_fleet(tabs, _trace("poisson", n=50), means=MEANS, b_max=BMAX, **CPU)
    ok = pf.simulate_fleet(tabs[:fk.MAX_REPLICAS], _trace("poisson", n=200, lam=20 * LAM),
                           router="rr", means=MEANS, zeta=ENERGY, b_max=BMAX, **CPU)
    assert ok.n_served == 200


@pytest.mark.parametrize("rid", [-1, 4])
def test_kernel_refuses_router_ids_outside_the_four(rid):
    tabs = pf._norm_tables(HOM_TABLES)
    M = tabs.shape[0]
    arr = pc.pad_arrivals_batch([_trace("poisson", n=50, lam=4 * LAM)])
    busy0, state0 = pf._fresh_state(M)
    q0 = np.full((M, 1), np.inf)
    max_eps, cap, _ = pf._budgets(50, M)
    args, kw = pf._kernel_args(
        "cpu", tabs[None], pf.threshold_gaps(tabs)[None], np.array([1, rid]), arr,
        np.full_like(arr, np.inf), np.zeros(arr.shape, np.int64),
        np.full(arr.shape + (2,), 0.5), np.ones((1, 1)), MEANS, ENERGY,
        pc.default_hist_edges(MEANS), np.full((M, 1), np.inf), np.ones((M, 1)), q0, q0,
        busy0, state0, None, None, t0=0.0, horizon=np.inf, max_eps=max_eps, drain=True,
        b_max=BMAX, buf_cap=pf._NO_BUFFER, max_retries=0, cap=cap)
    with pytest.raises(ValueError, match=rf"router ids \[{rid}\] outside 0\.\.3"):
        fk.fleet_scan(*args, **kw)
    ok = fk.fleet_scan(*args[:2], args[2][:1], *args[3:], **kw)
    assert ok.rep_i[0, fk.REP_I.index("n_srv")].sum() == 50
