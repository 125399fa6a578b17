"""Port vs reference: the managed-queue and adaptive lanes, the grid runners.

The port runs with device="cpu" (the event kernel's plain version); the
reference runs its jitted scan on the same numpy inputs.  Held:

* simulate_compiled(buffer= / shed_expired=) on Poisson, MMPP2, diurnal
  and a deterministic trace: actions, latencies, counters, n_shed,
  n_expired, queue_slots and the histogram exact; energy and lat_sum at
  rtol 1e-12 (the reference sums in a tree, the kernel in serve order);
* AdaptiveLane.from_controller field for field, simulate_compiled(adaptive=)
  with its adaptive_state (the EWMA gap average at rtol 1e-12: XLA may
  fuse its multiply-add), and AdaptiveController observe by observe;
* the engine's post-run sync and a continued second run, and
  verify_backends(scheduler=AdaptiveController..., buffer=...);
* run_grid and run_grid_adaptive, every key but n_steps_used (the
  reference's step count of a fixed-length scan), NaN conventions included;
* the finite-buffer overload solve through backup="pallas" equal to
  "dense" and to the reference.

Sizes stay at a few hundred arrivals and few padded shapes: the reference
compiles its scan once per static shape.
"""
import math

import numpy as np
import pytest

from repro.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ServiceModel,
    SMDPSpec,
    solve as ref_solve,
)
from repro.core.policies import greedy_policy, q_policy, static_policy
from repro.serving import AdaptiveController as RefController
from repro.serving import ServingEngine as RefEngine
from repro.serving import SMDPSchedulerBank as RefBank
from repro.serving import compiled as rc
from repro_torch import core as pt
from repro_torch import interop
from repro_torch import serving as ps
from repro_torch.serving import arrivals as pa
from repro_torch.serving import compiled as pc

B_MAX = 32
SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
LAM = 0.7 * B_MAX / float(SVC.mean(B_MAX))
ENERGY = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, B_MAX + 1)])
MEANS = np.array([0.0] + [float(SVC.mean(b)) for b in range(1, B_MAX + 1)])
TABLE = q_policy(8, 128, B_MAX)
N = 400


def _trace(mode: str, n: int = N, seed: int = 0) -> np.ndarray:
    """Overloaded traces (gaps at 0.55x the 0.7-load fixture's), so the
    waiting room fills and deadlines lapse."""
    rng = np.random.default_rng(seed)
    if mode == "poisson":
        t = np.cumsum(rng.exponential(1.0 / LAM, n))
    elif mode == "mmpp2":
        m = pa.MMPP2(lam1=0.3 * LAM, lam2=1.3 * LAM, dwell1=60.0, dwell2=30.0)
        t = m.sample_arrivals(n / m.mean_rate, rng)[0]
    elif mode == "diurnal":
        proc = pa.DiurnalProcess(base=LAM, amp=0.8 * LAM, period=200.0)
        t = np.array([ev.time for ev in pa.take(proc, rng, n=n)[0]])
    else:  # deterministic bursts and gaps
        t = np.cumsum(np.tile([0.1, 0.1, 0.1, 5.0, 0.5], n // 5))
    return t * 0.55


def _port_svc(family="det"):
    return interop.spec_from_reference(
        SMDPSpec(lam=LAM, service=ServiceModel(latency=GOOGLENET_P4_LATENCY,
                                               family=family),
                 energy=GOOGLENET_P4_ENERGY)
    ).service


def _same_result(got, want):
    """A port CompiledResult against the reference's."""
    for key in ("n_served", "n_batches", "n_epochs", "n_admitted", "slo_miss",
                "terminated", "t_final", "n_shed", "n_expired"):
        assert getattr(got, key) == getattr(want, key), key
    np.testing.assert_array_equal(got.hist, want.hist)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)
    np.testing.assert_allclose(got.lat_sum, want.lat_sum, rtol=1e-12)
    if want.actions is not None:
        np.testing.assert_array_equal(got.actions, want.actions)
        np.testing.assert_array_equal(got.serve, want.serve)
        np.testing.assert_array_equal(got.latencies, want.latencies)
    if want.queue_slots is None:
        assert got.queue_slots is None
    else:
        np.testing.assert_array_equal(got.queue_slots, want.queue_slots)
    if want.adaptive_state is None:
        assert got.adaptive_state is None
    else:
        assert got.adaptive_state.keys() == want.adaptive_state.keys()
        for k, v in want.adaptive_state.items():
            g = got.adaptive_state[k]
            if k == "gap_bar":
                # XLA's CPU backend may fuse the EWMA's multiply-add; the
                # kernel rounds each operation, as the Python controller
                # does, and equals it bit for bit (the engine-sync test)
                np.testing.assert_allclose(g, v, rtol=1e-12, equal_nan=True)
            else:
                assert g == v or (math.isnan(g) and math.isnan(v)), k


def _both(tables, tr, **kw):
    want = rc.simulate_compiled(tables, tr, means=MEANS, b_max=B_MAX, **kw)
    lane = kw.pop("adaptive", None)
    if lane is not None:
        kw["adaptive"] = _port_controller(lane) if isinstance(
            lane, RefController) else lane
    got = pc.simulate_compiled(tables, tr, means=MEANS, b_max=B_MAX,
                               device="cpu", **kw)
    return got, want


# --- the managed-queue lane --------------------------------------------------

KNOBS = {
    "buffer": lambda tr: dict(buffer=10),
    "expiry": lambda tr: dict(deadlines=tr + 4.0, shed_expired=True),
    "both": lambda tr: dict(buffer=14, deadlines=tr + 5.0, shed_expired=True),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("mode", ["poisson", "mmpp2", "diurnal", "trace"])
def test_managed_queue_matches_reference(mode, knob):
    tr = _trace(mode)
    kw = KNOBS[knob](tr)
    if mode == "trace" and "buffer" in kw:
        kw["buffer"] = 2  # 3-bursts: only a shallow room refuses
    got, want = _both(TABLE, tr, zeta=ENERGY, record=True, **kw)
    _same_result(got, want)
    assert want.n_shed > 0 or want.n_expired > 0
    assert (got.n_served + got.n_expired + len(got.queue_slots)
            == got.n_admitted - got.n_shed)


def test_managed_queue_phase_stack_budget_and_survivors():
    tr = _trace("poisson")
    tabs = np.stack([q_policy(4, 128, B_MAX), q_policy(12, 128, B_MAX)])
    ph = (np.arange(len(tr)) // 150) % 2
    got, want = _both(tabs, tr, zeta=ENERGY, phases=ph, buffer=16,
                      deadlines=tr + 5.0, shed_expired=True, record=True)
    _same_result(got, want)
    # an epoch budget and no drain leave a surviving queue
    got, want = _both(q_policy(20, 128, B_MAX), tr, buffer=40,
                      deadlines=tr + 25.0, shed_expired=True, drain=False,
                      max_epochs=150, record=True)
    _same_result(got, want)
    assert len(got.queue_slots) > 0


def test_buffer_zero_sheds_everything():
    tr = _trace("poisson")
    got, want = _both(TABLE, tr, buffer=0, record=True)
    _same_result(got, want)
    assert got.n_served == 0 and got.n_shed == len(tr)


def test_managed_queue_rejections():
    tr = np.arange(1.0, 9.0)
    dl = tr + np.array([20.0, 16.0, 12.0, 8.0, 4.0, 2.0, 1.0, 0.5])
    with pytest.raises(ValueError, match="nondecreasing"):
        pc.simulate_compiled(TABLE, tr, means=np.array([0.0, 1.0]), b_max=1,
                             deadlines=dl, shed_expired=True, device="cpu")
    with pytest.raises(ValueError, match="belief"):
        pc.simulate_compiled(np.stack([TABLE, TABLE]), np.arange(1.0, 5.0),
                             means=np.array([0.0, 1.0]), b_max=1, buffer=4,
                             phase_mode="belief_mix",
                             beliefs=np.full((4, 2), 0.5), device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        pc.simulate_compiled(TABLE, tr, means=MEANS, b_max=B_MAX, buffer=-1,
                             device="cpu")


@pytest.mark.parametrize("mode", ["poisson", "mmpp2", "diurnal", "trace"])
def test_verify_backends_managed_queue(mode):
    out = ps.verify_backends(
        TABLE, _trace(mode), service=_port_svc(), energy_table=ENERGY,
        b_max=B_MAX, buffer=2 if mode == "trace" else 12, slo=5.0,
        shed_expired=True, device="cpu",
    )
    assert out["python"].n_shed + out["python"].n_expired > 0


def test_verify_backends_managed_queue_stochastic_budget_horizon():
    tr = _trace("poisson")
    ps.verify_backends(TABLE, tr, service=_port_svc("expo"), energy_table=ENERGY,
                       b_max=B_MAX, buffer=12, slo=5.0, shed_expired=True,
                       device="cpu")
    ps.verify_backends(TABLE, tr, service=_port_svc(), b_max=B_MAX,
                       n_epochs=250, buffer=10, slo=4.0, shed_expired=True,
                       device="cpu")
    ps.verify_backends(TABLE, tr, service=_port_svc(), b_max=B_MAX,
                       horizon=float(tr[len(tr) // 2]), buffer=10, slo=4.0,
                       shed_expired=True, device="cpu")


# --- the adaptive lane -------------------------------------------------------

def _banks(two_dims: bool):
    """The same bank in both packages: keyed (lam,) or (lam, w2)."""
    tabs = [q_policy(8, 128, B_MAX), static_policy(8, 128), q_policy(16, 96, B_MAX)]
    lams = [0.5 * LAM, LAM, 2 * LAM]
    if two_dims:
        keys = [(lam, w2) for lam in lams for w2 in (0.5, 1.0)]
        tables = {k: tabs[i // 2] for i, k in enumerate(keys)}
        names = ("lam", "w2")
    else:
        tables = {(lam,): t for lam, t in zip(lams, tabs)}
        names = ("lam",)
    return RefBank(tables, key_names=names), ps.SMDPSchedulerBank(tables, key_names=names)


CONTROLLERS = {
    "lam": (False, dict(ewma=0.2, margin=0.1, min_dwell=5.0)),
    "lam_w2": (True, dict(ewma=0.3, margin=0.0, w2=1.0)),
    "init_rate": (False, dict(ewma=0.15, margin=0.2, min_dwell=20.0,
                              init_rate=1.7 * LAM)),
}


def _port_controller(ref_ctrl):
    """The port's controller in the reference controller's exact state."""
    bank = ps.SMDPSchedulerBank(ref_ctrl.bank.tables, key_names=ref_ctrl.bank.key_names)
    est = ref_ctrl.estimator
    ctrl = ps.AdaptiveController(
        bank, estimator=ps.RateEstimator(ewma=est.ewma, init=est._init_rate,
                                         min_gap=est.min_gap),
        margin=ref_ctrl.margin, min_dwell=ref_ctrl.min_dwell, **ref_ctrl.fixed,
    )
    ctrl.restore(ref_ctrl.snapshot())
    return ctrl


def _controllers(name):
    two, kw = CONTROLLERS[name]
    rb, pb = _banks(two)
    return RefController(rb, **kw), ps.AdaptiveController(pb, **kw)


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_controller_observe_by_observe(name):
    ref, port = _controllers(name)
    assert port.key == ref.key
    for t in _trace("mmpp2", 300):
        ref.observe_arrival(float(t))
        port.observe_arrival(float(t))
        assert port.key == ref.key
        assert port.n_switches == ref.n_switches
        assert port._last_switch == ref._last_switch
        assert port.estimator.snapshot() == ref.estimator.snapshot()
        assert port.decide(9) == ref.decide(9)
    assert ref.n_switches > 0
    assert port.snapshot() == ref.snapshot()


def test_window_estimator_stays_on_the_python_backend():
    _, pb = _banks(False)
    ctrl = ps.AdaptiveController(pb, estimator=ps.RateEstimator(window=16))
    with pytest.raises(TypeError, match="EWMA"):
        pc.AdaptiveLane.from_controller(ctrl)
    eng = ps.ServingEngine(ctrl, lam=LAM, b_max=B_MAX, service=_port_svc(),
                           device="cpu")
    with pytest.raises(TypeError, match="EWMA"):
        eng.run(100, backend="compiled")


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_adaptive_lane_lowering_field_for_field(name, warm):
    ref, _ = _controllers(name)
    if warm:  # a controller mid-stream: its live state is the lane's start
        for t in _trace("mmpp2", 200):
            ref.observe_arrival(float(t))
    want = rc.AdaptiveLane.from_controller(ref)
    got = pc.AdaptiveLane.from_controller(_port_controller(ref))
    for field in want.__dataclass_fields__:
        g, w = getattr(got, field), getattr(want, field)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w or (math.isnan(g) and math.isnan(w)), field


@pytest.mark.parametrize("buffer", [None, 12])
@pytest.mark.parametrize("mode", ["poisson", "mmpp2"])
@pytest.mark.parametrize("name", ["lam", "lam_w2"])
def test_adaptive_lane_matches_reference(name, mode, buffer):
    ref, _ = _controllers(name)
    got, want = _both(None, _trace(mode), zeta=ENERGY, adaptive=ref,
                      buffer=buffer, record=True)
    _same_result(got, want)
    assert want.adaptive_state["n_switches"] > 0


@pytest.mark.parametrize("knobs", [{}, dict(buffer=12, slo=5.0, shed_expired=True)])
@pytest.mark.parametrize("mode", ["poisson", "mmpp2"])
def test_verify_backends_adaptive(mode, knobs):
    _, pb = _banks(True)
    out = ps.verify_backends(
        None, _trace(mode), service=_port_svc(), energy_table=ENERGY,
        b_max=B_MAX, device="cpu",
        scheduler=lambda: ps.AdaptiveController(pb, ewma=0.2, margin=0.1,
                                                min_dwell=5.0, w2=0.5),
        **knobs,
    )
    assert out["n_decisions"] > 0


def _engine_state(eng):
    ctrl = eng.scheduler
    return dict(
        t=eng.t, rids=[r.rid for r in eng.queue], next_rid=eng.next_rid,
        key=ctrl.key, n_switches=ctrl.n_switches, last_switch=ctrl._last_switch,
        est=ctrl.estimator.snapshot(), table=ctrl.scheduler.table.tolist(),
    )


@pytest.mark.parametrize("knobs", [{}, dict(buffer=10, slo=4.0, shed_expired=True)])
def test_engine_sync_and_continued_run(knobs):
    """Two compiled runs in a row equal two Python runs in a row and the
    reference's two compiled runs: the engine, its queue and the
    controller are synced after each."""
    rb, pb = _banks(False)
    kw = dict(ewma=0.2, margin=0.1, min_dwell=5.0)
    mk = dict(lam=1.8 * LAM, b_max=B_MAX, energy_table=ENERGY, seed=11, **knobs)
    ref = RefEngine(RefController(rb, **kw), service=SVC, **mk)
    c = ps.ServingEngine(ps.AdaptiveController(pb, **kw), service=_port_svc(),
                         device="cpu", **mk)
    py = ps.ServingEngine(ps.AdaptiveController(pb, **kw), service=_port_svc(),
                          device="cpu", **mk)
    carried = 0  # requests a compiled run re-admits from the engine's queue
    for n in (300, 200):
        carried += len(c.queue)
        r_ref = ref.run(n, backend="compiled")
        r_c = c.run(n, backend="compiled")
        r_py = py.run(n)
        for other in (r_ref, r_py):
            np.testing.assert_array_equal(r_c.batch_sizes, other.batch_sizes)
            np.testing.assert_array_equal(r_c.latencies, other.latencies)
            assert (r_c.n_shed, r_c.n_expired) == (other.n_shed, other.n_expired)
            np.testing.assert_allclose(r_c.energy, other.energy, rtol=1e-12)
        state = _engine_state(c)
        want = _engine_state(ref)
        # the reference's lane may fuse the EWMA's multiply-add (XLA)
        np.testing.assert_allclose(state["est"].pop("gap_bar"),
                                   want["est"].pop("gap_bar"), rtol=1e-12)
        assert state == want
        # the Python loop gave its peeked (not admitted) arrival a rid; the
        # compiled sync counts a carried request as observed again (the
        # reference's rule, n_observed += n_admitted - n_shed)
        state = _engine_state(c)
        want = _engine_state(py)
        assert want.pop("next_rid") == state.pop("next_rid") + 1
        assert want["est"].pop("n_observed") + carried == state["est"].pop("n_observed")
        assert state == want
    assert c.scheduler.n_switches > 0


# --- the grid runners --------------------------------------------------------

def _grid_traces(n_seeds=2, n=300):
    traces = [np.cumsum(np.random.default_rng(s).exponential(1.0 / LAM, n))
              for s in range(1, n_seeds + 1)]
    return traces, pc.pad_arrivals_batch(traces)


def _same_grid(got, want):
    assert set(got) == set(want) - {"n_steps_used"}
    for k, w in want.items():
        if k == "n_steps_used":
            continue
        g = got[k]
        if k in ("energy", "lat_sum", "w_mean", "power", "ad_gap_bar"):
            np.testing.assert_allclose(g, w, rtol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
            assert np.asarray(g).dtype.kind == np.asarray(w).dtype.kind, k


def test_pad_arrivals_batch_matches_reference():
    traces, arrs = _grid_traces()
    np.testing.assert_array_equal(arrs, rc.pad_arrivals_batch(traces))
    with pytest.raises(ValueError):
        pc.pad_arrivals_batch([])


@pytest.mark.parametrize("zeta", [ENERGY, None])
def test_run_grid_matches_reference(zeta):
    _, arrs = _grid_traces()
    q8 = q_policy(8, 128, B_MAX)
    never = np.zeros_like(q8)  # never serves: starved with no drain
    tabs = np.stack([q8, static_policy(8, 128), greedy_policy(128, 1, B_MAX), never])
    kw = dict(means=MEANS, zeta=zeta, b_max=B_MAX, drain=False,
              deadlines=arrs + 6.0)
    got = pc.run_grid(tabs, arrs, device="cpu", **kw)
    want = rc.run_grid(tabs, arrs, **kw)
    _same_grid(got, want)
    assert got["w_mean"].shape == (2, 4) and np.isnan(got["w_mean"][:, 3]).all()
    assert np.isnan(got["power"]).all() == (zeta is None)


def test_run_grid_adaptive_matches_reference():
    traces, arrs = _grid_traces()
    ref, _ = _controllers("lam")
    lane_ref = rc.AdaptiveLane.from_controller(ref)
    kw = dict(means=MEANS, zeta=ENERGY, b_max=B_MAX)
    want = rc.run_grid_adaptive(arrs, adaptive=lane_ref, **kw)
    got = pc.run_grid_adaptive(arrs, adaptive=_port_controller(ref),
                               device="cpu", **kw)
    _same_grid(got, want)
    assert (got["ad_n_switches"] > 0).all()
    # each lane equals a single adaptive run on its own trace
    for s, tr in enumerate(traces):
        one = pc.simulate_compiled(None, tr, adaptive=_port_controller(ref),
                                   device="cpu", **kw)
        assert one.n_served == got["n_served"][s]
        assert one.adaptive_state["n_switches"] == got["ad_n_switches"][s]


# --- the finite-buffer overload solve ----------------------------------------

def test_finite_buffer_solve_kernel_path_matches_dense_and_reference():
    b_max = 16
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    lam = 1.2 * b_max / float(svc.mean(b_max))
    spec = SMDPSpec(lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY, b_min=1,
                    b_max=b_max, w1=1.0, w2=1.0, s_max=24, buffer=24,
                    c_drop=50.0)
    port = interop.spec_from_reference(spec)
    kern = pt.solve(port, backup="pallas", device="cpu")
    dense = pt.solve(port, backup="dense", device="cpu")
    np.testing.assert_array_equal(kern.action_table(), dense.action_table())
    np.testing.assert_array_equal(kern.action_table(),
                                  ref_solve(spec).action_table())
    # the drop price pulls the serve-from threshold below the blind table's
    aware_from = int(np.argmax(kern.action_table() > 0))
    blind = pt.solve(interop.spec_from_reference(
        SMDPSpec(lam=0.7 * b_max / float(svc.mean(b_max)), service=svc,
                 energy=GOOGLENET_P4_ENERGY, b_min=1, b_max=b_max, w1=1.0,
                 w2=1.0, s_max=128)), device="cpu")
    assert aware_from < int(np.argmax(blind.action_table() > 0))
