"""Port vs reference: the independent queue simulator (core.simulate).

* the reference's own bars (tests/test_serving.py): simulate's W within
  rtol 0.02 of evaluate_policy and its P of the serving engine's, Little's
  law within 0.02, simulate_events (Python loop and the compiled event
  lane) the same, at 60 000 epochs;
* the port's simulate against the reference's on the same policy, in
  distribution (another generator): W, P, P50 and P95 within rtol 0.03;
* the simulator kernel's plain walk, fed hand-made draws on a det service,
  equals exactly an independent numpy loop (an unbounded list FIFO, no
  ring) over 8 000 epochs of static-8 -- more than 2^15 requests, so the
  ring wraps -- and with k_max = 3, where services clip;
* a clipped service keeps its k_max arrivals in the reference's law, spread
  uniformly over the service (a KS test on >= 2000 clipped services, which
  the earliest k_max arrivals of the same draws fail);
* every service family runs; a run that outruns its arrival stream
  raises.
"""
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import GOOGLENET_P4_LATENCY as REF_LATENCY
from repro.core import ServiceModel as RefServiceModel
from repro.core.simulate import simulate as ref_simulate
from repro_torch.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ServiceModel,
    SMDPSpec,
    build_smdp,
    evaluate_policy,
    solve,
    static_policy,
)
from repro_torch.core import simulate as psim
from repro_torch.core.simulate import simulate, simulate_events
from repro_torch.kernels import sim_scan as sk
from repro_torch.serving import ServingEngine, StaticScheduler

CPU = "cpu"
SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
BMAX = 32
LAM = 0.7 * BMAX / float(SVC.mean(BMAX))
ENERGY = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, BMAX + 1)])


def spec(w2=1.0, s_max=128, svc=SVC):
    return SMDPSpec(lam=LAM, service=svc, energy=GOOGLENET_P4_ENERGY, b_min=1,
                    b_max=BMAX, w1=1.0, w2=w2, s_max=s_max, c_o=100.0)


def test_simulator_matches_evaluation_and_engine():
    pol = static_policy(8, 128)
    ev = evaluate_policy(build_smdp(spec()), pol)
    sim = simulate(pol[:-1], SVC, ENERGY, LAM, BMAX, n_epochs=60_000, seed=1, device=CPU)
    rep = ServingEngine(StaticScheduler(8), lam=LAM, b_max=BMAX, service=SVC,
                        energy_table=ENERGY, seed=2, device=CPU).run(60_000)
    np.testing.assert_allclose(sim.w_bar, ev.w_bar, rtol=0.02)
    np.testing.assert_allclose(sim.p_bar, ev.p_bar, rtol=0.02)
    np.testing.assert_allclose(rep.power, sim.p_bar, rtol=0.02)
    assert sim.n_served == len(sim.response_times) and sim.n_clipped_arrivals == 0


def test_littles_law_in_simulator():
    pol = static_policy(8, 128)
    sim = simulate(pol[:-1], SVC, ENERGY, LAM, BMAX, n_epochs=60_000, seed=3, device=CPU)
    np.testing.assert_allclose(sim.l_bar / LAM, sim.w_bar, rtol=0.02)


@pytest.mark.parametrize("backend", ["python", "compiled"])
def test_simulate_events_delegates_to_the_engine(backend):
    pol = static_policy(8, 128)
    ev = evaluate_policy(build_smdp(spec()), pol)
    sim = simulate_events(pol, SVC, ENERGY, LAM, BMAX, n_epochs=60_000, seed=4,
                          backend=backend, device=CPU)
    np.testing.assert_allclose(sim.w_bar, ev.w_bar, rtol=0.02)
    np.testing.assert_allclose(sim.p_bar, ev.p_bar, rtol=0.02)
    np.testing.assert_allclose(sim.l_bar / LAM, sim.w_bar, rtol=0.02)


def test_port_simulate_matches_the_reference_in_distribution():
    """The SMDP policy at w2 = 1.6 (Fig. 6): W, P, P50 and P95 of the port's
    simulate within 0.03 of the reference's."""
    pol = solve(spec(w2=1.6), device=CPU).rvi.policy
    ref_svc = RefServiceModel(latency=REF_LATENCY, family="det")
    want = ref_simulate(pol[:-1], ref_svc, ENERGY, LAM, BMAX, n_epochs=60_000, seed=0)
    got = simulate(pol[:-1], SVC, ENERGY, LAM, BMAX, n_epochs=60_000, seed=0, device=CPU)
    np.testing.assert_allclose(got.w_bar, want.w_bar, rtol=0.03)
    np.testing.assert_allclose(got.p_bar, want.p_bar, rtol=0.03)
    np.testing.assert_allclose(got.percentile([50, 95]), want.percentile([50, 95]),
                               rtol=0.03)


def _numpy_loop(pol, means, en, arr, lam, E, k_max):
    """simulate()'s epoch step on a det service, written with an unbounded
    list FIFO: (acts, responses, t, integral, energy, clipped)."""
    fifo, acts, resp = [], [], []
    s, cur, clipped = 0, 0, 0
    t = q = energy = 0.0
    for _ in range(E):
        a = int(pol[min(s, len(pol) - 1)])
        if a > s:
            a = 0
        if a == 0:
            dt = arr[cur] / lam
            cur += 1
            q += s * dt
            t += dt
            fifo.append(t)
            s += 1
            acts.append(0)
            continue
        T = means[a]
        t_next = t + T
        resp += [t_next - x for x in fifo[:a]]
        del fifo[:a]
        c, contrib, offs = 0.0, 0.0, []
        while True:
            c += arr[cur] / lam
            cur += 1
            if not c < T:
                break
            if len(offs) == k_max:  # clipped: the kept k_max spread over T
                clipped += 1
                offs = [(x / c) * T for x in offs]
                break
            offs.append(c)
        for x in offs:
            fifo.append(t + x)
            contrib += T - x
        n = len(offs)
        q += s * T + contrib
        energy += en[a]
        s += n - a
        t = t_next
        acts.append(a)
    return np.array(acts), np.array(resp), t, q, energy, clipped


@pytest.mark.parametrize("k_max", [64, 3])
def test_plain_walk_equals_an_independent_numpy_loop(k_max):
    E = 8_000
    pol = static_policy(8, 128)[:-1]
    fam, k, W, means, cum, scales = psim.service_params(SVC, BMAX)
    rng = np.random.default_rng(k_max)
    arr = rng.exponential(size=(1, 12 * E))
    out = sk.sim_scan(torch.as_tensor(pol), torch.as_tensor(means),
                      torch.as_tensor(ENERGY), torch.as_tensor(cum),
                      torch.as_tensor(scales), torch.zeros((1, E, 0), dtype=torch.float64),
                      torch.as_tensor(arr), fam=fam, erlang_k=k, lam=LAM, k_max=k_max,
                      R=E * 8)
    acts, resp, t, q, energy, clipped = _numpy_loop(pol, means, ENERGY, arr[0], LAM, E,
                                                    k_max)
    assert int(out.exhausted[0]) == -1 and sk.sim_scan.launches == 0
    n = int(out.n_served[0])
    if k_max == 64:
        assert n > sk.BUF  # the ring wrapped
    else:
        assert clipped > 0
    np.testing.assert_array_equal(out.acts[0].numpy(), acts)
    np.testing.assert_array_equal(out.resp[0, :n].numpy(), resp)
    assert (float(out.t[0]), float(out.qint[0]), float(out.energy[0]),
            int(out.clipped[0])) == (t, q, energy, clipped)


@pytest.mark.parametrize("family,extra", [
    ("det", {}), ("expo", {}), ("erlang", dict(erlang_k=3)), ("hyperexpo", {}),
    ("atoms", dict(atom_weights=(0.5, 0.3, 0.2), atom_scales=(0.5, 1.0, 2.0)))])
def test_every_service_family_runs(family, extra):
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family=family, **extra)
    pol = static_policy(8, 128)
    sim = simulate(pol[:-1], svc, ENERGY, LAM, BMAX, n_epochs=4_000, seed=5, device=CPU)
    assert sim.n_served > 0 and np.isfinite(sim.response_times).all()
    assert (sim.response_times > 0).all()
    np.testing.assert_allclose(sim.l_bar / LAM, sim.w_bar, rtol=0.1)
    fam, k, W, *_ = psim.service_params(svc, BMAX)
    assert sk.FAMILIES[fam] == family and W == {"det": 0, "expo": 1, "erlang": 3,
                                                 "hyperexpo": 2, "atoms": 1}[family]


def test_outrunning_the_arrival_stream_raises(monkeypatch):
    pol = static_policy(8, 128)[:-1]
    monkeypatch.setattr(psim, "arrival_stream_size", lambda *a: 50)
    with pytest.raises(RuntimeError, match="ran out"):
        simulate(pol, SVC, ENERGY, LAM, BMAX, n_epochs=1_000, device=CPU)


def test_arrival_stream_sizing_rule():
    """n (1 + lam m) + 8 sd + 64, never above n (k_max + 1)."""
    A = psim.arrival_stream_size(1000, 2.0, 3.0, 9.0, 64)
    mean, sd = 1000 * 7.0, np.sqrt(1000 * (1 + 18.0 + 36.0))
    assert A == int(np.ceil(mean + 8 * sd + 64))
    assert psim.arrival_stream_size(1000, 2.0, 3.0, 9.0, 2) == 3000


def test_clipped_arrivals_are_spread_uniformly_over_the_service():
    """With k_max = 4 at lam T = 40 every service clips.  Serve-all on a det
    service: a request that arrived at offset c of a service of length T
    leaves when the next one ends, so its response is 2 T - c.  The kept
    offsets over T are k_max sorted uniforms, which pooled are U(0, 1) (the
    reference's sort(u) * T); the earliest k_max of the same draws are not."""
    k_max, T, E = 4, 2.0, 2_100
    lam = 40.0 / T
    means = torch.tensor([0.0] + [T] * k_max, dtype=torch.float64)
    pol = torch.arange(k_max + 1, dtype=torch.int64)  # serve all (at most k_max)
    arr = np.random.default_rng(7).exponential(size=(1, E * (k_max + 1) + 8))
    out = sk.sim_scan(pol, means, torch.zeros(k_max + 1, dtype=torch.float64),
                      torch.ones(1, dtype=torch.float64), torch.ones(1, dtype=torch.float64),
                      torch.zeros((1, E, 0), dtype=torch.float64), torch.as_tensor(arr),
                      fam=0, erlang_k=1, lam=lam, k_max=k_max, R=E * k_max)
    n_clipped = int(out.clipped[0])
    assert n_clipped == E - 1 >= 2000  # every epoch but the first wait clips
    resp = out.resp[0, :int(out.n_served[0])].numpy()
    offs = (2 * T - resp[1:]) / T  # the first response is the waited-for request's
    assert len(offs) >= 2000 * k_max and ((offs > 0) & (offs < 1)).all()
    assert stats.kstest(offs, "uniform").pvalue > 0.01
    # the earliest k_max offsets of the same draws (each service reads k_max
    # + 1 gaps after the first epoch's one)
    gaps = arr[0, 1:1 + (E - 1) * (k_max + 1)].reshape(E - 1, k_max + 1) / lam
    earliest = np.cumsum(gaps, axis=1)[:, :k_max].ravel() / T
    assert stats.kstest(earliest, "uniform").pvalue < 1e-6
