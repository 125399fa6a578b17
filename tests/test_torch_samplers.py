"""Port vs reference: the on-device arrival samplers (serving.arrivals).

The port's poisson_times / mmpp2_times / diurnal_times draw from a
torch.Generator, the reference's *_times_jax from jax.random: they are
held in distribution only.

* the reference's own bars (tests/test_compiled.py TestJaxSamplers,
  tests/test_modulated.py's sampler tests): sorted output, an +inf tail,
  the rate within 5% (Poisson) or 10% (MMPP2, diurnal), the output
  feeding simulate_compiled and run_grid(phases=) end to end;
* a two-sample Kolmogorov-Smirnov test of the port's MMPP2 gaps against
  the reference sampler's, at alpha = 0.001 (one gap from each of 4000
  independent lanes / keys, so the samples are i.i.d.);
* the MMPP sampler kernel's plain walk, fed hand-made exponentials, equals
  exactly a numpy transcription of the reference's ``step``
  (src/repro/serving/arrivals.py:580-593);
* the diurnal rate in torch ops equals DiurnalProcess.rate.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

from repro.serving.arrivals import MMPP2 as RefMMPP2
from repro.serving.arrivals import mmpp2_times_jax
from repro_torch.core import GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel
from repro_torch.core.policies import q_policy
from repro_torch.kernels import mmpp_sample as mk
from repro_torch.serving import (
    MMPP2,
    DiurnalProcess,
    PhaseBeliefFilter,
    belief_forward,
    diurnal_times,
    mmpp2_times,
    pad_arrivals,
    poisson_times,
    run_grid,
    simulate_compiled,
)
from repro_torch.serving.arrivals import diurnal_rate

CPU = "cpu"
SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
BMAX = 16
LAM = 0.7 * BMAX / float(SVC.mean(BMAX))
MEANS = np.array([0.0] + [float(SVC.mean(b)) for b in range(1, BMAX + 1)])
ENERGY = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, BMAX + 1)])
KS_ALPHA = 1e-3


def test_poisson_times_statistics():
    t = poisson_times(0, 2.0, 20000, device=CPU).numpy()
    assert np.all(np.diff(t) > 0)
    assert abs(len(t) / t[-1] - 2.0) / 2.0 < 0.05
    lanes = poisson_times(torch.Generator().manual_seed(1), 2.0, 500, lanes=3, device=CPU)
    assert lanes.shape == (3, 500) and not torch.equal(lanes[0], lanes[1])


def test_mmpp2_times_sorted_and_rate():
    m = MMPP2(lam1=1.0, lam2=5.0, dwell1=50.0, dwell2=50.0)
    times, mask = (x.numpy() for x in mmpp2_times(1, m, 30000, device=CPU))
    n = int(mask.sum())
    assert mask[:n].all() and not mask[n:].any()
    assert np.all(np.isinf(times[n:]))
    assert np.all(np.diff(times[:n]) >= 0)
    rate = n / times[n - 1]
    assert abs(rate - m.mean_rate) / m.mean_rate < 0.1


def test_mmpp2_feeds_compiled_kernel():
    m = MMPP2(lam1=0.3 * LAM, lam2=1.3 * LAM, dwell1=60.0, dwell2=30.0)
    times, mask = mmpp2_times(2, m, 4096, device=CPU)
    res = simulate_compiled(q_policy(6, 96, BMAX), times, means=MEANS, zeta=ENERGY,
                            b_max=BMAX, device=CPU)
    assert res.n_served == int(mask.sum())
    assert res.terminated


def test_mmpp2_phases_feed_grid_and_belief_filter():
    """The sampler-carry phases drive the compiled phase lane, and the
    times feed the belief filter (posterior rows for every arrival)."""
    lam = 0.6 * BMAX / float(SVC.mean(BMAX))
    m = MMPP2(lam1=0.4 * lam, lam2=1.4 * lam, dwell1=80.0, dwell2=40.0)
    times, mask, phases = mmpp2_times(3, m, 2048, with_phases=True, device=CPU)
    n = int(mask.sum())
    assert phases.dtype == torch.int32 and set(phases[:n].tolist()) <= {0, 1}
    arr, _, ph = pad_arrivals(times[:n], phases=phases[:n])
    stack = np.stack([q_policy(4, 96, BMAX), q_policy(10, 96, BMAX)])
    g = run_grid(stack[None], arr[None], phases=ph[None], means=MEANS, zeta=ENERGY,
                 b_max=BMAX, device=CPU)
    assert int(g["n_served"][0, 0]) == n
    filt = PhaseBeliefFilter([m.lam1, m.lam2], [[-1 / 80.0, 1 / 80.0], [1 / 40.0, -1 / 40.0]])
    rows, (b_f, t_f) = belief_forward(times, filt, device=CPU)
    assert rows.shape == (len(times), 2) and float(t_f) == float(times[n - 1])
    assert torch.isfinite(rows).all()


def test_mmpp2_lanes_are_independent_traces():
    m = MMPP2(lam1=1.0, lam2=5.0, dwell1=20.0, dwell2=10.0)
    times, mask, phases = mmpp2_times(torch.Generator().manual_seed(4), m, 300,
                                      with_phases=True, lanes=5, device=CPU)
    assert times.shape == mask.shape == phases.shape == (5, 300)
    for s in range(5):
        n = int(mask[s].sum())
        assert torch.isinf(times[s, n:]).all() and (times[s, :n].diff() >= 0).all()
    assert not torch.equal(times[0], times[1])


def test_mmpp2_gaps_match_the_reference_in_distribution():
    """Two-sample KS: the 20th inter-arrival gap and the time of the 20th
    arrival, one value a lane, over 4000 lanes (port) and 4000 keys
    (reference)."""
    m = RefMMPP2(lam1=1.0, lam2=5.0, dwell1=20.0, dwell2=10.0)
    pm = MMPP2(lam1=1.0, lam2=5.0, dwell1=20.0, dwell2=10.0)
    n_lanes, steps = 4000, 60
    times, mask = mmpp2_times(5, pm, steps, lanes=n_lanes, device=CPU)
    times, mask = times.numpy(), mask.numpy()
    keys = jax.random.split(jax.random.PRNGKey(5), n_lanes)
    rt, rm = jax.vmap(lambda k: mmpp2_times_jax(k, m, steps))(keys)
    rt, rm = np.asarray(rt), np.asarray(rm)
    assert mask.sum(axis=1).min() >= 21 and rm.sum(axis=1).min() >= 21
    for stat in (lambda t: t[:, 20] - t[:, 19], lambda t: t[:, 19]):
        p = stats.ks_2samp(stat(times), stat(rt)).pvalue
        assert p > KS_ALPHA, p


def _numpy_step_walk(draws, lam, dwell):
    """The reference's ``step`` (arrivals.py:580-593) in numpy, with its
    two per-step exponentials taken from ``draws`` in order."""
    L, n = draws.shape[0], (draws.shape[1] - 1) // 2
    lam, dwell = np.asarray(lam), np.asarray(dwell)
    times = np.empty((L, n))
    emitted = np.empty((L, n), bool)
    phases = np.empty((L, n), np.int32)
    for ln in range(L):
        t, phase, nsw = np.float64(0.0), 0, draws[ln, 0] * dwell[0]
        for i in range(n):
            gap = draws[ln, 1 + 2 * i] / lam[phase]
            switch = t + gap >= nsw
            new_phase = 1 - phase if switch else phase
            t_new = nsw if switch else t + gap
            nsw = nsw + draws[ln, 2 + 2 * i] * dwell[new_phase] if switch else nsw
            t, phase = t_new, new_phase
            times[ln, i], emitted[ln, i], phases[ln, i] = t_new, not switch, new_phase
    return times, emitted, phases


@pytest.mark.parametrize("L,n", [(1, 1), (3, 400), (7, 57)])
def test_plain_walk_equals_the_reference_step_exactly(L, n):
    rng = np.random.default_rng(L * 1000 + n)
    draws = rng.exponential(size=(L, 1 + 2 * n))
    lam, dwell = (0.7, 3.1), (25.0, 7.5)
    got = mk.mmpp_sample(torch.as_tensor(draws), lam, dwell)
    want = _numpy_step_walk(draws, lam, dwell)
    assert got[0].dtype == torch.float64 and got[1].dtype == torch.bool
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert mk.mmpp_sample.launches == 0  # CPU tensors take the plain walk


def test_mmpp_sample_refuses_bad_draws():
    with pytest.raises(TypeError):
        mk.mmpp_sample(torch.zeros((1, 5), dtype=torch.float32), (1, 2), (3, 4))
    with pytest.raises(ValueError, match="1 \\+ 2 n_steps"):
        mk.mmpp_sample(torch.zeros((1, 4), dtype=torch.float64), (1, 2), (3, 4))


def test_diurnal_times_sorted_and_rate():
    p = DiurnalProcess(base=2.0, amp=1.2, period=150.0)
    t, m = (x.numpy() for x in diurnal_times(0, p, 16384, device=CPU))
    n = int(m.sum())
    assert np.all(np.isinf(t[n:]))
    assert np.all(np.diff(t[:n]) >= 0)
    assert abs(n / t[n - 1] - 2.0) / 2.0 < 0.1


def test_diurnal_ramp_rate_and_times():
    p = DiurnalProcess(period=100.0, phase0=7.0,
                       ramp=[(10.0, 1.0), (40.0, 4.0), (70.0, 2.0), (90.0, 0.5)])
    ts = np.random.default_rng(0).uniform(-50.0, 400.0, 2000)
    np.testing.assert_allclose(diurnal_rate(p, torch.as_tensor(ts)).numpy(), p.rate(ts),
                               rtol=1e-12, atol=1e-12)
    sine = DiurnalProcess(base=2.0, amp=1.2, period=150.0, phase0=3.0)
    np.testing.assert_allclose(diurnal_rate(sine, torch.as_tensor(ts)).numpy(),
                               sine.rate(ts), rtol=1e-12)
    t, m = diurnal_times(1, p, 20000, lanes=2, device=CPU)
    for s in range(2):
        n = int(m[s].sum())
        assert abs(n / float(t[s, n - 1]) - p.mean_rate) / p.mean_rate < 0.1


def test_a_seed_is_a_generator_seeded_with_it():
    m = MMPP2(lam1=1.0, lam2=5.0, dwell1=20.0, dwell2=10.0)
    a = mmpp2_times(7, m, 200, with_phases=True, device=CPU)
    b = mmpp2_times(torch.Generator().manual_seed(7), m, 200, with_phases=True,
                    device=CPU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(poisson_times(7, 2.0, 50, device=CPU),
                       poisson_times(torch.Generator().manual_seed(7), 2.0, 50,
                                     device=CPU))
