"""Port vs reference: the MMPP phase belief and the belief serving lanes.

The port runs with device="cpu" (the belief kernel's and the event
kernel's plain versions); the reference runs its numpy filter and jitted
scans on the same numpy inputs.  Held:

* PhaseBeliefFilter bit for bit against the reference's (rows, snapshot);
* belief_forward_ref bit for bit against folding the numpy filter (the
  products are the fused multiply-add chains numpy's BLAS takes, the sums
  numpy's order), within atol 1e-15 of belief_forward_jax, over padded
  tails and an (S, N) batch, and into the stationary fallback after a gap
  that underflows the propagation;
* belief_forward_chunked_ref (the belief kernel's time-parallel algorithm:
  chunk products, chunk starts, exact folds from the starts) within atol
  1e-12 of belief_forward_jax and of the serial fold, argmax rows equal,
  at chunks of 1, 7, 32 and N slots, through an underflowing gap (pass B
  folds that chunk exactly), a zero-rate phase, K = 3 and 8 with complex
  eigenvalues, padded slots and a wholly padded trace; its rows over a
  prefix of the slots bit for bit those of a call on the prefix;
* BeliefPhaseScheduler in both modes through the compiled engine against
  the Python engine (batch sizes equal, latencies at atol 1e-9, the
  reference's bar) and against the reference's engine; verify_backends
  with belief and AdaptiveController(phase_filter=) factories;
* run_grid / run_grid_adaptive belief modes against the reference's
  (aggregates exact, energy and lat_sum at rtol 1e-12), belief_argmax equal
  to its explicit phase stream, belief_mix different from argmax somewhere;
* two half-horizon compiled runs equal one full run, the belief resumed
  (the re-admitted queue counted observed again, as the reference counts it);
* solve_phase_policies, PhaseAwareScheduler and the controller's snapshot /
  restore with a filter against the reference.

Sizes stay at b_max 16 and a few thousand arrivals.
"""
import numpy as np
import pytest
import torch

from repro.core import GOOGLENET_P4_ENERGY, GOOGLENET_P4_LATENCY, ServiceModel, SMDPSpec
from repro.core.policies import q_policy
from repro.serving import AdaptiveController as RefController
from repro.serving import BeliefPhaseScheduler as RefBelief
from repro.serving import PhaseAwareScheduler as RefPhaseAware
from repro.serving import PhaseBeliefFilter as RefFilter
from repro.serving import ServingEngine as RefEngine
from repro.serving import SMDPSchedulerBank as RefBank
from repro.serving import TraceProcess as RefTrace
from repro.serving import solve_phase_policies as ref_solve_phase_policies
from repro.serving.arrivals import belief_forward_jax
from repro.serving import compiled as rc
from repro_torch import interop
from repro_torch import serving as ps
from repro_torch.kernels import belief_forward as bf
from repro_torch.serving import arrivals as pa
from repro_torch.serving import compiled as pc

CPU = "cpu"
BMAX = 16
SVC = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
LAM = 0.7 * BMAX / float(SVC.mean(BMAX))
EN = np.array([0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(1, BMAX + 1)])
MEANS = np.array([0.0] + [float(SVC.mean(b)) for b in range(1, BMAX + 1)])
RATES = [0.3 * LAM, 1.3 * LAM]
GEN = [[-1 / 60.0, 1 / 60.0], [1 / 30.0, -1 / 30.0]]
STACK = np.stack([q_policy(4, 128, BMAX), q_policy(12, 128, BMAX)])


def _psvc():
    return interop.spec_from_reference(SMDPSpec(lam=LAM, service=SVC,
                                                energy=GOOGLENET_P4_ENERGY)).service


def _trace(n=1200, seed=0):
    m = pa.MMPP2(lam1=RATES[0], lam2=RATES[1], dwell1=60.0, dwell2=30.0)
    return np.asarray(m.sample_arrivals(n / m.mean_rate, np.random.default_rng(seed))[0])


def _fold(filt, times):
    rows = np.empty((len(times), len(filt.rates)))
    for i, t in enumerate(times):
        filt.observe(t)
        rows[i] = filt.belief
    return rows


# --- the filter and the plain fold -------------------------------------------


def test_filter_equals_the_reference_bit_for_bit():
    tr = _trace(900, 1)
    got, want = pa.PhaseBeliefFilter(RATES, GEN), RefFilter(RATES, GEN)
    np.testing.assert_array_equal(got._b0, want._b0)
    np.testing.assert_array_equal(_fold(got, tr), _fold(want, tr))
    assert got.snapshot() == want.snapshot() and got.phase == want.phase
    snap = got.snapshot()
    got.observe(tr[-1] + 3.0)
    got.restore(snap)
    assert got.snapshot() == want.snapshot()


def test_plain_fold_equals_the_filter_bit_for_bit():
    tr = _trace(2000, 2)
    filt = pa.PhaseBeliefFilter(RATES, GEN)
    b0 = filt.belief.copy()
    bel, (b_fin, t_fin) = pa.belief_forward(tr, filt, device=CPU)
    want = _fold(pa.PhaseBeliefFilter(RATES, GEN), tr)
    np.testing.assert_array_equal(bel.numpy(), want)
    np.testing.assert_array_equal(b_fin.numpy(), want[-1])
    assert float(t_fin) == tr[-1]
    np.testing.assert_array_equal(filt.belief, b0)  # not mutated
    assert filt.n_observed == 0


def test_plain_fold_within_1e15_of_the_reference_scan():
    tr = _trace(2000, 3)
    got, (b_fin, t_fin) = pa.belief_forward(tr, pa.PhaseBeliefFilter(RATES, GEN), device=CPU)
    want, (wb, wt) = belief_forward_jax(tr, RefFilter(RATES, GEN))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    np.testing.assert_allclose(b_fin.numpy(), np.asarray(wb), rtol=0, atol=1e-15)
    assert float(t_fin) == float(wt)


def test_padded_tails_and_a_batch():
    tr = _trace(600, 4)
    padded = np.concatenate([tr[:200], [np.nan], tr[200:], np.full(9, np.inf)])
    two = np.stack([padded, padded + 0.75])
    filt = pa.PhaseBeliefFilter(RATES, GEN)
    filt.observe(0.1)  # start mid-stream: the state is the filter's
    bel, (b_fin, t_fin) = pa.belief_forward(two, filt, device=CPU)
    assert bel.shape == (2, len(padded), 2)
    want, (wb, wt) = belief_forward_jax(two, _ref_copy(filt))
    np.testing.assert_allclose(bel.numpy(), np.asarray(want), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(bel[:, 200], bel[:, 199])  # the hole keeps the carry
    np.testing.assert_array_equal(bel[:, -1], bel[:, len(tr)])  # the tail repeats
    np.testing.assert_array_equal(t_fin.numpy(), [tr[-1], tr[-1] + 0.75])
    one, _ = pa.belief_forward(padded, filt, device=CPU)
    np.testing.assert_array_equal(one.numpy(), bel[0].numpy())


def _ref_copy(filt):
    ref = RefFilter(filt.rates, filt.gen)
    ref.restore(filt.snapshot())
    return ref


def test_a_gap_that_underflows_takes_the_stationary_fallback():
    tr = np.array([1.0, 2.0, 2.0e6, 2.0e6 + 0.5])
    filt = pa.PhaseBeliefFilter(RATES, GEN)
    bel, _ = pa.belief_forward(tr, filt, device=CPU)
    fb = filt._b0 * filt.rates / (filt._b0 * filt.rates).sum()
    np.testing.assert_array_equal(bel[2].numpy(), fb)
    np.testing.assert_array_equal(bel.numpy(), _fold(pa.PhaseBeliefFilter(RATES, GEN), tr))


def test_the_wrapper_checks_its_inputs():
    filt = pa.PhaseBeliefFilter(RATES, GEN)
    c = filt.consts(torch.device(CPU))
    with pytest.raises(TypeError, match="times"):
        bf.belief_forward(torch.zeros(3), torch.as_tensor(filt.belief), 0.0, c)
    with pytest.raises(ValueError, match="phases"):
        nine = [1.0] * 9
        big = pa.PhaseBeliefFilter(nine, np.zeros((9, 9)))
        bf.belief_forward(torch.zeros(1, 3, dtype=torch.float64),
                          torch.as_tensor(big.belief), 0.0, big.consts(torch.device(CPU)))
    with pytest.raises(ValueError, match="1-D or 2-D"):
        pa.belief_forward(np.zeros((1, 1, 3)), filt, device=CPU)


def _cyclic(K, a, rates):
    """A K-phase cycle 0 -> 1 -> ... -> 0 at rate a (complex eigenvalues of
    R - Lambda when a is large beside the rates' spread)."""
    gen = np.zeros((K, K))
    for k in range(K):
        gen[k, k], gen[k, (k + 1) % K] = -a, a
    return list(rates), gen.tolist()


def _chunk_case(case):
    """(rates, gen, (S, N) times, chunk sizes, the filter's start time)."""
    tr = _trace(700, 20)
    if case.startswith("chunk"):
        two = np.stack([tr, np.concatenate([tr[:300] + 0.25, [np.nan], tr[301:500] + 0.25,
                                            np.full(len(tr) - 500, np.inf)])])
        C = int(case[5:]) if case[5:] != "N" else two.shape[1]
        return RATES, GEN, two, C, 0.0
    if case == "underflow":  # a gap no propagation survives, mid-chunk
        t = np.concatenate([tr[:100], tr[100:] + 2.0e6])
        return RATES, GEN, t[None], 7, 0.0
    if case == "zero_rate":
        return [0.0, RATES[1]], GEN, tr[None], 32, 0.0
    if case == "padded":
        t = np.concatenate([tr[:150], [np.inf, np.nan], tr[150:400], np.full(9, np.inf)])
        return RATES, GEN, np.stack([t, np.full(len(t), np.inf), t + 1.5]), 32, 0.5
    K = int(case[1:])
    rates, gen = _cyclic(K, 2.0, np.linspace(0.2, 3.0, K) * LAM)
    return rates, gen, tr[None, :400], 7, 0.0


@pytest.mark.parametrize("case", ["chunk1", "chunk7", "chunk32", "chunkN", "underflow",
                                  "zero_rate", "padded", "K3", "K8"])
def test_the_chunked_mirror_holds_to_the_reference(case):
    """The belief kernel's algorithm (chunk products, chunk starts, exact
    folds) within atol 1e-12 of the reference scan and of the serial fold,
    argmax rows equal; bit for bit the same over a prefix."""
    rates, gen, times, C, t0 = _chunk_case(case)
    filt = pa.PhaseBeliefFilter(rates, gen)
    if t0:
        filt.observe(t0)
    c = filt.consts(torch.device(CPU))
    tt, b_init = torch.as_tensor(times), torch.as_tensor(filt.belief)
    stats = {}
    got = bf.belief_forward_chunked_ref(tt, b_init, filt._last, c, C, stats=stats)
    serial = bf.belief_forward_ref(tt, b_init, filt._last, c)
    want, (wb, wt) = belief_forward_jax(times, _ref_copy(filt))
    want = torch.as_tensor(np.array(want))
    for ref in (want, serial[0]):
        torch.testing.assert_close(got[0], ref, rtol=0, atol=1e-12)
        assert torch.equal(got[0].argmax(-1), ref.argmax(-1))
    torch.testing.assert_close(got[1], torch.as_tensor(np.asarray(wb)), rtol=0, atol=1e-12)
    torch.testing.assert_close(got[1], serial[1], rtol=0, atol=1e-12)
    assert torch.equal(got[2], serial[2]) and np.array_equal(got[2].numpy(), np.asarray(wt))
    # chunks where a guard could fire (the underflow), or whose step matrices
    # round below zero (some of the K-cycle's), are folded exactly; the
    # two-phase cases have none, the K cases keep most chunks on products
    n_unsafe = int(stats["unsafe_chunks"].sum())
    if case == "underflow":
        assert n_unsafe > 0
    elif case.startswith("K"):
        assert n_unsafe < times.shape[0] * (-(-times.shape[1] // C) - 1) // 2
    else:
        assert n_unsafe == 0
    if case == "underflow":
        fb = filt._b0 * filt.rates / (filt._b0 * filt.rates).sum()
        np.testing.assert_allclose(got[0][0, 100].numpy(), fb, rtol=0, atol=1e-12)
    for n in (1, C - 1, C, C + 1, times.shape[1] // 2):
        if 0 < n <= times.shape[1]:
            pre = bf.belief_forward_chunked_ref(tt[:, :n], b_init, filt._last, c, C)
            assert torch.equal(pre[0], got[0][:, :n])


# --- the schedulers and the engine's lowering -------------------------------


@pytest.mark.parametrize("mode", ["argmax", "mix"])
def test_belief_scheduler_compiled_equals_python_and_the_reference(mode):
    tr = _trace(1500, 5)

    def run(pkg, backend):
        if pkg == "port":
            sch = ps.BeliefPhaseScheduler(STACK, ps.PhaseBeliefFilter(RATES, GEN), mode=mode)
            eng = ps.ServingEngine(sch, arrivals=ps.TraceProcess(tr), b_max=BMAX,
                                   service=_psvc(), energy_table=EN, device=CPU)
        else:
            sch = RefBelief(STACK, RefFilter(RATES, GEN), mode=mode)
            eng = RefEngine(sch, arrivals=RefTrace(tr), b_max=BMAX, service=SVC,
                            energy_table=EN)
        return eng.run(n_epochs=None, backend=backend), sch

    (py, s_py), (c, s_c) = run("port", "python"), run("port", "compiled")
    ref, s_ref = run("ref", "compiled")
    np.testing.assert_array_equal(c.batch_sizes, py.batch_sizes)
    np.testing.assert_allclose(c.latencies, py.latencies, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(c.batch_sizes, ref.batch_sizes)
    np.testing.assert_allclose(c.latencies, ref.latencies, rtol=0, atol=1e-9)
    np.testing.assert_allclose(c.energy, ref.energy, rtol=1e-12)
    # the engine's sync leaves the filter where the Python loop left it
    np.testing.assert_array_equal(s_c.filter.belief, s_py.filter.belief)
    assert s_c.filter.snapshot() == s_py.filter.snapshot()
    assert s_c.name == ("smdp_belief_mix" if mode == "mix" else "smdp_belief")


def _adaptive_factory(pkg):
    lo = np.stack([q_policy(4, 128, BMAX), q_policy(8, 128, BMAX)])
    hi = np.stack([q_policy(10, 128, BMAX), q_policy(14, 128, BMAX)])
    Bank, Ctrl, Filt = ((ps.SMDPSchedulerBank, ps.AdaptiveController, ps.PhaseBeliefFilter)
                        if pkg == "port" else (RefBank, RefController, RefFilter))
    bank = Bank({(0.4 * LAM,): lo, (1.2 * LAM,): hi}, key_names=("lam",))
    return lambda: Ctrl(bank, ewma=0.2, margin=0.1, min_dwell=5.0,
                        phase_filter=Filt(RATES, GEN))


@pytest.mark.parametrize("kind", ["argmax", "mix", "adaptive_filter"])
def test_verify_backends_certifies_the_belief_lanes(kind):
    tr = _trace(1200, 6 + len(kind))
    if kind == "adaptive_filter":
        mk = _adaptive_factory("port")
    else:
        def mk():
            return ps.BeliefPhaseScheduler(STACK, ps.PhaseBeliefFilter(RATES, GEN), mode=kind)
    out = ps.verify_backends(None, tr, service=_psvc(), energy_table=EN, b_max=BMAX,
                             scheduler=mk, device=CPU)
    assert out["n_decisions"] > 0 and out["max_latency_err"] <= 1e-9
    with pytest.raises(NotImplementedError, match="buffer"):
        ps.verify_backends(None, tr, service=_psvc(), b_max=BMAX, scheduler=mk,
                           buffer=8, device=CPU)


def test_adaptive_controller_with_a_filter_follows_the_reference():
    tr = _trace(900, 9)
    got, want = _adaptive_factory("port")(), _adaptive_factory("ref")()
    snap_at = 400
    for i, t in enumerate(tr):
        got.observe_arrival(float(t))
        want.observe_arrival(float(t))
        assert got.key == want.key and got.scheduler.phase == want.scheduler.phase
        assert got.decide(1 + i % 9) == want.decide(1 + i % 9)
        if i == snap_at:
            snap = got.snapshot()
            assert snap == want.snapshot()
    assert got.n_switches == want.n_switches > 0
    got.restore(snap)
    assert got.phase_filter.snapshot() == snap["phase_filter"]


def test_two_half_runs_equal_one_full_run_the_belief_resumed():
    tr = _trace(1600, 10)
    horizon = float(tr[-1]) + 1.0

    def engine():
        sch = ps.BeliefPhaseScheduler(STACK, ps.PhaseBeliefFilter(RATES, GEN), mode="mix")
        return sch, ps.ServingEngine(sch, arrivals=ps.TraceProcess(tr), b_max=BMAX,
                                     service=_psvc(), energy_table=EN, device=CPU)

    s1, one = engine()
    full = one.run(horizon=horizon, backend="compiled")
    s2, two = engine()
    a = two.run(horizon=horizon / 2, backend="compiled")
    assert 0 < s2.filter.n_observed < len(tr)
    carried = len(two.queue)
    b = two.run(horizon=horizon, backend="compiled")
    np.testing.assert_array_equal(np.concatenate([a.batch_sizes, b.batch_sizes]),
                                  full.batch_sizes)
    np.testing.assert_allclose(np.concatenate([a.latencies, b.latencies]), full.latencies,
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(s2.filter.belief, s1.filter.belief)
    assert s2.filter._last == s1.filter._last
    # the second run re-admits the carried queue and counts it observed
    # again, as the reference's compiled run does (ROADMAP, section 3)
    assert carried > 0
    assert s2.filter.n_observed == s1.filter.n_observed + carried
    ref = RefBelief(STACK, RefFilter(RATES, GEN), mode="mix")
    eng = RefEngine(ref, arrivals=RefTrace(tr), b_max=BMAX, service=SVC, energy_table=EN)
    eng.run(horizon=horizon / 2, backend="compiled")
    eng.run(horizon=horizon, backend="compiled")
    assert ref.filter.n_observed == s2.filter.n_observed
    np.testing.assert_allclose(ref.filter.belief, s2.filter.belief, rtol=0, atol=1e-15)


# --- the grid runners ----------------------------------------------------------


def _grid_inputs():
    traces = [_trace(700, 40 + s) for s in (0, 1)]
    arrs = pc.pad_arrivals_batch(traces)
    bel, _ = pa.belief_forward(arrs, pa.PhaseBeliefFilter(RATES, GEN), device=CPU)
    return traces, arrs, bel.numpy()


def _same_grid(got, want):
    for k in ("n_served", "n_admitted", "n_batches", "n_epochs", "terminated", "hist",
              "slo_miss", "t_final"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("energy", "lat_sum", "w_mean", "power"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("pm", ["belief_argmax", "belief_mix"])
def test_run_grid_belief_modes_equal_the_reference(pm):
    traces, arrs, bel = _grid_inputs()
    tables = np.stack([STACK, STACK[::-1]])
    got = ps.run_grid(tables, arrs, means=MEANS, zeta=EN, b_max=BMAX, phase_mode=pm,
                      beliefs=bel, device=CPU)
    want = rc.run_grid(tables, arrs, means=MEANS, zeta=EN, b_max=BMAX, phase_mode=pm,
                       beliefs=bel)
    _same_grid(got, want)
    mode = "mix" if pm == "belief_mix" else "argmax"
    for s, tr in enumerate(traces):
        rep = ps.ServingEngine(ps.BeliefPhaseScheduler(STACK, ps.PhaseBeliefFilter(RATES, GEN),
                                                       mode=mode),
                               arrivals=ps.TraceProcess(tr), b_max=BMAX, service=_psvc(),
                               energy_table=EN, device=CPU).run(n_epochs=None)
        np.testing.assert_allclose(got["w_mean"][s, 0], rep.latencies.mean(), rtol=0,
                                   atol=1e-9)


def test_belief_argmax_is_its_phase_stream_and_mix_differs():
    _, arrs, bel = _grid_inputs()
    kw = dict(means=MEANS, zeta=EN, b_max=BMAX, device=CPU)
    arg = ps.run_grid(STACK[None], arrs, phase_mode="belief_argmax", beliefs=bel, **kw)
    ph = ps.run_grid(STACK[None], arrs, phases=bel.argmax(-1), **kw)
    _same_grid(arg, ph)
    mix = ps.run_grid(STACK[None], arrs, phase_mode="belief_mix", beliefs=bel, **kw)
    assert not np.array_equal(mix["hist"], arg["hist"])
    with pytest.raises(ValueError, match="needs beliefs"):
        ps.run_grid(STACK[None], arrs, phase_mode="belief_mix", **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ps.run_grid(STACK[None], arrs, phase_mode="belief_mix", beliefs=bel,
                    phases=bel.argmax(-1), **kw)


@pytest.mark.parametrize("pm", ["belief_argmax", "belief_mix"])
def test_run_grid_adaptive_belief_modes_equal_the_reference(pm):
    _, arrs, bel = _grid_inputs()
    got = ps.run_grid_adaptive(arrs, adaptive=_adaptive_factory("port")(), means=MEANS,
                               zeta=EN, b_max=BMAX, phase_mode=pm, beliefs=bel, device=CPU)
    want = rc.run_grid_adaptive(arrs, adaptive=_adaptive_factory("ref")(), means=MEANS,
                                zeta=EN, b_max=BMAX, phase_mode=pm, beliefs=bel)
    _same_grid(got, want)
    np.testing.assert_array_equal(got["ad_n_switches"], want["ad_n_switches"])


def test_simulate_compiled_belief_modes_equal_the_reference():
    tr = _trace(800, 12)
    bel, _ = pa.belief_forward(tr, pa.PhaseBeliefFilter(RATES, GEN), device=CPU)
    for pm in ("belief_argmax", "belief_mix"):
        got = ps.simulate_compiled(STACK, tr, means=MEANS, zeta=EN, b_max=BMAX,
                                   phase_mode=pm, beliefs=bel, record=True, device=CPU)
        want = rc.simulate_compiled(STACK, tr, means=MEANS, zeta=EN, b_max=BMAX,
                                    phase_mode=pm, beliefs=bel.numpy(), record=True)
        np.testing.assert_array_equal(got.actions, want.actions)
        np.testing.assert_array_equal(got.hist, want.hist)
        np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)
    with pytest.raises(ValueError, match="phase_mode"):
        ps.simulate_compiled(STACK, tr, means=MEANS, b_max=BMAX, phase_mode="belief",
                             beliefs=bel, device=CPU)


# --- the phase-rate schedulers ------------------------------------------------


def test_solve_phase_policies_and_phase_aware_scheduler_equal_the_reference():
    base = SMDPSpec(lam=LAM, service=SVC, energy=GOOGLENET_P4_ENERGY, b_min=1, b_max=BMAX,
                    w1=1.0, w2=0.5, s_max=48)
    rates = {0: 0.2 * LAM, 1: 0.8 * LAM}
    want = ref_solve_phase_policies(base, rates)
    got = ps.solve_phase_policies(interop.spec_from_reference(base), rates,
                                  backup="pallas", device=CPU)
    for z in rates:
        np.testing.assert_array_equal(got[z], want[z])
    p, r = ps.PhaseAwareScheduler(got, rates), RefPhaseAware(want, rates)
    for i, t in enumerate(_trace(600, 13)):
        p.observe_arrival(float(t))
        r.observe_arrival(float(t))
        assert p.current_phase() == r.current_phase()
        assert p.decide(i % 20) == r.decide(i % 20)
    assert p.n_switches == r.n_switches > 0
