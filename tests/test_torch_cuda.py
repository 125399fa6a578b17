"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the reference package, so it runs on a
machine that has PyTorch with CUDA alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test is marked `cuda` and skips where torch.cuda.is_available() is
false (the kernels have no CPU mode).  Tolerances are the reference's:
atol 1e-4 / rtol 1e-5 for the f32 Bellman backup (sums in another order;
also at the edges of its design: T off its tiles, A around its 3-action
warps, K around its 256-wide chunks and 4097, unaligned h_len and bases),
1e-5 / 1e-6 between the batched and scalar launches of the same kernel
and against its plain mirror (bellman_banded_split_ref),
1e-9 on serving latencies (the event walk is bit-for-bit the plain
version's arithmetic; every instance of the event kernel -- plain,
managed queue, adaptive, both, each with and without the belief mix
rule -- equals the plain walk exactly in its counts, clocks, sums,
histograms, queues and records), atol 1e-12 and equal argmax rows for the
belief kernel against its plain serial fold (its time-parallel passes
associate the steps' products differently, and CUDA's exp / sin / cos are
within an ulp of the host's: not bit for bit; at chunk seams, 1 to 200
traces, K 1 to 8, any chunk length, a gap that underflows every
propagation, repeated times, zero slots, a wholly padded trace), its rows
bit for bit the same in two calls and over any prefix of the slots, the
fleet kernel equal to its plain walk in every record, count, clock and
sum (plain, faults with a finite room, the mix rule, a chunk carry, a grid;
M = 1, 3, 4, 8 and its maximum of 64, and a refusal above; the seams of its
design: M = 2, 5, 8 in registers against 9 and 64 in shared memory, traces of
several staging chunks, bursts that fill the record ring, lanes of unequal
length, the FIFO and tables in global memory, RECORD on and off), equal policies between the kernel and banded
batched solves (lockstep, MPI, Anderson), their g at rtol 1e-6 of each
other (the float64 finish run to eps 1e-6) and of the same solve through
the kernel's mirror, and a sweep whose guard ladder
fires no rung (the ladder is the reference's: a poisoned warm start heals
on the plain restart, a NaN spec completes as failed), 2e-5 (f32) and
2e-2 (bf16) for the attention kernels against their plain versions
(tests/test_kernels.py's), 2e-6 for the f32 decode kernel against the
plain mirror of its split-K arithmetic (the same sums in another order),
atol 3e-4 on model logits (tests/test_models.py's; the reduced Zamba2
too, its launches one SSD scan per Mamba2 layer and step, one flash /
decode per occurrence of the shared block), the SSD scan kernel at 2e-5
(f32) and 2e-2 (bf16) against its plain version (the reference's
kernel-against-naive bar and the attention kernels'; inputs in a Mamba2
block's regime, see _ssd_inputs), the MMPP sampler
and simulator kernels equal to their plain walks in every output (lanes
1, 6, 7, 133, 200; n_steps 1, the staged chunk's length +-1 and a long
run; dwells so short that most steps switch, rates 1e3 apart; a run that
clips at k_max, a > s,
every service family, the ring wrapping; clipped runs across the staging
chunks, a queue that outgrows the ring, lanes that run out of draws beside
lanes that do not), and a durable sweep resumed on
the card bitwise equal to the uninterrupted one, a CPU checkpoint
refused there.  The attention backward kernel
(flash_attention_bwd.cu) is held against autograd through the plain
attention at f32 1e-4 and bf16 2e-2 of each gradient's largest |entry|,
the forward's saved log-sum-exp against the plain one at 1e-5 (f32) and
2e-2 (bf16); a reduced Qwen2.5's training gradients through the kernels
(autograd Function, remat) against the same model's through the plain
versions on the CPU at 1e-4 of each tensor's largest |gradient|; and the
kernels without a backward refuse tensors that require grad.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import core as pt
from repro_torch import kernels
from repro_torch.configs import ARCHS
from repro_torch.core.policies import q_policy
from repro_torch.kernels import belief_forward as bfk
from repro_torch.kernels import bellman as tb
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ops
from repro_torch.kernels import fleet_scan as fk
from repro_torch.kernels import mmpp_sample as mk
from repro_torch.kernels import sim_scan as sk
from repro_torch.kernels import ssd_scan as sd
from repro_torch.kernels import serve_scan as ss
from repro_torch.launch import serve_llm
from repro_torch.models import model as M
from repro_torch.serving import pad_arrivals_batch, simulate_compiled
from repro_torch.serving import arrivals as pa
from repro_torch.serving import faults as pfa
from repro_torch.serving import fleet as pf

pytestmark = pytest.mark.cuda

SHAPES = [(64, 9, 40), (200, 33, 170), (128, 33, 128), (300, 17, 513),
          (129, 33, 129), (4097, 33, 4097)]
BATCHED_SHAPES = [(1, 64, 9, 40), (3, 130, 33, 130), (4, 128, 17, 260),
                  (17, 129, 33, 129),
                  # shapes the sweep path launches (trimmed f32 bands, regrow)
                  (17, 129, 33, 56), (108, 129, 33, 66), (3, 33, 33, 33), (1, 109, 33, 66)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, T, A, K, n, dev):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, T + K)) * 10
    logits = rng.normal(size=(n, A, K))
    pmfs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tails = rng.uniform(size=(n, T, A))
    hso = rng.normal(size=n) * 3
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (h, pmfs, tails, hso)]


@pytest.mark.parametrize("T,A,K", SHAPES)
def test_bellman_kernel_matches_plain(cuda, T, A, K):
    h, pmfs, tails, hso = (x[0] for x in _inputs(T + K, T, A, K, 1, cuda))
    before = tb.bellman_banded.launches
    got = tb.bellman_banded(h, pmfs, tails, hso)
    torch.cuda.synchronize()
    assert tb.bellman_banded.launches == before + 1
    torch.testing.assert_close(got, tb.bellman_banded_ref(h, pmfs, tails, hso),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("N,T,A,K", BATCHED_SHAPES)
def test_batched_kernel_matches_plain_and_scalar(cuda, N, T, A, K):
    args = _inputs(N * T + K, T, A, K, N, cuda)
    got = tb.bellman_banded_batched(*args)
    torch.testing.assert_close(got, tb.bellman_banded_batched_ref(*args),
                               atol=1e-4, rtol=1e-5)
    for n in range(N):
        one = tb.bellman_banded(*(x[n] for x in args))
        torch.testing.assert_close(got[n], one, atol=1e-5, rtol=1e-6)


#: edges of the kernel's design: T off the 5-state lanes and the t tiles,
#: A = 1, 9, 33 (multiples of the 3-action warps), 64, 65 (ragged warps),
#: K = 1, either side of the 256-wide chunk, and 4097 (17 chunks, the ring)
EDGE_T, EDGE_A, EDGE_K = (1, 63, 65, 129), (1, 9, 33, 64, 65), (1, 255, 256, 257, 4097)


def _edge_inputs(seed, N, T, A, K, dev, *, extra, h_off, p_off, neg, zero_tails):
    """Inputs with h_len = T + K - 1 + extra, h and pmfs at bases h_off /
    p_off words past a 16-byte boundary, hso of either sign, tails or zeros."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, T + K - 1 + extra)) * 10
    logits = rng.normal(size=(N, A, K))
    pmfs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tails = np.zeros((N, T, A)) if zero_tails else rng.uniform(size=(N, T, A))
    hso = rng.normal(size=N) * 3 + (-5.0 if neg else 5.0)

    def at(x, off):
        buf = torch.zeros(x.size + 4, dtype=torch.float32, device=dev)
        view = buf[off:off + x.size].view(x.shape)
        view.copy_(torch.as_tensor(x, dtype=torch.float32))
        return view

    return at(h, h_off), at(pmfs, p_off), at(tails, 0), at(hso, 0)


@pytest.mark.parametrize("K", EDGE_K)
@pytest.mark.parametrize("A", EDGE_A)
@pytest.mark.parametrize("T", EDGE_T)
def test_bellman_kernel_edges(cuda, T, A, K):
    """The kernel against its plain version at its design's edges, with
    unaligned h_len and bases, negative hso and zero tails among the cases."""
    i = T + A + K
    args = _edge_inputs(i, 1, T, A, K, cuda, extra=1 + i % 3, h_off=i % 4,
                        p_off=(i // 4) % 4, neg=i % 2 == 0, zero_tails=i % 5 == 0)
    h, pmfs, tails, hso = (x[0] for x in args)
    before = tb.bellman_banded.launches
    got = tb.bellman_banded(h, pmfs, tails, hso)
    torch.cuda.synchronize()
    assert tb.bellman_banded.launches == before + 1
    torch.testing.assert_close(got, tb.bellman_banded_ref(h, pmfs, tails, hso),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("N,T,A,K", [(1, 65, 9, 65), (17, 63, 33, 257), (17, 129, 65, 56),
                                     (108, 129, 33, 66), (108, 1, 1, 1), (17, 65, 64, 4097)])
def test_batched_kernel_edges(cuda, N, T, A, K):
    """The batched launch against its plain version (1e-4 / 1e-5) and against
    N scalar launches (1e-5 / 1e-6: the split may differ, so the sums' order
    may too), at N = 1, 17 and 108, with unaligned bases and negative hso."""
    args = _edge_inputs(N + T + K, N, T, A, K, cuda, extra=2, h_off=1, p_off=3,
                        neg=True, zero_tails=N == 1)
    before = tb.bellman_banded_batched.launches
    got = tb.bellman_banded_batched(*args)
    torch.cuda.synchronize()
    assert tb.bellman_banded_batched.launches == before + 1
    torch.testing.assert_close(got, tb.bellman_banded_batched_ref(*args), atol=1e-4, rtol=1e-5)
    for n in range(N):
        one = tb.bellman_banded(*(x[n] for x in args))
        torch.testing.assert_close(got[n], one, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("N,T,A,K", [(1, 129, 33, 129), (1, 65, 9, 65), (1, 4097, 33, 4097),
                                     (108, 129, 33, 66), (17, 129, 33, 56), (2, 7, 100, 40)])
def test_bellman_geometry_matches_the_plan(cuda, N, T, A, K):
    """The C launch geometry at the wrapper's split: the warps the plan
    counted, one block per t tile and spec, a tile of every action up to
    A_TILE, and shared memory within the card's 227 KB."""
    import ctypes

    from repro_torch.kernels import _build

    split = tb._split_plan(N, T, A, K, tb._sm_count(cuda))
    geo = (ctypes.c_longlong * 5)()
    fn = _build.function("bellman", "bellman_banded_geometry", ctypes.c_int,
                         [ctypes.c_int] * 5 + [ctypes.c_void_p])
    assert fn(N, T, A, K, split, geo) == 0
    gx, gy, gz, threads, smem = list(geo)
    assert gx * gy * gz * threads // 32 == tb.grid_warps(N, T, A, split)
    assert gz == N and threads == 32 * -(-min(A, tb.A_TILE) // tb.RA)
    assert smem <= 227 * 1024
    assert fn(N, T, A, K, 3, geo) != 0  # a split the kernel does not take


def test_event_kernel_matches_plain(cuda):
    svc = pt.ServiceModel(latency=pt.GOOGLENET_P4_LATENCY, family="det")
    means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, 33)])
    energy = np.array([0.0] + [float(pt.GOOGLENET_P4_ENERGY(b)) for b in range(1, 33)])
    lam = 0.7 * 32 / means[32]
    rng = np.random.default_rng(4)
    trace = np.cumsum(rng.exponential(1.0 / lam, 30_000))
    kw = dict(means=means, zeta=energy, b_max=32, max_epochs=5000, record=True,
              draws=rng.exponential(size=5000), deadlines=trace + 9.0)
    before = ss.serve_scan.launches
    runs = {d: simulate_compiled(q_policy(8, 128, 32), trace, device=d, **kw)
            for d in ("cpu", cuda)}
    assert ss.serve_scan.launches == before + 1
    got, want = runs[cuda], runs["cpu"]
    np.testing.assert_array_equal(got.actions, want.actions)
    np.testing.assert_allclose(got.latencies, want.latencies, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.hist, want.hist)
    assert got.slo_miss == want.slo_miss and got.t_final == want.t_final
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-12)


def _lane_inputs(seed, S=2, n=600, P=3, adaptive=False, dev="cpu"):
    """Overloaded traces, a few tables (or a bank lowered from a controller)
    and deadlines: inputs for every instance of the event kernel."""
    from repro_torch.serving import AdaptiveController, SMDPSchedulerBank
    from repro_torch.serving.compiled import default_hist_edges, pad_arrivals_batch

    rng = np.random.default_rng(seed)
    svc = pt.ServiceModel(latency=pt.GOOGLENET_P4_LATENCY, family="det")
    means = np.array([0.0] + [float(svc.mean(b)) for b in range(1, 33)])
    zeta = np.array([0.0] + [float(pt.GOOGLENET_P4_ENERGY(b)) for b in range(1, 33)])
    lam = 1.3 * 32 / means[32]
    arr = pad_arrivals_batch([np.cumsum(rng.exponential(1.0 / lam, n)) for _ in range(S)])
    tabs = np.stack([q_policy(4 + 6 * p, 128, 32) for p in range(P)])[:, None]
    ad = None
    if adaptive:
        bank = SMDPSchedulerBank({(lam * (0.5 + p),): tabs[p, 0] for p in range(P)},
                                 key_names=("lam",))
        from repro_torch.serving.compiled import AdaptiveLane

        lane = AdaptiveLane.from_controller(AdaptiveController(bank, ewma=0.3, margin=0.05))
        tabs = lane.tables
        ad = [torch.as_tensor(x, device=dev) for x in lane.lowered()]
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    args = [t(tabs, torch.int64), t(arr, torch.float64), t(arr + 6.0, torch.float64),
            t(np.zeros(arr.shape), torch.int64), t(rng.exponential(size=(S, 2 * n)), torch.float64),
            t(means, torch.float64), t(zeta, torch.float64),
            t(default_hist_edges(means), torch.float64)]
    kw = dict(t0=0.0, horizon=float("inf"), max_eps=2 * n + 2, drain=True, b_max=32,
              adaptive=None if ad is None else tuple(ad))
    return args, kw


def _same_scan(got, want):
    got = ss.ScanOut(*(None if x is None else x.cpu() for x in got))
    assert torch.equal(got.agg_i, want.agg_i)
    assert torch.equal(got.hist, want.hist)
    torch.testing.assert_close(got.agg_f, want.agg_f, rtol=0, atol=0, equal_nan=True)
    col = {k: i for i, k in enumerate(ss.AGG_I)}
    for lane, row in enumerate(want.agg_i.tolist()):
        n_srv, n_eps = row[col["n_served"]], row[col["n_epochs"]]
        if want.queue is not None:
            h, t = row[col["head"]], row[col["tail"]]
            assert torch.equal(got.queue[lane, h:t], want.queue[lane, h:t])
        if want.rec_a is not None:
            assert torch.equal(got.rec_a[lane, :n_eps], want.rec_a[lane, :n_eps])
            assert torch.equal(got.rec_slot[lane, :n_srv], want.rec_slot[lane, :n_srv])
            assert torch.equal(got.rec_done[lane, :n_srv], want.rec_done[lane, :n_srv])


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("qman,adaptive", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_event_kernel_instances_match_plain(cuda, qman, adaptive, record):
    """Every template instance over a multi-lane launch against the plain
    walk: counts, clocks, sums, histograms, queues and records equal."""
    args, kw = _lane_inputs(5, adaptive=adaptive)
    kw.update(record=record, buffer=12 if qman else None, shed=qman)
    gargs = [a.to(cuda) for a in args]
    gkw = dict(kw, adaptive=None if not adaptive else tuple(a.to(cuda) for a in kw["adaptive"]))
    name = ss.instance_name(qman, adaptive, 2 if adaptive else 6)
    before = ss.serve_scan.instance_launches.get(name, 0)
    got = ss.serve_scan(*gargs, **gkw)
    assert ss.serve_scan.instance_launches[name] == before + 1
    want = ss.serve_scan_ref(*args, **kw)
    _same_scan(got, want)
    col = {k: i for i, k in enumerate(ss.AGG_I)}
    if qman:
        assert want.agg_i[:, col["n_shed"]].sum() > 0
        assert want.agg_i[:, col["n_expired"]].sum() > 0
    if adaptive:
        assert want.agg_i[:, col["n_switches"]].sum() > 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_event_kernel_multi_lane_equals_single_lanes(cuda, adaptive):
    args, kw = _lane_inputs(6, adaptive=adaptive, dev=cuda)
    kw["record"] = True
    grid = ss.serve_scan(*args, **kw)
    tables, arr, dl, ph, draws = args[:5]
    n_pol = 1 if adaptive else tables.shape[0]
    for lane in range(arr.shape[0] * n_pol):
        s, p = divmod(lane, n_pol)
        tab = tables if adaptive else tables[p:p + 1]
        one = ss.serve_scan(tab, arr[s:s + 1], dl[s:s + 1], ph[s:s + 1],
                            draws[s:s + 1], *args[5:], **kw)
        part = ss.ScanOut(*(None if x is None else x[lane:lane + 1].cpu() for x in grid))
        _same_scan(one, part)


def test_grid_runners_launch_once(cuda):
    from repro_torch.serving import AdaptiveController, SMDPSchedulerBank
    from repro_torch.serving import run_grid, run_grid_adaptive

    args, _ = _lane_inputs(7)
    tables, arr = args[0].numpy()[:, 0], args[1].numpy()
    means, zeta = args[5].numpy(), args[6].numpy()
    kw = dict(means=means, zeta=zeta, b_max=32)
    before = ss.serve_scan.launches
    g = run_grid(tables, arr, device=cuda, **kw)
    assert ss.serve_scan.launches == before + 1
    want = run_grid(tables, arr, device="cpu", **kw)
    for k in want:
        np.testing.assert_array_equal(g[k], want[k], err_msg=k)
    bank = SMDPSchedulerBank({(0.5 * (p + 1),): tables[p] for p in range(len(tables))},
                             key_names=("lam",))
    ctrl = AdaptiveController(bank, ewma=0.3, margin=0.05)
    before = ss.serve_scan.launches
    ga = run_grid_adaptive(arr, adaptive=ctrl, device=cuda, **kw)
    assert ss.serve_scan.launches == before + 1
    want = run_grid_adaptive(arr, adaptive=ctrl, device="cpu", **kw)
    for k in want:
        np.testing.assert_array_equal(ga[k], want[k], err_msg=k)


def test_event_kernel_refuses_what_it_does_not_take(cuda):
    """A CUDA tensor of the wrong type or on another device raises; nothing
    falls back to the plain version and nothing launches."""
    args, kw = _lane_inputs(8, dev=cuda)
    before = ss.serve_scan.launches
    bad = list(args)
    bad[1] = args[1].float()  # f32 arrivals
    with pytest.raises(TypeError, match="arrivals"):
        ss.serve_scan(*bad, **kw)
    bad = list(args)
    bad[3] = args[3].int()  # int32 phases
    with pytest.raises(TypeError, match="phases"):
        ss.serve_scan(*bad, **kw)
    bad = list(args)
    bad[0] = args[0].cpu()  # tables on the host, arrivals on the card
    with pytest.raises(ValueError, match="arrivals on cuda"):
        ss.serve_scan(*bad, **kw)
    with pytest.raises(ValueError, match="shed needs deadlines"):
        ss.serve_scan(args[0], args[1], None, *args[3:], shed=True, **kw)
    assert ss.serve_scan.launches == before


def _phase_filter(K):
    """A K-phase filter: the MMPP2 of the bursty scenario for K = 2, a
    cyclic 3-phase chain (complex eigenvalues) for K = 3."""
    from repro_torch.serving import PhaseBeliefFilter

    if K == 2:
        return PhaseBeliefFilter([0.26, 2.79], [[-1 / 4000, 1 / 4000], [1 / 800, -1 / 800]])
    a = 1 / 300
    gen = [[-a, a, 0.0], [0.0, -a, a], [a, 0.0, -a]]
    return PhaseBeliefFilter([0.3, 1.1, 2.6], gen)


def _belief_times(seed, S, n, K):
    """S traces of n arrivals, padded with +inf, a NaN slot inside, and one
    gap long enough that the propagated mass underflows (the stationary
    fallback)."""
    rng = np.random.default_rng(seed)
    out = np.full((S, n + 7), np.inf)
    for s in range(S):
        gaps = rng.exponential(rng.choice([0.4, 3.0], size=n))
        gaps[n // 2] = 2e5  # degenerate propagation
        t = np.cumsum(gaps)
        t[n // 3] = np.nan  # a hole: keeps the carry
        out[s, :n] = t
    return out


@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("K", [2, 3])
def test_belief_kernel_matches_plain(cuda, K, S):
    from repro_torch.kernels import belief_forward as bf

    filt = _phase_filter(K)
    times = torch.as_tensor(_belief_times(10 + K, S, 3000, K))
    b_init = torch.as_tensor(filt.belief)
    before = bf.belief_forward.launches
    got = bf.belief_forward(times.to(cuda), b_init.to(cuda), 0.5, filt.consts(cuda))
    assert bf.belief_forward.launches == before + 1
    want = bf.belief_forward(times, b_init, 0.5, filt.consts(torch.device("cpu")))
    bel, b_fin, t_fin = (x.cpu() for x in got)
    torch.testing.assert_close(bel, want[0], rtol=0, atol=1e-12)
    assert torch.equal(bel.argmax(-1), want[0].argmax(-1))
    torch.testing.assert_close(b_fin, want[1], rtol=0, atol=1e-12)
    assert torch.equal(t_fin, want[2])
    # the fallback fired after the long gap: the row is b0 * rates, normalised
    fb = filt._b0 * filt.rates / (filt._b0 * filt.rates).sum()
    np.testing.assert_allclose(bel[0, 1500].numpy(), fb, rtol=0, atol=1e-12)
    # padded tail repeats the last row
    assert torch.equal(bel[:, -1], bel[:, 2999])


def _k_filter(K):
    """A K-phase filter: a single Poisson phase, the bursty MMPP2, or a
    K-phase cycle (complex eigenvalues for K >= 3)."""
    from repro_torch.serving import PhaseBeliefFilter

    if K <= 3:
        return _phase_filter(K) if K > 1 else PhaseBeliefFilter([1.1], [[0.0]])
    a = 2.0  # beside rates 0.25 .. 2.8: complex eigenvalues
    gen = np.zeros((K, K))
    for k in range(K):
        gen[k, k], gen[k, (k + 1) % K] = -a, a
    return PhaseBeliefFilter(list(np.linspace(0.25, 2.8, K)), gen.tolist())


def _bursty_times(seed, S, n):
    """S traces of n arrivals from a bursty MMPP2, the later traces shorter
    (padded with +inf)."""
    from repro_torch.serving.arrivals import MMPP2

    m = MMPP2(lam1=0.26, lam2=2.79, dwell1=4000.0, dwell2=800.0)
    out = np.full((S, n), np.inf)
    for s in range(S):
        k = n - (s * n) // (2 * S)
        tr = m.sample_arrivals(1.2 * max(n, 64) / m.mean_rate,
                               np.random.default_rng(seed + s))[0]
        while len(tr) < k:
            tr = np.concatenate([tr, tr[-1] + 1.0 + tr[: k - len(tr)]])
        out[s, :k] = tr[:k]
    return out


def _belief_both(cuda, filt, times, chunk=None, t_init=0.0):
    """The kernel (one call at `chunk`, default CHUNK; launches checked),
    its count of chunks folded exactly in pass B, and the serial plain
    fold."""
    from repro_torch.kernels import belief_forward as bf

    tt = torch.as_tensor(times)
    b_init = torch.as_tensor(filt.belief)
    before = bf.belief_forward.launches
    inst = dict(bf.belief_forward.instance_launches)
    *got, unsafe = bf._launch(tt.to(cuda), b_init.to(cuda), t_init, filt.consts(cuda),
                              bf.CHUNK if chunk is None else chunk)
    torch.cuda.synchronize()
    assert bf.belief_forward.launches == before + 1
    passes = ("products", "starts", "fold") if times.shape[1] else ("starts",)
    for name in ("products", "starts", "fold"):
        want_n = inst.get(name, 0) + (1 if name in passes else 0)
        assert bf.belief_forward.instance_launches.get(name, 0) == want_n
    want = bf.belief_forward_ref(tt, b_init, t_init, filt.consts(torch.device("cpu")))
    return tuple(x.cpu() for x in got), want, unsafe.cpu()


def _held(got, want):
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-12)
    assert torch.equal(got[0].argmax(-1), want[0].argmax(-1))
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-12)
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("S,N,K", [(1, 1, 2), (6, bfk.CHUNK - 1, 2), (6, bfk.CHUNK, 2),
                                   (6, bfk.CHUNK + 1, 2), (200, 700, 2), (6, 49_152, 2),
                                   (1, 3000, 1), (6, 300, 3), (6, 300, 4), (6, 300, 5),
                                   (6, 300, 6), (6, 300, 7), (6, 300, 8),
                                   (200, bfk.CHUNK + 1, 8)])
def test_belief_kernel_chunked_matches_plain(cuda, S, N, K):
    """The time-parallel kernel against the serial plain fold at chunk
    seams (N = C - 1, C, C + 1 for the default C), many traces, the bursty
    batch's shape and every K; deterministic and prefix-stable bit for bit;
    the same algorithm's CPU mirror within atol 1e-12."""
    bf = bfk
    filt = _k_filter(K)
    times = _bursty_times(100 + K + S, S, N)
    got, want, unsafe = _belief_both(cuda, filt, times)
    _held(got, want)
    if K <= 2:  # no guard can fire and no step matrix rounds below zero here
        assert int(unsafe.sum()) == 0
    tt = torch.as_tensor(times, device=cuda)
    b_init = torch.as_tensor(filt.belief, device=cuda)
    c = filt.consts(cuda)
    again = bf.belief_forward(tt, b_init, 0.0, c)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(again, got))
    for n in sorted({1, bf.CHUNK - 1, bf.CHUNK, bf.CHUNK + 1, N // 2, N - 1}):
        if 0 < n < N:
            pre = bf.belief_forward(tt[:, :n].contiguous(), b_init, 0.0, c)
            assert torch.equal(pre[0].cpu(), got[0][:, :n])
    if N <= 3000:
        mirror = bf.belief_forward_chunked_ref(torch.as_tensor(times), b_init.cpu(), 0.0,
                                               filt.consts(torch.device("cpu")), bf.CHUNK)
        _held(got, mirror)


@pytest.mark.parametrize("chunk", [1, 7, 32, 64, 1000, 3007])
def test_belief_kernel_any_chunk_and_unsafe_slots(cuda, chunk):
    """Any chunk length, on traces with a hole and a gap that underflows
    every propagation (the chunk holding it is folded exactly in pass B
    and counted); the one-chunk call (C = N) is a serial fold."""
    filt = _phase_filter(2)
    times = _belief_times(40 + chunk, 3, 3000, 2)
    got, want, unsafe = _belief_both(cuda, filt, times, chunk=chunk)
    _held(got, want)
    n_chunks = -(-times.shape[1] // chunk)
    assert unsafe.shape == (3,) and unsafe.dtype == torch.int32
    # the underflowing gap sits in chunk 1500 // C of each trace (the hole
    # keeps every gap positive); the last chunk's product is never used
    assert unsafe.tolist() == [1 if 1500 // chunk < n_chunks - 1 else 0] * 3
    fb = filt._b0 * filt.rates / (filt._b0 * filt.rates).sum()
    np.testing.assert_allclose(got[0][:, 1500].numpy(), np.tile(fb, (3, 1)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("K", [2, 8])
def test_belief_kernel_repeated_times(cuda, K):
    """Runs of equal times (gaps of exactly 0: E = I up to rounding, which
    leaves entries a hair below zero) and a start after the first arrivals:
    the chunks holding them are folded exactly; rows still held."""
    filt = _k_filter(K)
    times = _bursty_times(60 + K, 4, 2000)
    times[:, 300:340] = times[:, 300:301]
    times[1, 1000:1200] = times[1, 1000]
    got, want, unsafe = _belief_both(cuda, filt, times, t_init=5.0)
    _held(got, want)
    assert int(unsafe.sum()) >= 1


def test_belief_kernel_empty_and_padded_traces(cuda):
    """Zero slots give the start state back (one launch, pass B alone); a
    wholly padded trace repeats b_init and keeps t_init."""
    filt = _phase_filter(2)
    got, want, _ = _belief_both(cuda, filt, np.zeros((3, 0)))
    assert got[0].shape == (3, 0, 2)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    times = _bursty_times(7, 3, 400)
    times[1] = np.inf
    got, want, _ = _belief_both(cuda, filt, times)
    _held(got, want)
    assert torch.equal(got[0][1], torch.as_tensor(filt.belief).expand(400, 2))
    assert float(got[2][1]) == 0.0


def _mix_inputs(seed, S=2, n=600, P=3, adaptive=False, dev="cpu"):
    """Overloaded traces, (P, 2, L) phase stacks (or a bank of them lowered
    from a controller), random posterior rows: inputs for the mix rule."""
    from repro_torch.serving import AdaptiveController, SMDPSchedulerBank
    from repro_torch.serving.compiled import AdaptiveLane

    args, kw = _lane_inputs(seed, S=S, n=n, P=P)
    rng = np.random.default_rng(seed + 100)
    stacks = np.stack([np.stack([q_policy(2 + 5 * p, 128, 32), q_policy(9 + 5 * p, 128, 32)])
                       for p in range(P)])
    lam = 1.3 * 32 / float(args[5][32])
    ad = None
    if adaptive:
        bank = SMDPSchedulerBank({(lam * (0.5 + p),): stacks[p] for p in range(P)},
                                 key_names=("lam",))
        lane = AdaptiveLane.from_controller(AdaptiveController(bank, ewma=0.3, margin=0.05))
        stacks = lane.tables
        ad = tuple(torch.as_tensor(x, device=dev) for x in lane.lowered())
    w = rng.uniform(size=args[1].shape)
    bel = np.stack([w, 1.0 - w], axis=-1)
    args = [a.to(dev) for a in args]
    args[0] = torch.as_tensor(stacks, dtype=torch.int64, device=dev)
    return args, dict(kw, adaptive=ad, beliefs=torch.as_tensor(bel, device=dev))


@pytest.mark.parametrize("lanes", ["one", "grid"])
@pytest.mark.parametrize("qman,adaptive", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_event_kernel_mix_matches_plain(cuda, qman, adaptive, lanes):
    """The mix rule in every instance, one lane and a grid, against the
    plain walk: counts, clocks, sums, histograms, queues and records equal."""
    args, kw = _mix_inputs(11, S=1 if lanes == "one" else 2, P=1 if lanes == "one" else 3,
                           adaptive=adaptive)
    kw.update(record=True, buffer=12 if qman else None, shed=qman)
    n_lanes = args[1].shape[0] * (1 if adaptive else args[0].shape[0])
    name = ss.instance_name(qman, adaptive, n_lanes, mix=True)
    assert name.endswith("mix")
    gkw = dict(kw, beliefs=kw["beliefs"].to(cuda),
               adaptive=None if not adaptive else tuple(a.to(cuda) for a in kw["adaptive"]))
    before = ss.serve_scan.instance_launches.get(name, 0)
    got = ss.serve_scan(*[a.to(cuda) for a in args], **gkw)
    assert ss.serve_scan.instance_launches[name] == before + 1
    want = ss.serve_scan_ref(*args, **kw)
    _same_scan(got, want)
    # the blend is not either row: it differs from serving phase 0's row
    plain = ss.serve_scan_ref(*args, **dict(kw, beliefs=None))
    assert not torch.equal(want.agg_i, plain.agg_i)


def test_belief_lanes_on_the_card_equal_the_cpu(cuda):
    """The engine's belief lowering on the card (belief kernel, then the
    event kernel) equals the Python loop and the CPU plain path."""
    from repro_torch.serving import BeliefPhaseScheduler, verify_backends

    svc = pt.ServiceModel(latency=pt.GOOGLENET_P4_LATENCY, family="det")
    energy = np.array([0.0] + [float(pt.GOOGLENET_P4_ENERGY(b)) for b in range(1, 33)])
    trace = _belief_times(3, 1, 4000, 2)[0, :4000]
    trace = np.sort(trace[np.isfinite(trace)])
    stack = np.stack([q_policy(3, 128, 32), q_policy(14, 128, 32)])
    for mode in ("argmax", "mix"):
        runs = {d: verify_backends(
            None, trace, service=svc, energy_table=energy, b_max=32, device=d,
            scheduler=lambda: BeliefPhaseScheduler(stack, _phase_filter(2), mode=mode))
            for d in ("cpu", cuda)}
        np.testing.assert_array_equal(runs[cuda]["compiled"].batch_sizes,
                                      runs["cpu"]["compiled"].batch_sizes)
        np.testing.assert_allclose(runs[cuda]["compiled"].latencies,
                                   runs["cpu"]["compiled"].latencies, rtol=0, atol=1e-9)


def test_kernel_solve_matches_cpu_plain_path(cuda):
    svc = pt.ServiceModel(latency=pt.GOOGLENET_P4_LATENCY, family="det")
    spec = pt.SMDPSpec(lam=0.3 * 32 / float(svc.mean(32)), service=svc,
                       energy=pt.GOOGLENET_P4_ENERGY, b_max=32, s_max=48, w2=1.0)
    mdp = pt.build_smdp(spec)
    on_card = pt.relative_value_iteration(mdp, backup="pallas", device=cuda)
    banded = pt.relative_value_iteration(mdp, backup="banded", device=cuda)
    plain = pt.relative_value_iteration(mdp, backup="pallas", device="cpu")
    assert np.array_equal(on_card.policy, banded.policy)
    assert np.array_equal(on_card.policy, plain.policy)
    assert abs(on_card.g - banded.g) < 1e-2


def _sweep_specs(rho, n=3, b_max=16, s_max=64):
    svc = pt.ServiceModel(latency=pt.GOOGLENET_P4_LATENCY, family="det")
    lam = rho * b_max / float(svc.mean(b_max))
    return [pt.SMDPSpec(lam=lam, service=svc, energy=pt.GOOGLENET_P4_ENERGY,
                        b_max=b_max, s_max=s_max, w2=float(w))
            for w in np.linspace(0.0, 8.0, n)]


def _mirror_launch(h2, p3, t3, hso1):
    """The kernel's launch replaced by its plain mirror (the same
    partition, emulated fused multiply-adds and reduction order, on the
    same card)."""
    N, T, A = t3.shape
    split = tb._split_plan(N, T, A, p3.shape[2], tb._sm_count(h2.device))
    return tb.bellman_banded_split_ref(h2, p3, t3, hso1, split)


@pytest.mark.parametrize("accel,rho", [("none", 0.5), ("mpi", 0.7), ("anderson", 0.7)])
def test_batched_kernel_solve_matches_banded(cuda, accel, rho, monkeypatch):
    """The batched loops with every lockstep backup on the spec-batched
    kernel give the banded path's policies and g (rtol 1e-6), on the card.
    The float64 finish runs to eps 1e-6 (about 1e-8 of g), so where the
    float32 phase stops -- which moves with the kernel's sum order -- does
    not decide g.  The same solve with the kernel's plain mirror as
    the backup takes the same iterations and gives the same policies and g."""
    batch = pt.build_smdp_batched(_sweep_specs(rho))
    tight = dict(accel=accel, eps=1e-6, eps_rel=1e-9, device=cuda)
    before = tb.bellman_banded_batched.launches
    got = pt.relative_value_iteration_batched(batch, backup="pallas", **tight)
    launched = tb.bellman_banded_batched.launches - before
    want = pt.relative_value_iteration_batched(batch, **tight)
    assert launched > 0
    assert got.converged.all() and want.converged.all()
    np.testing.assert_array_equal(got.policies, want.policies)
    np.testing.assert_allclose(got.g, want.g, rtol=1e-6)
    monkeypatch.setattr(tb, "_launch", _mirror_launch)
    same = pt.relative_value_iteration_batched(batch, backup="pallas", **tight)
    np.testing.assert_array_equal(same.iterations, got.iterations)
    np.testing.assert_array_equal(same.policies, got.policies)
    np.testing.assert_allclose(got.g, same.g, rtol=1e-6)


@pytest.mark.parametrize("N,T,A,K", [(None, 129, 33, 129), (None, 65, 9, 65),
                                     (17, 129, 33, 56), (108, 129, 33, 66), (3, 33, 33, 33),
                                     (None, 200, 33, 600)])
def test_bellman_kernel_matches_its_mirror(cuda, N, T, A, K):
    """The kernel against bellman_banded_split_ref at the split it plans:
    the same arithmetic, so equal up to rounding of the mirror's emulated
    fused multiply-adds (atol 1e-5, rtol 1e-6, ten times tighter than the
    plain-version bar), at the paths' shapes and a two-chunk K."""
    args = _inputs(T + A + K, T, A, K, N or 1, cuda)
    if N is None:
        args = [x[0] for x in args]
        got = tb.bellman_banded(*args)
    else:
        got = tb.bellman_banded_batched(*args)
    split = tb._split_plan(N or 1, T, A, K, tb._sm_count(cuda))
    want = tb.bellman_banded_split_ref(*args, split)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-6)


def test_kernel_sweep_fires_no_rung(cuda):
    """A 6-spec sweep on the kernel path (anchor warm start, MPI): the
    guard ladder stays silent and the policies equal the banded sweep's."""
    specs = _sweep_specs(0.7, n=6)
    sink = []
    got = pt.sweep_solve(specs, backup="pallas", report_sink=sink, device=cuda)
    want = pt.sweep_solve(specs, device=cuda)
    rep = sink[0]
    assert rep.healthy.all() and not rep.any_fired, rep.rungs
    for a, b in zip(got, want):
        assert a.spec.s_max == b.spec.s_max
        np.testing.assert_array_equal(a.policy, b.policy)


def test_kernel_ladder_heals_on_the_kernel_or_raises(cuda):
    """On the card with backup="pallas" the guard ladder is the
    reference's: a poisoned warm start survives the banded rung (same warm
    start) and heals on the plain restart; a grid with a NaN spec completes,
    that row quarantined and failed, every other row healthy and equal in
    policy to the same grid without it.  Both runs start on the kernel."""
    specs = _sweep_specs(0.5, n=4)
    batch = pt.build_smdp_batched(specs)
    clean = pt.relative_value_iteration_batched(batch, backup="pallas", device=cuda)
    h0 = np.zeros_like(clean.h)
    h0[1] = np.nan
    before = tb.bellman_banded_batched.launches
    res = pt.relative_value_iteration_batched(batch, h0=h0, guard=True, backup="pallas",
                                              device=cuda)
    assert tb.bellman_banded_batched.launches > before
    assert res.report.rungs == {"backup_banded": [1], "plain_restart": [1]}
    assert res.report.healthy.all()
    np.testing.assert_array_equal(res.policies, clean.policies)
    specs[2] = dataclasses.replace(specs[2], w2=float("nan"))
    sink = []
    before = tb.bellman_banded_batched.launches
    got = pt.sweep_solve(specs, backup="pallas", report_sink=sink, delta=None,
                         auto_c_o=False, device=cuda)
    assert tb.bellman_banded_batched.launches > before
    rep = sink[0]
    assert rep.quarantined == rep.failed == [2]
    assert rep.rungs["backup_banded"] == [2]
    assert rep.healthy.tolist() == [True, True, False, True]
    assert np.isnan(got[2].eval.g)
    without = pt.sweep_solve(specs[:2] + specs[3:], backup="pallas", delta=None,
                             auto_c_o=False, device=cuda)
    for a, b in zip(got[:2] + got[3:], without):
        assert a.spec.s_max == b.spec.s_max
        np.testing.assert_array_equal(a.policy, b.policy)


# --- attention kernels ------------------------------------------------------

#: tests/test_kernels.py's shapes, then the serving path's prefill (prompt
#: 128, Qwen2.5-32B's 40 / 8 heads of 128) at b = 1 and 8
FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 16, True, None),
    (1, 33, 70, 4, 4, 8, False, None),
    (2, 128, 128, 8, 2, 32, True, 50.0),
    (1, 17, 128, 2, 1, 64, True, None),
    (1, 128, 128, 40, 8, 128, True, None),
    (8, 128, 128, 40, 8, 128, True, None),
]
#: tests/test_kernels.py's shapes, then the path's decode (cache 144 deep)
DECODE_SHAPES = [(2, 300, 8, 2, 16), (3, 128, 4, 4, 32), (1, 77, 8, 1, 64),
                 (4, 64, 16, 4, 8), (1, 144, 40, 8, 128), (8, 144, 40, 8, 128)]
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _normal(rng, shape, dtype, dev):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, D, causal, cap, dtype):
    rng = np.random.default_rng(Sq * Sk + H)
    q = _normal(rng, (B, Sq, H, D), dtype, cuda)
    k, v = (_normal(rng, (B, Sk, KV, D), dtype, cuda) for _ in range(2))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.attention_ref(q, k, v, causal=causal, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D", DECODE_SHAPES)
def test_decode_kernel_matches_plain(cuda, B, S, H, KV, D, dtype):
    rng = np.random.default_rng(B * S)
    q = _normal(rng, (B, H, D), dtype, cuda)
    # a layer's slice of an (L, B, S, KV, D) cache: read in place
    cache = _normal(rng, (2, 2, B, S, KV, D), dtype, cuda)
    kc, vc = cache[0, 1], cache[1, 0]
    lens = torch.as_tensor(rng.integers(1, S + 1, B), dtype=torch.int32, device=cuda)
    before = da.decode_attention.launches
    got = da.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_ref(q, kc, vc, lens)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


#: edge cases of the tensor-core flash kernel: lengths that are not
#: multiples of its 64-row tiles, causal rows that see no key (Sq > Sk),
#: every head size, softcap
FLASH_EDGE_SHAPES = [
    (2, 100, 100, 4, 2, 64, True, None),
    (1, 70, 130, 8, 2, 128, False, None),
    (2, 150, 90, 4, 1, 64, True, None),
    (1, 130, 70, 2, 2, 128, True, None),
    (2, 80, 80, 4, 2, 128, True, 30.0),
    (2, 300, 300, 8, 2, 128, True, None),
    (2, 200, 260, 4, 2, 8, True, 30.0),
    (1, 70, 330, 4, 4, 64, False, None),
] + [(1, 96, 96, 4, 2, d, True, None) for d in (8, 16, 32, 64, 128, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap", FLASH_EDGE_SHAPES)
def test_flash_kernel_edge_cases(cuda, B, Sq, Sk, H, KV, D, causal, cap, dtype):
    rng = np.random.default_rng(Sq * Sk + D)
    q = _normal(rng, (B, Sq, H, D), dtype, cuda)
    k, v = (_normal(rng, (B, Sk, KV, D), dtype, cuda) for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    want = fa.attention_ref(q, k, v, causal=causal, softcap=cap)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,D", [(128, 40, 8, 128), (77, 4, 2, 16)])
def test_flash_kernel_reads_fused_qkv_views(cuda, S, H, KV, D, dtype):
    """q / k / v as the strided views of one fused qkv projection, as
    models/layers.py passes them: read in place."""
    rng = np.random.default_rng(S + H)
    qkv = _normal(rng, (2, S, (H + 2 * KV) * D), dtype, cuda)
    q, k, v = torch.split(qkv, [H * D, KV * D, KV * D], dim=-1)
    q, k, v = q.reshape(2, S, H, D), k.reshape(2, S, KV, D), v.reshape(2, S, KV, D)
    assert not q.is_contiguous() and v.stride(1) == (H + 2 * KV) * D
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = fa.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


def test_kernels_refuse_misaligned_views(cuda):
    """16-byte loads need aligned rows: a view 2 bytes off raises, for bf16
    flash inputs and for decode's q and caches alike; nothing is copied."""
    base = torch.zeros(1 + 16 * 2 * 16, dtype=torch.bfloat16, device=cuda)
    odd = base[1:].view(1, 16, 2, 16)
    k = torch.zeros((1, 16, 2, 16), dtype=torch.bfloat16, device=cuda)
    before = fa.flash_attention.launches, da.decode_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(odd, k, k)
    lens = torch.full((1,), 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        da.decode_attention(k[:, 0], odd, k, lens)
    with pytest.raises(ValueError, match="16-byte"):
        da.decode_attention(odd[:, 0], k, k, lens)
    assert (fa.flash_attention.launches, da.decode_attention.launches) == before


def _decode_case(rng, B, S, H, KV, D, dtype, dev, lengths, cap=None):
    """q from ``rng``; K / V as one layer's slices of an (L, B, S, KV, D)
    cache drawn on the card from a seeded generator (4096-deep caches are
    too large to draw on the host quickly)."""
    q = _normal(rng, (B, H, D), dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(B * S)
    cache = torch.randn((2, 2, B, S, KV, D), generator=gen, device=dev).to(dtype)
    kc, vc = cache[0, 1], cache[1, 0]
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    before = da.decode_attention.launches
    got = da.decode_attention(q, kc, vc, lens, softcap=cap)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_ref(q, kc, vc, lens, softcap=cap)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_decode_kernel_edge_lengths(cuda, dtype, cap):
    """lengths 0 (a uniform average of all S values), 1, S and one inside a
    split, on a cache deep enough to split."""
    S = 300
    n = da._split_plan(4, S, 2, da._sm_count(cuda))
    assert n > 1
    inside = da.split_bounds(S, n)[1][0] + 5
    _decode_case(np.random.default_rng(7), 4, S, 8, 2, 64, dtype, cuda,
                 [0, 1, S, inside], cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8])
def test_decode_kernel_deep_cache(cuda, B, dtype):
    """A 4096-deep cache: many splits, most of them past short lengths."""
    S = 4096
    assert da._split_plan(B, S, 8, da._sm_count(cuda)) > 1
    rng = np.random.default_rng(B)
    lens = [S] + list(rng.integers(0, S + 1, B - 1))
    _decode_case(rng, B, S, 40, 8, 128, dtype, cuda, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_single_split(cuda, dtype):
    """b x KV >= the SM count: one split, the block writes the output."""
    B, KV = 17, 8
    assert B * KV >= da._sm_count(cuda)
    assert da._split_plan(B, 144, KV, da._sm_count(cuda)) == 1
    rng = np.random.default_rng(17)
    _decode_case(rng, B, 144, 40, KV, 128, dtype, cuda, rng.integers(0, 145, B))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(16, 1, 32), (12, 4, 256), (6, 2, 8)])
def test_decode_kernel_head_groups(cuda, H, KV, D, dtype):
    """G = 16 (two chunks of 8 q heads), G = 3 (a padded chunk of 4), and
    the head sizes at both ends."""
    rng = np.random.default_rng(H * D)
    _decode_case(rng, 2, 200, H, KV, D, dtype, cuda, [200, 37])


@pytest.mark.parametrize("B,S,H,KV,D,lengths", [
    (4, 300, 8, 2, 64, "edges"), (1, 4096, 40, 8, 128, "random"),
    (8, 144, 40, 8, 128, "random"), (2, 200, 12, 4, 256, [200, 37])])
def test_decode_kernel_matches_split_ref(cuda, B, S, H, KV, D, lengths):
    """f32: the kernel against decode_attention_split_ref, the plain mirror
    of its partials and combine, at the split count it plans (2e-6: the same
    sums, in another order)."""
    n = da._split_plan(B, S, KV, da._sm_count(cuda))
    rng = np.random.default_rng(S + D)
    if lengths == "edges":  # 0, 1, S and one inside the second split
        lengths = [0, 1, S, da.split_bounds(S, n)[1][0] + 5]
    elif lengths == "random":
        lengths = [S] + list(rng.integers(0, S + 1, B - 1))
    q = _normal(rng, (B, H, D), torch.float32, cuda)
    cache = _normal(rng, (2, 2, B, S, KV, D), torch.float32, cuda)
    kc, vc = cache[0, 1], cache[1, 0]
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    got = da.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    want = da.decode_attention_split_ref(q, kc, vc, lens, n)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


def test_reduced_model_card_matches_cpu(cuda):
    """Reduced Qwen2.5-32B in f32: the kernels on the card against the plain
    versions on the CPU, from the same weights; one serving segment's
    launches are one flash per layer and one decode per layer and step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["qwen2.5-32b"].reduced()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    card = copy.deepcopy(cpu).to(cuda)  # Module.to moves in place
    assert cpu.device.type == "cpu" and card.device.type == "cuda"
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 16)))
    outs = {}
    for name, p in (("cpu", cpu), ("cuda", card)):
        lg, cache = M.prefill(cfg, p, {"tokens": toks.to(p.device)}, 24, torch.float32)
        seq = [lg]
        tok = toks[:, :1].to(p.device)
        for _ in range(4):
            lg, cache = M.decode_step(cfg, p, cache, tok)
            seq.append(lg)
        outs[name] = torch.cat(seq, 1).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=3e-4, rtol=0)
    kernels.reset_launch_counts()
    ex = serve_llm.build_executor(cfg, card, 5, b_max=4, prompt_len=16)
    ex.run(toks.to(cuda))
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["decode_attention"] == cfg.n_layers * 4


# --- the fleet event kernel ---------------------------------------------------

FLEET_BMAX = 16
FLEET_MEANS = np.array([0.0] + [float(pt.GOOGLENET_P4_LATENCY(b))
                                for b in range(1, FLEET_BMAX + 1)])
FLEET_ZETA = np.array([0.0] + [float(pt.GOOGLENET_P4_ENERGY(b))
                               for b in range(1, FLEET_BMAX + 1)])
FLEET_LAM = 0.7 * FLEET_BMAX / float(FLEET_MEANS[FLEET_BMAX])
FLEET_ROUTERS = ("rr", "jsq", "pow2", "batch_aware")
FLEET_FAULTS = dict(mtbf=40.0, mttr=6.0, p_straggle=0.1, straggle_mult=3.0)


def _fleet_tables(M):
    qs = (4, 6, 8, 12)
    return np.stack([q_policy(qs[m % 4], 96, FLEET_BMAX) for m in range(M)])


def _fleet_trace(M, n=1200, seed=0, load=1.0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / (load * M * FLEET_LAM), n))


def _same_fleet(got, want):
    """Kernel against plain walk: every field equal, the sums too (both
    add in step order with every operation rounded on its own)."""
    for f in ("t_final", "n_served", "n_batches", "n_epochs", "n_admitted", "energy",
              "lat_sum", "slo_miss", "terminated", "n_crashes", "n_dropped", "n_shed"):
        assert getattr(got, f) == getattr(want, f), (f, getattr(got, f), getattr(want, f))
    for f in ("hist", "qlen", "busy", "n_routed", "n_served_m", "actions", "servers",
              "served", "arr_server", "dropped", "shed"):
        a, b = getattr(got, f), getattr(want, f)
        if a is not None or b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    if got.latencies is not None:
        np.testing.assert_array_equal(got.latencies, want.latencies)


@pytest.mark.parametrize("M", [1, 3, 4, 8, fk.MAX_REPLICAS])
@pytest.mark.parametrize("router", FLEET_ROUTERS)
def test_fleet_kernel_matches_plain(cuda, router, M):
    tabs, tr = _fleet_tables(M), _fleet_trace(M, n=1200 if M <= 8 else 3000)
    kw = dict(router=router, means=FLEET_MEANS, zeta=FLEET_ZETA, b_max=FLEET_BMAX,
              slo=3.0, record=True)
    before = fk.fleet_scan.launches
    got = pf.simulate_fleet(tabs, tr, device="cuda", **kw)
    assert fk.fleet_scan.launches == before + 1
    _same_fleet(got, pf.simulate_fleet(tabs, tr, device="cpu", **kw))
    assert got.n_served == len(tr)


def test_fleet_kernel_stray_phases(cuda):
    tabs, tr = _fleet_tables(4), _fleet_trace(4, n=600)
    ph = np.random.default_rng(1).integers(0, 3, len(tr))
    kw = dict(router="batch_aware", means=FLEET_MEANS, zeta=FLEET_ZETA,
              b_max=FLEET_BMAX, phases=ph, record=True)
    _same_fleet(pf.simulate_fleet(tabs, tr, device="cuda", **kw),
                pf.simulate_fleet(tabs, tr, device="cpu", **kw))


@pytest.mark.parametrize("router", FLEET_ROUTERS)
@pytest.mark.parametrize("buffer", [24, 0])
def test_fleet_kernel_faults_and_buffer(cuda, router, buffer):
    tabs, tr = _fleet_tables(3), _fleet_trace(3, load=1.4)
    sch = pfa.FaultModel(**FLEET_FAULTS).materialize(3, float(tr[-1]) + 50.0, seed=1)
    kw = dict(router=router, means=FLEET_MEANS, zeta=FLEET_ZETA, b_max=FLEET_BMAX,
              slo=2.0, faults=sch, buffer=buffer, record=True)
    got = pf.simulate_fleet(tabs, tr, device="cuda", **kw)
    _same_fleet(got, pf.simulate_fleet(tabs, tr, device="cpu", **kw))
    if buffer:
        assert got.n_crashes > 0
        pfa.verify_faults(tabs, tr, faults=sch, service=pt.ServiceModel(
            latency=pt.GOOGLENET_P4_LATENCY, family="det"), b_max=FLEET_BMAX,
            router=router, buffer=buffer, energy_table=FLEET_ZETA, slo=2.0,
            device="cuda")
    else:
        assert got.n_shed == len(tr)


def _fleet_beliefs(tr, device):
    filt = pa.PhaseBeliefFilter(rates=[0.6 * FLEET_LAM, 2.6 * FLEET_LAM],
                                gen=[[-1 / 60.0, 1 / 60.0], [1 / 30.0, -1 / 30.0]])
    return pa.belief_forward(tr, filt, device=device)[0].cpu().numpy()


@pytest.mark.parametrize("router", ["jsq", "batch_aware"])
def test_fleet_kernel_mix(cuda, router):
    tr = _fleet_trace(2, n=900)
    bel = _fleet_beliefs(tr, "cpu")
    lo, hi = q_policy(4, 96, FLEET_BMAX), q_policy(10, 96, FLEET_BMAX)
    stacks = np.stack([np.stack([lo, hi]), np.stack([hi, lo])])
    kw = dict(router=router, means=FLEET_MEANS, zeta=FLEET_ZETA, b_max=FLEET_BMAX,
              record=True, phase_mode="belief_mix", beliefs=bel)
    before = fk.fleet_scan.instance_launches.get("mix", 0)
    got = pf.simulate_fleet(stacks, tr, device="cuda", **kw)
    assert fk.fleet_scan.instance_launches["mix"] == before + 1
    _same_fleet(got, pf.simulate_fleet(stacks, tr, device="cpu", **kw))


@pytest.mark.parametrize("phase_mode", ["oracle", "belief_mix"])
def test_fleet_kernel_chunk_carry(cuda, phase_mode):
    tr = _fleet_trace(3, n=2000, load=1.3)
    sch = pfa.FaultModel(**FLEET_FAULTS).materialize(3, float(tr[-1]) + 50.0, seed=2)
    tabs = _fleet_tables(3)
    extra = {}
    if phase_mode != "oracle":
        lo, hi = q_policy(4, 96, FLEET_BMAX), q_policy(10, 96, FLEET_BMAX)
        tabs = np.stack([np.stack([lo, hi])] * 3)
    streams = {}
    for dev in ("cuda", "cpu"):
        if phase_mode != "oracle":
            extra = dict(phase_mode=phase_mode, belief_filter=pa.PhaseBeliefFilter(
                rates=[0.6 * FLEET_LAM, 2.6 * FLEET_LAM],
                gen=[[-1 / 60.0, 1 / 60.0], [1 / 30.0, -1 / 30.0]]))
        fs = pf.FleetStream(tabs, router="jsq", means=FLEET_MEANS, zeta=FLEET_ZETA,
                            b_max=FLEET_BMAX, slo=2.0, faults=sch, buffer=24,
                            device=dev, **extra)
        for lo_ in range(0, len(tr), 180):
            fs.push(tr[lo_:lo_ + 180])
        streams[dev] = fs
    got, want = streams["cuda"].finish(), streams["cpu"].finish()
    _same_fleet(got, want)
    assert streams["cuda"].report() == streams["cpu"].report()
    if phase_mode == "oracle":
        one = pf.simulate_fleet(tabs, tr, router="jsq", means=FLEET_MEANS,
                                zeta=FLEET_ZETA, b_max=FLEET_BMAX, slo=2.0,
                                faults=sch, buffer=24, device="cuda")
        for f in ("n_served", "n_batches", "n_epochs", "slo_miss", "n_crashes",
                  "n_dropped", "n_shed", "t_final"):
            assert getattr(got, f) == getattr(one, f), f
        np.testing.assert_array_equal(got.hist, one.hist)


@pytest.mark.parametrize("mode", ["belief_argmax", "belief_mix"])
def test_fleet_stream_belief_matches_one_shot(cuda, mode):
    """tests/test_torch_faults.py's chunked belief stream on the card: the
    rows of each chunk's belief_forward call agree with one call over the
    whole trace only to rounding, and every aggregate still equals the
    one-shot run's (energy and lat_sum at rtol 1e-12, the reference's bar)."""
    lam = 3 * FLEET_LAM
    m = pa.MMPP2(lam1=0.3 * lam, lam2=1.3 * lam, dwell1=60.0, dwell2=30.0)
    tr, _ = m.sample_arrivals(1000 / m.mean_rate, np.random.default_rng(0))
    sch = pfa.FaultModel(**FLEET_FAULTS).materialize(3, float(tr[-1]) + 50.0, seed=1)
    lo, hi = q_policy(4, 96, FLEET_BMAX), q_policy(10, 96, FLEET_BMAX)
    stacks = np.stack([np.stack([lo, hi]), np.stack([hi, lo]), np.stack([lo, lo])])
    kw = dict(router="jsq", means=FLEET_MEANS, zeta=FLEET_ZETA, b_max=FLEET_BMAX, slo=2.0,
              buffer=24, faults=sch, device="cuda")

    def filt():
        return pa.PhaseBeliefFilter(rates=[0.3 * lam, 1.3 * lam],
                                    gen=[[-1 / 60, 1 / 60], [1 / 30, -1 / 30]])

    st = pf.FleetStream(stacks, phase_mode=mode, belief_filter=filt(), **kw)
    for i in range(0, len(tr), 97):
        st.push(tr[i:i + 97])
    got = st.finish()
    bel, _ = pa.belief_forward(tr, filt(), device="cuda")
    one = pf.simulate_fleet(stacks, tr, phase_mode=mode, beliefs=bel.cpu().numpy(), **kw)
    for f in ("n_served", "n_batches", "n_epochs", "slo_miss", "n_crashes", "n_dropped",
              "n_shed", "t_final"):
        assert getattr(got, f) == getattr(one, f), (f, getattr(got, f), getattr(one, f))
    np.testing.assert_allclose(got.energy, one.energy, rtol=1e-12)
    np.testing.assert_allclose(got.lat_sum, one.lat_sum, rtol=1e-12)
    np.testing.assert_array_equal(got.hist, one.hist)
    np.testing.assert_array_equal(got.qlen, one.qlen)
    assert got.n_crashes > 0


@pytest.mark.parametrize("phase_mode", ["oracle", "belief_mix"])
def test_fleet_kernel_grid(cuda, phase_mode):
    traces = [_fleet_trace(4, n=1500, seed=s) for s in range(3)]
    arr = pad_arrivals_batch(traces)
    kw = dict(routers=FLEET_ROUTERS, means=FLEET_MEANS, zeta=FLEET_ZETA,
              b_max=FLEET_BMAX, router_seed=3)
    if phase_mode == "oracle":
        tabs = np.stack([_fleet_tables(4), np.tile(q_policy(10, 96, FLEET_BMAX), (4, 1))])
    else:
        lo, hi = q_policy(4, 96, FLEET_BMAX), q_policy(10, 96, FLEET_BMAX)
        tabs = np.stack([np.stack([np.stack([lo, hi])] * 4)])
        kw.update(phase_mode=phase_mode, beliefs=_fleet_beliefs(arr, "cpu"))
    before = fk.fleet_scan.launches
    got = pf.run_fleet_grid(tabs, arr, device="cuda", **kw)
    assert fk.fleet_scan.launches == before + 1
    want = pf.run_fleet_grid(tabs, arr, device="cpu", **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_fleet_kernel_refuses_above_its_maximum(cuda):
    tabs = _fleet_tables(fk.MAX_REPLICAS + 1)
    before = fk.fleet_scan.launches
    with pytest.raises(ValueError, match=f"at most {fk.MAX_REPLICAS}"):
        pf.simulate_fleet(tabs, _fleet_trace(4, n=100), means=FLEET_MEANS,
                          b_max=FLEET_BMAX, device="cuda")
    assert fk.fleet_scan.launches == before


# The redesigned fleet kernel's seams: the register walk (M <= 8) against the
# shared-memory walk (M >= 9), the staging windows (256 arrivals a chunk),
# the consumer's record ring (64 records), the FIFO and tables in shared or
# global memory by the wrapper's plan, RECORD on and off.


@pytest.mark.parametrize("record", [True, False])
@pytest.mark.parametrize("router", ["rr", "pow2", "batch_aware"])
@pytest.mark.parametrize("M", [2, 5, 8, 9, fk.MAX_REPLICAS])
def test_fleet_kernel_walk_switch(cuda, M, router, record):
    """M = 2, 5 and 8 walk in registers (the instances for 2 and 8), 9 and
    64 in shared memory; a trace of several staging chunks, with faults so
    boundaries replay too."""
    assert fk.smem_plan(6, M, 1, 97, 10, FLEET_BMAX, False).walk == (
        "registers" if M <= fk.REG_REPLICAS else "shared")
    tabs, tr = _fleet_tables(M), _fleet_trace(M, n=5 * 256 + 37, load=1.2)
    sch = pfa.FaultModel(**FLEET_FAULTS).materialize(M, float(tr[-1]) + 50.0, seed=M)
    kw = dict(router=router, means=FLEET_MEANS, zeta=FLEET_ZETA, b_max=FLEET_BMAX,
              slo=2.0, faults=sch, buffer=40, record=record)
    _same_fleet(pf.simulate_fleet(tabs, tr, device="cuda", **kw),
                pf.simulate_fleet(tabs, tr, device="cpu", **kw))


def test_fleet_kernel_record_ring_bursts(cuda):
    """Clumps of 16 x M simultaneous arrivals and a table that serves
    b_max at once: back-to-back serves, many more records than the
    consumer's ring holds, every one accounted."""
    M, n = 4, 6000
    rng = np.random.default_rng(5)
    tr = np.repeat(np.cumsum(rng.exponential(6.0, n // (16 * M) + 1)), 16 * M)[:n]
    tabs = np.stack([q_policy(1, 96, FLEET_BMAX)] * M)
    kw = dict(router="rr", means=FLEET_MEANS, zeta=FLEET_ZETA, b_max=FLEET_BMAX,
              slo=5.0, record=True)
    got = pf.simulate_fleet(tabs, tr, device="cuda", **kw)
    _same_fleet(got, pf.simulate_fleet(tabs, tr, device="cpu", **kw))
    assert got.n_served == n and got.n_batches > 4 * 64  # the ring holds 64


@pytest.mark.parametrize("mix", [False, True])
def test_fleet_kernel_unequal_lanes(cuda, mix):
    """One launch over traces of 300, 1900 and 700 arrivals (lanes end at
    different steps; the longest crosses several staging chunks)."""
    traces = [_fleet_trace(4, n=k, seed=k) for k in (300, 1900, 700)]
    arr = pad_arrivals_batch(traces)
    kw = dict(routers=FLEET_ROUTERS, means=FLEET_MEANS, zeta=FLEET_ZETA,
              b_max=FLEET_BMAX, router_seed=2)
    if mix:
        lo, hi = q_policy(4, 96, FLEET_BMAX), q_policy(10, 96, FLEET_BMAX)
        tabs = np.stack([np.stack([np.stack([lo, hi])] * 4)])
        kw.update(phase_mode="belief_mix", beliefs=_fleet_beliefs(arr, "cpu"))
    else:
        tabs = _fleet_tables(4)[None]
    got = pf.run_fleet_grid(tabs, arr, device="cuda", **kw)
    want = pf.run_fleet_grid(tabs, arr, device="cpu", **kw)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("M,n,L", [(8, 9000, 97), (fk.MAX_REPLICAS, 600, 400)])
def test_fleet_kernel_global_fifo_and_tables(cuda, M, n, L):
    """The plan's fallbacks: 8 x 9000 FIFO slots exceed a block's shared
    memory (the FIFO stays in global scratch); 64 x 400-column tables do
    (read from global memory)."""
    plan = fk.smem_plan(129, M, 1, L, n + 64, FLEET_BMAX, False)
    assert not (plan.fifo_smem and plan.stage_tables) and plan.bytes <= fk.MAX_SMEM_BYTES
    qs = (4, 6, 8, 12)
    tabs = np.stack([q_policy(qs[m % 4], L - 1, FLEET_BMAX) for m in range(M)])
    tr = _fleet_trace(M, n=n, seed=3)
    kw = dict(router="jsq", means=FLEET_MEANS, zeta=FLEET_ZETA, b_max=FLEET_BMAX,
              slo=3.0, record=True)
    _same_fleet(pf.simulate_fleet(tabs, tr, device="cuda", **kw),
                pf.simulate_fleet(tabs, tr, device="cpu", **kw))


def test_scan_kernels_lay_out_the_wrappers_plans(cuda):
    """The C layouts of fleet_scan.cu and sim_scan.cu equal the wrappers'
    mirrors (the wrappers raise on a mismatch; this names it)."""
    import ctypes

    from repro_torch.kernels import _build

    ll, ci = ctypes.c_longlong, ctypes.c_int
    fleet = _build.function("fleet_scan", "fleet_scan_smem_bytes", ll, [ll] * 6 + [ci] * 3)
    for args in [(129, 3, 1, 97, 8100, 17, 0, 1, 1), (64, 64, 3, 129, 600, 33, 1, 0, 0),
                 (1, 1, 1, 1, 1, 2, 0, 0, 0), (300, 9, 2, 385, 20000, 17, 1, 1, 0)]:
        assert fleet(*args) == fk.smem_bytes(*args)
    sim = _build.function("sim_scan", "sim_scan_smem_bytes", ll, [ll] * 3)
    for args in [(128, 33, 1), (4097, 65, 3), (1, 2, 5)]:
        assert sim(*args) == sk.smem_bytes(*args)


# ---------------------------------------------------------------------------
# The MMPP sampler kernel, the simulator kernel, durable sweeps on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,n", [(1, 1), (1, 60_000), (7, 5_000), (133, 300)])
def test_mmpp_sample_kernel_matches_plain(cuda, L, n):
    g = torch.Generator(device="cuda")
    g.manual_seed(L * 7 + n)
    draws = torch.empty((L, 1 + 2 * n), dtype=torch.float64, device="cuda").exponential_(
        generator=g)
    lam, dwell = (0.4, 3.0), (30.0, 6.0)
    before = mk.mmpp_sample.launches
    got = mk.mmpp_sample(draws, lam, dwell)
    torch.cuda.synchronize()
    assert mk.mmpp_sample.launches == before + 1
    want = mk.mmpp_sample_ref(draws.cpu(), lam, dwell)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("L", [1, 6, 200])
@pytest.mark.parametrize("n", [mk.RING - 1, mk.RING, mk.RING + 1, 2 * mk.RING + 1])
def test_mmpp_sample_kernel_ring_seams(cuda, L, n):
    """Walks of one chunk's length +-1 and over two, 1 to 200 lanes, bit for
    bit against the plain walk."""
    import ctypes

    from repro_torch.kernels import _build

    ring = _build.function("mmpp_sample", "mmpp_sample_chunk", ctypes.c_longlong, [])()
    assert ring == mk.RING
    g = torch.Generator(device="cuda")
    g.manual_seed(L * 11 + n)
    draws = torch.empty((L, 1 + 2 * n), dtype=torch.float64, device="cuda").exponential_(
        generator=g)
    got = mk.mmpp_sample(draws, (0.3, 2.5), (40.0, 8.0))
    want = mk.mmpp_sample_ref(draws.cpu(), (0.3, 2.5), (40.0, 8.0))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("lam,dwell", [((0.01, 10.0), (0.05, 0.02)), ((10.0, 0.01), (1e-3, 5.0)),
                                       ((1e-3, 1.0), (300.0, 300.0))])
def test_mmpp_sample_kernel_switch_heavy_and_extreme_rates(cuda, lam, dwell):
    """Dwells so short that most steps switch, rates 1e3 apart: the walk's
    selects on both sides of every compare, bit for bit."""
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    draws = torch.empty((6, 1 + 2 * 4000), dtype=torch.float64, device="cuda").exponential_(
        generator=g)
    got = mk.mmpp_sample(draws, lam, dwell)
    want = mk.mmpp_sample_ref(draws.cpu(), lam, dwell)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    share = 1.0 - float(want[1].double().mean())
    assert share > 0.5 if dwell[0] < 0.1 else share < 0.5


def test_mmpp2_times_on_the_card(cuda):
    m = pa.MMPP2(lam1=1.0, lam2=5.0, dwell1=50.0, dwell2=50.0)
    times, mask, ph = pa.mmpp2_times(1, m, 30_000, with_phases=True, lanes=3)
    assert times.device.type == "cuda"
    for s_ in range(3):
        n = int(mask[s_].sum())
        assert torch.isinf(times[s_, n:]).all() and (times[s_, :n].diff() >= 0).all()
        assert abs(n / float(times[s_, n - 1]) - m.mean_rate) / m.mean_rate < 0.1
    res = simulate_compiled(q_policy(6, 96, 16), times[0], means=np.arange(17.0) * 0.3 + 1,
                            b_max=16, device="cuda")
    assert res.n_served == int(mask[0].sum())


def _sim_inputs(fam_name, L, E, seed, k_max_arr=12, **extra):
    from repro_torch.core.simulate import service_params

    svc = pt.ServiceModel(latency=pt.GOOGLENET_P4_LATENCY, family=fam_name, **extra)
    fam, k, W, means, cum, scales = service_params(svc, 32)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device="cuda")
    svc_d = torch.empty((L, E, W), **f64).exponential_(generator=g)
    if fam_name in ("hyperexpo", "atoms"):
        svc_d[..., 0] = torch.rand((L, E), generator=g, **f64)
    arr = torch.empty((L, E * k_max_arr), **f64).exponential_(generator=g)
    en = torch.as_tensor([0.0] + [float(pt.GOOGLENET_P4_ENERGY(b)) for b in range(1, 33)],
                         **f64)
    lam = 0.7 * 32 / float(svc.mean(32))
    return (torch.as_tensor(means, **f64), en, torch.as_tensor(cum, **f64),
            torch.as_tensor(scales, **f64), svc_d, arr), dict(fam=fam, erlang_k=k, lam=lam)


def _same_sim(got, want):
    for name in got._fields:
        a, b = getattr(got, name).cpu(), getattr(want, name)
        if name == "resp":
            for ln in range(a.shape[0]):
                n = int(want.n_served[ln])
                assert torch.equal(a[ln, :n], b[ln, :n]), ln
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("family,extra", [
    ("det", {}), ("expo", {}), ("erlang", dict(erlang_k=3)), ("hyperexpo", {}),
    ("atoms", dict(atom_weights=(0.5, 0.3, 0.2), atom_scales=(0.5, 1.0, 2.0)))])
@pytest.mark.parametrize("k_max", [64, 4])
def test_sim_scan_kernel_matches_plain(cuda, family, extra, k_max):
    """Every family, a run that clips at k_max, and (det, static-8, 8 000
    epochs) more than 2^15 requests, so the ring wraps."""
    E, L = 8_000, 2
    (means, en, cum, scales, svc_d, arr), kw = _sim_inputs(family, L, E, 3, **extra)
    pol = torch.as_tensor(pt.static_policy(8, 128)[:-1], device="cuda")
    before = sk.sim_scan.launches
    got = sk.sim_scan(pol, means, en, cum, scales, svc_d, arr, k_max=k_max, R=E * 8, **kw)
    torch.cuda.synchronize()
    assert sk.sim_scan.launches == before + 1
    want = sk.sim_scan_ref(pol.cpu(), means.cpu(), en.cpu(), cum.cpu(), scales.cpu(),
                           svc_d.cpu(), arr.cpu(), k_max=k_max, R=E * 8, **kw)
    _same_sim(got, want)
    assert (want.exhausted == -1).all()
    if k_max == 4:
        assert int(want.clipped.sum()) > 0
    if family == "det" and k_max == 64:
        assert int(want.n_served.min()) > sk.BUF


def test_sim_scan_kernel_cuts_actions_above_the_queue(cuda):
    """A table whose action exceeds s serves nothing there (a > s -> 0),
    and a lane that runs out of draws stops and reports the epoch."""
    E = 3_000
    (means, en, cum, scales, svc_d, arr), kw = _sim_inputs("expo", 1, E, 4)
    pol = torch.full((40,), 12, dtype=torch.int64, device="cuda")
    got = sk.sim_scan(pol, means, en, cum, scales, svc_d, arr, k_max=64, R=E * 12, **kw)
    want = sk.sim_scan_ref(pol.cpu(), means.cpu(), en.cpu(), cum.cpu(), scales.cpu(),
                           svc_d.cpu(), arr.cpu(), k_max=64, R=E * 12, **kw)
    _same_sim(got, want)
    assert set(want.acts[0].tolist()) == {0, 12}
    short = arr[:, :200].contiguous()
    got = sk.sim_scan(pol, means, en, cum, scales, svc_d, short, k_max=64, R=E * 12, **kw)
    want = sk.sim_scan_ref(pol.cpu(), means.cpu(), en.cpu(), cum.cpu(), scales.cpu(),
                           svc_d.cpu(), short.cpu(), k_max=64, R=E * 12, **kw)
    assert int(want.exhausted[0]) >= 0
    _same_sim(got, want)


def _sim_both(pol, inputs, kw, **extra):
    got = sk.sim_scan(pol, *inputs, **kw, **extra)
    torch.cuda.synchronize()
    want = sk.sim_scan_ref(pol.cpu(), *(x.cpu() for x in inputs), **kw, **extra)
    _same_sim(got, want)
    return want


@pytest.mark.parametrize("family", ["det", "erlang"])
def test_sim_scan_kernel_clips_across_staging_chunks(cuda, family):
    """Arrivals at 40x the rate: every serve's run is clipped at k_max =
    300, so clipped runs (and their re-sums) cross the 1024-gap staging
    chunks, and the epochs' service factors cross theirs (512 epochs)."""
    E, L = 1_500, 2
    extra = dict(erlang_k=3) if family == "erlang" else {}
    inputs, kw = _sim_inputs(family, L, E, 7, k_max_arr=320, **extra)
    kw["lam"] *= 40
    pol = torch.as_tensor(pt.static_policy(8, 128)[:-1], device="cuda")
    want = _sim_both(pol, inputs, kw, k_max=300, R=E * 8)
    assert (want.exhausted == -1).all() and int(want.clipped.min()) > 100


def test_sim_scan_kernel_overfull_ring(cuda):
    """Load 2.1: the queue outgrows the 2^15-entry ring, so a serve reads
    an entry that a later arrival overwrote, as the reference's carried
    buffer does; the kernel's responses must read the same entries."""
    E = 8_000
    inputs, kw = _sim_inputs("det", 1, E, 11, k_max_arr=30)
    kw["lam"] *= 3
    pol = torch.as_tensor(pt.static_policy(8, 128)[:-1], device="cuda")
    want = _sim_both(pol, inputs, kw, k_max=64, R=E * 8)
    assert int(want.consumed[0]) - int(want.n_served[0]) > sk.BUF


def test_sim_scan_kernel_unequal_lanes(cuda):
    """Five lanes with one arrival stream length: the stream is cut at the
    median lane's need, so some lanes stop early (exhausted) and others
    run every epoch, in one launch."""
    E, L = 4_000, 5
    (means, en, cum, scales, svc_d, arr), kw = _sim_inputs("expo", L, E, 13)
    pol = torch.as_tensor(pt.static_policy(8, 128)[:-1], device="cuda")
    full = sk.sim_scan_ref(pol.cpu(), means.cpu(), en.cpu(), cum.cpu(), scales.cpu(),
                           svc_d.cpu(), arr.cpu(), k_max=64, R=E * 8, **kw)
    cut = int(np.sort(full.consumed.numpy())[L // 2])
    short = arr[:, :cut].contiguous()
    want = _sim_both(pol, (means, en, cum, scales, svc_d, short), kw, k_max=64, R=E * 8)
    ex = want.exhausted.numpy()
    assert (ex >= 0).any() and (ex == -1).any()


def test_simulate_on_the_card_meets_the_analytic_values(cuda):
    from repro_torch.core.simulate import simulate

    svc = pt.ServiceModel(latency=pt.GOOGLENET_P4_LATENCY)
    spec = pt.SMDPSpec(lam=0.7 * 32 / float(svc.mean(32)), service=svc,
                       energy=pt.GOOGLENET_P4_ENERGY, b_max=32, s_max=128, w2=1.6)
    en = np.array([0.0] + [float(pt.GOOGLENET_P4_ENERGY(b)) for b in range(1, 33)])
    pol = pt.static_policy(8, 128)
    ev = pt.evaluate_policy(pt.build_smdp(spec), pol)
    sim = simulate(pol[:-1], svc, en, spec.lam, 32, n_epochs=150_000, seed=0)
    np.testing.assert_allclose(sim.w_bar, ev.w_bar, rtol=0.02)
    np.testing.assert_allclose(sim.p_bar, ev.p_bar, rtol=0.02)
    np.testing.assert_allclose(sim.l_bar / spec.lam, sim.w_bar, rtol=0.02)


def test_durable_sweep_on_the_card(cuda, tmp_path):
    """backup="pallas": a resume from the first committed step equals the
    uninterrupted checkpointed run bitwise; a CPU checkpoint is refused."""
    import shutil

    svc = pt.ServiceModel(latency=pt.GOOGLENET_P4_LATENCY)
    base = pt.SMDPSpec(lam=0.5 * 16 / float(svc.mean(16)), service=svc,
                       energy=pt.GOOGLENET_P4_ENERGY, b_max=16, s_max=48)
    specs = [dataclasses.replace(base, w2=w) for w in (0.0, 1.0, 3.0, 6.0)]
    kw = dict(chunk_size=1, keep_last_k=99, backup="pallas")
    ref = pt.sweep_solve(specs, checkpoint_dir=str(tmp_path / "ref"), device="cuda", **kw)
    crash = tmp_path / "crash"
    shutil.copytree(tmp_path / "ref", crash)
    for p in sorted(crash.glob("step_*"))[1:]:
        shutil.rmtree(p)
    before = tb.bellman_banded_batched.launches
    got = pt.sweep_solve(specs, checkpoint_dir=str(crash), device="cuda", **kw)
    assert tb.bellman_banded_batched.launches > before
    for a, b in zip(got, ref):
        assert np.array_equal(a.rvi.policy, b.rvi.policy) and a.rvi.g == b.rvi.g
        assert np.array_equal(a.rvi.h, b.rvi.h)
    pt.sweep_solve(specs, checkpoint_dir=str(tmp_path / "cpu"), device="cpu", **kw)
    with pytest.raises(ValueError, match="different sweep"):
        pt.sweep_solve(specs, checkpoint_dir=str(tmp_path / "cpu"), device="cuda", **kw)


# --- the SSD scan kernel (Mamba2) ---------------------------------------------

SSD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: bf16 inputs, held inside their 2e-2 bar: both versions multiply the same
#: bf16 values in f32, so only the order of sums differs.  A kernel that
#: rounded the decay-weighted att, the state or w x to bf16 would miss it.
SSD_BF16_IN_F32_TOL = 1e-4


def _ssd_inputs(seed, B, S, H, P, N, dtype, zero_state, dev):
    """Inputs in a Mamba2 block's regime: xs, B and C as views of one fused
    (B, S, H P + 2 N) tensor, B and C at the 1/sqrt(N) scale of a
    normalised dot product, dt log-uniform on Mamba2's initialisation range
    [1e-3, 1e-1], A = -exp(log-uniform on [0, log 16]).  (Unit-scale B / C
    and dt ~ 0.3 make outputs of ~100 from cancelling sums and decays of
    e^-60 a chunk, where the plain version in f32 misses 2e-5 against
    float64 itself.)"""
    rng = np.random.default_rng(seed)
    xbc = rng.normal(size=(B, S, H * P + 2 * N))
    xbc[..., H * P:] /= np.sqrt(N)
    xbc = torch.as_tensor(xbc, dtype=torch.float32, device=dev).to(dtype)
    xs = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    f = dict(dtype=torch.float32, device=dev)
    dt = torch.as_tensor(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H))), **f)
    a = torch.as_tensor(-np.exp(rng.uniform(0.0, np.log(16.0), H)), **f)
    state = None if zero_state else torch.as_tensor(rng.normal(size=(B, H, P, N)), **f)
    return xs, Bm, Cm, dt, dt * a, state


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk", [(1, 128), (7, 8), (7, 128), (128, 128), (129, 128),
                                     (300, 8), (300, 128), (70, 66), (200, 100)])
@pytest.mark.parametrize("B,H,P,N", [(8, 64, 64, 64), (1, 8, 16, 16), (2, 5, 32, 128),
                                     (1, 3, 18, 10)])
def test_ssd_scan_kernel_matches_plain(cuda, B, H, P, N, S, chunk, dtype, zero_state):
    args = _ssd_inputs(S + chunk, B, S, H, P, N, dtype, zero_state, cuda)
    before = sd.ssd_scan.launches
    inst = dict(sd.ssd_scan.instance_launches)
    y, st = sd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sd.ssd_scan.launches == before + 1
    for name in sd.KERNELS:  # the first pass only for chunks of L > 1
        ran = name == "scan" or sd.chunk_len(S, chunk) > 1
        assert sd.ssd_scan.instance_launches.get(name, 0) == inst.get(name, 0) + ran
    y_ref, st_ref = sd.ssd_scan_ref(*args, chunk=chunk)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y, y_ref, atol=tol, rtol=tol)
    torch.testing.assert_close(st, st_ref, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        tol = SSD_BF16_IN_F32_TOL
        torch.testing.assert_close(y, y_ref, atol=tol, rtol=tol)
        torch.testing.assert_close(st, st_ref, atol=tol, rtol=tol)


def test_ssd_scan_kernel_in_place_and_layout(cuda):
    """The state updated in place (state_out is state); the C library's
    shared-memory size equals the wrapper's; inputs the kernel cannot read
    in place, or a chunk over the shared memory, are refused."""
    import ctypes

    from repro_torch.kernels import _build

    xs, Bm, Cm, dt, dA, st = _ssd_inputs(5, 8, 129, 64, 64, 64, torch.bfloat16, False, cuda)
    y_ref, st_ref = sd.ssd_scan_ref(xs, Bm, Cm, dt, dA, st, chunk=128)
    y, out = sd.ssd_scan(xs, Bm, Cm, dt, dA, st, chunk=128, state_out=st)
    torch.cuda.synchronize()
    assert out.data_ptr() == st.data_ptr()
    for tol in (SSD_TOL[torch.bfloat16], SSD_BF16_IN_F32_TOL):
        torch.testing.assert_close(y, y_ref, atol=tol, rtol=tol)
        torch.testing.assert_close(out, st_ref, atol=tol, rtol=tol)
    fn = _build.function("ssd_scan", "ssd_scan_smem_bytes", ctypes.c_longlong,
                         [ctypes.c_int] * 3)
    for P, N, L in ((64, 64, 128), (16, 16, 8), (64, 64, 1), (32, 128, 100), (18, 10, 66),
                    (64, 64, 200)):
        assert fn(P, N, L) == sd.smem_bytes(P, N, L)
    with pytest.raises(ValueError, match="contiguous"):
        sd.ssd_scan(xs.transpose(2, 3), Bm, Cm, dt, dA, None)
    long = _ssd_inputs(6, 1, 600, 2, 64, 64, torch.bfloat16, True, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sd.ssd_scan(*long, chunk=512)


def test_reduced_hybrid_card_matches_cpu(cuda):
    """Reduced Zamba2 in f32: the kernels on the card against the plain
    versions on the CPU from the same weights; prefill + 4 decode steps
    launch one SSD scan per Mamba2 layer and step, one flash / decode per
    occurrence of the shared block."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["zamba2-1.2b"].reduced()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 16)))
    outs = {}
    kernels.reset_launch_counts()
    for name, p in (("cpu", cpu), ("cuda", card)):
        lg, cache = M.prefill(cfg, p, {"tokens": toks.to(p.device)}, 24, torch.float32)
        seq = [lg]
        tok = toks[:, :1].to(p.device)
        for _ in range(4):
            lg, cache = M.decode_step(cfg, p, cache, tok)
            seq.append(lg)
        outs[name] = torch.cat(seq, 1).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=3e-4, rtol=0)
    counts = kernels.launch_counts()
    n_occ = M.n_shared_occurrences(cfg)
    assert counts["ssd_scan"] == counts["ssd_scan:scan"] == 5 * cfg.n_layers
    assert counts["ssd_scan:cb"] == cfg.n_layers  # the prefill's first pass
    assert counts["flash_attention"] == n_occ
    assert counts["decode_attention"] == 4 * n_occ



# --- attention backward kernel (training) -------------------------------------

#: the training path's shape (qwen2.5-100m: b 8, S 256, 8 / 4 heads of 64),
#: then edges: Sq != Sk (rows that see no key), lengths off the 64-row bf16
#: tiles and the 32-key / 64-query f32 tiles (31, 33, 63, 65, 97, 129, 161),
#: G 1 / 2 / 5 / 8, D 64 / 128 and the other head sizes (D = 256 on its two
#: warpgroups, over several tiles), softcap, causal and not
BWD_SHAPES = [
    (8, 256, 256, 8, 4, 64, True, None),
    (2, 100, 100, 4, 2, 64, True, None),
    (1, 70, 130, 8, 1, 128, False, None),
    (2, 90, 60, 10, 2, 64, True, 30.0),
    (1, 33, 77, 8, 8, 128, True, None),
    (1, 65, 65, 16, 2, 32, False, 20.0),
    (1, 31, 31, 5, 1, 64, True, None),
    (2, 97, 161, 10, 2, 128, True, 30.0),
    (1, 129, 65, 4, 4, 32, True, None),
    (1, 130, 130, 4, 2, 256, True, None),
    (1, 63, 97, 5, 1, 256, False, None),
] + [(1, 40, 40, 4, 2, d, True, None) for d in (8, 16, 256)]
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_inputs(seed, B, Sq, Sk, H, KV, D, dtype, dev):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, Sq, H, D), dtype, dev)
    k, v = (_normal(rng, (B, Sk, KV, D), dtype, dev) for _ in range(2))
    return q, k, v, _normal(rng, (B, Sq, H, D), dtype, dev)


def _held_to_max(got, want, tol, what):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), f"{what}: {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap", BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, D, causal, cap, dtype):
    q, k, v, do = _bwd_inputs(Sq + Sk + H, B, Sq, Sk, H, KV, D, dtype, cuda)
    out, lse = fa.flash_attention(q, k, v, causal=causal, softcap=cap, return_lse=True)
    before = dict(fb.flash_attention_bwd.instance_launches)
    got = fb.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    for name in fb.KERNELS:
        assert fb.flash_attention_bwd.instance_launches[name] == before.get(name, 0) + 1
    lse_tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(lse, fa.lse_ref(q, k, causal=causal, softcap=cap),
                               atol=lse_tol, rtol=lse_tol)
    want = fb.flash_attention_bwd_ref(q, k, v, do, causal=causal, softcap=cap)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape and g.is_contiguous()
        _held_to_max(g, w, BWD_TOL[dtype], f"d{name}")
    again = fb.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, softcap=cap)
    for g, h in zip(got, again):  # no atomics: the same bits every run
        assert torch.equal(g, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_reads_a_misaligned_dout(cuda, dtype):
    """dO as a view one element into a buffer (rows not 16-byte aligned):
    the kernels stage it by plain loads instead of 16-byte copies, with the
    same result and bits as an aligned copy of it."""
    q, k, v, do = _bwd_inputs(3, 2, 70, 70, 4, 2, 64, dtype, cuda)
    buf = torch.empty(do.numel() + 1, dtype=dtype, device=cuda)
    odd = buf[1:].view(do.shape)
    odd.copy_(do)
    assert odd.data_ptr() % 16 != 0
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    got = fb.flash_attention_bwd(q, k, v, out, lse, odd)
    want = fb.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, fb.flash_attention_bwd_ref(q, k, v, do)):
        _held_to_max(g, w, BWD_TOL[dtype], "grad")


def test_flash_function_and_refusals(cuda):
    """ops.flash_attention on inputs that require grad goes through the
    autograd Function (forward with lse, then the backward kernel); the
    flash wrapper called directly, decode, the SSD scan and the Bellman
    backup refuse such tensors."""
    q, k, v, do = _bwd_inputs(1, 2, 64, 64, 4, 2, 64, torch.float32, cuda)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    f0, b0 = fa.flash_attention.launches, fb.flash_attention_bwd.launches
    out = ops.flash_attention(qg, kg, vg, causal=True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    assert fa.flash_attention.launches == f0 + 1 and fb.flash_attention_bwd.launches == b0 + 1
    for g, w in zip(grads, fb.flash_attention_bwd_ref(q, k, v, do, causal=True)):
        _held_to_max(g, w, 1e-4, "grad")
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(qg, kg, vg)
    with pytest.raises(RuntimeError, match="requires grad"):
        da.decode_attention(qg[:, 0], kg, vg,
                            torch.full((2,), 64, dtype=torch.int32, device=cuda))
    xs, Bm, Cm, dt, dA, st = _ssd_inputs(2, 1, 16, 2, 16, 16, torch.float32, True, cuda)
    with pytest.raises(RuntimeError, match="requires grad"):
        sd.ssd_scan(xs.requires_grad_(True), Bm, Cm, dt, dA, st)
    h, pmfs, tails, hso = _inputs(0, 64, 9, 40, 1, cuda)
    with pytest.raises(RuntimeError, match="requires grad"):
        tb.bellman_banded(h[0].requires_grad_(True), pmfs[0], tails[0], hso[0])
    with torch.no_grad():  # without grad mode the kernels run
        fa.flash_attention(qg, kg, vg)


def test_training_gradients_on_the_card_match_the_cpu(cuda):
    """A reduced Qwen2.5 (f32): lm_loss with remat through the kernels on
    the card, against the same weights through the plain versions on the
    CPU; two flash launches a layer (forward and its recompute), one
    backward call a layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["qwen2.5-32b"].reduced()
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 40)))
    grads = {}
    for name, p in (("cpu", cpu), ("cuda", card)):
        p.trainable()
        kernels.reset_launch_counts()
        loss = M.lm_loss(cfg, p, {"tokens": toks.to(p.device)}, remat=True)
        grads[name] = torch.autograd.grad(loss, list(p.parameters()))
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_bwd"] == cfg.n_layers
    for (n, _), g, w in zip(cpu.named_parameters(), grads["cuda"], grads["cpu"]):
        _held_to_max(g.cpu(), w, 1e-4, n)
