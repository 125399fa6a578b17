"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the reference package, so it runs on a
machine that has PyTorch with CUDA alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test is marked `cuda` and skips where torch.cuda.is_available() is
false (the kernels have no CPU mode).  Tolerances are the reference's:
atol 1e-4 / rtol 1e-5 for the f32 Bellman backup (sums in another order),
1e-5 / 1e-6 between the batched and scalar launches of the same kernel,
and 1e-9 on serving latencies (the event walk is bit-for-bit the plain
version's arithmetic).
"""
import numpy as np
import pytest
import torch

from repro_torch import core as pt
from repro_torch.core.policies import q_policy
from repro_torch.kernels import bellman as tb
from repro_torch.kernels import serve_scan as ss
from repro_torch.serving import simulate_compiled

pytestmark = pytest.mark.cuda

SHAPES = [(64, 9, 40), (200, 33, 170), (128, 33, 128), (300, 17, 513),
          (129, 33, 129), (4097, 33, 4097)]
BATCHED_SHAPES = [(1, 64, 9, 40), (3, 130, 33, 130), (4, 128, 17, 260),
                  (17, 129, 33, 129)]


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
