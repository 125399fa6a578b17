"""Port vs reference: the banded Bellman backup and its kernel wrappers.

The same numpy inputs (from a seed) go through the reference Pallas kernel
(interpret mode on the CPU) and through the port's plain version and its
CPU dispatch, at the reference test shapes and tolerances (atol 1e-4,
rtol 1e-5: f32 sums in another order).  The spec-batched form is in
test_torch_bellman_batched.py; the CUDA kernel itself is held against its
plain version in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from repro.kernels.bellman import bellman_banded
from repro_torch.kernels import bellman as tb
from repro_torch.kernels import ops

SHAPES = [(64, 9, 40), (200, 33, 170), (128, 33, 128), (300, 17, 513)]


def inputs(seed, T, A, K, n=None):
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    h = (rng.normal(size=lead + (T + K,)) * 10).astype(np.float32)
    logits = rng.normal(size=lead + (A, K))
    pmfs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    tails = rng.uniform(size=lead + (T, A)).astype(np.float32)
    hso = (rng.normal(size=lead) * 3).astype(np.float32) if n else np.float32(2.5)
    return h, pmfs, tails, hso


def _t(x):
    return torch.as_tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("T,A,K", SHAPES)
def test_scalar_matches_reference_kernel(T, A, K):
    h, pmfs, tails, hso = inputs(T * A, T, A, K)
    want = np.asarray(bellman_banded(h, pmfs, tails, float(hso)))
    plain = tb.bellman_banded_ref(_t(h), _t(pmfs), _t(tails), _t(hso))
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-4, rtol=1e-5)
    got = ops.bellman_backup(h, pmfs, tails, hso, device="cpu")
    assert got.shape == (T, A) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_wrappers_check_their_inputs():
    h, pmfs, tails, hso = (_t(x) for x in inputs(0, 16, 5, 8))
    with pytest.raises(TypeError, match="float32"):
        tb.bellman_banded(h.double(), pmfs, tails, hso)
    with pytest.raises(ValueError, match="T \\+ K - 1"):
        tb.bellman_banded(h[:10], pmfs, tails, hso)
    with pytest.raises(ValueError, match="pmfs"):
        tb.bellman_banded(h, pmfs[:3], tails, hso)
    with pytest.raises(ValueError, match="spec axis"):
        tb.bellman_banded_batched(h[None], pmfs[None], tails[None], hso.reshape(1).repeat(2))


def test_short_h_main_is_enough():
    """h_main needs only T + K - 1 entries (the last window's end)."""
    h, pmfs, tails, hso = inputs(1, 20, 4, 9)
    full = ops.bellman_backup(h, pmfs, tails, hso, device="cpu")
    short = ops.bellman_backup(h[: 20 + 9 - 1], pmfs, tails, hso, device="cpu")
    assert torch.equal(full, short)
