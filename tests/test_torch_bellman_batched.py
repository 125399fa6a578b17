"""Port vs reference: the spec-batched Bellman backup.

The reference batched Pallas kernel (interpret mode) and the port's CPU
dispatch on the same numpy inputs, at the reference batched test shapes:
atol 1e-4 / rtol 1e-5 against the reference, 1e-5 / 1e-6 against the
port's own per-spec scalar backups; the plain mirror of the kernel's k
split against the reference's oracle spec by spec.  The CUDA kernel is
held against its plain version in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bellman import bellman_banded_batched
from repro.kernels.ref import bellman_banded_ref
from repro_torch.kernels import bellman as tb
from repro_torch.kernels import ops

BATCHED_SHAPES = [(1, 64, 9, 40), (3, 130, 33, 130), (4, 128, 17, 260)]


def inputs(seed, N, T, A, K):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(N, T + K)) * 10).astype(np.float32)
    logits = rng.normal(size=(N, A, K))
    pmfs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    tails = rng.uniform(size=(N, T, A)).astype(np.float32)
    hso = (rng.normal(size=N) * 3).astype(np.float32)
    return h, pmfs, tails, hso


@pytest.mark.parametrize("N,T,A,K", BATCHED_SHAPES)
def test_batched_matches_reference_kernel(N, T, A, K):
    h, pmfs, tails, hso = inputs(N * T + K, N, T, A, K)
    want = np.asarray(bellman_banded_batched(h, pmfs, tails, hso))
    got = ops.bellman_backup_batched(h, pmfs, tails, hso, device="cpu")
    assert got.shape == (N, T, A)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    for n in range(N):
        scalar = ops.bellman_backup(h[n], pmfs[n], tails[n], hso[n], device="cpu")
        np.testing.assert_allclose(got[n].numpy(), scalar.numpy(), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("split", [1, 8, "plan"])
@pytest.mark.parametrize("N,T,A,K", [(3, 33, 33, 33), (1, 109, 33, 66)])
def test_batched_split_ref_matches_reference_spec_by_spec(N, T, A, K, split):
    """The batched plain mirror of the kernel's split against the reference's
    oracle (repro.kernels.ref.bellman_banded_ref) applied spec by spec, at
    the sweep's small shapes (atol 1e-4, rtol 1e-5)."""
    h, pmfs, tails, hso = inputs(N * T + A, N, T, A, K)
    if split == "plan":
        split = tb._split_plan(N, T, A, K, 132)
    got = tb.bellman_banded_split_ref(*(torch.as_tensor(x) for x in (h, pmfs, tails, hso)),
                                      split)
    assert got.shape == (N, T, A)
    for n in range(N):
        want = np.asarray(bellman_banded_ref(jnp.asarray(h[n]), jnp.asarray(pmfs[n]),
                                             jnp.asarray(tails[n]), jnp.asarray(hso[n])))
        np.testing.assert_allclose(got[n].numpy(), want, atol=1e-4, rtol=1e-5)
