"""Port vs reference: the banded Bellman backup and its kernel wrappers.

The same numpy inputs (from a seed) go through the reference Pallas kernel
(interpret mode on the CPU) and through the port's plain version and its
CPU dispatch, at the reference test shapes and tolerances (atol 1e-4,
rtol 1e-5: f32 sums in another order), and so does the plain mirror of
the kernel's k split, at every split; the split plan and partition are
checked here too.  The spec-batched form is in
test_torch_bellman_batched.py; the CUDA kernel itself is held against its
plain version in test_torch_cuda.py.
"""
import re
from pathlib import Path

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


# ---------------------------------------------------------------------------
# The kernel's k split: the plan, the partition, and its plain mirror
# ---------------------------------------------------------------------------

#: (N, T, A, K) -> the split on a 132-SM card.  The Table-I path (129 x 33 x
#: 129) and the LLM path's solve (65 x 9 x 65) split; the bank (108 specs)
#: fills the card unsplit.  At 4097 x 33 x 4097 an unsplit grid is 26
#: blocks of 160 base states (286 warps on 132 SMs), so the plan splits 4
#: ways there (0.079 ms on an H100 against 0.223 ms unsplit: the design-time
#: split scan in PERF.md).
PLANS = [((1, 129, 33, 129), 32), ((1, 65, 9, 65), 16), ((1, 4097, 33, 4097), 4),
         ((108, 129, 33, 66), 1), ((17, 129, 33, 56), 8), ((17, 129, 33, 129), 8),
         ((1, 109, 33, 66), 16), ((3, 33, 33, 33), 8)]


@pytest.mark.parametrize("shape,want", PLANS)
def test_split_plan(shape, want):
    """The split from the shapes and the SM count alone: the fewest k slices
    that put WARPS_PER_SM warps on every SM, while a slice keeps
    MIN_SLICE steps of the first chunk."""
    N, T, A, K = shape
    split = tb._split_plan(N, T, A, K, 132)
    assert split == want
    assert split in tb.SPLITS
    if split > 1:
        assert -(-tb.chunk_width(K) // split) >= tb.MIN_SLICE
        assert tb.grid_warps(N, T, A, split // 2) < tb.WARPS_PER_SM * 132
    nxt = split * 2
    assert (tb.grid_warps(N, T, A, split) >= tb.WARPS_PER_SM * 132 or nxt > 32
            or -(-tb.chunk_width(K) // nxt) < tb.MIN_SLICE)
    # a card with fewer SMs never splits more
    assert tb._split_plan(N, T, A, K, 66) <= split


@pytest.mark.parametrize("K", [1, 2, 5, 55, 56, 65, 66, 129, 255, 256, 257, 513, 4097])
@pytest.mark.parametrize("split", [1, 2, 4, 8, 16, 32])
def test_split_slices_cover_k_once(K, split):
    """Every k lies in exactly one slice, in chunks of at most KC, and a
    slice's start in a chunk is s * L with L odd (the banks of the pmf
    reads)."""
    seen = np.zeros(K, dtype=int)
    for s, ranges in enumerate(tb.split_slices(K, split)):
        for k0, k1 in ranges:
            assert 0 <= k0 < k1 <= K
            c0 = (k0 // tb.KC) * tb.KC
            assert k1 <= c0 + tb.KC
            w = min(tb.KC, K - c0)
            L = -(-w // split) | 1
            assert k0 - c0 == s * L
            seen[k0:k1] += 1
    assert (seen == 1).all()


#: the kernel's source, whose tile constants and launch geometry the plan,
#: split_slices and the plain mirror repeat in Python
BELLMAN_CU = Path(tb.__file__).with_name("csrc") / "bellman.cu"


def _cu_constants():
    text = BELLMAN_CU.read_text()
    return {m[0]: m[1] for m in re.findall(r"constexpr int (\w+) = ([^;]+);", text)}, text


@pytest.mark.parametrize("name", ["RT", "RA", "KC", "A_TILE"])
def test_tile_constants_match_the_kernel_source(name):
    """The Python copies of the kernel's tile constants equal bellman.cu's."""
    consts, _ = _cu_constants()
    expr = consts[name]
    for other, value in consts.items():  # A_TILE = RA * MAX_WARPS
        expr = re.sub(rf"\b{other}\b", f"({value})", expr)
    assert re.fullmatch(r"[\d\s()*+]+", expr), expr
    assert eval(expr) == getattr(tb, name)


#: each line of bellman.cu's geometry that a Python function here repeats,
#: beside that function's form of it
GEOMETRY_LINES = [
    ("g.tb = (32 >> sw_log2) * RT;", "grid_warps: t_tile = (32 // split) * RT"),
    ("g.kc = K < KC ? (K > 0 ? K : 1) : KC;", "chunk_width: max(1, min(K, KC))"),
    ("const int warps = ((A < A_TILE ? A : A_TILE) + RA - 1) / RA;",
     "grid_warps: -(-min(A, A_TILE) // RA)"),
    ("g.grid_x = (T + g.tb - 1) / g.tb;", "grid_warps: -(-T // t_tile)"),
    ("const int L = ((w + sw - 1) >> sw_log2) | 1;", "split_slices: -(-w // split) | 1"),
    ("for (int l = 0; l <= 5; ++l)", "SPLITS: 1, 2, ..., 32"),
]


@pytest.mark.parametrize("line,mirror", GEOMETRY_LINES,
                         ids=[m.split(":")[0] + str(i) for i, (_, m) in enumerate(GEOMETRY_LINES)])
def test_geometry_lines_match_the_kernel_source(line, mirror):
    """bellman.cu still computes its launch geometry as the Python plan and
    mirror assume: a change to one side must change the other."""
    _, text = _cu_constants()
    assert line in " ".join(text.split()), f"bellman.cu no longer has {line!r} ({mirror})"
    assert tb.SPLITS == tuple(1 << s for s in range(6))


#: the reference test shapes, then the Table-I path's and the LLM path's
SPLIT_SHAPES = SHAPES + [(129, 33, 129), (65, 9, 65)]


@pytest.fixture(scope="module")
def reference_kernel_outputs():
    """The reference Pallas kernel (interpret mode) per shape, computed once."""
    out = {}
    for T, A, K in SPLIT_SHAPES:
        h, pmfs, tails, hso = inputs(T * A + K, T, A, K)
        out[T, A, K] = ((h, pmfs, tails, hso),
                        np.asarray(bellman_banded(h, pmfs, tails, float(hso))))
    return out


@pytest.mark.parametrize("split", [1, 2, 32, "plan"])
@pytest.mark.parametrize("T,A,K", SPLIT_SHAPES)
def test_split_ref_matches_reference_kernel(reference_kernel_outputs, T, A, K, split):
    """The plain mirror of the kernel's partition and reduction order against
    the JAX kernel, at the reference bar (atol 1e-4, rtol 1e-5)."""
    (h, pmfs, tails, hso), want = reference_kernel_outputs[T, A, K]
    if split == "plan":
        split = tb._split_plan(1, T, A, K, 132)
    got = tb.bellman_banded_split_ref(_t(h), _t(pmfs), _t(tails), _t(hso), split)
    assert got.shape == (T, A) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
