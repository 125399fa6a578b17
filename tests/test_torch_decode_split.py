"""The split-K decode algorithm, held on the CPU.

The card's decode kernel splits the key axis into chunks, keeps a partial
(m, l, acc) per chunk and combines them.  ``decode_attention_split_ref``
repeats that arithmetic in plain PyTorch; here it is held against the
plain version ``decode_attention_ref`` and against the reference's Pallas
kernel (interpret mode, as tests/test_torch_attention.py runs it) on the
same numpy inputs, for several split counts, at ragged lengths that
include 0 (every key masked: a uniform average) and S, with and without a
softcap.  f32 at 2e-5 (tests/test_kernels.py's attention tolerance; sums
in another order), which also checks that an empty split puts no NaN into
the result.  ``_split_plan`` is held to its contract: chunks that cover
[0, S) once, each at least MIN_CHUNK keys unless it is the only one,
planned from shapes alone.  The wrappers' read checks, which refuse
(rather than copy) inputs the kernels cannot read in place, are held on
CPU tensors: they need no card; so is ``_build.function``, which binds a
kernel's C entry point with its ctypes signature once, not on every call.
"""
import ctypes
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa

S = 200  # block_k=256 below: the reference pads nothing, so length 0 averages S keys
LENGTHS = [0, 1, 37, 64, 65, 150, S, 5]
SPLITS = [1, 2, 5, 9]
CAPS = [None, 30.0]


def _inputs(seed, B=len(LENGTHS), H=8, KV=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    return q, k, v, np.array(LENGTHS[:B], np.int32)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("n_split", SPLITS)
def test_split_ref_matches_plain_version(n_split, cap):
    q, k, v, lens = (torch.as_tensor(x) for x in _inputs(n_split))
    got = tda.decode_attention_split_ref(q, k, v, lens, n_split, softcap=cap)
    want = tda.decode_attention_ref(q, k, v, lens, softcap=cap)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("n_split", SPLITS)
def test_split_ref_matches_reference_kernel(n_split, cap):
    q, k, v, lens = _inputs(10 + n_split)
    want = np.asarray(rops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(lens), softcap=cap, block_k=256))
    got = tda.decode_attention_split_ref(*(torch.as_tensor(x) for x in (q, k, v, lens)),
                                         n_split, softcap=cap)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_empty_splits_and_masked_rows():
    """A length inside the first split leaves every later split empty; a
    length of 0 gives the uniform average of all S values, as the plain
    version's softmax over -1e30 scores does."""
    q, k, v, _ = (torch.as_tensor(x) for x in _inputs(3, B=2))
    lens = torch.tensor([0, 3])
    got = tda.decode_attention_split_ref(q, k, v, lens, 9)
    assert torch.isfinite(got).all()
    G = q.shape[1] // k.shape[2]
    uniform = v[0].mean(0).repeat_interleave(G, dim=0)  # (H, D)
    torch.testing.assert_close(got[0], uniform, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(got, tda.decode_attention_ref(q, k, v, lens),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_split", [1, 5])
def test_split_ref_rounds_p_as_the_kernel_does(n_split):
    """p is rounded to v's dtype before P.V, per split, as the kernel does:
    with f32 scores and bf16 values, the split reference equals the same
    sums taken over bf16-rounded p at 1e-6, and differs from the sums over
    unrounded p by far more.  All-bf16 caches agree with the plain version
    at bf16's 2e-2."""
    q, k, v, lens = _inputs(4)
    q, k, lens = torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(lens)
    v = torch.as_tensor(v).bfloat16()
    got = tda.decode_attention_split_ref(q, k, v, lens, n_split)
    assert got.dtype == torch.float32  # q's dtype

    B, H, D = q.shape
    KV = k.shape[2]
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KV, H // KV, D), k) / D ** 0.5
    s = s.masked_fill(~(torch.arange(S)[None, :] < lens[:, None])[:, None, None, :], -1e30)

    def split_sums(rounded):
        num, den, mb = 0.0, 0.0, None
        parts = []
        for c0, c1 in tda.split_bounds(S, n_split):
            keys = torch.arange(S)
            keep = (keys >= c0) & (keys < c1) & ((keys[None, :] < lens[:, None])
                                                 | (lens[:, None] <= 0))
            x = s.masked_fill(~keep[:, None, None, :], -float("inf"))
            m = x.amax(-1).nan_to_num(neginf=0.0)
            p = torch.exp(x - m[..., None])
            pv = p.bfloat16().float() if rounded else p
            parts.append((m, keep.any(-1)[:, None, None], p.sum(-1),
                          torch.einsum("bkgs,bskd->bkgd", pv, v.float())))
        mb = torch.stack([torch.where(e, m, -float("inf")) for m, e, _, _ in parts]).amax(0)
        for m, e, l, acc in parts:
            w = torch.where(e, torch.exp(m - mb), torch.zeros_like(m))
            num = num + w[..., None] * acc
            den = den + w * l
        return (num / den[..., None]).reshape(B, H, D)

    torch.testing.assert_close(got, split_sums(True), atol=1e-6, rtol=1e-6)
    assert (got - split_sums(False)).abs().max() > 1e-4

    qb, kb = q.bfloat16(), k.bfloat16()
    got = tda.decode_attention_split_ref(qb, kb, v, lens, n_split)
    assert got.dtype == torch.bfloat16
    want = tda.decode_attention_ref(qb, kb, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,S_,KV", [(1, 144, 8), (8, 144, 8), (17, 144, 8), (1, 4096, 8),
                                     (8, 4096, 8), (4, 300, 2), (2, 31, 1), (1, 64, 1)])
@pytest.mark.parametrize("n_sm", [132, 114, 8])
def test_split_plan_covers_the_cache(B, S_, KV, n_sm):
    n = tda._split_plan(B, S_, KV, n_sm)
    assert 1 <= n <= tda.MAX_SPLITS
    bounds = tda.split_bounds(S_, n)
    assert bounds[0][0] == 0 and bounds[-1][1] == S_
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # once, in order
    sizes = [hi - lo for lo, hi in bounds]
    assert n == 1 or min(sizes) >= tda.MIN_CHUNK >= 32
    if B * KV >= n_sm:
        assert n == 1  # enough blocks without splitting


def test_split_plan_never_needs_lengths():
    assert list(inspect.signature(tda._split_plan).parameters) == ["B", "S", "KV", "n_sm"]
    # the serving path's shapes on a 132-SM card: enough splits for a block
    # per SM (ceil(132 / 64) = 3 at b = 8), as long as a split keeps
    # MIN_CHUNK keys (144 // 48 = 3 at b = 1)
    assert tda._split_plan(8, 144, 8, 132) == 3
    assert tda._split_plan(1, 144, 8, 132) == 3
    assert tda._split_plan(1, 4096, 8, 132) == tda.MAX_SPLITS


@pytest.mark.parametrize("shape,strides,offset,ok", [
    ((2, 4, 2, 16), None, 0, True),          # contiguous bf16
    ((2, 4, 2, 16), None, 1, False),         # 2 bytes off
    ((2, 4, 2, 16), (224, 56, 16, 1), 0, True),   # fused-qkv-like view, aligned
    ((2, 4, 2, 16), (228, 57, 16, 1), 0, False),  # a sequence stride of 57 elements
    ((1, 4, 2, 16), (3, 32, 16, 1), 0, True),     # a size-1 axis's stride is free
])
def test_aligned16(shape, strides, offset, ok):
    base = torch.zeros(2048, dtype=torch.bfloat16)
    if strides is None:
        strides = torch.empty(shape).stride()
    assert base.data_ptr() % 16 == 0  # torch's CPU allocator aligns to 64 bytes
    assert tfa.aligned16(base.as_strided(shape, strides, offset)) is ok


def _fused_qkv(B=2, S=8, H=4, KV=2, D=16, dtype=torch.bfloat16, offset=0):
    """q, k, v as views of one fused qkv projection, as models/layers.py makes
    them; ``offset`` elements into a larger buffer."""
    n = B * S * (H + 2 * KV) * D
    qkv = torch.zeros(n + offset, dtype=dtype)[offset:].view(B, S, (H + 2 * KV) * D)
    q, k, v = torch.split(qkv, [H * D, KV * D, KV * D], dim=-1)
    return q.reshape(B, S, H, D), k.reshape(B, S, KV, D), v.reshape(B, S, KV, D)


def test_flash_reads_fused_qkv_views_in_place():
    q, k, v = _fused_qkv()
    assert not q.is_contiguous() and v.stride(1) == (4 + 2 * 2) * 16
    tfa.check_readable(q, k, v)  # aligned views: no error, and nothing copied


@pytest.mark.parametrize("dtype,ok", [(torch.bfloat16, False), (torch.float32, True)])
def test_flash_refuses_misaligned_bf16(dtype, ok):
    """A view 1 element off is refused in bf16 (16-byte row copies); the f32
    kernel reads element by element and takes it."""
    q, k, v = _fused_qkv(dtype=dtype, offset=1)
    if ok:
        tfa.check_readable(q, k, v)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            tfa.check_readable(q, k, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_refuses_a_strided_last_axis(dtype):
    q, k, v = _fused_qkv(dtype=dtype)
    with pytest.raises(ValueError, match="last axis"):
        tfa.check_readable(q.transpose(2, 3), k, v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["q", "k_cache", "v_cache"])
def test_decode_refuses_misaligned_inputs(which, dtype):
    """q and both caches are read in 16-byte pieces in either dtype: one
    element off raises, naming the input; nothing is copied (q neither)."""
    B, S, H, KV, D = 2, 12, 4, 2, 16
    cache = torch.zeros((2, 3, B, S, KV, D), dtype=dtype)  # (kind, L, B, S, KV, D)
    args = {"q": torch.zeros((B, H, D), dtype=dtype), "k_cache": cache[0, 1],
            "v_cache": cache[1, 2]}
    tda.check_readable(*args.values())  # one layer's slices: aligned
    args[which] = torch.zeros(args[which].numel() + 1, dtype=dtype)[1:].view(
        args[which].shape)
    with pytest.raises(ValueError, match=f"16-byte.*{which}|{which}.*16-byte"):
        tda.check_readable(*args.values())


def test_function_binds_its_signature_once(monkeypatch):
    """The first call looks the symbol up and sets restype / argtypes; later
    calls return the same bound function without touching the library."""
    class Lib:
        def __init__(self):
            self.lookups = 0

        def __getattr__(self, name):
            self.lookups += 1
            return type("Fn", (), {})()

    lib = Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "_fns", {})
    args = [ctypes.c_void_p, ctypes.c_int]
    fn = _build.function("decode_attention", "decode_attention_launch", ctypes.c_int, args)
    assert fn.restype is ctypes.c_int and fn.argtypes == args
    assert _build.function("decode_attention", "decode_attention_launch",
                           ctypes.c_int, args) is fn
    assert lib.lookups == 1
