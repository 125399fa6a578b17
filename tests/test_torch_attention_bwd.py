"""Port vs reference: the attention gradient, and the rules around the
backward kernel.

* ``attention_ref`` through autograd against ``jax.grad`` of the
  reference's differentiable blockwise attention
  (``repro.models.layers.flash_attention``, what the reference trains
  through), on the same numpy inputs: causal and not, softcap, G 1 and 2,
  Sq != Sk (the port's bottom-right causal alignment is the reference's
  ``q_offset = Sk - Sq``), sliding windows and chunks (Sq > Sk under a
  chunk: rows that see no key), at f32 1e-5;
* the arithmetic of the backward kernel (``csrc/flash_attention_bwd.cu``)
  written densely -- P = exp(s - lse) from the saved log-sum-exp, D =
  rowsum(dO * O), dS = P (dP - D) times the softcap's 1 - tanh^2, rows that
  see no key averaging every key, under the same masks -- against autograd,
  at f32 1e-5; and the
  plain log-sum-exp ``lse_ref`` against ``torch.logsumexp`` of the plain
  scores;
* the same arithmetic with the bf16 kernel's roundings (bf16 inputs and
  output, P and dS rounded to bf16 before the dV, dK and dQ products,
  everything else f32) against autograd through ``attention_ref`` at the
  card's bf16 bar, 2e-2 of each gradient's largest |entry|;
* the kernels' tile plan in Python (``spans``, ``seen_by``,
  ``query_tiles``, ``key_tiles``, ``tile_open``) against the mask
  ``visible`` keeps: a row's span and a key's rows are exactly its
  visible pairs; the
  query tiles of a key block and the key tiles of a query block hold every
  visible pair (and a blind row's every key), an open tile only visible
  pairs;
* on the CPU ``ops.flash_attention`` stays differentiable by autograd; a
  tensor that requires grad and does not lie on the CPU never reaches a
  kernel without a backward (decode, SSD scan, Bellman, and the flash
  wrapper called directly): each raises.

The kernel itself is held against its plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.kernels import bellman, decode_attention, ops, ssd_scan
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb

TOL = dict(rtol=1e-5, atol=1e-5)
#: (B, Sq, Sk, H, KV, D, causal, softcap, window, chunk)
CASES = [
    (2, 12, 12, 4, 2, 8, True, None, None, None),
    (1, 9, 16, 2, 2, 8, True, None, None, None),
    (2, 10, 10, 2, 1, 16, False, None, None, None),
    (1, 7, 13, 4, 2, 8, True, 5.0, None, None),
    (1, 16, 11, 2, 2, 8, False, 3.0, None, None),
    (2, 20, 20, 4, 2, 8, True, None, 5, None),
    (1, 9, 23, 2, 1, 8, True, 4.0, 7, None),
    (1, 14, 14, 4, 2, 8, False, None, 4, None),
    (2, 20, 20, 4, 2, 8, True, None, None, 6),
    (1, 11, 19, 2, 2, 8, True, 3.0, None, 8),
    # Sq > Sk under a chunk: rows that see no key, which average every key.
    # The reference's blockwise attention averages them over its padded
    # 8-key blocks, so Sk is a multiple of 8 here (the kernels and
    # attention_ref average over the Sk keys, as the reference's oracle)
    (1, 17, 8, 4, 2, 8, False, None, None, 4),  # 9 rows see no key
    (1, 21, 16, 2, 1, 8, True, None, None, 5),  # causal too: 5 rows
]


def _inputs(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D))]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap,window,chunk", CASES)
def test_attention_gradient_matches_jax_grad(B, Sq, Sk, H, KV, D, causal, cap, window,
                                             chunk):
    q, k, v, do = _inputs(Sq * Sk + H, B, Sq, Sk, H, KV, D)

    def ref(q_, k_, v_):
        out = RL.flash_attention(q_, k_, v_, causal=causal, q_offset=Sk - Sq,
                                 softcap=cap, window=window, chunk=chunk, chunk_q=8,
                                 chunk_kv=8)
        return jnp.sum(out * do)

    want = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = fb.flash_attention_bwd_ref(*(torch.as_tensor(x) for x in (q, k, v, do)),
                                     causal=causal, softcap=cap, window=window, chunk=chunk)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)


def _bf16(x):
    return x.bfloat16().float()


def _dense_kernel_arithmetic(q, k, v, out, lse, do, causal, cap, window=None, chunk=None,
                             round_pds=False):
    """The backward kernel's formulas, over whole (Sq, Sk) tiles; with
    ``round_pds`` P and dS are rounded to bf16 before their products, as
    the bf16 kernel feeds them to the tensor cores."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    kh = k.repeat_interleave(G, dim=2)  # kv head of q head h is h // G
    vh = v.repeat_interleave(G, dim=2)
    x = torch.einsum("bqhd,bkhd->bhqk", q, kh) / math.sqrt(D)
    c, dcap = x, torch.ones_like(x)
    if cap is not None:
        th = torch.tanh(x / cap)
        c, dcap = cap * th, 1 - th * th
    # each row's span [lo, hi), as the kernels read it
    lo, hi = (torch.tensor(x)[:, None] for x in zip(
        *(fb.spans(i + Sk - Sq, Sk, causal, window, chunk) for i in range(Sq))))
    kpos = torch.arange(Sk)[None, :]
    seen = (kpos >= lo) & (kpos < hi)
    blind = hi <= lo  # rows that see no key
    p = torch.where(seen, torch.exp(c - lse[..., None]), torch.zeros(()))
    p = torch.where(blind, torch.full((), 1.0 / Sk), p)
    dvec = torch.einsum("bqhd,bqhd->bhq", do, out)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vh)
    ds = torch.where(seen & ~blind, p * (dp - dvec[..., None]) * dcap, torch.zeros(()))
    if round_pds:
        p, ds = _bf16(p), _bf16(ds)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh) / math.sqrt(D)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) / math.sqrt(D)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    fold = lambda t: t.reshape(B, Sk, KV, G, D).sum(3)  # noqa: E731
    return dq, fold(dk), fold(dv)


EDGE = [(1, 12, 7, 4, 2, 8, True, None, None, None)]  # 5 rows see no key


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap,window,chunk", CASES + EDGE)
def test_backward_kernel_arithmetic_matches_autograd(B, Sq, Sk, H, KV, D, causal, cap,
                                                     window, chunk):
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(7 + Sq, B, Sq, Sk, H, KV, D))
    mask = dict(causal=causal, softcap=cap, window=window, chunk=chunk)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **mask)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    scores = fa._scores(q, k, causal, cap, window=window, chunk=chunk)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1).reshape(B, H, Sq))
    got = _dense_kernel_arithmetic(q, k, v, out, lse, do, causal, cap, window, chunk)
    want = fb.flash_attention_bwd(q, k, v, out, lse, do, **mask)
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, **TOL, msg=f"d{name}")


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap,window,chunk", CASES + EDGE)
def test_bf16_kernel_arithmetic_holds_the_bar(B, Sq, Sk, H, KV, D, causal, cap, window,
                                              chunk):
    """bf16 inputs (held in f32), the forward's output rounded to bf16, P
    and dS rounded to bf16 before their products: within 2e-2 of each
    gradient's largest |entry| of autograd through attention_ref on the
    same inputs (the bar chip_smoke.py and the card tests hold the bf16
    kernel to)."""
    q, k, v, do = (_bf16(torch.as_tensor(x)) for x in _inputs(11 + Sk, B, Sq, Sk, H, KV, D))
    mask = dict(causal=causal, softcap=cap, window=window, chunk=chunk)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **mask)
    got = _dense_kernel_arithmetic(q, k, v, _bf16(out), lse, do, causal, cap, window, chunk,
                                   round_pds=True)
    want = fb.flash_attention_bwd_ref(q, k, v, do, **mask)
    for name, g, w in zip("qkv", got, want):
        err = (g - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item(), f"d{name}: {err}"
        assert err > 0 or name == "v"  # the roundings are really there


#: (Sq, Sk, causal, window, chunk) for the tile plan: windows and chunks
#: below, at and past a tile, spans that start mid-tile, Sq > Sk (rows that
#: see no key), Sq < Sk (an append), causal off
PLAN_CASES = [(200, 200, True, None, None), (70, 130, True, None, None),
              (130, 70, True, None, None), (100, 100, False, None, None),
              (200, 200, True, 1, None), (200, 200, True, 16, None),
              (200, 200, True, 100, None), (70, 130, True, 37, None),
              (130, 70, True, 37, None), (150, 150, False, 40, None),
              (200, 200, True, None, 1), (200, 200, True, None, 16),
              (200, 200, True, None, 64), (70, 130, True, None, 50),
              (130, 70, True, None, 50), (130, 70, False, None, 33),
              (150, 150, False, None, 64), (200, 200, True, 30, 50)]


@pytest.mark.parametrize("Sq,Sk,causal,window,chunk", PLAN_CASES)
def test_tile_plan_holds_every_visible_pair(Sq, Sk, causal, window, chunk):
    """The kernels' tile plan against the mask: a row's span is its visible
    keys; a dK / dV block's query tiles (64 rows; key blocks of 64 bf16, 32
    f32) hold every row that sees one of its keys and every blind row; a dQ
    block's key tiles hold its rows' visible keys; an open tile holds only
    visible pairs of real rows and keys."""
    keep = fa.visible(torch.arange(Sq) + (Sk - Sq), torch.arange(Sk), causal=causal,
                      window=window, chunk=chunk)
    blind = ~keep.any(1)
    for i in range(Sq):
        lo, hi = fb.spans(i + Sk - Sq, Sk, causal, window, chunk)
        assert bool(blind[i]) == (hi <= lo)
        if hi > lo:
            assert torch.equal(keep[i], (torch.arange(Sk) >= lo) & (torch.arange(Sk) < hi))
    pos = torch.arange(Sq) + (Sk - Sq)
    for j in range(Sk):  # the rows that see key j, as the bf16 dK / dV kernel tests them
        first, last = fb.seen_by(j, causal, window, chunk)
        assert torch.equal(keep[:, j], (pos >= first) & (pos <= last))
    mask = dict(causal=causal, window=window, chunk=chunk)
    T = fb.TILE
    for nk in (T, fb.F_KT):
        for k0 in range(0, Sk, nk):
            tiles = fb.query_tiles(k0, nk, Sq, Sk, **mask)
            assert tiles == sorted(set(tiles))
            rows = torch.zeros(Sq, dtype=torch.bool)
            for t in tiles:
                rows[t * T:(t + 1) * T] = True
            need = keep[:, k0:k0 + nk].any(1) | blind
            assert not (need & ~rows).any(), (k0, nk, tiles)
    for kt in (T, fb.F_KT):
        for q0 in range(0, Sq, T):
            q_last = min(q0 + T, Sq) - 1
            begin, end = fb.key_tiles(q0, q_last, Sq, Sk, tile=kt, **mask)
            cols = torch.zeros(Sk, dtype=torch.bool)
            cols[begin * kt:end * kt] = True
            assert not (keep[q0:q_last + 1] & ~cols).any(), (q0, begin, end)
            assert begin <= end
    for q0 in range(0, Sq, T):
        for k0 in range(0, Sk + T, fb.F_KT):
            if fb.tile_open(q0, T, k0, fb.F_KT, Sq, Sk, **mask):
                assert q0 + T <= Sq and k0 + fb.F_KT <= Sk
                assert keep[q0:q0 + T, k0:k0 + fb.F_KT].all()


def test_tile_plan_walks_only_the_span():
    """Gemma2-9B's local layer at 6144 rows under its 4096 window: a dQ block
    walks at most 4096 + 64 keys, and a dK / dV block only the query tiles
    within the window of its keys."""
    Sq = Sk = 6144
    for q0 in range(0, Sq, fb.TILE):
        begin, end = fb.key_tiles(q0, q0 + fb.TILE - 1, Sq, Sk, True, window=4096)
        assert (end - begin) * fb.TILE <= 4096 + fb.TILE
    tiles = fb.query_tiles(0, fb.TILE, Sq, Sk, True, window=4096)
    assert tiles == list(range(0, 4096 // fb.TILE + 1))
    # Llama-4's chunks of 8192 at 9216 rows: the last chunk's key tiles see
    # only the last chunk's query tiles
    assert fb.query_tiles(8192, fb.TILE, 9216, 9216, True, chunk=8192) == list(
        range(8192 // fb.TILE, 9216 // fb.TILE))


def test_masked_grad_under_ops_is_the_plain_gradient():
    """On the CPU a masked ``ops.flash_attention`` under grad is autograd
    through the plain version (no launch)."""
    q, k, v, do = (torch.as_tensor(x).requires_grad_(i < 3)
                   for i, x in enumerate(_inputs(5, 1, 20, 20, 4, 2, 8)))
    for mask in (dict(window=5), dict(chunk=6)):
        out = ops.flash_attention(q, k, v, causal=True, device="cpu", **mask)
        grads = torch.autograd.grad(out, (q, k, v), do)
        want = fb.flash_attention_bwd_ref(q, k, v, do, causal=True, **mask)
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w)
    assert fa.flash_attention.launches == 0 and fb.flash_attention_bwd.launches == 0


def test_ops_flash_attention_is_differentiable_on_the_cpu():
    q, k, v, do = (torch.as_tensor(x).requires_grad_(i < 3)
                   for i, x in enumerate(_inputs(3, 2, 8, 8, 4, 2, 8)))
    out = ops.flash_attention(q, k, v, causal=True, device="cpu")
    grads = torch.autograd.grad(out, (q, k, v), do)
    want = fb.flash_attention_bwd_ref(q, k, v, do, causal=True)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w)
    assert fa.flash_attention.launches == 0 and fb.flash_attention_bwd.launches == 0


def _meta(*shape, dtype=torch.float32, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


@pytest.mark.parametrize("wrapper", ["flash", "decode", "ssd", "bellman", "bellman_batched"])
def test_kernels_without_a_backward_refuse_tensors_that_require_grad(wrapper):
    """A meta tensor stands in for a card's: the refusal comes before any
    launch, and nothing is counted."""
    calls = {
        "flash": lambda: fa.flash_attention(_meta(1, 4, 2, 16), _meta(1, 4, 1, 16),
                                            _meta(1, 4, 1, 16)),
        "decode": lambda: decode_attention.decode_attention(
            _meta(1, 2, 16), _meta(1, 4, 1, 16), _meta(1, 4, 1, 16),
            torch.empty(1, dtype=torch.int32, device="meta")),
        "ssd": lambda: ssd_scan.ssd_scan(
            _meta(1, 3, 2, 4), _meta(1, 3, 5), _meta(1, 3, 5), _meta(1, 3, 2),
            _meta(1, 3, 2), None),
        "bellman": lambda: bellman.bellman_banded(_meta(9), _meta(3, 5), _meta(5, 3),
                                                  _meta()),
        "bellman_batched": lambda: bellman.bellman_banded_batched(
            _meta(2, 9), _meta(2, 3, 5), _meta(2, 5, 3), _meta(2)),
    }
    with pytest.raises(RuntimeError, match="requires grad"):
        calls[wrapper]()
    with torch.no_grad():  # without grad mode the same call reaches the device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            calls[wrapper]()
    assert all(w.launches == 0 for w in (fa.flash_attention, decode_attention.decode_attention,
                                         ssd_scan.ssd_scan, bellman.bellman_banded))
