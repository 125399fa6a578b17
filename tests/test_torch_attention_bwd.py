"""Port vs reference: the attention gradient, and the rules around the
backward kernel.

* ``attention_ref`` through autograd against ``jax.grad`` of the
  reference's differentiable blockwise attention
  (``repro.models.layers.flash_attention``, what the reference trains
  through), on the same numpy inputs: causal and not, softcap, G 1 and 2,
  Sq != Sk (the port's bottom-right causal alignment is the reference's
  ``q_offset = Sk - Sq``), at f32 1e-5;
* the arithmetic of the backward kernel (``csrc/flash_attention_bwd.cu``)
  written densely -- P = exp(s - lse) from the saved log-sum-exp, D =
  rowsum(dO * O), dS = P (dP - D) times the softcap's 1 - tanh^2, rows that
  see no key averaging every key -- against autograd, at f32 1e-5; and the
  plain log-sum-exp ``lse_ref`` against ``torch.logsumexp`` of the plain
  scores;
* the same arithmetic with the bf16 kernel's roundings (bf16 inputs and
  output, P and dS rounded to bf16 before the dV, dK and dQ products,
  everything else f32) against autograd through ``attention_ref`` at the
  card's bf16 bar, 2e-2 of each gradient's largest |entry|;
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
#: (B, Sq, Sk, H, KV, D, causal, softcap)
CASES = [
    (2, 12, 12, 4, 2, 8, True, None),
    (1, 9, 16, 2, 2, 8, True, None),
    (2, 10, 10, 2, 1, 16, False, None),
    (1, 7, 13, 4, 2, 8, True, 5.0),
    (1, 16, 11, 2, 2, 8, False, 3.0),
]


def _inputs(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D))]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap", CASES)
def test_attention_gradient_matches_jax_grad(B, Sq, Sk, H, KV, D, causal, cap):
    q, k, v, do = _inputs(Sq * Sk + H, B, Sq, Sk, H, KV, D)

    def ref(q_, k_, v_):
        out = RL.flash_attention(q_, k_, v_, causal=causal, q_offset=Sk - Sq,
                                 softcap=cap, chunk_q=8, chunk_kv=8)
        return jnp.sum(out * do)

    want = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = fb.flash_attention_bwd_ref(*(torch.as_tensor(x) for x in (q, k, v, do)),
                                     causal=causal, softcap=cap)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)


def _bf16(x):
    return x.bfloat16().float()


def _dense_kernel_arithmetic(q, k, v, out, lse, do, causal, cap, round_pds=False):
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
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    seen = (kpos <= qpos + Sk - Sq) if causal else torch.ones(Sq, Sk, dtype=torch.bool)
    blind = ~seen.any(-1, keepdim=True)  # rows that see no key
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


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap",
                         CASES + [(1, 12, 7, 4, 2, 8, True, None)])  # 5 rows see no key
def test_backward_kernel_arithmetic_matches_autograd(B, Sq, Sk, H, KV, D, causal, cap):
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(7 + Sq, B, Sq, Sk, H, KV, D))
    out, lse = fa.flash_attention(q, k, v, causal=causal, softcap=cap, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    scores = fa._scores(q, k, causal, cap)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1).reshape(B, H, Sq))
    got = _dense_kernel_arithmetic(q, k, v, out, lse, do, causal, cap)
    want = fb.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, softcap=cap)
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, **TOL, msg=f"d{name}")


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap",
                         CASES + [(1, 12, 7, 4, 2, 8, True, None)])
def test_bf16_kernel_arithmetic_holds_the_bar(B, Sq, Sk, H, KV, D, causal, cap):
    """bf16 inputs (held in f32), the forward's output rounded to bf16, P
    and dS rounded to bf16 before their products: within 2e-2 of each
    gradient's largest |entry| of autograd through attention_ref on the
    same inputs (the bar chip_smoke.py and the card tests hold the bf16
    kernel to)."""
    q, k, v, do = (_bf16(torch.as_tensor(x)) for x in _inputs(11 + Sk, B, Sq, Sk, H, KV, D))
    out, lse = fa.flash_attention(q, k, v, causal=causal, softcap=cap, return_lse=True)
    got = _dense_kernel_arithmetic(q, k, v, _bf16(out), lse, do, causal, cap, round_pds=True)
    want = fb.flash_attention_bwd_ref(q, k, v, do, causal=causal, softcap=cap)
    for name, g, w in zip("qkv", got, want):
        err = (g - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item(), f"d{name}: {err}"
        assert err > 0 or name == "v"  # the roundings are really there


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
