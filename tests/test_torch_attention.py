"""Port vs reference: the two attention kernels' plain versions and the
model's routing to them.

The same numpy inputs (from a seed) go through the reference's Pallas
kernels (interpret mode on the CPU, as tests/test_kernels.py runs them) and
through the port's wrappers, which run their plain versions on CPU tensors.
Shapes, dtypes and tolerances are tests/test_kernels.py's: 2e-5 for f32
(sums in another order), 2e-2 for bf16 (the Pallas kernels round p to bf16
before P.V, the plain versions keep it f32).  The routing tests hold the
port's prefill / decode attention against the reference's blockwise
attention with ``q_offset`` / ``kv_len`` set as its ``attention`` sets them.
The CUDA kernels themselves are held against the plain versions in
test_torch_cuda.py.
"""
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.kernels import ops as rops
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.interop import params_from_reference
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import layers as PL

FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 16, True, None),
    (1, 33, 70, 4, 4, 8, False, None),
    (2, 128, 128, 8, 2, 32, True, 50.0),
    (1, 17, 128, 2, 1, 64, True, None),
]
DECODE_SHAPES = [(2, 300, 8, 2, 16), (3, 128, 4, 4, 32), (1, 77, 8, 1, 64),
                 (4, 64, 16, 4, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def both(x, name="float32"):
    """The same values in both frameworks (bf16 rounds f32 to nearest even
    in both)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,cap", FLASH_SHAPES)
def test_flash_plain_matches_reference_kernel(B, Sq, Sk, H, KV, D, causal, cap):
    rng = np.random.default_rng(Sq * Sk + H)
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(rng, s)) for s in
                                    ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    want = np.asarray(rops.flash_attention(jq, jk, jv, causal=causal, softcap=cap,
                                           block_q=32, block_k=32))
    got = tfa.flash_attention(tq, tk, tv, causal=causal, softcap=cap,
                              block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), want, **tol("float32"))
    via_ops = ops.flash_attention(tq, tk, tv, causal=causal, softcap=cap, device="cpu")
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_flash_dtypes(name):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(rng, s), name) for s in
                                    ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    want = rops.flash_attention(jq, jk, jv, block_q=32, block_k=32)
    got = ops.flash_attention(tq, tk, tv, block_q=32, block_k=32, device="cpu")
    assert got.dtype == DTYPES[name][1]
    np.testing.assert_allclose(f32(got), f32(want), **tol(name))


@pytest.mark.parametrize("B,S,H,KV,D", DECODE_SHAPES)
def test_decode_plain_matches_reference_kernel(B, S, H, KV, D):
    rng = np.random.default_rng(B * S)
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(rng, s)) for s in
                                    ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    want = np.asarray(rops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=64))
    got = tda.decode_attention(tq, tk, tv, torch.as_tensor(lens), block_k=64)
    np.testing.assert_allclose(got.numpy(), want, **tol("float32"))
    via_ops = ops.decode_attention(tq, tk, tv, lens, device="cpu")
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_decode_dtypes(name):
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (both(normal(rng, s), name) for s in
                                    ((2, 8, 32), (2, 160, 2, 32), (2, 160, 2, 32)))
    lens = np.array([100, 160], np.int32)
    want = rops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=64)
    got = ops.decode_attention(tq, tk, tv, lens, device="cpu")
    assert got.dtype == DTYPES[name][1]
    np.testing.assert_allclose(f32(got), f32(want), **tol(name))


# --- the model's routing: prefill -> flash, one-token decode -> decode ------


@pytest.mark.parametrize("S,cap", [(24, None), (7, 30.0)])
def test_fresh_prefill_equals_blockwise_over_the_cache(S, cap):
    """A fresh-cache prefill is causal attention over the segment's own
    k, v: the reference attends over the buffer with q_offset=0, kv_len=S."""
    B, H, KV, D, cap_len = 2, 8, 2, 16, 40
    rng = np.random.default_rng(S)
    q, k, v = (normal(rng, s) for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    kbuf = np.zeros((B, cap_len, KV, D), np.float32)
    vbuf = np.zeros_like(kbuf)
    kbuf[:, :S], vbuf[:, :S] = k, v
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(kbuf), jnp.asarray(vbuf),
                              causal=True, q_offset=0, kv_len=S, softcap=cap,
                              chunk_kv=16, chunk_q=16)
    got = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                              causal=True, softcap=cap, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("length,cap", [(1, None), (29, None), (63, 50.0)])
def test_one_token_decode_equals_blockwise_over_the_cache(length, cap):
    """A one-token decode at position ``length`` is decode attention with
    lengths = length + 1: the reference attends with q_offset=length,
    kv_len=length + 1."""
    B, H, KV, D, cap_len = 3, 8, 2, 16, 64
    rng = np.random.default_rng(length)
    q = normal(rng, (B, 1, H, D))
    kbuf, vbuf = normal(rng, (B, cap_len, KV, D)), normal(rng, (B, cap_len, KV, D))
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(kbuf), jnp.asarray(vbuf),
                              causal=True, q_offset=length, kv_len=length + 1,
                              softcap=cap, chunk_kv=16)
    got = ops.decode_attention(torch.as_tensor(q[:, 0]), torch.as_tensor(kbuf),
                               torch.as_tensor(vbuf), np.full(B, length + 1),
                               softcap=cap, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], atol=2e-5, rtol=2e-5)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("flash_attention", "decode_attention"):
            real = getattr(ops, name)

            def spy(*a, _real=real, _name=name, **kw):
                self.calls.append(_name)
                return _real(*a, **kw)

            monkeypatch.setattr(PL.ops, name, spy)


def test_attention_block_routes_prefill_and_decode_to_the_kernels(monkeypatch):
    """The port's attention block (projections, bias, rope, cache append)
    against the reference's, on the same weights: prefill into a fresh
    cache goes to flash_attention, each one-token step to decode_attention."""
    cfg_r = ARCHS["qwen2.5-32b"].reduced()
    cfg = PARCHS["qwen2.5-32b"].reduced()
    rp = RM.init_params(cfg_r, jax.random.PRNGKey(3))
    rp["blocks"]["bq"] = jnp.full_like(rp["blocks"]["bq"], 0.1)  # a live bias
    tree = jax.tree.map(np.asarray, rp)
    p = params_from_reference(cfg, tree, device="cpu").blocks[0]
    p_ref = jax.tree.map(lambda x: x[0], rp["blocks"])
    B, S, cap_len = 2, 10, 16
    rng = np.random.default_rng(5)
    x = normal(rng, (B, S + 3, cfg.d_model))
    kv_shape = (B, cap_len, cfg.n_kv_heads, cfg.head_dim)
    rcache = {"k": jnp.zeros(kv_shape), "v": jnp.zeros(kv_shape), "length": 0}
    pcache = {"k": torch.zeros(kv_shape), "v": torch.zeros(kv_shape), "length": 0}
    spy = _Spy(monkeypatch)
    for lo, hi in [(0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)]:
        want, rcache = RL.attention(cfg_r, p_ref, jnp.asarray(x[:, lo:hi]),
                                    kv_cache=rcache, fresh_cache=lo == 0)
        got, pcache = PL.attention(cfg, p, torch.as_tensor(x[:, lo:hi]), kv_cache=pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
        assert pcache["length"] == hi and isinstance(pcache["length"], int)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(rcache["k"]), atol=2e-6)
    assert spy.calls == ["flash_attention"] + ["decode_attention"] * 3


def test_unported_attention_cases_raise():
    """No attention case is left unported: M-RoPE (qwen2-vl) runs -- under its
    default (t, t, t) positions it turns q and k as plain RoPE does, bit for
    bit (distinct positions: tests/test_torch_vlm.py) -- and so do a
    multi-token append and the window / chunk masks
    (tests/test_torch_local_moe.py)."""
    cfg = PARCHS["qwen2.5-32b"].reduced()
    p = params_from_reference(cfg, _tree(cfg), device="cpu").blocks[0]
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(1, 3, cfg.d_model)),
                        dtype=torch.float32)
    vlm = dataclasses.replace(cfg, mrope_sections=(2, 3, 3))
    out, _ = PL.attention(vlm, p, x)
    torch.testing.assert_close(out, PL.attention(cfg, p, x)[0], atol=0, rtol=0)
    kv = {"k": torch.zeros(1, 8, cfg.n_kv_heads, cfg.head_dim), "length": 2}
    kv["v"] = torch.zeros_like(kv["k"])
    out, kv = PL.attention(cfg, p, x, kv_cache=kv)
    assert out.shape == x.shape and kv["length"] == 5


def _tree(cfg):
    ref_cfg = ARCHS[cfg.name.replace("-reduced", "")].reduced()
    return jax.tree.map(np.asarray, RM.init_params(ref_cfg, jax.random.PRNGKey(0)))
