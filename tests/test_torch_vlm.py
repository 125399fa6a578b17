"""Port vs reference: the VLM family (Qwen2-VL: M-RoPE, stub patch
embeddings) and its serving path.

The reduced Qwen2-VL-7B config (d 64, 4 / 2 heads of 16, M-RoPE sections
(2, 3, 3), 8 stub patches, qkv bias) in float32.  The reference's
``init_params`` sets the qkv biases to 0; they are drawn again from a
numpy seed before either side sees them.  M-RoPE and an attention block
under distinct (t, h, w) positions are held at 1e-5, logits, the caches
and decode against a full forward at 3e-4 (the reference's
decode-vs-forward bound).  The attention runs the kernels' plain versions
here (CPU tensors); the kernels are held against them at Qwen2-VL's heads
(G = 7) in test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.interop import params_from_reference
from repro_torch.launch import serve_llm
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCH = "qwen2-vl-7b"
TOL = 1e-5
ATOL = 3e-4
SEED = 3


@pytest.fixture(scope="module")
def vlm():
    cfg_r = ARCHS[ARCH].reduced()
    cfg = PARCHS[ARCH].reduced()
    tree = jax.tree.map(np.array, RM.init_params(cfg_r, jax.random.PRNGKey(SEED)))
    rng = np.random.default_rng(SEED)
    for n in ("bq", "bk", "bv"):
        tree["blocks"][n] = rng.normal(0.0, 0.1, tree["blocks"][n].shape).astype(np.float32)
    rp = jax.tree.map(jnp.asarray, tree)
    pp = params_from_reference(cfg, tree, device="cpu")
    return cfg_r, cfg, rp, pp


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "patches": rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)}


def _ref(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def _port(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens" else torch.float32)
            for k, v in batch.items()}


def _positions3(B, S, seed):
    """Distinct (t, h, w) positions, as a real image grid gives them."""
    return np.random.default_rng(seed).integers(0, 64, (3, B, S))


@pytest.mark.parametrize("D,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(D, sections):
    B, S, H = 2, 9, 3
    x = np.random.default_rng(D).normal(size=(B, S, H, D)).astype(np.float32)
    pos3 = _positions3(B, S, D)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = L.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # (t, t, t) positions are plain RoPE
    flat = np.repeat(pos3[:1], 3, axis=0)
    np.testing.assert_allclose(
        L.apply_mrope(torch.as_tensor(x), torch.as_tensor(flat), 1e6, sections).numpy(),
        L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos3[0]), 1e6).numpy(), atol=0)
    with pytest.raises(ValueError, match="sections"):
        L.mrope_tables(torch.as_tensor(pos3), D, 1e6, (1, 1, 1))


def test_attention_under_mrope_matches_reference(vlm):
    """One attention block (qkv bias, G = 2) under distinct (t, h, w)
    positions, the tables built once as a forward builds them."""
    cfg_r, cfg, rp, pp = vlm
    B, S = 2, 11
    x = np.random.default_rng(7).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos3 = _positions3(B, S, 7)
    ref_p = {n: rp["blocks"][n][1] for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}
    want, _ = RL.attention(cfg_r, ref_p, jnp.asarray(x), positions=jnp.asarray(pos3))
    got, _ = L.attention(cfg, pp.blocks[1], torch.as_tensor(x),
                         rope=L.rotary_tables(cfg, torch.as_tensor(pos3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_prefill_decode_logits_and_cache_match_reference(vlm):
    cfg_r, cfg, rp, pp = vlm
    B, P, steps = 2, 14, 4
    batch = _batch(cfg, B, P, seed=1)
    lr, cr = RM.prefill(cfg_r, rp, _ref(batch), max_len=P + steps, cache_dtype=jnp.float32)
    lp, cp = M.prefill(cfg, pp, _port(batch), max_len=P + steps, cache_dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), atol=ATOL)
    step = jax.jit(lambda p, c, t: RM.decode_step(cfg_r, p, c, t))
    for _ in range(steps):
        tok = np.array(jnp.argmax(lr[:, -1], axis=-1))[:, None]
        lr, cr = step(rp, cr, jnp.asarray(tok, jnp.int32))
        lp, cp = M.decode_step(cfg, pp, cp, torch.as_tensor(tok, dtype=torch.long))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), atol=ATOL)
    assert cp["length"] == int(cr["length"]) == P + steps
    for name in ("k", "v"):
        np.testing.assert_allclose(cp[name].numpy(), np.asarray(cr[name]), atol=ATOL,
                                   err_msg=name)


def test_patches_take_the_first_embeddings(vlm):
    """The patches replace the prompt's first n_patches embeddings (so those
    tokens do not matter), and a prompt shorter than n_patches raises."""
    _, cfg, _, pp = vlm
    batch = _port(_batch(cfg, 2, 12, seed=4))
    other = dict(batch, tokens=batch["tokens"].clone())
    other["tokens"][:, :cfg.n_patches] = 0
    a, _ = M.forward(cfg, pp, batch["tokens"], patches=batch["patches"])
    b, _ = M.forward(cfg, pp, other["tokens"], patches=other["patches"])
    assert torch.equal(a, b)
    c, _ = M.forward(cfg, pp, batch["tokens"])
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="patches"):
        M.prefill(cfg, pp, {"tokens": batch["tokens"][:, :cfg.n_patches - 1],
                            "patches": batch["patches"]}, 16, torch.float32)


def test_decode_matches_full_forward(vlm):
    """tests/test_models.py's decode-vs-forward check, on its shape, held to
    the reference's full forward too."""
    cfg_r, cfg, rp, pp = vlm
    B, S = 2, 32
    batch = _batch(cfg, B, S, seed=11)
    pb = _port(batch)
    h, cache = M.forward(cfg, pp, pb["tokens"], patches=pb["patches"])
    assert cache is None
    full = M._unembed(cfg, pp, h[:, -1:])
    hr, _ = RM.forward(cfg_r, rp, _ref(batch))
    np.testing.assert_allclose(full.numpy(), np.asarray(RM._unembed(cfg_r, rp, hr[:, -1:])),
                               atol=ATOL)
    _, cache = M.prefill(cfg, pp, {"tokens": pb["tokens"][:, :-1], "patches": pb["patches"]},
                         max_len=S + 4, cache_dtype=torch.float32)
    dec, _ = M.decode_step(cfg, pp, cache, pb["tokens"][:, -1:])
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL)


def test_greedy_segment_tokens_match_reference(vlm):
    """One serving segment: the same greedy tokens as the reference's loop,
    the reference's top-2 gap > 10 x ATOL at every step."""
    cfg_r, cfg, rp, pp = vlm
    B, P, G = 3, 16, 8
    batch = _batch(cfg, B, P, seed=3)
    lg, cache = RM.prefill(cfg_r, rp, _ref(batch), max_len=P + G, cache_dtype=jnp.float32)
    step = jax.jit(lambda p, c, t: RM.decode_step(cfg_r, p, c, t))
    want = []
    for i in range(G):
        top2 = np.sort(np.asarray(lg[:, -1]), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 10 * ATOL, f"step {i} near a tie"
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        if i < G - 1:
            lg, cache = step(rp, cache, tok)
    ex = serve_llm.build_executor(cfg, pp, G, b_max=4, prompt_len=P)
    got = ex.run(**_port(batch))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))
    assert ex.segments == 1


def test_init_params_layout_and_supported():
    cfg = PARCHS[ARCH].reduced()
    a = M.init_params(cfg, torch.Generator().manual_seed(7), torch.float32, "cpu")
    assert isinstance(a, M.DenseLM) and M.supported(cfg)
    for p in a.blocks:
        assert set(p.keys()) == set(M.block_shapes(cfg)) and "bqkv" in p.keys()
    ref = jax.tree.map(np.asarray, RM.init_params(ARCHS[ARCH].reduced(),
                                                  jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in a.parameters()) == sum(
        x.size for x in jax.tree.leaves(ref))
    # a VLM without sections is a dense decoder with patches: plain RoPE
    plain = dataclasses.replace(cfg, mrope_sections=None)
    assert M.supported(plain)


def test_serve_llm_cli_qwen2_vl_on_cpu(capsys):
    res = serve_llm.main(["--arch", ARCH, "--device", "cpu", "--n-requests", "6",
                          "--gen-tokens", "2", "--b-max", "4", "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert f"serving reduced {ARCH}" in out and "not a power measurement" in out
    assert len(res.lat_ms) == 4 and np.all(np.diff(res.lat_ms) >= 0)
    for rep in res.reports.values():
        assert rep.n_served == 6 and np.isfinite(rep.latencies).all()
    served = sum(len(r.batch_sizes) for r in res.reports.values())
    assert res.segments == 2 * 4 + served
