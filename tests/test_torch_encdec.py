"""Port vs reference: the encoder-decoder family (Whisper) and its serving
path.

The reduced Whisper-small config (d 64, 4 heads of 16, 2 encoder + 2
decoder layers, 32 stub frames) in float32.  The reference's
``init_params`` sets every LayerNorm scale to 1 and bias to 0; those
leaves are drawn again from a numpy seed before either side sees them, so
that the biases count.  The encoder's output, cross-attention and the
plain-GELU MLP are held at 1e-5, logits, the caches and decode against a
full forward at 3e-4 (the reference's decode-vs-forward bound).  The
attention runs the kernels' plain versions here (CPU tensors); the
kernels are held against them at Whisper's shapes in test_torch_cuda.py
and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import layers as RL
from repro.models import model as RM
from repro.serving.kv_cache import KVCachePool as RefPool
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.interop import params_from_reference
from repro_torch.launch import serve_llm
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.kv_cache import KVCachePool

ARCH = "whisper-small"
TOL = 1e-5
ATOL = 3e-4
#: the weights' seed (and the LayerNorms')
SEED = 2
NORMS = {"blocks": ("ln1", "ln2", "lnx"), "enc_blocks": ("ln1", "ln2")}


def _perturb_norms(rng, tree, n_layers, n_enc):
    """Draw the LayerNorms (scale 1 + N(0, 0.1), bias N(0, 0.1)) that the
    reference initialises to 1 and 0."""
    def draw(node, lead):
        d = node["s"].shape[-1]
        node["s"] = (1.0 + rng.normal(0.0, 0.1, lead + (d,))).astype(np.float32)
        node["b"] = rng.normal(0.0, 0.1, lead + (d,)).astype(np.float32)

    for part, lead in (("blocks", (n_layers,)), ("enc_blocks", (n_enc,))):
        for n in NORMS[part]:
            draw(tree[part][n], lead)
    for n in ("final_norm", "enc_final_norm"):
        draw(tree[n], ())


@pytest.fixture(scope="module")
def whisper():
    cfg_r = ARCHS[ARCH].reduced()
    cfg = PARCHS[ARCH].reduced()
    tree = jax.tree.map(np.array, RM.init_params(cfg_r, jax.random.PRNGKey(SEED)))
    _perturb_norms(np.random.default_rng(SEED), tree, cfg.n_layers, cfg.n_encoder_layers)
    rp = jax.tree.map(jnp.asarray, tree)
    pp = params_from_reference(cfg, tree, device="cpu")
    return cfg_r, cfg, rp, pp, tree


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "frames": rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)}


def _ref(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def _port(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens" else torch.float32)
            for k, v in batch.items()}


def test_params_from_reference_layout(whisper):
    _, cfg, _, pp, tree = whisper
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert isinstance(pp, M.EncDecLM)
    assert len(pp.enc_blocks) == cfg.n_encoder_layers and len(pp.blocks) == cfg.n_layers
    np.testing.assert_array_equal(pp.enc_pos.numpy(), tree["enc_pos"])
    np.testing.assert_array_equal(pp.enc_final_norm_b.numpy(), tree["enc_final_norm"]["b"])
    blk = tree["blocks"]
    for i, p in enumerate(pp.blocks):
        assert set(p.keys()) == set(M.encdec_block_shapes(cfg))
        np.testing.assert_array_equal(p["x_wq"].numpy(), blk["x_wq"][i].reshape(d, H * hd))
        np.testing.assert_array_equal(p["x_wkv"][:, :KV * hd].numpy(),
                                      blk["x_wk"][i].reshape(d, KV * hd))
        np.testing.assert_array_equal(p["x_wkv"][:, KV * hd:].numpy(),
                                      blk["x_wv"][i].reshape(d, KV * hd))
        np.testing.assert_array_equal(p["x_wo"].numpy(), blk["x_wo"][i].reshape(H * hd, d))
        np.testing.assert_array_equal(p["lnx_b"].numpy(), blk["lnx"]["b"][i])
    for i, p in enumerate(pp.enc_blocks):
        assert set(p.keys()) == set(M.block_shapes(cfg))
        np.testing.assert_array_equal(p["w1"].numpy(), tree["enc_blocks"]["w1"][i])


@pytest.mark.parametrize("S", [1, 5])
def test_cross_attention_matches_reference(whisper, S):
    """A one-row call (the decode kernel's route, lengths all T) and a
    multi-row one (non-causal flash) against the reference's."""
    cfg_r, cfg, rp, pp, _ = whisper
    rng = np.random.default_rng(S)
    x = rng.normal(size=(3, S, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(3, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    xp = {k[2:]: v[1] for k, v in rp["blocks"].items() if k.startswith("x_")}
    want = RL.cross_attention(cfg_r, xp, jnp.asarray(x), jnp.asarray(enc))
    got = L.cross_attention(cfg, pp.blocks[1], torch.as_tensor(x), torch.as_tensor(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_forward_encoder_matches_reference(whisper):
    cfg_r, cfg, rp, pp, _ = whisper
    frames = _batch(cfg, 2, 4)["frames"]
    want = RM.forward_encoder(cfg_r, rp, jnp.asarray(frames))
    got = M.forward_encoder(cfg, pp, torch.as_tensor(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="exceed"):
        M.forward_encoder(cfg, pp, torch.zeros(1, cfg.encoder_len + 1, cfg.d_model))


def test_plain_gelu_mlp_matches_reference(whisper):
    """Whisper's MLP: gelu (the tanh form, jax.nn.gelu's default) of x w1, then w2."""
    cfg_r, cfg, rp, pp, _ = whisper
    assert cfg.act == "gelu"
    x = np.random.default_rng(5).normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    ref_p = {n: rp["enc_blocks"][n][0] for n in ("w1", "w2")}
    want = RL.mlp(cfg_r, ref_p, jnp.asarray(x))
    got = L.mlp(cfg, pp.enc_blocks[0], torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_prefill_decode_logits_and_cache_match_reference(whisper):
    cfg_r, cfg, rp, pp, _ = whisper
    B, P, steps = 2, 12, 4
    batch = _batch(cfg, B, P, seed=1)
    lr, cr = RM.prefill(cfg_r, rp, _ref(batch), max_len=P + steps, cache_dtype=jnp.float32)
    lp, cp = M.prefill(cfg, pp, _port(batch), max_len=P + steps, cache_dtype=torch.float32)
    assert lp.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), atol=ATOL)
    np.testing.assert_allclose(cp["enc_out"].numpy(), np.asarray(cr["enc_out"]), atol=TOL,
                               rtol=TOL)
    step = jax.jit(lambda p, c, t: RM.decode_step(cfg_r, p, c, t))
    for _ in range(steps):
        tok = np.array(jnp.argmax(lr[:, -1], axis=-1))[:, None]
        lr, cr = step(rp, cr, jnp.asarray(tok, jnp.int32))
        lp, cp = M.decode_step(cfg, pp, cp, torch.as_tensor(tok, dtype=torch.long))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), atol=ATOL)
    assert cp["length"] == int(cr["length"]) == P + steps
    assert cp["enc_out"].dtype == torch.float32
    for name in ("k", "v", "enc_out"):
        np.testing.assert_allclose(cp[name].numpy(), np.asarray(cr[name]), atol=ATOL,
                                   err_msg=name)


def test_decode_matches_full_forward(whisper):
    """tests/test_models.py's decode-vs-forward check, on its shape, held to
    the reference's full forward too."""
    cfg_r, cfg, rp, pp, _ = whisper
    B, S = 2, 32
    batch = _batch(cfg, B, S, seed=11)
    pb = _port(batch)
    h, cache = M.forward(cfg, pp, pb["tokens"], frames=pb["frames"])
    assert cache is None
    full = M._unembed(cfg, pp, h[:, -1:])
    hr, _ = RM.forward(cfg_r, rp, _ref(batch))
    np.testing.assert_allclose(full.numpy(), np.asarray(RM._unembed(cfg_r, rp, hr[:, -1:])),
                               atol=ATOL)
    _, cache = M.prefill(cfg, pp, {"tokens": pb["tokens"][:, :-1], "frames": pb["frames"]},
                         max_len=S + 4, cache_dtype=torch.float32)
    dec, _ = M.decode_step(cfg, pp, cache, pb["tokens"][:, -1:])
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL)


def test_greedy_segment_tokens_match_reference(whisper):
    """One serving segment: the same greedy tokens as the reference's loop,
    the reference's top-2 gap > 10 x ATOL at every step."""
    cfg_r, cfg, rp, pp, _ = whisper
    B, P, G = 3, 16, 8
    batch = _batch(cfg, B, P, seed=5)  # no greedy step near a tie (checked below)
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


def test_init_params_cache_and_pool_match_reference():
    cfg, cfg_r = PARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    a = M.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    assert isinstance(a, M.EncDecLM) and a.device.type == "cpu"
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in a.parameters())
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    ref = jax.tree.map(np.asarray, RM.init_params(cfg_r, jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in a.parameters()) == sum(
        x.size for x in jax.tree.leaves(ref))
    for name in ("final_norm", "enc_final_norm"):
        assert torch.equal(getattr(a, name), torch.ones_like(getattr(a, name)))
        assert torch.equal(getattr(a, name + "_b"), torch.zeros_like(getattr(a, name + "_b")))
    for p in a.blocks:
        assert torch.equal(p["lnx"], torch.ones_like(p["lnx"]))
        for name in ("x_wq", "x_wkv", "x_wo"):
            assert float(p[name].float().std()) == pytest.approx(0.02, rel=0.2), name
    assert float(a.enc_pos.float().std()) == pytest.approx(0.02, rel=0.2)
    cache = M.init_cache(cfg, 3, 20, dtype=torch.bfloat16, device="cpu")
    rc = RM.init_cache(cfg_r, 3, 20)
    assert set(cache) == set(rc) == {"k", "v", "length"}
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == rc[name].shape
    pool = KVCachePool(cfg, n_slots=2, max_len=24, dtype=torch.float32, device="cpu")
    assert pool.bytes_per_slot() == RefPool(cfg_r, n_slots=2, max_len=24,
                                            dtype=jnp.float32).bytes_per_slot()
    with pytest.raises(ValueError, match="frames"):
        M.prefill(cfg, a, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, 8,
                  torch.bfloat16)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "zamba2-1.2b", ARCH, "qwen2-vl-7b"])
def test_request_draws_leave_prompts_and_arrivals_as_they_were(arch):
    """draw_requests: the prompt tokens, and the generator state the
    arrivals are drawn from next, are the draws the pipeline made before it
    drew frames and patches; those come from a generator of their own."""
    cfg = PARCHS[arch].reduced()
    n, P, seed = 9, 16, 5
    payloads, rng = serve_llm.draw_requests(cfg, n, P, seed=seed, device="cpu")
    old = np.random.default_rng(seed)  # the pipeline's draws before this family
    for p in payloads:
        np.testing.assert_array_equal(p["tokens"].numpy(), old.integers(0, cfg.vocab_size, P))
        assert p["tokens"].dtype == torch.long
    np.testing.assert_array_equal(rng.exponential(1.0, 20), old.exponential(1.0, 20))
    extra = {"encdec": {"frames": (cfg.encoder_len, cfg.d_model)},
             "vlm": {"patches": (cfg.n_patches, cfg.d_model)}}.get(cfg.family, {})
    assert M.input_shapes(cfg) == extra
    assert set(payloads[0]) == {"tokens", *extra}
    for name, shape in extra.items():
        xs = torch.stack([p[name] for p in payloads])
        assert xs.shape == (n,) + shape and xs.dtype == torch.float32
        assert 0.9 < float(xs.std()) < 1.1
        again, _ = serve_llm.draw_requests(cfg, n, P, seed=seed, device="cpu")
        assert torch.equal(xs, torch.stack([p[name] for p in again]))


def test_serve_llm_cli_whisper_on_cpu(capsys):
    res = serve_llm.main(["--arch", ARCH, "--device", "cpu", "--n-requests", "6",
                          "--gen-tokens", "2", "--b-max", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert f"serving reduced {ARCH}" in out and "not a power measurement" in out
    assert len(res.lat_ms) == 4 and np.all(np.diff(res.lat_ms) >= 0)
    for rep in res.reports.values():
        assert rep.n_served == 6 and np.isfinite(rep.latencies).all()
    served = sum(len(r.batch_sizes) for r in res.reports.values())
    assert res.segments == 2 * 4 + served
