"""Port vs reference: the Mamba2 hybrid family (Zamba2), its SSD scan and
its serving path.

The reduced Zamba2-1.2B config in float32; inputs and block weights come
from a numpy seed, the model's weights from the reference's
``init_params`` through ``params_from_reference``.  The Mamba2 block is
held at atol / rtol 2e-5 (the reference's kernel-against-naive bar), the
chunked scan against a per-token recurrence at 2e-4 (the reference's own
chunked-vs-stepwise bound), logits and caches at 3e-4 (its
decode-vs-forward bound).  The SSD scan runs its plain version here (CPU
tensors); the kernel is held against it in test_torch_cuda.py.
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
from repro_torch.kernels import ssd_scan as K
from repro_torch.launch import serve_llm
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.kv_cache import KVCachePool

ARCH = "zamba2-1.2b"
BLOCK_TOL = 2e-5
STEP_TOL = 2e-4
ATOL = 3e-4
#: a seed whose greedy top-2 logit gaps all exceed 10 x ATOL (checked below)
SEED = 1


@pytest.fixture(scope="module")
def zamba():
    cfg_r = ARCHS[ARCH].reduced()
    cfg = PARCHS[ARCH].reduced()
    rp = RM.init_params(cfg_r, jax.random.PRNGKey(SEED))
    pp = params_from_reference(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    return cfg_r, cfg, rp, pp


def _block_params(cfg, rng):
    """One Mamba2 layer's weights, random (not the initial constants)."""
    d, di, N, H, Kc = (cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads,
                       cfg.ssm_conv)
    f = np.float32
    return {
        "in_proj": (rng.normal(size=(d, 2 * di + 2 * N + H)) * 0.1).astype(f),
        "out_proj": (rng.normal(size=(di, d)) * 0.1).astype(f),
        "conv_w": (rng.normal(size=(Kc, di + 2 * N)) * 0.3).astype(f),
        "dt_bias": rng.normal(-1.0, 0.5, size=H).astype(f),
        "a_log": rng.normal(0.0, 0.5, size=H).astype(f),
        "d_skip": rng.normal(0.1, 0.5, size=H).astype(f),
    }


def _prompts(cfg, B, P, seed=SEED):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [8, 128])
@pytest.mark.parametrize("S", [1, 5, 24, 130])
def test_mamba2_block_matches_reference(S, chunk, with_state):
    cfg = PARCHS[ARCH].reduced()
    rng = np.random.default_rng(100 * S + chunk + with_state)
    p = _block_params(cfg, rng)
    B, H, P, N = 2, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    C = cfg.d_inner_ssm + 2 * N
    x = (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)
    ssm = conv = None
    if with_state:
        ssm = (rng.normal(size=(B, H, P, N)) * 0.5).astype(np.float32)
        conv = (rng.normal(size=(B, cfg.ssm_conv - 1, C)) * 0.5).astype(np.float32)
    jn = (lambda a: None if a is None else jnp.asarray(a))
    tn = (lambda a: None if a is None else torch.as_tensor(a))
    want = RL.mamba2_block(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                           ssm_state=jn(ssm), conv_state=jn(conv), chunk=chunk)
    got = L.mamba2_block(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                         torch.as_tensor(x), ssm_state=tn(ssm), conv_state=tn(conv),
                         chunk=chunk)
    for name, g, w in zip(("y", "ssm_state", "conv_state"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BLOCK_TOL,
                                   rtol=BLOCK_TOL, err_msg=name)


def test_ssd_scan_ref_equals_recurrence():
    """The chunked scan (chunks of 8, the last padded) equals the per-token
    recurrence S <- S exp(dA) + dt x B^T, y = S C, from a nonzero state."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 21, 3, 4, 5
    t = (lambda *s, scale=1.0: torch.as_tensor(rng.normal(size=s) * scale,
                                               dtype=torch.float32))
    xs, Bm, Cm = t(B, S, H, P), t(B, S, N, scale=0.5), t(B, S, N, scale=0.5)
    dt = torch.nn.functional.softplus(t(B, S, H) - 1.0)
    dA = dt * -torch.exp(t(H, scale=0.5))
    state0 = t(B, H, P, N)
    st, ys = state0.clone(), []
    for s in range(S):
        st = (st * torch.exp(dA[:, s])[:, :, None, None]
              + (dt[:, s, :, None] * xs[:, s])[..., None] * Bm[:, s, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cm[:, s]))
    for chunk in (8, 128):
        y, fin = K.ssd_scan_ref(xs, Bm, Cm, dt, dA, state0, chunk=chunk)
        np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(), atol=STEP_TOL)
        np.testing.assert_allclose(fin.numpy(), st.numpy(), atol=STEP_TOL)
    out = torch.empty_like(state0)
    _, fin = K.ssd_scan(xs, Bm, Cm, dt, dA, state0, chunk=8, state_out=out)
    # CPU tensors: the plain version
    assert fin is out and K.ssd_scan.launches == 0 and not K.ssd_scan.instance_launches


def test_mamba2_block_chunked_equals_stepwise():
    """The port's counterpart of test_mamba2_chunked_equals_stepwise:
    a 24-token block in chunks of 8 against 24 one-token calls."""
    cfg = PARCHS[ARCH].reduced()
    rng = np.random.default_rng(7)
    p = {k: torch.as_tensor(v) for k, v in _block_params(cfg, rng).items()}
    x = torch.as_tensor(rng.normal(size=(2, 24, cfg.d_model)) * 0.3, dtype=torch.float32)
    y_full, ssm_f, conv_f = L.mamba2_block(cfg, p, x, chunk=8)
    ssm = conv = None
    outs = []
    for s in range(24):
        y, ssm, conv = L.mamba2_block(cfg, p, x[:, s:s + 1], ssm_state=ssm,
                                      conv_state=conv, chunk=8)
        outs.append(y)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(outs, 1).numpy(), atol=STEP_TOL)
    np.testing.assert_allclose(ssm_f.numpy(), ssm.numpy(), atol=STEP_TOL)
    np.testing.assert_allclose(conv_f.numpy(), conv.numpy(), atol=STEP_TOL)


def test_ssd_kernel_shared_memory_plan():
    """csrc/ssd_scan.cu's layout as the wrapper computes it (the card tests
    hold it equal to the C library's): Zamba2-1.2B's prefill block fits
    twice in an H100 SM; a decode block (L = 1) holds two heads' states
    row-major; a chunk of 200 fits a block and one of 512 does not (the
    card test's refusal)."""
    cfg = PARCHS[ARCH]
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    smem = K.smem_bytes(P, N, 128)
    assert smem <= 110 * 1024 and 2 * (smem + 1024) <= 228 * 1024
    assert K.smem_bytes(P, N, 1) == 8 * (P * N + P + 2 * N + 4)  # decode: 2 heads' state, rows
    assert K.smem_bytes(64, 64, 200) <= K.MAX_SMEM < K.smem_bytes(64, 64, 512)
    assert K.smem_bytes(18, 10, 66) == K.smem_bytes(20, 12, 66)  # P, N padded to 4


def test_params_from_reference_layout(zamba):
    cfg_r, cfg, rp, pp = zamba
    tree = jax.tree.map(np.asarray, rp)
    assert isinstance(pp, M.HybridLM) and len(pp.blocks) == cfg.n_layers
    assert sum(p.numel() for p in pp.parameters()) == sum(
        x.size for x in jax.tree.leaves(tree))
    for i, p in enumerate(pp.blocks):
        for name in ("in_proj", "out_proj", "conv_w", "dt_bias", "a_log", "d_skip"):
            np.testing.assert_array_equal(p[name].numpy(), tree["blocks"][name][i])
        np.testing.assert_array_equal(p["ln1"].numpy(), tree["blocks"]["ln1"]["s"][i])
    sa, sp = tree["shared_attn"], pp.shared
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    np.testing.assert_array_equal(sp["wqkv"].numpy()[:, :H * hd], sa["wq"].reshape(d, -1))
    np.testing.assert_array_equal(sp["wqkv"].numpy()[:, -H * hd:], sa["wv"].reshape(d, -1))
    np.testing.assert_array_equal(sp["wo"].numpy(), sa["wo"].reshape(-1, d))
    np.testing.assert_array_equal(sp["w1"].numpy(), sa["w1"])
    np.testing.assert_array_equal(sp["ln_m"].numpy(), sa["ln_m"]["s"])


def test_prefill_decode_logits_and_cache_match_reference(zamba):
    cfg_r, cfg, rp, pp = zamba
    B, P, steps = 2, 12, 4
    toks = _prompts(cfg, B, P)
    lr, cr = RM.prefill(cfg_r, rp, {"tokens": jnp.asarray(toks)}, max_len=P + steps,
                        cache_dtype=jnp.float32)
    lp, cp = M.prefill(cfg, pp, {"tokens": torch.as_tensor(toks, dtype=torch.long)},
                       max_len=P + steps, cache_dtype=torch.float32)
    assert lp.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), atol=ATOL)
    for _ in range(steps):
        tok = np.array(jnp.argmax(lr[:, -1], axis=-1))[:, None]
        lr, cr = RM.decode_step(cfg_r, rp, cr, jnp.asarray(tok, jnp.int32))
        lp, cp = M.decode_step(cfg, pp, cp, torch.as_tensor(tok, dtype=torch.long))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), atol=ATOL)
    assert cp["length"] == int(cr["length"]) == P + steps
    assert cp["ssm"].dtype == torch.float32
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(cp[name].numpy(), np.asarray(cr[name]), atol=ATOL,
                                   err_msg=name)
    assert len(cp["attn"]) == len(cr["attn"]) == M.n_shared_occurrences(cfg) == 2
    for occ, (a, b) in enumerate(zip(cp["attn"], cr["attn"])):
        for name in ("k", "v"):
            np.testing.assert_allclose(a[name].numpy(), np.asarray(b[name]), atol=ATOL,
                                       err_msg=f"attn {occ} {name}")


def test_decode_matches_full_forward(zamba):
    """tests/test_models.py's decode-vs-forward check, on its shape."""
    _, cfg, _, pp = zamba
    B, S = 2, 32
    toks = torch.as_tensor(_prompts(cfg, B, S, seed=11), dtype=torch.long)
    h, cache = M.forward(cfg, pp, toks)
    assert cache is None
    full = M._unembed(cfg, pp, h[:, -1:])
    _, cache = M.prefill(cfg, pp, {"tokens": toks[:, :-1]}, max_len=S + 4,
                         cache_dtype=torch.float32)
    dec, _ = M.decode_step(cfg, pp, cache, toks[:, -1:])
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL)


def test_greedy_segment_tokens_match_reference(zamba):
    """One serving segment: the same greedy tokens as the reference's loop,
    the reference's top-2 gap > 10 x ATOL at every step."""
    cfg_r, cfg, rp, pp = zamba
    B, P, G = 3, 16, 8
    toks = _prompts(cfg, B, P)
    lg, cache = RM.prefill(cfg_r, rp, {"tokens": jnp.asarray(toks)}, max_len=P + G,
                           cache_dtype=jnp.float32)
    want = []
    for i in range(G):
        top2 = np.sort(np.asarray(lg[:, -1]), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 10 * ATOL, f"step {i} near a tie"
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        if i < G - 1:
            lg, cache = RM.decode_step(cfg_r, rp, cache, tok)
    ex = serve_llm.build_executor(cfg, pp, G, b_max=4, prompt_len=P)
    got = ex.run(torch.as_tensor(toks, dtype=torch.long))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))
    assert ex.segments == 1


def test_init_params_values_dtype_device_and_seed():
    cfg = PARCHS[ARCH].reduced()
    a = M.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    c = M.init_params(cfg, torch.Generator().manual_seed(8), torch.bfloat16, "cpu")
    assert isinstance(a, M.HybridLM) and a.device.type == "cpu"
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in a.parameters())
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.blocks[0]["in_proj"], c.blocks[0]["in_proj"])
    ref = jax.tree.map(np.asarray, RM.init_params(ARCHS[ARCH].reduced(),
                                                  jax.random.PRNGKey(0), jnp.bfloat16))
    assert sum(p.numel() for p in a.parameters()) == sum(
        x.size for x in jax.tree.leaves(ref))
    for p in a.blocks:
        for name, value in (("dt_bias", -4.6), ("a_log", 0.0), ("d_skip", 0.1)):
            want = torch.full_like(p[name], value)
            assert torch.equal(p[name], want), name
            np.testing.assert_array_equal(p[name].float().numpy(),
                                          np.asarray(ref["blocks"][name][0], np.float32))
        assert not p["ln1"].any()
        for name in ("in_proj", "out_proj", "conv_w"):
            assert float(p[name].float().std()) == pytest.approx(0.02, rel=0.15), name
    assert float(a.shared["wqkv"].float().std()) == pytest.approx(0.02, rel=0.05)
    assert not a.shared["ln_a"].any() and not a.shared["ln_m"].any()
    assert set(a.shared.keys()) == {"wqkv", "wo", "w1", "w2", "ln_a", "ln_m"}


def test_init_cache_and_pool_match_reference():
    cfg = PARCHS[ARCH].reduced()
    cache = M.init_cache(cfg, 3, 20, dtype=torch.bfloat16, device="cpu")
    ref = RM.init_cache(ARCHS[ARCH].reduced(), 3, 20)
    assert cache["ssm"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16
    for name in ("ssm", "conv"):
        assert tuple(cache[name].shape) == ref[name].shape, name
    assert [tuple(c["k"].shape) for c in cache["attn"]] == [c["k"].shape for c in ref["attn"]]
    assert cache["length"] == 0
    pool = KVCachePool(cfg, n_slots=2, max_len=24, dtype=torch.float32, device="cpu")
    assert pool.bytes_per_slot() == RefPool(ARCHS[ARCH].reduced(), n_slots=2,
                                            max_len=24).bytes_per_slot()


def test_serve_llm_cli_zamba2_on_cpu(capsys):
    res = serve_llm.main(["--arch", ARCH, "--device", "cpu", "--n-requests", "6",
                          "--gen-tokens", "2", "--b-max", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert f"serving reduced {ARCH}" in out and "not a power measurement" in out
    assert len(res.lat_ms) == 4 and np.all(np.diff(res.lat_ms) >= 0)
    for rep in res.reports.values():
        assert rep.n_served == 6 and np.isfinite(rep.latencies).all()
    served = sum(len(r.batch_sizes) for r in res.reports.values())
    assert res.segments == 2 * 4 + served
