"""Port vs reference: RWKV6 (Finch), its WKV6 recurrence and its serving
path.

The reduced RWKV6-3B config (d 64, 4 heads of 16) in float32.  The
reference's ``init_params`` sets ``u_bonus`` and ``ln_x`` to 0, ``w_base``
to -0.6 and every ``mu_*`` to 0.5; those leaves are drawn again from a
numpy seed before either side sees them, so that the bonus term, the
per-channel decay (w from 0.9999 down to ~1e-3) and the lerps count.
The time mix is held at atol / rtol 2e-5 (the reference's
kernel-against-naive bar), the channel mix at 1e-5, logits, every cache
entry and decode against a full forward at 3e-4 (the reference's
decode-vs-forward bound), the plain scan against a float64 recurrence at
1e-6.  The WKV6 scan runs its plain version here (CPU tensors); the
kernel is held against it in test_torch_cuda.py and chip_smoke.py.  The
kernel's arithmetic in its order (``wkv6_scan_grouped``) is held to the
plain scan and to the float64 recurrence at 2e-5 of each output's largest
|entry| (the card's bar), and through the time mix to the reference.
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
from repro_torch.kernels import wkv6_scan as K
from repro_torch.launch import serve_llm
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.kv_cache import KVCachePool

ARCH = "rwkv6-3b"
MIX_TOL = 2e-5
CMIX_TOL = 1e-5
ATOL = 3e-4
#: a seed whose greedy top-2 logit gaps all exceed 10 x ATOL (checked below)
SEED = 4
MU = ("r", "k", "v", "g", "w", "ck", "cr")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain scan is a loop of small torch ops: one intra-op thread
    keeps the module at its solo time beside other busy test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _perturb(rng, blk, lead):
    """Draw the leaves the reference initialises to constants: u_bonus,
    ln_x, w_base (decays exp(-exp(w_base)) from 0.9999 to ~1e-3) and the
    lerps, each with the leading axes ``lead``."""
    f = np.float32
    H, P = blk["u_bonus"].shape[-2:]
    blk["u_bonus"] = rng.normal(0.0, 0.5, lead + (H, P)).astype(f)
    blk["ln_x"] = rng.normal(0.0, 0.3, lead + (P,)).astype(f)
    blk["w_base"] = rng.uniform(-9.0, 2.0, lead + (H, P)).astype(f)
    for n in MU:
        blk[f"mu_{n}"] = rng.uniform(0.0, 1.0, blk[f"mu_{n}"].shape).astype(f)


@pytest.fixture(scope="module")
def rwkv():
    cfg_r = ARCHS[ARCH].reduced()
    cfg = PARCHS[ARCH].reduced()
    tree = jax.tree.map(np.array, RM.init_params(cfg_r, jax.random.PRNGKey(SEED)))
    _perturb(np.random.default_rng(SEED), tree["blocks"], (cfg.n_layers,))
    rp = jax.tree.map(jnp.asarray, tree)
    pp = params_from_reference(cfg, tree, device="cpu")
    return cfg_r, cfg, rp, pp, tree


def _block_params(cfg, rng):
    """One RWKV6 layer's weights in the reference's layout, random."""
    d, H, P, ff, R = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, M.RWKV_LORA_RANK
    f = np.float32
    n = (lambda *s, scale: (rng.normal(size=s) * scale).astype(f))
    p = {"wr": n(d, H, P, scale=0.2), "wk": n(d, H, P, scale=0.2),
         "wv": n(d, H, P, scale=0.2), "wg": n(d, H, P, scale=0.2),
         "wo": n(H, P, d, scale=0.2), "w_lora_a": n(d, R, scale=0.2),
         "w_lora_b": n(R, H * P, scale=0.2), "w_base": np.zeros((H, P), f),
         "u_bonus": np.zeros((H, P), f), "ln_x": np.zeros(P, f),
         "ck": n(d, ff, scale=0.2), "cv": n(ff, d, scale=0.2), "cr": n(d, d, scale=0.2)}
    for m in MU:
        p[f"mu_{m}"] = np.zeros(d, f)
    _perturb(rng, p, ())
    return p


def _port_block(cfg, p):
    shapes = M.rwkv_shapes(cfg)
    return {k: torch.as_tensor(v.reshape(shapes[k])) for k, v in p.items()}


def _prompts(cfg, B, P, seed=SEED):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=what)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 12, 64, 65, 130])
def test_time_mix_matches_reference(S, carried):
    """S <= 64 is the reference's plain scan, 65 and 130 its segmented,
    padded one; fresh, and from a carried WKV state and shift."""
    _time_mix_against_reference(S, carried)


def _time_mix_against_reference(S, carried):
    cfg = PARCHS[ARCH].reduced()
    rng = np.random.default_rng(10 * S + carried)
    p = _block_params(cfg, rng)
    B, H, P, d = 2, cfg.n_heads, cfg.head_dim, cfg.d_model
    x = (rng.normal(size=(B, S, d)) * 0.5).astype(np.float32)
    state = shift = None
    if carried:
        state = (rng.normal(size=(B, H, P, P)) * 0.5).astype(np.float32)
        shift = (rng.normal(size=(B, 1, d)) * 0.5).astype(np.float32)
    jn = (lambda a: None if a is None else jnp.asarray(a))
    tn = (lambda a: None if a is None else torch.as_tensor(a))
    want = RL.rwkv6_time_mix(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             state=jn(state), shift_state=jn(shift))
    got = L.rwkv6_time_mix(cfg, _port_block(cfg, p), torch.as_tensor(x), state=tn(state),
                           shift_state=tn(shift))
    for name, g, w in zip(("y", "wkv state", "shift"), got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, MIX_TOL, name)


@pytest.mark.parametrize("S,carried", [(1, True), (12, False), (12, True)])
def test_channel_mix_matches_reference(S, carried):
    cfg = PARCHS[ARCH].reduced()
    rng = np.random.default_rng(S + 100 * carried)
    p = _block_params(cfg, rng)
    x = (rng.normal(size=(2, S, cfg.d_model)) * 0.5).astype(np.float32)
    shift = (rng.normal(size=(2, 1, cfg.d_model)) * 0.5).astype(np.float32) if carried else None
    want = RL.rwkv6_channel_mix(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x),
                                shift_state=None if shift is None else jnp.asarray(shift))
    got = L.rwkv6_channel_mix(cfg, _port_block(cfg, p), torch.as_tensor(x),
                              shift_state=None if shift is None else torch.as_tensor(shift))
    for name, g, w in zip(("y", "shift"), got, want):
        _close(g, w, CMIX_TOL, name)


def test_wkv6_scan_ref_equals_recurrence():
    """The plain scan against the recurrence in numpy float64 from a nonzero
    state, bf16 inputs upcast as the kernel reads them, the state written
    into the incoming one (state_out aliasing state)."""
    rng = np.random.default_rng(3)
    B, S, H, P = 2, 9, 3, 8
    r, k, v = (rng.normal(size=(B, S, H, P)) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-9.0, 2.0, (B, S, H, P))))
    u = rng.normal(size=(H, P)) * 0.5
    s0 = rng.normal(size=(B, H, P, P)) * 0.5
    for dtype in (torch.float32, torch.bfloat16):
        rt, kt, vt = (torch.as_tensor(a, dtype=torch.float32).to(dtype) for a in (r, k, v))
        r64, k64, v64 = (a.double().numpy() for a in (rt, kt, vt))
        w32, u32, s32 = (torch.as_tensor(a, dtype=torch.float32) for a in (w, u, s0))
        st, ys = s32.double().numpy(), []
        for t in range(S):
            kv = k64[:, t, :, :, None] * v64[:, t, :, None, :]
            ys.append(np.einsum("bhp,bhpq->bhq", r64[:, t],
                                st + u32.double().numpy()[None, :, :, None] * kv))
            st = w32[:, t].double().numpy()[..., None] * st + kv
        state = s32.clone()
        y, fin = K.wkv6_scan(rt, kt, vt, w32, u32, state, state_out=state)
        assert fin is state and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), atol=1e-6)
        np.testing.assert_allclose(fin.numpy(), st, atol=1e-6)
        y0, fin0 = K.wkv6_scan_ref(rt, kt, vt, w32, u32)  # state None: zeros
        y1, _ = K.wkv6_scan_ref(rt, kt, vt, w32, u32, torch.zeros_like(s32))
        assert torch.equal(y0, y1)
    assert K.wkv6_scan.launches == 0  # CPU tensors: the plain version


#: of the largest |entry| of y and of the final state (test_torch_cuda.py's
#: and chip_smoke.py's bar for the kernel against the plain scan)
WKV_TOL = 2e-5


def _wkv_recurrence(r, k, v, w, u, s0):
    """The recurrence in numpy float64 from the inputs' float32 values."""
    r, k, v, w, u = (a.double().numpy() for a in (r.float(), k.float(), v.float(), w, u))
    st = np.zeros(r.shape[:1] + r.shape[2:] + r.shape[-1:]) if s0 is None \
        else s0.double().numpy()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(np.einsum("bhp,bhpq->bhq", r[:, t], st + u[None, :, :, None] * kv))
        st = w[:, t][..., None] * st + kv
    return np.stack(ys, 1), st


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_scan_grouped_matches_plain_and_recurrence(dtype, zero_state, P, S):
    """The kernel's order (row-group partials, their sum, then a_t v_t) on
    the CPU: against the plain scan and the float64 recurrence, decays from
    6e-4 to 0.9999, bf16 inputs upcast as the kernel reads them."""
    rng = np.random.default_rng(P * S + zero_state)
    B, H = 2, 2
    r, k, v = (torch.as_tensor(rng.normal(size=(B, S, H, P)) * 0.5,
                               dtype=torch.float32).to(dtype) for _ in range(3))
    w = torch.as_tensor(np.exp(-np.exp(rng.uniform(-9.0, 2.0, (B, S, H, P)))),
                        dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=(H, P)) * 0.5, dtype=torch.float32)
    s0 = None if zero_state else torch.as_tensor(rng.normal(size=(B, H, P, P)) * 0.5,
                                                 dtype=torch.float32)
    y, fin = K.wkv6_scan_grouped(r, k, v, w, u, s0)
    assert y.dtype == fin.dtype == torch.float32
    y_ref, fin_ref = K.wkv6_scan_ref(r, k, v, w, u, s0)
    y64, fin64 = _wkv_recurrence(r, k, v, w, u, s0)
    for what, got, want in (("y", y, y_ref), ("state", fin, fin_ref),
                            ("y vs f64", y, torch.as_tensor(y64)),
                            ("state vs f64", fin, torch.as_tensor(fin64))):
        err = (got.double() - want.double()).abs().max().item()
        assert err <= WKV_TOL * want.abs().max().item(), f"{what}: max abs err {err}"


@pytest.mark.parametrize("S", [65, 200])
def test_time_mix_with_the_grouped_scan_matches_reference(S, monkeypatch):
    """rwkv6_time_mix with the kernel's order in place of the plain scan,
    past the reference's 64-step segments, from a carried state."""
    calls = []

    def grouped(r, k, v, w, u, state=None, *, state_out=None, device=None):
        calls.append(r.shape)
        y, fin = K.wkv6_scan_grouped(r, k, v, w, u, state)
        if state_out is not None:
            fin = state_out.copy_(fin)
        return y, fin

    monkeypatch.setattr(L.ops, "wkv6_scan", grouped)
    _time_mix_against_reference(S, True)
    assert len(calls) == 1 and calls[0][1] == S


def test_wkv6_scan_checks_its_inputs():
    f = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError, match="w must be float32"):
        K.wkv6_scan(f, f, f, f.bfloat16(), torch.zeros(2, 16))
    with pytest.raises(TypeError, match="share"):
        K.wkv6_scan(f, f.bfloat16(), f, f, torch.zeros(2, 16))
    with pytest.raises(ValueError, match="u must be"):
        K.wkv6_scan(f, f, f, f, torch.zeros(16))
    with pytest.raises(ValueError, match="state must be"):
        K.wkv6_scan(f, f, f, f, torch.zeros(2, 16), torch.zeros(1, 2, 16, 8))


def test_params_from_reference_layout(rwkv):
    cfg_r, cfg, rp, pp, tree = rwkv
    assert isinstance(pp, M.RwkvLM) and len(pp.blocks) == cfg.n_layers
    assert sum(p.numel() for p in pp.parameters()) == sum(
        x.size for x in jax.tree.leaves(tree))
    d, HP = cfg.d_model, cfg.n_heads * cfg.head_dim
    blk = tree["blocks"]
    for i, p in enumerate(pp.blocks):
        for name in ("wr", "wk", "wv", "wg"):
            assert tuple(p[name].shape) == (d, HP)
            np.testing.assert_array_equal(p[name].numpy(), blk[name][i].reshape(d, HP))
        np.testing.assert_array_equal(p["wo"].numpy(), blk["wo"][i].reshape(HP, d))
        for name in ("w_lora_a", "w_lora_b", "w_base", "u_bonus", "ln_x", "ck", "cv", "cr",
                     *(f"mu_{n}" for n in MU)):
            np.testing.assert_array_equal(p[name].numpy(), blk[name][i], err_msg=name)
        for n in ("ln1", "ln2"):
            np.testing.assert_array_equal(p[n].numpy(), blk[n]["s"][i])
            np.testing.assert_array_equal(p[n + "_b"].numpy(), blk[n]["b"][i])
    np.testing.assert_array_equal(pp.final_norm_b.numpy(), tree["final_norm"]["b"])
    np.testing.assert_array_equal(pp.out.numpy(), tree["out"])


def test_prefill_decode_logits_and_cache_match_reference(rwkv):
    cfg_r, cfg, rp, pp, _ = rwkv
    B, P, steps = 2, 70, 4  # a prompt past the reference's 64-step segments
    toks = _prompts(cfg, B, P)
    lr, cr = RM.prefill(cfg_r, rp, {"tokens": jnp.asarray(toks)}, max_len=P + steps,
                        cache_dtype=jnp.float32)
    lp, cp = M.prefill(cfg, pp, {"tokens": torch.as_tensor(toks, dtype=torch.long)},
                       max_len=P + steps, cache_dtype=torch.float32)
    assert lp.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), atol=ATOL)
    step = jax.jit(lambda p, c, t: RM.decode_step(cfg_r, p, c, t))
    for _ in range(steps):
        tok = np.array(jnp.argmax(lr[:, -1], axis=-1))[:, None]
        lr, cr = step(rp, cr, jnp.asarray(tok, jnp.int32))
        lp, cp = M.decode_step(cfg, pp, cp, torch.as_tensor(tok, dtype=torch.long))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), atol=ATOL)
    assert cp["length"] == int(cr["length"]) == P + steps
    assert cp["wkv"].dtype == torch.float32
    for name in ("wkv", "tshift", "cshift"):
        np.testing.assert_allclose(cp[name].numpy(), np.asarray(cr[name]), atol=ATOL,
                                   err_msg=name)


def test_decode_matches_full_forward(rwkv):
    """tests/test_models.py's decode-vs-forward check, on its shape."""
    _, cfg, _, pp, _ = rwkv
    B, S = 2, 32
    toks = torch.as_tensor(_prompts(cfg, B, S, seed=11), dtype=torch.long)
    h, cache = M.forward(cfg, pp, toks)
    assert cache is None
    full = M._unembed(cfg, pp, h[:, -1:])
    _, cache = M.prefill(cfg, pp, {"tokens": toks[:, :-1]}, max_len=S + 4,
                         cache_dtype=torch.float32)
    dec, _ = M.decode_step(cfg, pp, cache, toks[:, -1:])
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL)


def test_greedy_segment_tokens_match_reference(rwkv):
    """One serving segment: the same greedy tokens as the reference's loop,
    the reference's top-2 gap > 10 x ATOL at every step."""
    cfg_r, cfg, rp, pp, _ = rwkv
    B, P, G = 3, 16, 8
    toks = _prompts(cfg, B, P)
    lg, cache = RM.prefill(cfg_r, rp, {"tokens": jnp.asarray(toks)}, max_len=P + G,
                           cache_dtype=jnp.float32)
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
    got = ex.run(torch.as_tensor(toks, dtype=torch.long))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))
    assert ex.segments == 1


def test_init_params_values_dtype_device_and_seed():
    cfg = PARCHS[ARCH].reduced()
    a = M.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    c = M.init_params(cfg, torch.Generator().manual_seed(8), torch.bfloat16, "cpu")
    assert isinstance(a, M.RwkvLM) and a.device.type == "cpu"
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in a.parameters())
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.blocks[0]["wr"], c.blocks[0]["wr"])
    ref = jax.tree.map(np.asarray, RM.init_params(ARCHS[ARCH].reduced(),
                                                  jax.random.PRNGKey(0), jnp.bfloat16))
    assert sum(p.numel() for p in a.parameters()) == sum(
        x.size for x in jax.tree.leaves(ref))
    consts = {"w_base": -0.6, "u_bonus": 0.0, "ln_x": 0.0, "ln1": 1.0, "ln1_b": 0.0,
              "ln2": 1.0, "ln2_b": 0.0, **{f"mu_{n}": 0.5 for n in MU}}
    for p in a.blocks:
        assert set(p.keys()) == set(M.rwkv_shapes(cfg))
        for name, value in consts.items():
            assert torch.equal(p[name], torch.full_like(p[name], value)), name
            leaf = ref["blocks"][name[:3]] if name.startswith("ln") and name != "ln_x" \
                else ref["blocks"][name]
            if isinstance(leaf, dict):
                leaf = leaf["b" if name.endswith("_b") else "s"]
            np.testing.assert_array_equal(p[name].float().numpy(),
                                          np.asarray(leaf[0], np.float32), err_msg=name)
        for name in ("wr", "wk", "wv", "wg", "wo", "w_lora_a", "w_lora_b", "ck", "cv", "cr"):
            assert float(p[name].float().std()) == pytest.approx(0.02, rel=0.2), name
    assert torch.equal(a.final_norm, torch.ones_like(a.final_norm))


def test_init_cache_and_pool_match_reference():
    cfg = PARCHS[ARCH].reduced()
    cache = M.init_cache(cfg, 3, 20, dtype=torch.bfloat16, device="cpu")
    ref = RM.init_cache(ARCHS[ARCH].reduced(), 3, 20)
    assert set(cache) == set(ref) == {"wkv", "tshift", "cshift", "length"}
    assert cache["wkv"].dtype == torch.float32
    assert cache["tshift"].dtype == cache["cshift"].dtype == torch.bfloat16
    for name in ("wkv", "tshift", "cshift"):
        assert tuple(cache[name].shape) == ref[name].shape, name
        assert str(cache[name].dtype).replace("torch.", "") == str(ref[name].dtype), name
    assert cache["length"] == 0
    pool = KVCachePool(cfg, n_slots=2, max_len=24, dtype=torch.float32, device="cpu")
    ref_pool = RefPool(ARCHS[ARCH].reduced(), n_slots=2, max_len=24, dtype=jnp.float32)
    assert pool.bytes_per_slot() == ref_pool.bytes_per_slot()
    for name in ("wkv", "tshift", "cshift"):
        assert tuple(pool.cache[name].shape) == ref_pool.cache[name].shape, name
    with pytest.raises(ValueError, match="cache dtype"):
        M.decode_step(cfg, M.init_params(cfg, torch.Generator(), device="cpu"),
                      M.init_cache(cfg, 1, 4, dtype=torch.bfloat16, device="cpu"),
                      torch.zeros(1, 1, dtype=torch.long))


def test_serve_llm_cli_rwkv6_on_cpu(capsys):
    res = serve_llm.main(["--arch", ARCH, "--device", "cpu", "--n-requests", "6",
                          "--gen-tokens", "2", "--b-max", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert f"serving reduced {ARCH}" in out and "not a power measurement" in out
    assert len(res.lat_ms) == 4 and np.all(np.diff(res.lat_ms) >= 0)
    for rep in res.reports.values():
        assert rep.n_served == 6 and np.isfinite(rep.latencies).all()
    served = sum(len(r.batch_sizes) for r in res.reports.values())
    assert res.segments == 2 * 4 + served
