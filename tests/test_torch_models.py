"""Port vs reference: the dense model stack, the KV cache pool and the LLM
serving pipeline.

The reference's ``init_params`` of the reduced Qwen2.5-32B config (float32)
crosses over with ``params_from_reference``; prompts come from a numpy
seed.  Logits are held at atol 3e-4, the bound of the reference's own
decode-vs-forward test (tests/test_models.py).  The attention inside runs
the kernels' plain versions (CPU tensors); the kernels themselves are held
against them in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import model as RM
from repro.serving.kv_cache import KVCachePool as RefPool
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.configs import get_config
from repro_torch.interop import params_from_reference
from repro_torch.launch import serve_llm
from repro_torch.models import model as M
from repro_torch.serving.kv_cache import KVCachePool

ATOL = 3e-4
ARCH = "qwen2.5-32b"
#: a seed whose greedy top-2 logit gaps all exceed 10 x ATOL (checked below)
SEED = 1


@pytest.fixture(scope="module")
def qwen():
    cfg_r = ARCHS[ARCH].reduced()
    cfg = PARCHS[ARCH].reduced()
    rp = RM.init_params(cfg_r, jax.random.PRNGKey(SEED))
    pp = params_from_reference(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    return cfg_r, cfg, rp, pp


def _prompts(cfg, B, P, seed=SEED):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)


def test_config_copies_match_the_reference():
    assert sorted(PARCHS) == sorted(ARCHS)
    for name, cfg in ARCHS.items():
        port = PARCHS[name]
        assert vars(port) == vars(cfg), name
        assert port.n_params() == cfg.n_params()
        assert vars(port.reduced()) == vars(cfg.reduced())
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_params_from_reference_layout(qwen):
    cfg_r, cfg, rp, pp = qwen
    tree = jax.tree.map(np.asarray, rp)
    n_ref = sum(x.size for x in jax.tree.leaves(tree))
    assert sum(p.numel() for p in pp.parameters()) == n_ref
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    blk = tree["blocks"]
    for i, p in enumerate(pp.blocks):
        wqkv = p["wqkv"].numpy()
        np.testing.assert_array_equal(wqkv[:, :H * hd], blk["wq"][i].reshape(d, H * hd))
        np.testing.assert_array_equal(wqkv[:, H * hd:(H + KV) * hd],
                                      blk["wk"][i].reshape(d, KV * hd))
        np.testing.assert_array_equal(p["wo"].numpy(), blk["wo"][i].reshape(H * hd, d))
        np.testing.assert_array_equal(p["w13"].numpy()[:, cfg.d_ff:], blk["w3"][i])
        np.testing.assert_array_equal(p["bqkv"].numpy()[:H * hd], blk["bq"][i].reshape(-1))
    np.testing.assert_array_equal(pp.out.numpy(), tree["out"])
    assert pp.dtype == torch.float32 and pp.device.type == "cpu"


def test_prefill_and_decode_logits_match_reference(qwen):
    cfg_r, cfg, rp, pp = qwen
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
    np.testing.assert_allclose(cp["k"].numpy(), np.asarray(cr["k"]), atol=ATOL)


def test_forward_matches_decode_path(qwen):
    """The port's own decode-vs-forward check (tests/test_models.py's)."""
    _, cfg, _, pp = qwen
    B, S = 2, 20
    toks = torch.as_tensor(_prompts(cfg, B, S), dtype=torch.long)
    h, _ = M.forward_lm(cfg, pp, toks)
    full = M._unembed(cfg, pp, h[:, -1:])
    _, cache = M.prefill(cfg, pp, {"tokens": toks[:, :-1]}, max_len=S + 2,
                         cache_dtype=torch.float32)
    dec, _ = M.decode_step(cfg, pp, cache, toks[:, -1:])
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL)


def test_greedy_segment_tokens_match_reference(qwen):
    """One serving segment (prefill + greedy decode steps): the same tokens
    as the reference's loop, with the reference's top-2 gap > 10 x ATOL at
    every step so no step sits on a tie."""
    cfg_r, cfg, rp, pp = qwen
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


@pytest.mark.parametrize("name,what", [
    # training RWKV6 and the hybrid: the WKV6 and SSD scans have no backward
    # kernel
    ("rwkv6-3b", "lm_loss"), ("zamba2-1.2b", "lm_loss"),
])
def test_unported_families_raise(name, what):
    cfg = PARCHS[name].reduced()
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen, device="cpu")  # the weights build; serving runs
    batch = {"tokens": torch.zeros(1, max(4, cfg.n_patches), dtype=torch.long)}
    for name, shape in M.input_shapes(cfg).items():
        batch[name] = torch.zeros((1,) + shape)
    M.prefill(cfg, params, batch, 12, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(M, what)(cfg, params, batch)


def test_init_params_dtype_device_and_seed():
    cfg = PARCHS[ARCH].reduced()
    a = M.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(7), torch.bfloat16, "cpu")
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in a.parameters())
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert sum(p.numel() for p in a.parameters()) == cfg.n_params() + sum(
        p.numel() for n, p in a.named_parameters() if "ln" in n or "norm" in n or "bqkv" in n)
    assert float(a.embed.float().std()) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("max_len", [24, 144])
def test_kv_cache_pool(max_len):
    cfg = PARCHS[ARCH].reduced()
    pool = KVCachePool(cfg, n_slots=4, max_len=max_len, dtype=torch.float32, device="cpu")
    ref = RefPool(ARCHS[ARCH].reduced(), n_slots=4, max_len=max_len, dtype=jnp.float32)
    assert pool.bytes_per_slot() == ref.bytes_per_slot()
    assert pool.cache["k"].shape == ref.cache["k"].shape
    slots = pool.claim(3)
    assert len(slots) == 3 and pool.stats().in_use == 3
    assert pool.claim(2) is None
    pool.release(slots[:1])
    with pytest.raises(ValueError, match="double release"):
        pool.release(slots[:1])
    assert pool.stats().utilization == pytest.approx(0.5)
    assert pool.lengths().dtype == torch.int32 and pool.lengths().shape == (4,)


def test_serve_llm_cli_on_cpu(capsys):
    res = serve_llm.main(["--device", "cpu", "--n-requests", "6", "--gen-tokens", "2",
                          "--b-max", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "P_proxy" in out and "not a power measurement" in out
    assert len(res.lat_ms) == 4 and np.all(np.diff(res.lat_ms) >= 0)
    assert set(res.reports) == {"smdp", "greedy", "static_4"}
    for rep in res.reports.values():
        assert rep.n_served == 6 and np.isfinite(rep.latencies).all()
    served = sum(len(r.batch_sizes) for r in res.reports.values())
    assert res.segments == 2 * 4 + served  # profile (warm + timed) + serving
    table = res.solution.action_table(16)
    assert table[0] == 0 and table.max() <= 4
