"""Port vs reference: sliding-window and chunked-local masks, chunked
prefill (an append to a non-empty cache) and the MoE FFN -- the pieces that
serve Gemma2, Llama-4 Scout and Grok-1.

The same numpy inputs, from a seed, go through the reference and the port.
Masks: the kernels' plain versions (``attention_ref``,
``decode_attention_ref`` and the decode kernel's split mirror) against the
reference's blockwise ``flash_attention`` with ``window`` / ``chunk`` /
``q_offset`` / ``kv_len`` at 2e-5, the reference's own kernel-against-naive
bar (tests/test_models.py::test_masks_vs_naive).  MoE: ``moe_ffn`` against
the reference's at 1e-5, with the same (token, expert) pairs dropped past
capacity.  Models: prefill and decode logits of the four reduced
architectures (window 32, chunk 32, E <= 4) at atol 3e-4 (the reference's
decode-vs-forward bound), prompts of 48 and decode to 80 so that the
window binds and chunk boundaries are crossed; the reference's steps are
jitted once per architecture.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.interop import params_from_reference, reference_tree
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as PL
from repro_torch.models import model as M

TOL = dict(atol=2e-5, rtol=2e-5)
ATOL = 3e-4
LOCAL_ARCHS = ["gemma2-9b", "gemma2-27b", "llama4-scout-17b-a16e", "grok-1-314b"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The decode loops run many small torch ops: one intra-op thread keeps
    the module at its solo time beside other busy test workers (their
    OpenMP pools would spin against each other)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# --- masks --------------------------------------------------------------------

#: (Sq, Sk, causal, softcap, window, chunk): a prefill, an append (Sq < Sk:
#: q_offset = Sk - Sq), rows that see no key (Sq > Sk), non-causal windows
FLASH_CASES = [
    (64, 64, True, None, 32, None),
    (64, 64, True, None, None, 32),
    (64, 64, True, 50.0, 5, None),
    (64, 64, True, None, None, 7),
    (16, 80, True, None, 32, None),
    (16, 80, True, 30.0, None, 32),
    (48, 32, True, None, 9, None),
    (48, 32, True, None, None, 12),
    (40, 40, False, None, 13, None),
    (40, 40, False, None, None, 16),
]


@pytest.mark.parametrize("Sq,Sk,causal,cap,window,chunk", FLASH_CASES)
def test_flash_masks_match_reference(Sq, Sk, causal, cap, window, chunk):
    B, H, KV, D = 2, 4, 2, 16
    rng = np.random.default_rng(Sq * Sk + (window or 0) + (chunk or 0))
    q, k, v = _normal(rng, (B, Sq, H, D)), _normal(rng, (B, Sk, KV, D)), _normal(
        rng, (B, Sk, KV, D))
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=Sk - Sq, window=window, chunk=chunk,
                              softcap=cap, chunk_kv=16, chunk_q=16)
    mask = dict(causal=causal, softcap=cap, window=window, chunk=chunk)
    got = fa.flash_attention(*(torch.as_tensor(x) for x in (q, k, v)), **mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,chunk", [(32, None), (None, 32)])
def test_append_over_the_cache_prefix_matches_reference(window, chunk):
    """An append of S rows to a cache of ``length`` rows: the port attends
    over the buffer's prefix view, the reference over the whole buffer with
    q_offset=length, kv_len=length + S."""
    B, H, KV, D, length, S, cap_len = 2, 4, 2, 16, 40, 16, 80
    rng = np.random.default_rng(length + (window or 1))
    q = _normal(rng, (B, S, H, D))
    kbuf, vbuf = _normal(rng, (B, cap_len, KV, D)), _normal(rng, (B, cap_len, KV, D))
    want = RL.flash_attention(jnp.asarray(q), jnp.asarray(kbuf), jnp.asarray(vbuf),
                              causal=True, q_offset=length, kv_len=length + S,
                              window=window, chunk=chunk, chunk_kv=16, chunk_q=16)
    kt, vt = torch.as_tensor(kbuf), torch.as_tensor(vbuf)
    got = fa.flash_attention(torch.as_tensor(q), kt[:, :length + S], vt[:, :length + S],
                             window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


#: (window, chunk, lengths): below, at and past the window / the chunk
#: boundary, ragged, and 0 (no visible key: a uniform average of all S)
DECODE_CASES = [
    (32, None, [20, 32, 33, 96]),
    (None, 32, [1, 32, 33, 65]),
    (5, None, [0, 5, 6, 50]),
    (None, 7, [0, 7, 8, 96]),
]


@pytest.mark.parametrize("window,chunk,lengths", DECODE_CASES)
def test_decode_masks_match_reference(window, chunk, lengths):
    B, S, H, KV, D = len(lengths), 96, 8, 2, 16  # S a multiple of chunk_kv: no padding
    rng = np.random.default_rng(S + (window or 0) + (chunk or 0))
    q = _normal(rng, (B, H, D))
    kc, vc = _normal(rng, (B, S, KV, D)), _normal(rng, (B, S, KV, D))
    lens = np.array(lengths, np.int32)
    want = RL.flash_attention(jnp.asarray(q[:, None]), jnp.asarray(kc), jnp.asarray(vc),
                              causal=True, q_offset=jnp.asarray(lens - 1),
                              kv_len=jnp.asarray(lens), window=window, chunk=chunk,
                              chunk_kv=16)[:, 0]
    args = [torch.as_tensor(x) for x in (q, kc, vc, lens)]
    got = da.decode_attention(*args, window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the kernel's split-K arithmetic over the masked span, at several splits
    for n in (1, 2, 5):
        split = da.decode_attention_split_ref(*args, n, window=window, chunk=chunk)
        np.testing.assert_allclose(split.numpy(), np.asarray(want), **TOL)


def test_key_span_is_the_mask():
    """The decode kernel's key span [lo, hi) holds exactly the keys the
    plain version's mask keeps, and the planned span bounds it."""
    S = 100
    lengths = torch.arange(-1, S + 40)
    pos = torch.arange(S)
    for window, chunk in [(None, None), (1, None), (37, None), (None, 1), (None, 30)]:
        lo, hi, none = da.key_span(lengths, S, window, chunk)
        for b, n in enumerate(lengths.tolist()):
            keep = fa.visible(torch.tensor([n - 1]), pos, causal=True, window=window,
                              chunk=chunk)[0] & (pos < n)
            if none[b]:
                assert not keep.any() and (lo[b], hi[b]) == (0, S)
            else:
                assert torch.equal(keep, (pos >= lo[b]) & (pos < hi[b]))
                assert hi[b] - lo[b] <= da.span_cap(S, window, chunk)


# --- MoE ----------------------------------------------------------------------


def _moe_case(name, seed):
    """A reduced MoE config with groups of 32 (the last padded) and x
    leaning towards expert 0, so that a group overflows its capacity."""
    cfg_r = dataclasses.replace(ARCHS[name].reduced(), moe_group_size=32)
    cfg = dataclasses.replace(PARCHS[name].reduced(), moe_group_size=32)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(seed)
    lean = _normal(rng, (d,))
    p = {"router": _normal(rng, (d, E)) * 0.2,
         **{n: _normal(rng, (E, d, ff)) * 0.05 for n in ("w1", "w3")},
         "w2": _normal(rng, (E, ff, d)) * 0.05}
    p["router"][:, 0] += 0.1 * lean
    if cfg.n_shared_experts:
        p.update({n: _normal(rng, (d, ff)) * 0.05 for n in ("sw1", "sw3")})
        p["sw2"] = _normal(rng, (ff, d)) * 0.05
    x = _normal(rng, (2, 40, d)) + 0.5 * lean
    return cfg_r, cfg, p, x


def _port_moe(p):
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    out = {"router": t["router"], "w13": torch.cat([t["w1"], t["w3"]], -1), "w2": t["w2"]}
    if "sw1" in t:
        out.update(sw13=torch.cat([t["sw1"], t["sw3"]], -1), sw2=t["sw2"])
    return out


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "grok-1-314b"])
def test_moe_ffn_matches_reference(name):
    """Top-1 with a shared expert (Llama-4) and top-2 (Grok-1, geglu) at
    capacity factor 1.25, tokens dropped past capacity."""
    cfg_r, cfg, p, x = _moe_case(name, 3)
    assert cfg.moe_capacity_factor == 1.25 and cfg.top_k == (1 if "llama4" in name else 2)
    want = np.asarray(RL.moe_ffn(cfg_r, jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = PL.moe_ffn(cfg, _port_moe(p), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "grok-1-314b"])
def test_moe_drops_the_same_tokens(name):
    """The (token, expert) pairs each side keeps: the port's from its
    routing, the reference's read off its output with expert e writing only
    columns [16 e, 16 e + 16) (and no shared expert).  They are equal, and
    the port drops some, so the same pairs are dropped."""
    cfg_r, cfg, p, x = _moe_case(name, 3)
    E, d = cfg.n_experts, cfg.d_model
    w = d // E
    for e in range(E):  # expert e writes its own columns only
        p["w2"][e][:, :e * w] = 0.0
        p["w2"][e][:, (e + 1) * w:] = 0.0
    for n in ("sw1", "sw3", "sw2"):
        if n in p:
            p[n] = np.zeros_like(p[n])
    y = np.asarray(RL.moe_ffn(cfg_r, jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    T = x.shape[0] * x.shape[1]
    cols = np.abs(y.reshape(T, E, w)).max(-1)  # (token, expert)
    ref_kept = {(t, e) for t, e in zip(*np.nonzero(cols))}

    pt = _port_moe(p)
    xt = torch.as_tensor(x).reshape(T, d)
    g = cfg.moe_group_size
    xg = torch.nn.functional.pad(xt, (0, 0, 0, -T % g)).reshape(-1, g, d)
    kept, dropped = set(), set()
    for r in PL.moe_route(cfg, pt["router"], xg):
        for (G, i), e, k in zip(np.ndindex(*r.expert.shape), r.expert.reshape(-1).tolist(),
                                r.kept.reshape(-1).tolist()):
            t = G * g + i
            if t < T:
                (kept if k else dropped).add((t, e))
    assert dropped, "the case must overflow a group"
    assert kept == ref_kept
    got = PL.moe_ffn(cfg, pt, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, y, atol=1e-5, rtol=1e-5)


# --- models -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(name, capacity_factor=None):
    cfg_r, cfg = ARCHS[name].reduced(), PARCHS[name].reduced()
    if capacity_factor:
        cfg_r = dataclasses.replace(cfg_r, moe_capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    rp = RM.init_params(cfg_r, jax.random.PRNGKey(0))
    pp = params_from_reference(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    return cfg_r, cfg, rp, pp


@pytest.mark.parametrize("name", LOCAL_ARCHS)
def test_reference_tree_round_trips_the_leaves(name):
    """The MoE leaves (router, stacked experts, the shared expert) and
    Gemma2's post-block norms cross over and back unchanged, in the
    reference's leaf order."""
    _, cfg, rp, pp = _model(name)
    tree = jax.tree.map(np.asarray, rp)
    back = reference_tree(cfg, dict(pp.named_parameters()))
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(M.leaf_map(cfg)) == paths
    for want, got in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", LOCAL_ARCHS)
def test_prefill_and_decode_match_reference(name):
    """A 48-token prompt, then greedy decode to 80: past the window (32),
    across the chunk boundaries at 32 and 64."""
    cfg_r, cfg, rp, pp = _model(name)
    assert cfg.layer_pattern != "full" or cfg.n_experts
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    pre = jax.jit(functools.partial(RM.prefill, cfg_r, max_len=80, cache_dtype=jnp.float32))
    dec = jax.jit(functools.partial(RM.decode_step, cfg_r))
    lg, rcache = pre(rp, {"tokens": jnp.asarray(toks)})
    plg, pcache = M.prefill(cfg, pp, {"tokens": torch.as_tensor(toks).long()}, 80,
                            torch.float32)
    np.testing.assert_allclose(plg.numpy(), np.asarray(lg), atol=ATOL, rtol=0)
    for _ in range(80 - 48):
        tok = np.asarray(jnp.argmax(lg[:, -1], axis=-1))[:, None].astype(np.int32)
        lg, rcache = dec(rp, rcache, jnp.asarray(tok))
        plg, pcache = M.decode_step(cfg, pp, pcache, torch.as_tensor(tok).long())
        np.testing.assert_allclose(plg.numpy(), np.asarray(lg), atol=ATOL, rtol=0)
    assert pcache["length"] == 80
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(rcache["k"]), atol=ATOL)


@pytest.mark.parametrize("name", ["gemma2-9b", "llama4-scout-17b-a16e"])
def test_chunked_prefill_matches_one_shot_and_reference(name):
    """A 40-token prefill then a 16-token append: the append's logits and
    the cache equal the one-shot 56-token prefill's and the reference's
    append (its forward over the cache).  Experts drop-free (capacity
    factor E / top_k, as the reference's decode-vs-forward test raises it):
    the two paths group tokens differently."""
    E = PARCHS[name].reduced().n_experts
    cfg_r, cfg, rp, pp = _model(name, E / PARCHS[name].top_k if E else None)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 56)).astype(np.int32)
    t = torch.as_tensor(toks).long()
    _, pcache = M.prefill(cfg, pp, {"tokens": t[:, :40]}, 64, torch.float32)
    with torch.inference_mode():
        h, pcache = M.forward(cfg, pp, t[:, 40:], cache=pcache)
    got = M._unembed(cfg, pp, h).numpy()
    one, cache1 = M.prefill(cfg, pp, {"tokens": t}, 64, torch.float32)
    np.testing.assert_allclose(got[:, -1:], one.numpy(), atol=ATOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(pcache[key].numpy(), cache1[key].numpy(), atol=3e-5)
    assert pcache["length"] == cache1["length"] == 56

    _, rcache = RM.prefill(cfg_r, rp, {"tokens": jnp.asarray(toks[:, :40])}, max_len=64,
                           cache_dtype=jnp.float32)
    rh, rcache = RM.forward(cfg_r, rp, {"tokens": jnp.asarray(toks[:, 40:])}, cache=rcache)
    want = np.asarray(RM._unembed(cfg_r, rp, rh))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(rcache["k"]), atol=3e-5)
