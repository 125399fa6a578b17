"""Port vs reference: training the encoder-decoder (Whisper), the VLM
(Qwen2-VL), the local-mask layers (Gemma2's sliding window, Llama-4's
chunks) and the MoE families (Llama-4 Scout, Grok-1).

Each architecture's reduced config at 2 layers (Llama-4 at 4, its pattern
of three chunked layers and a global one; d 64, 4 heads of 16, vocab 512;
window and chunk 32, E <= 4), f32, on sequences of 48 tokens, so the
window and the chunk bite.  The reference's ``init_params`` tree
crosses over with ``params_from_reference`` after its constant leaves --
norm scales and biases, the qkv biases -- are drawn again from a numpy
seed, so that their gradients count; the same numpy tokens, frames and
patches go through both packages.  Bars, as tests/test_torch_training.py:

* ``lm_loss`` with and without remat: rtol 1e-5 of the reference's;
* gradients, leaf for leaf through ``interop.reference_tree``, against
  ``jax.grad`` of the reference's ``lm_loss``: rtol 1e-4, atol 1e-6;
* ``leaf_map`` round-trips the reference tree exactly, in its order;
* micro-batching splits frames and patches with the tokens: n_micro 2
  equals 1 (loss rtol 1e-5, parameters atol 2e-5);
* Adafactor, 3 updates on the VLM's and the encoder-decoder's leaves:
  parameters and factored state rtol 1e-6 of each leaf's largest entry;
* ``moe_ffn``'s gradients with tokens dropped past capacity (a dropped
  token gets no gradient through the experts): rtol 1e-4, atol 1e-6;
* the loss falls over 8 AdamW steps for a masked config and for Whisper.

The attention runs the kernels' plain versions here (CPU tensors); the
masked backward kernel is held against them in test_torch_cuda.py and
chip_smoke.py.
"""
import copy
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
from repro.training import optimizer as RO
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.interop import params_from_reference, reference_tree
from repro_torch.models import layers as PL
from repro_torch.models import model as M
from repro_torch.training import optimizer as PO
from repro_torch.training.train_step import make_train_step

ARCH_NAMES = ["whisper-small", "qwen2-vl-7b", "gemma2-9b", "gemma2-27b",
              "llama4-scout-17b-a16e", "grok-1-314b"]
B, S = 2, 48
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread keeps the module at its solo
    time beside other busy test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(name):
    """(reference, port) reduced configs: 2 layers, or one pattern of Llama-4's
    (the reference scans whole patterns)."""
    n = 4 if ARCHS[name].layer_pattern == "chunked_full" else 2
    return (dataclasses.replace(ARCHS[name].reduced(), n_layers=n),
            dataclasses.replace(PARCHS[name].reduced(), n_layers=n))


def _redraw_constants(rng, tree, layernorm):
    """Norm scales (LayerNorm 1 + N(0, 0.1), RMSNorm offsets N(0, 0.1)),
    norm biases and qkv biases (N(0, 0.1)), which the reference sets to
    constants."""
    for key, node in tree.items():
        if isinstance(node, dict):
            _redraw_constants(rng, node, layernorm)
        elif key in ("s", "b", "bq", "bk", "bv"):
            x = rng.normal(0.0, 0.1, node.shape)
            tree[key] = (x + (1.0 if key == "s" and layernorm else 0.0)).astype(np.float32)


def _batch(cfg, seed, b=B):
    """Tokens (b, S) and the family's frames / patches, numpy, from a seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)}
    for name, shape in M.input_shapes(cfg).items():
        batch[name] = rng.normal(size=(b,) + shape).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref(name):
    """(reference params (numpy), batch, the reference's loss and gradients
    on them, jitted once an architecture; without remat, which changes
    neither and compiles faster)."""
    cfg_r, cfg = _cfgs(name)
    params = jax.tree.map(np.array, RM.init_params(cfg_r, jax.random.PRNGKey(1)))
    _redraw_constants(np.random.default_rng(7), params, cfg.norm != "rmsnorm")
    batch = _batch(cfg, 3)
    vg = jax.jit(jax.value_and_grad(lambda p, b: RM.lm_loss(cfg_r, p, b, remat=False)))
    loss, grads = vg(params, jax.tree.map(jnp.asarray, batch))
    return params, batch, float(loss), jax.tree.map(np.asarray, grads)


def _port(cfg, params):
    return params_from_reference(cfg, params, device=CPU).trainable()


def _assert_trees(got, want, rtol, atol=None):
    """Leaf for leaf; ``atol=None`` means rtol of the leaf's largest |entry|."""
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        w = np.asarray(w, np.float32)
        tol = rtol * np.abs(w).max() if atol is None else atol
        np.testing.assert_allclose(g, w, rtol=rtol, atol=tol, err_msg=str(path))


def test_the_masks_bite():
    """S exceeds the reduced window and chunk, and Gemma2 / Llama-4 have
    local layers among the two."""
    for name in ARCH_NAMES:
        cfg = _cfgs(name)[1]
        for w in (cfg.sliding_window, cfg.chunk_size):
            assert w is None or w < S
    assert M._layer_is_local(_cfgs("gemma2-9b")[1], 0)
    assert M._layer_is_local(_cfgs("llama4-scout-17b-a16e")[1], 0)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_leaf_map_round_trips_the_reference_tree(name):
    params = _ref(name)[0]
    cfg = _cfgs(name)[1]
    tree = reference_tree(cfg, dict(_port(cfg, params).named_parameters()))
    assert list(M.leaf_map(cfg)) == ["/".join(str(k.key) for k in path) for path, _ in
                                   jax.tree_util.tree_flatten_with_path(params)[0]]
    _assert_trees(tree, params, rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_lm_loss_matches_reference(name, remat):
    params, batch, want, _ = _ref(name)
    cfg = _cfgs(name)[1]
    got = M.lm_loss(cfg, _port(cfg, params), _torch_batch(batch), remat=remat)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_gradients_match_jax_grad_leaf_for_leaf(name):
    params, batch, _, want = _ref(name)
    cfg = _cfgs(name)[1]
    pp = _port(cfg, params)
    loss = M.lm_loss(cfg, pp, _torch_batch(batch), remat=True)
    names = [n for n, _ in pp.named_parameters()]
    grads = torch.autograd.grad(loss, list(pp.parameters()))
    _assert_trees(reference_tree(cfg, dict(zip(names, grads))), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["whisper-small", "qwen2-vl-7b"])
def test_microbatching_splits_frames_and_patches(name):
    cfg = _cfgs(name)[1]
    opt = PO.AdamWConfig(lr=1e-3)
    p0 = M.init_params(cfg, torch.Generator().manual_seed(0), device=CPU).trainable()
    batch = _torch_batch(_batch(cfg, 5, b=4))
    assert set(batch) == {"tokens", *M.input_shapes(cfg)} and len(batch) == 2
    out = {}
    for n in (1, 2):
        p = copy.deepcopy(p0)
        p, _, m = make_train_step(cfg, opt, remat=False, n_micro=n)(p, PO.opt_init(p, opt),
                                                                   batch)
        out[n] = (float(m["loss"]), [x.detach().clone() for x in p.parameters()])
    np.testing.assert_allclose(out[1][0], out[2][0], rtol=1e-5)
    for a, b in zip(out[1][1], out[2][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("name", ["whisper-small", "qwen2-vl-7b"])
def test_adafactor_three_updates_on_the_reference_leaves(name):
    params, _, _, grads = _ref(name)
    cfg = _cfgs(name)[1]
    opt_r, opt_p = RO.AdafactorConfig(lr=1e-2), PO.AdafactorConfig(lr=1e-2)
    rp, pp = params, _port(cfg, params)
    rs, ps = RO.opt_init(rp, opt_r), PO.opt_init(pp, opt_p)
    update = jax.jit(RO.opt_update, static_argnums=3)
    for i in range(3):
        g = jax.tree.map(lambda x: x * (1 + 2 * i), grads)
        rp, rs, _ = update(g, rs, rp, opt_r)
        named = {n: p.detach() for n, p in
                 params_from_reference(cfg, g, device=CPU).named_parameters()}
        pp, ps, _ = PO.opt_update(named, ps, pp, opt_p)
    assert int(ps["step"]) == int(rs["step"]) == 3
    _assert_trees(reference_tree(cfg, dict(pp.named_parameters())), rp, rtol=1e-6)
    for path in M.leaf_map(cfg):
        node = rs["f"]
        for h in path.split("/"):
            node = node[h]
        assert sorted(ps["f"][path]) == sorted(node)
        for k, w in node.items():
            w = np.asarray(w)
            np.testing.assert_allclose(ps["f"][path][k].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "grok-1-314b"])
def test_moe_ffn_gradients_match_jax_grad_with_drops(name):
    """Groups of 32 and x leaning towards expert 0, so that a group
    overflows: the gradients to x, the router, the experts and the shared
    expert are the reference's, and a dropped (token, expert) pair passes
    none through that expert."""
    cfg_r = dataclasses.replace(ARCHS[name].reduced(), moe_group_size=32)
    cfg = dataclasses.replace(PARCHS[name].reduced(), moe_group_size=32)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(4)
    lean = rng.normal(size=(d,)).astype(np.float32)
    p = {"router": rng.normal(size=(d, E)).astype(np.float32) * 0.2,
         **{n: rng.normal(size=(E, d, ff)).astype(np.float32) * 0.05 for n in ("w1", "w3")},
         "w2": rng.normal(size=(E, ff, d)).astype(np.float32) * 0.05}
    p["router"][:, 0] += 0.1 * lean
    if cfg.n_shared_experts:
        p.update({n: rng.normal(size=(d, ff)).astype(np.float32) * 0.05
                  for n in ("sw1", "sw3")})
        p["sw2"] = rng.normal(size=(ff, d)).astype(np.float32) * 0.05
    x = rng.normal(size=(2, 40, d)).astype(np.float32) + 0.5 * lean
    dy = rng.normal(size=(2, 40, d)).astype(np.float32)

    def ref(p_, x_):
        return jnp.sum(RL.moe_ffn(cfg_r, p_, x_) * dy)

    want_p, want_x = jax.jit(jax.grad(ref, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    t = {k: torch.as_tensor(v).requires_grad_(True) for k, v in p.items()}
    pt = {"router": t["router"], "w13": torch.cat([t["w1"], t["w3"]], -1), "w2": t["w2"]}
    if cfg.n_shared_experts:
        pt.update(sw13=torch.cat([t["sw1"], t["sw3"]], -1), sw2=t["sw2"])
    xt = torch.as_tensor(x).requires_grad_(True)
    y = PL.moe_ffn(cfg, pt, xt)
    grads = torch.autograd.grad(y, [xt] + list(t.values()), torch.as_tensor(dy))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-6)
    for (k, _), g in zip(t.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    xg = torch.nn.functional.pad(torch.as_tensor(x).reshape(-1, d), (0, 0, 0, 16))
    kept = torch.stack([r.kept for r in PL.moe_route(cfg, pt["router"].detach(),
                                                     xg.reshape(-1, 32, d))])
    assert not kept.all(), "the case must overflow a group"


@pytest.mark.parametrize("name", ["gemma2-9b", "whisper-small"])
def test_loss_decreases(name):
    cfg = _cfgs(name)[1]
    opt = PO.AdamWConfig(lr=2e-3)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=CPU).trainable()
    state = PO.opt_init(params, opt)
    step = make_train_step(cfg, opt, remat=False)
    batches = [_torch_batch(_batch(cfg, s)) for s in (11, 12)]
    losses = []
    for i in range(8):
        params, state, m = step(params, state, batches[i % 2])
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert losses[-1] < losses[0], losses
