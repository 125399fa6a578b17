"""Port vs reference: training (lm_loss, its gradients, AdamW, Adafactor,
micro-batching, the restart-safe Trainer, the data pipeline).

A 2-layer reduced Qwen2.5 config (d 64, 4 / 2 heads of 16, vocab 512), f32.
The reference's ``init_params`` tree crosses over with
``params_from_reference``; the same numpy tokens go through both packages;
the port's tensors go back to the reference's leaves with
``interop.reference_tree``.  Bars:

* ``lm_loss`` with and without remat: rtol 1e-5 of the reference's;
* gradients, leaf for leaf, against ``jax.grad`` of the reference's
  ``lm_loss``: rtol 1e-4, atol 1e-6;
* AdamW, 3 updates on shared gradients: parameters and moments rtol 1e-6
  (each leaf's absolute bar 1e-6 of its largest entry: an updated weight
  p - lr u that cancels to near zero keeps the rounding of lr u, a large
  share of a tiny result); with bf16 moments, the moments within one bf16
  ulp;
* Adafactor, 3 updates on the reference's stacked leaves: parameters and
  factored state rtol 1e-6 (the same absolute bar); the state factored
  (n_s < 0.2 n_p, the reference test's bar);
* micro-batching: n_micro 2 equals 1 (loss rtol 1e-5, parameters atol
  2e-5, the reference test's bars);
* Trainer: a run stopped at step 3 and resumed equals the uninterrupted
  6-step run (losses rtol 1e-6, parameters atol 1e-6, the reference's);
* the loss falls over 8 steps for AdamW, AdamW with bf16 moments and
  Adafactor (the reference test's learning rates);
* data: a pure function of (seed, step); over 65 536 tokens the Zipf
  marginal (the five most common tokens' shares) and the rate of t + 1 =
  (t + 1) mod V within 0.02 of the reference's (another generator: in
  distribution).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import model as RM
from repro.training import data as RD
from repro.training import optimizer as RO
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.interop import params_from_reference, reference_tree
from repro_torch.launch import train as ptrain
from repro_torch.models import model as M
from repro_torch.training import data as PD
from repro_torch.training import optimizer as PO
from repro_torch.training.train_loop import Trainer, TrainerConfig
from repro_torch.training.train_step import make_train_step

CFG_R = dataclasses.replace(ARCHS["qwen2.5-32b"].reduced(), n_layers=2)
CFG = dataclasses.replace(PARCHS["qwen2.5-32b"].reduced(), n_layers=2)
DATA = PD.DataConfig(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4, seed=3)
CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """Reference params (numpy tree), tokens, and the reference's loss and
    gradients on them (jitted once)."""
    params = jax.tree.map(np.asarray, RM.init_params(CFG_R, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (4, 32)).astype(np.int32)
    vg = jax.jit(jax.value_and_grad(
        lambda p, t: RM.lm_loss(CFG_R, p, {"tokens": t}, remat=True)))
    loss, grads = vg(params, jnp.asarray(toks))
    return params, toks, float(loss), jax.tree.map(np.asarray, grads)


def _port(params):
    return params_from_reference(CFG, params, device=CPU).trainable()


def _named_grads(tree):
    """A reference-layout tree (gradients) as the port's {name: tensor}."""
    return {n: p.detach() for n, p in params_from_reference(CFG, tree, device=CPU)
            .named_parameters()}


def _assert_trees(got, want, rtol, atol=None):
    """Leaf for leaf; ``atol=None`` means rtol of the leaf's largest |entry|
    (an updated weight is p - lr * u: where that cancels to near zero, one
    rounding of lr * u is a large share of the result)."""
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        w = np.asarray(w, np.float32)
        tol = rtol * np.abs(w).max() if atol is None else atol
        np.testing.assert_allclose(g, w, rtol=rtol, atol=tol, err_msg=str(path))


def test_leaf_map_round_trips_the_reference_tree(ref):
    params = ref[0]
    tree = reference_tree(CFG, dict(_port(params).named_parameters()))
    assert list(M.leaf_map(CFG)) == ["/".join(str(k.key) for k in path) for path, _ in
                                   jax.tree_util.tree_flatten_with_path(params)[0]]
    _assert_trees(tree, params, rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_matches_reference(ref, remat):
    params, toks, want, _ = ref
    got = M.lm_loss(CFG, _port(params), {"tokens": torch.as_tensor(toks)}, remat=remat)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)


def test_gradients_match_jax_grad_leaf_for_leaf(ref):
    params, toks, _, want = ref
    pp = _port(params)
    loss = M.lm_loss(CFG, pp, {"tokens": torch.as_tensor(toks)}, remat=True)
    names = [n for n, _ in pp.named_parameters()]
    grads = torch.autograd.grad(loss, list(pp.parameters()))
    _assert_trees(reference_tree(CFG, dict(zip(names, grads))), want, rtol=1e-4, atol=1e-6)


def _updates(ref, opt_r, opt_p, n=3):
    """n updates with the reference's gradients scaled by 1, 3, 5, ... on
    both sides; returns (ref params, ref state, port params, port state)."""
    params, _, _, grads = ref
    rp, pp = params, _port(params)
    rs, ps = RO.opt_init(rp, opt_r), PO.opt_init(pp, opt_p)
    update = jax.jit(RO.opt_update, static_argnums=3)
    for i in range(n):
        g = jax.tree.map(lambda x: x * (1 + 2 * i), grads)
        rp, rs, _ = update(g, rs, rp, opt_r)
        pp, ps, _ = PO.opt_update(_named_grads(g), ps, pp, opt_p)
    assert int(ps["step"]) == int(rs["step"]) == n
    return rp, rs, pp, ps


def test_adamw_three_updates_match(ref):
    rp, rs, pp, ps = _updates(ref, RO.AdamWConfig(lr=1e-3), PO.AdamWConfig(lr=1e-3))
    _assert_trees(reference_tree(CFG, dict(pp.named_parameters())), rp, rtol=1e-6)
    for k in ("m", "v"):
        _assert_trees(reference_tree(CFG, ps[k]), rs[k], rtol=1e-6)


def test_adamw_bf16_moments_within_one_ulp(ref):
    rp, rs, pp, ps = _updates(ref, RO.AdamWConfig(lr=1e-3, moment_dtype=jnp.bfloat16),
                              PO.AdamWConfig(lr=1e-3, moment_dtype=torch.bfloat16))
    for k in ("m", "v"):
        assert all(x.dtype == torch.bfloat16 for x in ps[k].values())
        got = jax.tree.leaves(reference_tree(CFG, ps[k]))
        for g, w in zip(got, jax.tree.leaves(rs[k])):
            w = np.asarray(w, np.float32)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-38))) - 7)
            assert (np.abs(g - w) <= ulp).all()


def test_adafactor_three_updates_on_the_reference_leaves(ref):
    rp, rs, pp, ps = _updates(ref, RO.AdafactorConfig(lr=1e-2), PO.AdafactorConfig(lr=1e-2))
    _assert_trees(reference_tree(CFG, dict(pp.named_parameters())), rp, rtol=1e-6)
    for path, leaf in M.leaf_map(CFG).items():
        node = rs["f"]
        for h in path.split("/"):
            node = node[h]
        assert sorted(ps["f"][path]) == sorted(node)
        for k, w in node.items():
            w = np.asarray(w)
            np.testing.assert_allclose(ps["f"][path][k].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=f"{path}/{k}")
    n_p = sum(p.numel() for p in pp.parameters())
    n_s = sum(x.numel() for f in ps["f"].values() for x in f.values())
    assert n_s < 0.2 * n_p


def test_microbatching_matches_the_full_batch():
    opt = PO.AdamWConfig(lr=1e-3)
    p0 = M.init_params(CFG, torch.Generator().manual_seed(0), device=CPU).trainable()
    batch = PD.batch_at_step(DATA, 0, device=CPU)
    out = {}
    for n in (1, 2):
        p = copy.deepcopy(p0)
        p, _, m = make_train_step(CFG, opt, remat=False, n_micro=n)(p, PO.opt_init(p, opt),
                                                                   batch)
        out[n] = (float(m["loss"]), [x.detach().clone() for x in p.parameters()])
    np.testing.assert_allclose(out[1][0], out[2][0], rtol=1e-5)
    for a, b in zip(out[1][1], out[2][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_trainer_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Stopped at step 3 and restarted, the run lands where a straight
    6-step run lands (checkpoint + step-indexed data)."""
    opt = PO.AdamWConfig(lr=1e-3)

    def trainer(steps, every, d):
        return Trainer(CFG, DATA, opt, TrainerConfig(steps=steps, ckpt_every=every,
                                                     ckpt_dir=str(tmp_path / d),
                                                     log_every=100),
                       log_fn=lambda s: None, device=CPU)

    p_all, _, losses_all = trainer(6, 100, "a").run(seed=0)
    trainer(3, 3, "b").run(seed=0)
    p_res, opt_res, losses_res = trainer(6, 3, "b").run(seed=0)
    assert len(losses_res) == 3 and int(opt_res["step"]) == 6
    np.testing.assert_allclose(losses_all[3:], losses_res, rtol=1e-6)
    for a, b in zip(p_all.parameters(), p_res.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("opt", [PO.AdamWConfig(lr=2e-3),
                                 PO.AdamWConfig(lr=2e-3, moment_dtype=torch.bfloat16),
                                 PO.AdafactorConfig(lr=2e-2)],
                         ids=["adamw", "adamw_bf16", "adafactor"])
def test_loss_decreases(opt):
    params = M.init_params(CFG, torch.Generator().manual_seed(0), device=CPU).trainable()
    state = PO.opt_init(params, opt)
    step = make_train_step(CFG, opt, remat=False)
    losses = []
    for i in range(8):
        params, state, m = step(params, state, PD.batch_at_step(DATA, i % 2, device=CPU))
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert losses[-1] < losses[0], losses


def test_data_is_a_pure_function_of_seed_and_step():
    a = PD.batch_at_step(DATA, 5, device=CPU)["tokens"]
    assert a.dtype == torch.int32 and a.shape == (4, 32)
    assert torch.equal(a, PD.batch_at_step(DATA, 5, device=CPU)["tokens"])
    assert not torch.equal(a, PD.batch_at_step(DATA, 6, device=CPU)["tokens"])
    other = dataclasses.replace(DATA, seed=4)
    assert not torch.equal(a, PD.batch_at_step(other, 5, device=CPU)["tokens"])
    it = PD.DataIterator(DATA, start_step=5, device=CPU)
    assert torch.equal(next(it)["tokens"], a) and it.step == 6


def test_data_law_matches_the_reference():
    V, B, S = CFG.vocab_size, 64, 1024
    got = PD.batch_at_step(PD.DataConfig(V, S, B, seed=1), 0, device=CPU)["tokens"].numpy()
    want = np.asarray(RD.batch_at_step(RD.DataConfig(V, S, B, seed=1), 0)["tokens"])

    def stats(t):
        share = np.bincount(t.ravel(), minlength=V) / t.size
        shift = np.mean(t[:, 1:] == (t[:, :-1] + 1) % V)
        return np.sort(share)[::-1][:5], shift

    (sg, rg), (sw, rw) = stats(got), stats(want)
    np.testing.assert_allclose(sg, sw, atol=0.02)
    assert abs(rg - rw) < 0.02


def test_what_is_not_ported_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ptrain.main(["--arch", "qwen2.5-32b", "--dry-run"])
    hcfg = PARCHS["zamba2-1.2b"].reduced()
    hp = M.init_params(hcfg, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(NotImplementedError, match="SSD"):
        M.lm_loss(hcfg, hp, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
