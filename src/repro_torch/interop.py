"""State carried across from the reference package.

What crosses over is the problem, the solved policy and a model's
weights.  The converters read the reference objects by duck typing --
attribute names, ``dataclasses.fields``, nested dicts of arrays -- and
never import the reference package, so this module works with or without
it.

  * ``spec_from_reference(spec)`` rebuilds a reference ``SMDPSpec`` (with
    its ``ServiceModel`` and latency / energy profile dataclasses) as the
    port's ``SMDPSpec``;
  * ``table_from_reference(result)`` turns a reference ``SolveResult``'s
    policy into the port's ``SMDPScheduler``;
  * ``params_from_reference(cfg, params)`` turns the reference's
    ``init_params`` tree (layers stacked on a leading axis) into the
    port's ``DenseLM`` (a VLM too) or, for the hybrid family, ``HybridLM``,
    for RWKV6 ``RwkvLM`` and for the encoder-decoder ``EncDecLM``;
  * ``reference_tree(cfg, tensors)`` is the reverse of
    ``params_from_reference`` for any tensors in the port's layout
    (gradients, optimizer moments) of a dense or MoE decoder: the
    reference's nested dict of numpy arrays, leaf by leaf through
    ``models.model.leaf_map``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core import profiles, service_models
from .core.smdp import SMDPSpec
from .device import DeviceLike, resolve_device
from .models.config import ModelConfig
from .models.model import (
    LM,
    DenseLM,
    EncDecLM,
    HybridLM,
    RwkvLM,
    block_norms,
    check_supported,
    gather_leaf,
    leaf_map,
    mamba_shapes,
    rwkv_shapes,
)
from .serving.scheduler import SMDPScheduler

#: port classes a reference dataclass maps to, by class name
_CLASSES = {
    cls.__name__: cls
    for cls in (
        service_models.AffineProfile,
        service_models.ConstantProfile,
        service_models.LogProfile,
        service_models.TableProfile,
        service_models.PiecewiseMaxProfile,
        service_models.ServiceModel,
        profiles.TPUEnergyProfile,
        SMDPSpec,
    )
}


def _convert(obj):
    """Rebuild a reference dataclass (recursively) as its port class."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    cls = _CLASSES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(
            f"no port counterpart for {type(obj).__module__}."
            f"{type(obj).__name__}"
        )
    kwargs = {
        f.name: _convert(getattr(obj, f.name)) for f in dataclasses.fields(obj)
    }
    return cls(**kwargs)


def spec_from_reference(spec) -> SMDPSpec:
    """The port's SMDPSpec for a reference SMDPSpec (same problem)."""
    out = _convert(spec)
    if not isinstance(out, SMDPSpec):
        raise TypeError(f"expected an SMDPSpec, got {type(spec).__name__}")
    return out


def table_from_reference(result) -> SMDPScheduler:
    """The port's SMDPScheduler on a reference SolveResult's action table."""
    return SMDPScheduler.from_table(
        np.asarray(result.action_table(), dtype=np.int64)
    )


def params_from_reference(cfg: ModelConfig, params, *,
                          device: DeviceLike = None) -> LM:
    """The port's DenseLM (HybridLM for the hybrid family, RwkvLM for
    RWKV6, EncDecLM for the encoder-decoder) holding a reference
    ``init_params`` tree.

    ``params`` is the reference's nested dict with numpy (or array-like)
    leaves.  The stacked leading L axis is split into per-layer tensors;
    wq / wk / wv (d, H|KV, hd) become the columns of ``wqkv`` (and their
    biases of ``bqkv``), wo (H, hd, d) becomes (H hd, d), w1 / w3 the two
    halves of ``w13`` (an MoE layer's stacked (E, d, ff) experts on their
    last axis, its shared expert's sw1 / sw3 of ``sw13``; ``router`` as
    it is); the hybrid's Mamba2 weights keep their names and its
    ``shared_attn`` block gets the same attention / MLP layout; an RWKV6
    layer keeps its names, wr / wk / wv / wg (d, H, P) becoming (d, H P)
    and wo (H, P, d) becoming (H P, d), every other leaf as it is; norms
    and the output matrix carry over, all in the arrays' own dtype.  An
    encoder-decoder's ``enc_blocks`` become dense layers, ``enc_pos`` and
    ``enc_final_norm`` carry over, and a decoder layer's cross-attention
    leaves x_wq / x_wk / x_wv / x_wo become ``x_wq`` (d, H hd), ``x_wkv``
    (d, 2 KV hd) and ``x_wo`` (H hd, d), with its norm ``lnx``.  (The
    reference's cross-attention reads no bias, so none is kept.)
    """
    check_supported(cfg)
    dev = resolve_device(device)
    d = cfg.d_model

    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)  # a writable copy

    def norm(tree, name):
        out = {name: t(tree["s"])}
        if "b" in tree:
            out[name + "_b"] = t(tree["b"])
        return out

    def attn_mlp(get):
        """An attention + MLP block in the port's layout; get(name) -> array."""
        b = {
            "wqkv": t(np.concatenate(
                [np.asarray(get(n)).reshape(d, -1) for n in ("wq", "wk", "wv")], axis=1)),
            "wo": t(np.asarray(get("wo")).reshape(-1, d)),
        }
        if cfg.qkv_bias:
            b["bqkv"] = t(np.concatenate(
                [np.asarray(get(n)).reshape(-1) for n in ("bq", "bk", "bv")]))
        def ffn(prefix):
            if cfg.act in ("swiglu", "geglu"):
                b[prefix + "w13"] = t(np.concatenate(
                    [get(prefix + "w1"), get(prefix + "w3")], axis=-1))
            else:
                b[prefix + "w1"] = t(get(prefix + "w1"))
            b[prefix + "w2"] = t(get(prefix + "w2"))

        ffn("")
        if cfg.n_experts:
            b["router"] = t(get("router"))
            if cfg.n_shared_experts:
                ffn("s")
        return b

    def layer_norm_of(tree, i, name):
        return norm({k: np.asarray(v)[i] for k, v in tree.items()}, name)

    def dense_layer(tree, i, norms):
        b = attn_mlp(lambda name: np.asarray(tree[name])[i])
        for n in norms:
            b.update(layer_norm_of(tree[n], i, n))
        return b

    top = {"embed": t(params["embed"]), **norm(params["final_norm"], "final_norm")}
    if not cfg.tie_embeddings:
        top["out"] = t(params["out"])
    blk = params["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        layer = lambda name: np.asarray(blk[name])[i]  # noqa: E731
        if cfg.rwkv:
            shapes = rwkv_shapes(cfg)
            b = {n: t(layer(n).reshape(shapes[n]))
                 for n in shapes if n not in ("ln1", "ln1_b", "ln2", "ln2_b")}
            for n in ("ln1", "ln2"):
                b.update(layer_norm_of(blk[n], i, n))
        elif cfg.family == "hybrid":
            b = {n: t(layer(n)) for n in mamba_shapes(cfg) if not n.startswith("ln")}
            b.update(layer_norm_of(blk["ln1"], i, "ln1"))
        elif cfg.family == "encdec":
            b = dense_layer(blk, i, ("ln1", "ln2", "lnx"))
            b["x_wq"] = t(layer("x_wq").reshape(d, -1))
            b["x_wkv"] = t(np.concatenate(
                [layer(n).reshape(d, -1) for n in ("x_wk", "x_wv")], axis=1))
            b["x_wo"] = t(layer("x_wo").reshape(-1, d))
        else:
            b = dense_layer(blk, i, block_norms(cfg))
        blocks.append(b)
    if cfg.rwkv:
        return RwkvLM(cfg, top, blocks)
    if cfg.family == "encdec":
        top.update({"enc_pos": t(params["enc_pos"]),
                    **norm(params["enc_final_norm"], "enc_final_norm")})
        enc = [dense_layer(params["enc_blocks"], i, ("ln1", "ln2"))
               for i in range(cfg.n_encoder_layers)]
        return EncDecLM(cfg, top, enc, blocks)
    if cfg.family != "hybrid":
        return DenseLM(cfg, top, blocks)
    sa = params["shared_attn"]
    shared = attn_mlp(lambda name: sa[name])
    for n in ("ln_a", "ln_m"):
        shared.update(norm(sa[n], n))
    return HybridLM(cfg, top, blocks, shared)


def reference_tree(cfg: ModelConfig, tensors: Dict[str, torch.Tensor]) -> dict:
    """The reference's nested dict of numpy arrays (its ``init_params``
    layout) holding ``tensors`` -- port-layout tensors by their
    ``named_parameters()`` names: parameters, gradients or moments."""
    tree: dict = {}
    for path, leaf in leaf_map(cfg).items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = gather_leaf(tensors, leaf).detach().float().cpu().numpy()
    return tree
