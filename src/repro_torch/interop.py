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
    port's ``DenseLM`` or, for the hybrid family, ``HybridLM``;
  * ``reference_tree(cfg, tensors)`` is the reverse of
    ``params_from_reference`` for any tensors in the port's layout
    (gradients, optimizer moments): the reference's nested dict of numpy
    arrays, leaf by leaf through ``models.model.leaf_map``.
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
    HybridLM,
    block_norms,
    check_supported,
    gather_leaf,
    leaf_map,
    mamba_shapes,
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
    """The port's DenseLM (HybridLM for the hybrid family) holding a
    reference ``init_params`` tree.

    ``params`` is the reference's nested dict with numpy (or array-like)
    leaves.  The stacked leading L axis is split into per-layer tensors;
    wq / wk / wv (d, H|KV, hd) become the columns of ``wqkv`` (and their
    biases of ``bqkv``), wo (H, hd, d) becomes (H hd, d), w1 / w3 the two
    halves of ``w13``; the hybrid's Mamba2 weights keep their names and its
    ``shared_attn`` block gets the same attention / MLP layout; norms and
    the output matrix carry over, all in the arrays' own dtype.
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
        if cfg.act in ("swiglu", "geglu"):
            b["w13"] = t(np.concatenate([get("w1"), get("w3")], axis=1))
        else:
            b["w1"] = t(get("w1"))
        b["w2"] = t(get("w2"))
        return b

    def layer_norm_of(tree, i, name):
        return norm({k: np.asarray(v)[i] for k, v in tree.items()}, name)

    top = {"embed": t(params["embed"]), **norm(params["final_norm"], "final_norm")}
    if not cfg.tie_embeddings:
        top["out"] = t(params["out"])
    blk = params["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        layer = lambda name: np.asarray(blk[name])[i]  # noqa: E731
        if cfg.family == "hybrid":
            b = {n: t(layer(n)) for n in mamba_shapes(cfg) if not n.startswith("ln")}
            b.update(layer_norm_of(blk["ln1"], i, "ln1"))
        else:
            b = attn_mlp(layer)
            for n in block_norms(cfg):
                b.update(layer_norm_of(blk[n], i, n))
        blocks.append(b)
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
