"""AdamW (configurable moment dtype) and Adafactor (counterpart of
repro.training.optimizer).

Each update keeps the reference's arithmetic and its order, in f32 on the
parameters' device, and writes the new parameters into the model's tensors
in place (under ``torch.no_grad``); the optimizer state is a dict of
tensors on the same device, the step a 0-d int32 tensor (no host sync).

  * AdamW is elementwise apart from the global gradient norm, so it runs
    on the port's tensors as they are (fused ``wqkv``, ``w13``); only the
    order of the norm's sum differs from the reference's.
  * Adafactor factors each leaf over its last two axes and clips its
    update by the RMS over the whole leaf.  The reference's leaves are
    stacked over layers (``wq`` (L, d, H, hd), a norm (L, d)), so the
    factors and the clip depend on that layout: the update gathers each
    reference leaf from the port's tensors (``models.model.leaf_map``), updates
    it there and writes each layer's slice back.  Its state is keyed by
    the leaf's path (``blocks/wq``: ``vr`` (L, d, H), ``vc`` (L, d, hd)).

``grads`` are a dict {name: tensor} by ``params.named_parameters()`` names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch

from ..models.model import gather_leaf, leaf_map, scatter_leaf

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32  # torch.bfloat16 for huge models
    grad_clip: float = 1.0


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    """Factored second-moment optimizer (Shazeer & Stern, 2018): state of
    O(rows + cols) per matrix instead of O(rows * cols)."""

    lr: float = 1e-3
    decay: float = 0.8  # beta2 exponent schedule base (hat-beta2_t)
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


OptConfig = Union[AdamWConfig, AdafactorConfig]


def _named(params) -> Tensors:
    return dict(params.named_parameters())


def _step0(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    named = _named(params)
    zeros = {n: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
             for n, p in named.items()}
    return {"m": zeros, "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": _step0(params.device)}


def _global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over the tensors, in f32, leaf by leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


def _pow(base: float, t: torch.Tensor) -> torch.Tensor:
    """f32 ``base ** t`` (the reference's weak-typed python float ** f32)."""
    return torch.pow(torch.tensor(base, dtype=torch.float32, device=t.device), t)


@torch.no_grad()
def adamw_update(grads: Tensors, opt_state: dict, params, cfg: AdamWConfig):
    """Returns (params, new_opt_state, grad_norm); params updated in place.

    The reference's elementwise update, op for op, as ``torch._foreach_*``
    ops over all tensors at once (a few launches an op, not one a tensor:
    the step is bound by the host's launch rate)."""
    step = opt_state["step"] + 1
    t = step.float()
    gnorm = _global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    bc1, bc2 = 1 - _pow(cfg.b1, t), 1 - _pow(cfg.b2, t)
    names, ps = zip(*_named(params).items())
    ms = [opt_state["m"][n] for n in names]
    vs = [opt_state["v"][n] for n in names]
    g = torch._foreach_mul([grads[n].float() for n in names], scale)
    m_new = torch._foreach_mul([m.float() for m in ms], cfg.b1)
    torch._foreach_add_(m_new, torch._foreach_mul(g, 1 - cfg.b1))
    v_new = torch._foreach_mul([v.float() for v in vs], cfg.b2)
    gg = torch._foreach_mul(g, 1 - cfg.b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_add_(v_new, gg)
    mhat = torch._foreach_div(m_new, bc1)
    vhat = torch._foreach_div(v_new, bc2)
    den = torch._foreach_sqrt(vhat)
    torch._foreach_add_(den, cfg.eps)
    delta = torch._foreach_div(mhat, den)
    p32 = [p.float() for p in ps]  # the tensors themselves when f32
    torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    torch._foreach_mul_(delta, cfg.lr)
    torch._foreach_sub_(p32, delta)
    for p, x in zip(ps, p32):
        if x is not p:
            p.copy_(x.to(p.dtype))
    new_m = {n: x.to(m.dtype) for n, x, m in zip(names, m_new, ms)}
    new_v = {n: x.to(v.dtype) for n, x, v in zip(names, v_new, vs)}
    return params, {"m": new_m, "v": new_v, "step": step}, gnorm


def adafactor_init(params, cfg: AdafactorConfig) -> dict:
    named = _named(params)
    f = {}
    for path, leaf in leaf_map(params.cfg).items():
        shape = ((len(leaf.pieces),) if leaf.stacked else ()) + leaf.pieces[0].shape
        dev = named[leaf.pieces[0].name].device
        if len(shape) < 2:
            f[path] = {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}
        else:
            f[path] = {"vr": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                       "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                         device=dev)}
    return {"f": f, "step": _step0(params.device)}


@torch.no_grad()
def adafactor_update(grads: Tensors, opt_state: dict, params, cfg: AdafactorConfig):
    """Returns (params, new_opt_state); params updated in place."""
    step = opt_state["step"] + 1
    t = step.float()
    beta2 = 1.0 - torch.pow(t, -cfg.decay)
    named = _named(params)
    new_f = {}
    for path, leaf in leaf_map(params.cfg).items():
        g = gather_leaf(grads, leaf).float()
        p = gather_leaf(named, leaf)
        f = opt_state["f"][path]
        g2 = g * g + cfg.eps
        if g.dim() < 2:
            v = beta2 * f["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(v + cfg.eps)
            new_f[path] = {"v": v}
        else:
            vr = beta2 * f["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * f["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = torch.mean(vr, dim=-1, keepdim=True)
            u = (g * torch.rsqrt(vr / torch.clamp(denom, min=cfg.eps))[..., None]
                 * torch.rsqrt(vc)[..., None, :])
            new_f[path] = {"vr": vr, "vc": vc}
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        p_new = p.float() - cfg.lr * (u + cfg.weight_decay * p.float())
        scatter_leaf(named, leaf, p_new.to(p.dtype))
    return params, {"f": new_f, "step": step}


def opt_init(params, cfg: OptConfig) -> dict:
    if isinstance(cfg, AdafactorConfig):
        return adafactor_init(params, cfg)
    return adamw_init(params, cfg)


def opt_update(grads: Tensors, opt_state: dict, params, cfg: OptConfig):
    """Dispatch on the config's type; returns (params, opt_state, gnorm)."""
    if isinstance(cfg, AdafactorConfig):
        p, s = adafactor_update(grads, opt_state, params, cfg)
        return p, s, _global_norm(grads.values())
    return adamw_update(grads, opt_state, params, cfg)
