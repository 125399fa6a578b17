"""The train step: loss, gradients, optimizer (counterpart of
repro.training.train_step)."""
from __future__ import annotations

from typing import Dict

import torch

from ..models import model as M
from ..models.config import ModelConfig
from .optimizer import OptConfig, opt_update


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *, remat: bool = True,
                    n_micro: int = 1, accum_dtype: torch.dtype = torch.float32):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}), the parameters updated in place.

    ``params`` must be ``trainable()``.  With ``n_micro`` > 1 the batch is
    cut into n_micro micro-batches along its leading axis and the gradients
    accumulate as ``acc + (g / n_micro)`` in ``accum_dtype``, micro-batch by
    micro-batch from zero -- the reference's ``lax.scan`` as a Python loop;
    the loss is their mean.
    """

    def grads_of(params, names, batch):
        loss = M.lm_loss(cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in names])
        return loss.detach(), grads

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        names = list(params.named_parameters())
        if n_micro == 1:
            loss, grads = grads_of(params, names, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} is not a multiple of n_micro {n_micro}")
            acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                   for _, p in names]
            losses = []
            for i in range(n_micro):
                mb = {k: x.reshape((n_micro, b // n_micro) + x.shape[1:])[i]
                      for k, x in batch.items()}
                loss_i, g = grads_of(params, names, mb)
                acc = [a + (gi / n_micro).to(accum_dtype) for a, gi in zip(acc, g)]
                losses.append(loss_i)
            grads, loss = acc, torch.mean(torch.stack(losses))
        named_grads = {n: g for (n, _), g in zip(names, grads)}
        params, opt_state, gnorm = opt_update(named_grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
