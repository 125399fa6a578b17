"""Deterministic synthetic token pipeline (counterpart of
repro.training.data): seeded, restart-safe.

The batch is a pure function of (seed, step): a resumed run at step N sees
exactly the batches the interrupted run would have seen, with no pipeline
state to keep beyond the step counter.  The law is the reference's: a
Zipf(``zipf_a``) marginal over the vocabulary, then with probability 0.5
token t + 1 is replaced by (token t + 1) mod V (from the Zipf draw of
position t; the first position from the last, as ``jnp.roll`` wraps).

The draws come from the port's own generator (a ``torch.Generator`` on the
CPU seeded from (seed, step)), then the batch moves to ``device``: the same
batch on any device.  ``jax.random`` cannot be replayed here, so the
tokens equal the reference's in distribution, not draw for draw.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of (seed, step).  Its Mersenne twister keeps 32 bits
    of a seed, so the pair is mixed into 32 bits by numpy's SeedSequence."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0]))
    return g


def zipf_probs(vocab_size: int, zipf_a: float) -> torch.Tensor:
    """The Zipf marginal (f64): rank^-a over ranks 1..V, normalised."""
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float64)
    probs = ranks ** (-zipf_a)
    return probs / probs.sum()


def batch_at_step(cfg: DataConfig, step: int, *, device: DeviceLike = None) -> dict:
    """Batch for ``step``: {"tokens": (global_batch, seq_len) int32} on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    g = _generator(cfg.seed, step)
    shape = (cfg.global_batch, cfg.seq_len)
    cdf = torch.cumsum(zipf_probs(cfg.vocab_size, cfg.zipf_a), 0)
    u = torch.rand(shape, generator=g, dtype=torch.float64)
    toks = torch.clamp(torch.searchsorted(cdf, u, right=True), max=cfg.vocab_size - 1)
    rep = torch.rand(shape, generator=g, dtype=torch.float64) < 0.5
    shifted = torch.roll(toks, 1, dims=1) + 1
    toks = torch.where(rep, shifted % cfg.vocab_size, toks)
    return {"tokens": toks.to(torch.int32).to(dev)}


class DataIterator:
    def __init__(self, cfg: DataConfig, start_step: int = 0, *,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def __next__(self) -> dict:
        b = batch_at_step(self.cfg, self.step, device=self.device)
        self.step += 1
        return b
