"""Restart-safe training loop (counterpart of repro.training.train_loop):
checkpoint / resume, preemption, straggler watch.

  * a checkpoint every ``ckpt_every`` steps (async, atomic, keep-last-k,
    the port's ``CheckpointManager``) holding the parameters, the optimizer
    state and the step;
  * the data is a pure function of the step (``training/data.py``), so a
    resume needs no pipeline state;
  * SIGTERM / SIGINT make the loop save synchronously and stop cleanly;
  * a per-step wall-clock watch flags straggler steps (z-score over a
    moving window).

``Trainer(..., device=None)`` trains on the card; ``device="cpu"`` runs the
kernels' plain versions.  The weights are f32 ``init_params`` from a
``torch.Generator`` on the device seeded with ``seed``, as the reference's
default dtype.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..device import DeviceLike, resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from .data import DataConfig, batch_at_step
from .optimizer import AdamWConfig, OptConfig, opt_init
from .train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_last_k: int = 3
    log_every: int = 10
    n_micro: int = 1
    straggler_window: int = 32
    straggler_zscore: float = 3.0


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        data: DataConfig,
        opt_cfg: Optional[OptConfig] = None,
        tcfg: Optional[TrainerConfig] = None,
        log_fn: Callable[[str], None] = print,
        *,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.data = data
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.log = log_fn
        self.device = resolve_device(device)
        self.manager = CheckpointManager(self.tcfg.ckpt_dir, self.tcfg.keep_last_k)
        self.step_fn = make_train_step(cfg, self.opt_cfg, remat=True,
                                       n_micro=self.tcfg.n_micro)
        self._preempted = False
        self.step_times: list = []

    def _install_signal_handlers(self):
        def handler(signum, frame):  # pragma: no cover - signal path
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread (tests)

    def init_or_restore(self, seed: int = 0):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        params = M.init_params(self.cfg, gen, torch.float32, self.device).trainable()
        opt_state = opt_init(params, self.opt_cfg)
        start = 0
        latest = self.manager.latest_step()
        if latest is not None:
            named = dict(params.named_parameters())
            state = self.manager.restore({"params": named, "opt": opt_state})
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(state["params"][n])
            opt_state = state["opt"]
            start = latest
            self.log(f"[trainer] resumed from step {start}")
        return params, opt_state, start

    def _state(self, params, opt_state) -> dict:
        return {"params": dict(params.named_parameters()), "opt": opt_state}

    def _watch_straggler(self, dt: float, step: int):
        w = self.step_times[-self.tcfg.straggler_window:]
        if len(w) >= 8:
            mu, sd = float(np.mean(w)), float(np.std(w) + 1e-9)
            if dt > mu + self.tcfg.straggler_zscore * sd:
                self.log(
                    f"[watchdog] step {step} took {dt:.3f}s "
                    f"(window mean {mu:.3f}s) -- straggler suspected"
                )
        self.step_times.append(dt)

    def run(self, seed: int = 0):
        """Train from the latest checkpoint (or from scratch) to
        ``tcfg.steps``; returns (params, opt_state, losses of the steps run)."""
        self._install_signal_handlers()
        params, opt_state, start = self.init_or_restore(seed)
        losses = []
        for step in range(start, self.tcfg.steps):
            batch = batch_at_step(self.data, step, device=self.device)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step: the step barrier
            dt = time.perf_counter() - t0
            self._watch_straggler(dt, step)
            losses.append(loss)
            if step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {step} loss {loss:.4f} ({dt:.3f}s)")
            done = step + 1
            if done % self.tcfg.ckpt_every == 0 or done == self.tcfg.steps:
                self.manager.save(done, self._state(params, opt_state), async_=True)
            if self._preempted:
                self.log(f"[trainer] preemption signal at step {done}; saving")
                self.manager.wait()
                self.manager.save(done, self._state(params, opt_state))
                break
        self.manager.wait()
        return params, opt_state, losses
