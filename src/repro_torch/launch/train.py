"""Training driver (the port of repro.launch.train and examples/train_100m.py).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \
        --steps 20 [--device cpu]
        (the arch's reduced() config, as the reference driver)
    PYTHONPATH=src python -m repro_torch.launch.train --example-100m [--full] \
        [--device cpu]
        (examples/train_100m.py: qwen2.5-20m for 40 steps of 4 x 128, or with
        --full qwen2.5-100m -- 12 layers, d 512, 8 / 4 heads of 64, SwiGLU
        2048, vocab 32768 -- for 300 steps of 8 x 256; AdamW at lr 6e-4,
        data seed 17, a checkpoint every max(10, steps // 5) steps)

Training runs on the card (``--device`` defaults to cuda): every attention
layer's forward through the flash kernel (twice a step under remat) and its
gradient through the hand backward kernel.  ``--dry-run`` (the reference's
lowering of the full config on the production mesh) has no counterpart
until the sharded layer is ported.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

from ..configs import ARCHS, get_config
from ..device import DeviceLike
from ..models.config import ModelConfig
from ..training.data import DataConfig
from ..training.optimizer import AdamWConfig
from ..training.train_loop import Trainer, TrainerConfig


def example_config(full: bool) -> ModelConfig:
    """examples/train_100m.py's model: the qwen2.5 family (GQA, qkv bias,
    SwiGLU) at ~100M parameters with ``full``, else ~20M."""
    base = ARCHS["qwen2.5-32b"]
    if full:
        return dataclasses.replace(
            base, name="qwen2.5-100m", n_layers=12, d_model=512, n_heads=8,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
            attn_chunk_q=256, attn_chunk_kv=256,
        )
    return dataclasses.replace(
        base, name="qwen2.5-20m", n_layers=6, d_model=320, n_heads=5,
        n_kv_heads=5, head_dim=64, d_ff=1280, vocab_size=8192,
        attn_chunk_q=128, attn_chunk_kv=128,
    )


def example_trainer(full: bool, *, steps: Optional[int] = None,
                    batch: Optional[int] = None, seq: Optional[int] = None,
                    ckpt_dir: str = "checkpoints/train_100m",
                    ckpt_every: Optional[int] = None,
                    log_fn: Callable[[str], None] = print,
                    device: DeviceLike = None) -> Trainer:
    """The example's Trainer; ``ckpt_every`` defaults to the example's
    max(10, steps // 5)."""
    cfg = example_config(full)
    steps = steps or (300 if full else 40)
    batch = batch or (8 if full else 4)
    seq = seq or (256 if full else 128)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                      seed=17)
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every or max(10, steps // 5),
                         ckpt_dir=ckpt_dir, log_every=5)
    return Trainer(cfg, data, AdamWConfig(lr=6e-4), tcfg, log_fn=log_fn, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--example-100m", action="store_true",
                    help="examples/train_100m.py's model and schedule")
    ap.add_argument("--full", action="store_true",
                    help="with --example-100m: ~100M params, 300 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--dry-run", action="store_true",
                    help="lower + compile the FULL config on the production mesh")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError(
            "--dry-run lowers the full config on the production mesh: the sharded "
            "layer is not ported yet (ROADMAP.md queue 1, item 7)")
    if args.example_100m:
        trainer = example_trainer(args.full, steps=args.steps, batch=args.batch,
                                  seq=args.seq,
                                  ckpt_dir=args.ckpt_dir or "checkpoints/train_100m",
                                  device=args.device)
        cfg, data = trainer.cfg, trainer.data
        print(f"model {cfg.name}: ~{cfg.n_params() / 1e6:.0f}M params; "
              f"{trainer.tcfg.steps} steps of {data.global_batch}x{data.seq_len} tokens")
    else:
        if not args.arch:
            ap.error("--arch or --example-100m is required")
        cfg = get_config(args.arch).reduced()
        steps, batch, seq = args.steps or 20, args.batch or 4, args.seq or 128
        print(f"[train] {args.arch} (reduced: ~{cfg.n_params() / 1e6:.1f}M params) "
              f"{steps} steps of {batch}x{seq}")
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                          seed=0)
        tcfg = TrainerConfig(steps=steps, ckpt_every=max(5, steps // 4),
                             ckpt_dir=args.ckpt_dir or "checkpoints/train", log_every=5,
                             n_micro=args.n_micro)
        trainer = Trainer(cfg, data, AdamWConfig(lr=args.lr), tcfg, device=args.device)
    _, _, losses = trainer.run(seed=0)
    if losses:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps")
    print(f"checkpoints in {trainer.tcfg.ckpt_dir} (re-run to resume from the last one)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
