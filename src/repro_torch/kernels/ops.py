"""Public entry points of the Bellman kernel (counterpart of repro.kernels.ops).

They cast to the kernel's f32 and move the inputs to ``device`` exactly as
the reference wrappers cast: ``h_overflow`` becomes a float32 scalar, the
arrays float32.  On a CPU device they run the plain PyTorch version; on a
CUDA device they launch the hand-written kernel or raise -- there is no
fallback from one to the other.
"""
from __future__ import annotations

import torch

from ..device import DeviceLike, resolve_device
from . import bellman as _bellman


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def bellman_backup(h_main, pmfs, tails, h_overflow, *, device: DeviceLike = None):
    """Banded RVI backup G[t, a] (see kernels/bellman.py); (T, A) float32."""
    dev = resolve_device(device)
    return _bellman.bellman_banded(
        _f32(h_main, dev), _f32(pmfs, dev), _f32(tails, dev),
        _f32(h_overflow, dev),
    )


def bellman_backup_batched(h_main, pmfs, tails, h_overflow, *,
                           device: DeviceLike = None):
    """Spec-batched banded RVI backup G[n, t, a]; (N, T, A) float32."""
    dev = resolve_device(device)
    return _bellman.bellman_banded_batched(
        _f32(h_main, dev), _f32(pmfs, dev), _f32(tails, dev),
        _f32(h_overflow, dev),
    )
