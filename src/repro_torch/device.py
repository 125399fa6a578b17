"""The one device rule of the port: ``None`` means CUDA, and CUDA must exist."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]
_n_sm = {}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises.

    There is no silent CPU fallback: the plain PyTorch versions of the
    kernels run only when the caller asks for ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    n = _n_sm.get(device.index)
    if n is None:
        n = _n_sm[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n
