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


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if, under grad mode, a tensor bound for a CUDA kernel without a
    backward requires grad: its output would carry no ``grad_fn`` and the
    gradient would be dropped in silence.  (On the CPU the plain versions
    stay differentiable by autograd.)"""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{kernel}: a CUDA tensor that requires grad reached a kernel with no "
            "backward; run it under torch.no_grad() or detach the inputs")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    n = _n_sm.get(device.index)
    if n is None:
        n = _n_sm[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n
