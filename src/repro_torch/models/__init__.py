"""The model stack of the port, dense and hybrid families (counterpart of
repro.models).

``config`` is a copy of the reference's schema; ``layers`` and ``model``
run the dense decoder and the Mamba2 hybrid, their attention and SSD scan
on the hand-written kernels.
"""
from .config import ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    DenseLM,
    HybridLM,
    decode_step,
    forward,
    forward_hybrid,
    forward_lm,
    init_cache,
    init_params,
    lm_loss,
    prefill,
)
