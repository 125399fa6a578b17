"""The model stack of the port, dense subset (counterpart of repro.models).

``config`` is a copy of the reference's schema; ``layers`` and ``model``
run the dense decoder with its attention on the hand-written kernels.
"""
from .config import ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    DenseLM,
    decode_step,
    forward_lm,
    init_cache,
    init_params,
    prefill,
)
