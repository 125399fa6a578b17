"""The model stack of the port, dense, MoE, hybrid and RWKV6 families
(counterpart of repro.models).

``config`` is a copy of the reference's schema; ``layers`` and ``model``
run the dense and MoE decoders, the Mamba2 hybrid and RWKV6, their
attention, SSD scan and WKV6 scan on the hand-written kernels.
"""
from .config import ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    DenseLM,
    HybridLM,
    RwkvLM,
    decode_step,
    forward,
    forward_hybrid,
    forward_lm,
    forward_rwkv,
    init_cache,
    init_params,
    lm_loss,
    prefill,
)
