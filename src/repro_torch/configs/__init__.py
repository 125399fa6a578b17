"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

from ..models.config import ModelConfig

from .qwen2_5_32b import CONFIG as qwen2_5_32b
from .command_r_plus_104b import CONFIG as command_r_plus_104b
from .gemma2_9b import CONFIG as gemma2_9b
from .gemma2_27b import CONFIG as gemma2_27b
from .whisper_small import CONFIG as whisper_small
from .zamba2_1_2b import CONFIG as zamba2_1_2b
from .grok_1_314b import CONFIG as grok_1_314b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .rwkv6_3b import CONFIG as rwkv6_3b
from .qwen2_vl_7b import CONFIG as qwen2_vl_7b

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen2_5_32b,
        command_r_plus_104b,
        gemma2_9b,
        gemma2_27b,
        whisper_small,
        zamba2_1_2b,
        grok_1_314b,
        llama4_scout_17b_a16e,
        rwkv6_3b,
        qwen2_vl_7b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]
