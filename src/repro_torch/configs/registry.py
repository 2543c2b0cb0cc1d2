"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

Every id of the reference's registry resolves, full and smoke, to the
reference's config.
"""

from __future__ import annotations

from typing import List

from ..models.config import ModelConfig
from . import (
    deepseek_67b,
    llama4_maverick_400b_a17b,
    mixtral_8x7b,
    phi3_medium_14b,
    qwen2_vl_7b,
    recurrentgemma_2b,
    rwkv6_1_6b,
    tinyllama_1_1b,
    whisper_small,
    yi_34b,
)

_MODULES = {
    "mixtral-8x7b": mixtral_8x7b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "phi3-medium-14b": phi3_medium_14b,
    "deepseek-67b": deepseek_67b,
    "yi-34b": yi_34b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "whisper-small": whisper_small,
    "rwkv6-1.6b": rwkv6_1_6b,
}

ARCH_IDS: List[str] = list(_MODULES.keys())


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = _MODULES[arch]
    return mod.smoke() if smoke else mod.full()
