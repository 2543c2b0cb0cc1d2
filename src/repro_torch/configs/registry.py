"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

Every id of the reference's registry is known; the four dense ``(ATTN, MLP)``
decoders (TinyLlama-1.1B, DeepSeek-67B, Yi-34B, Phi-3-medium) are ported.
The others raise ``NotImplementedError`` until their block kinds are ported
(ROADMAP.md, modules to port, "The other block kinds").
"""

from __future__ import annotations

from typing import List

from ..models.config import ModelConfig
from . import deepseek_67b, phi3_medium_14b, tinyllama_1_1b, yi_34b

ARCH_IDS: List[str] = [
    "mixtral-8x7b",
    "llama4-maverick-400b-a17b",
    "qwen2-vl-7b",
    "tinyllama-1.1b",
    "phi3-medium-14b",
    "deepseek-67b",
    "yi-34b",
    "recurrentgemma-2b",
    "whisper-small",
    "rwkv6-1.6b",
]

_PORTED = {
    "tinyllama-1.1b": tinyllama_1_1b,
    "phi3-medium-14b": phi3_medium_14b,
    "deepseek-67b": deepseek_67b,
    "yi-34b": yi_34b,
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    if arch not in _PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: it comes with its block kinds "
            f"(ROADMAP.md, modules to port, 'The other block kinds')")
    mod = _PORTED[arch]
    return mod.smoke() if smoke else mod.full()
