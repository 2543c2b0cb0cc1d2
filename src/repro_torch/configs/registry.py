"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

Every id of the reference's registry is known; only TinyLlama-1.1B, the
dense decoder the serving path runs, is ported so far.  The others raise
``NotImplementedError`` until the rest of the model stack is ported
(ROADMAP.md, modules to port, "Model stack and training").
"""

from __future__ import annotations

from typing import List

from ..models.config import ModelConfig
from . import tinyllama_1_1b

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

_PORTED = {"tinyllama-1.1b": tinyllama_1_1b}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    if arch not in _PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: it comes with the rest of the model stack "
            f"(ROADMAP.md, modules to port, 'Model stack and training')")
    mod = _PORTED[arch]
    return mod.smoke() if smoke else mod.full()
