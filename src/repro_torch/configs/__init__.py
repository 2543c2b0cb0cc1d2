"""Architecture configs (``get_config``); only TinyLlama-1.1B is ported."""

from .registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "get_config"]
