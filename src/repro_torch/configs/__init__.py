"""Architecture configs (``get_config``); the four dense decoders are ported."""

from .registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "get_config"]
