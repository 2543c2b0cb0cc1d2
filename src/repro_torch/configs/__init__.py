"""Architecture configs (``get_config``): every id of the reference's registry."""

from .registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "get_config"]
