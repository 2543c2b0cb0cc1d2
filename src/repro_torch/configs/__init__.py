"""Architecture configs (``get_config``): every id of the reference's
registry, and the assigned input shapes."""

from .registry import ARCH_IDS, get_config
from .shapes import SHAPES, SMOKE_SHAPES, ShapeSpec

__all__ = ["ARCH_IDS", "get_config", "SHAPES", "SMOKE_SHAPES", "ShapeSpec"]
