"""Model stack of the port: the dense decoder the serving path runs
(TinyLlama-1.1B), held against the reference's ``repro.models``."""

from .config import ModelConfig
from .model import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
