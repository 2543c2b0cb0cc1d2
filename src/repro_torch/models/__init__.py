"""Model stack of the port: the dense decoder (TinyLlama-1.1B, DeepSeek-67B,
Yi-34B, Phi-3-medium) on the training, prefill and decode paths, held
against the reference's ``repro.models``."""

from .config import ModelConfig
from .model import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
