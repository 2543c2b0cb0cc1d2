"""Model stack of the port: every architecture of the registry (dense,
MoE, M-RoPE, RG-LRU hybrid, RWKV6 and encoder-decoder) on the training,
prefill and decode paths, held against the reference's ``repro.models``."""

from .config import ModelConfig
from .model import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
