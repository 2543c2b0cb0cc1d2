"""TinyLlama 1.1B: 22L, d2048, 32H (GQA kv=4), d_ff 5632, vocab 32000
[arXiv:2401.02385]."""

from ..models.config import ATTN, MLP, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32000,
        block_pattern=((ATTN, MLP),),
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="tinyllama-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )
