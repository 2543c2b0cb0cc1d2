"""Phi-3-medium 14B: 40L, d5120, 40H (GQA kv=10), d_ff 17920, vocab 100352,
RoPE + SwiGLU [arXiv:2404.14219]."""

from ..models.config import ATTN, MLP, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        block_pattern=((ATTN, MLP),),
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="phi3-medium-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )
