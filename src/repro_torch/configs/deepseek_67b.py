"""DeepSeek 67B: 95L, d8192, 64H (GQA kv=8), d_ff 22016, vocab 102400
[arXiv:2401.02954]."""

from ..models.config import ATTN, MLP, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=102400,
        block_pattern=((ATTN, MLP),),
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="deepseek-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )
