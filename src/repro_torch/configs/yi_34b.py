"""Yi 34B: 60L, d7168, 56H (GQA kv=8), d_ff 20480, vocab 64000
[arXiv:2403.04652]."""

from ..models.config import ATTN, MLP, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        block_pattern=((ATTN, MLP),),
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="yi-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
    )
