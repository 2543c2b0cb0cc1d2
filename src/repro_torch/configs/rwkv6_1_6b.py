"""RWKV6 "Finch" 1.6B: 24L, d2048 (32 heads x 64), attention-free with
data-dependent decay; channel-mix d_ff 7168, vocab 65536 [arXiv:2404.05892]."""

from ..models.config import RWKV, RWKV_CM, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        block_pattern=((RWKV, RWKV_CM),),
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="rwkv6-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
    )
