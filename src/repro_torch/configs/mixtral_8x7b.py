"""Mixtral 8x7B: 32L, d4096, 32H (GQA kv=8), d_ff 14336, MoE 8e top-2,
sliding-window attention 4096 [arXiv:2401.04088]."""

from ..models.config import ATTN_SWA, MOE, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        block_pattern=((ATTN_SWA, MOE),),
        attn_window=4096,
        num_experts=8,
        top_k=2,
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="mixtral-8x7b-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, num_experts=4, top_k=2, attn_window=32,
    )
