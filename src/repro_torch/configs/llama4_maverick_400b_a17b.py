"""Llama-4 Maverick 400B-A17B: 48L, d5120, 40H (GQA kv=8), d_ff 8192,
vocab 202048, MoE 128 experts top-1 interleaved on every 2nd layer
(24 MoE layers -> ~400B total / ~17B active; the assignment's flat-48-MoE
reading would be ~770B total — see DESIGN.md §7) [hf:meta-llama/Llama-4]."""

from ..models.config import ATTN, MLP, MOE, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        block_pattern=((ATTN, MLP), (ATTN, MOE)),
        num_experts=128,
        top_k=1,
        rope_theta=5e5,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="llama4-maverick-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, num_experts=8, top_k=1,
    )
