"""Qwen2-VL 7B backbone: 28L, d3584, 28H (GQA kv=4), d_ff 18944,
vocab 152064, M-RoPE sections (16, 24, 24) over head_dim/2
[arXiv:2409.12191].  Vision frontend is a stub: the VLM input path takes
precomputed patch embeddings (B, S, d)."""

from ..models.config import ATTN, MLP, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        block_pattern=((ATTN, MLP),),
        mrope_sections=(16, 24, 24),
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2-vl-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, mrope_sections=(2, 3, 3),
    )
