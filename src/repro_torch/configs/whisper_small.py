"""Whisper-small: 12L encoder + 12L decoder, d768, 12H (kv=12), d_ff 3072,
vocab 51865, GELU, tied embeddings [arXiv:2212.04356].  The conv audio
frontend is a stub: input specs provide precomputed frame embeddings
(B, frames, d).  Deviation recorded in DESIGN.md: decoder self-attention
uses RoPE instead of learned absolute positions."""

from ..models.config import ATTN, MLP, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        block_pattern=((ATTN, MLP),),
        encoder_layers=12,
        act="gelu",
        tie_embeddings=True,
        embed_inputs=False,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="whisper-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, encoder_layers=2,
    )
