"""RecurrentGemma 2B (Griffin): 26L, d2560, 10H (MQA kv=1, head_dim 256),
d_ff 7680, vocab 256000; RG-LRU + local attention in a 2:1 pattern with
window 2048 [arXiv:2402.19427].  26 = 8 full (R,R,A) groups + 2 remainder
recurrent layers (handled unrolled)."""

from ..models.config import ATTN_LOCAL, MLP, RGLRU, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        block_pattern=((RGLRU, MLP), (RGLRU, MLP), (ATTN_LOCAL, MLP)),
        local_window=2048,
        rnn_width=2560,
        conv_width=4,
        act="gelu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="recurrentgemma-smoke",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, rnn_width=64, local_window=32,
    )
