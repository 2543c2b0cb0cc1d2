"""Model configuration covering all ten assigned architectures (verbatim from
the reference).

One ``ModelConfig`` describes any member of the zoo: dense llama-family,
MoE (mixtral / llama4), M-RoPE VLM backbone (qwen2-vl), RG-LRU hybrid
(recurrentgemma), encoder–decoder (whisper) and RWKV6.  The per-layer
structure is a repeating ``block_pattern`` of (mixer, mlp) kinds, which the
transformer assembles with scan-over-groups so HLO size is O(pattern), not
O(layers).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# mixer kinds
ATTN = "attn"          # causal full attention
ATTN_SWA = "attn_swa"  # sliding-window causal attention
ATTN_LOCAL = "attn_local"  # local attention (recurrentgemma flavour)
RGLRU = "rglru"        # RG-LRU recurrent block
RWKV = "rwkv"          # RWKV6 time-mix

# mlp kinds
MLP = "mlp"
MOE = "moe"
RWKV_CM = "rwkv_cm"    # RWKV channel-mix


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[Tuple[str, str], ...] = ((ATTN, MLP),)
    # attention
    attn_window: int = 0             # sliding window for ATTN_SWA
    local_window: int = 2048         # window for ATTN_LOCAL
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (sums to head_dim//2)
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # recurrent blocks
    rnn_width: int = 0               # RG-LRU width (defaults to d_model)
    conv_width: int = 4              # temporal conv in RG blocks
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0             # frame positions (stub frontend output)
    decoder_slots: int = 448         # decoder self-attention cache slots
    # misc
    norm_eps: float = 1e-6
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    embed_inputs: bool = True        # False => input_specs provide embeddings (stubs)
    max_seq_len: int = 1_048_576
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Per-layer (mixer, mlp) kinds, pattern tiled over num_layers."""
        p = self.block_pattern
        reps = -(-self.num_layers // len(p))
        return (p * reps)[: self.num_layers]

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def scan_groups(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def remainder_kinds(self) -> Tuple[Tuple[str, str], ...]:
        return self.layer_kinds[self.scan_groups * self.pattern_period :]

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """True when decoding state is bounded (long_500k eligibility)."""
        kinds = {m for m, _ in self.layer_kinds}
        return ATTN not in kinds  # only windowed/recurrent mixers

    def active_params_per_token_matmul(self) -> int:
        """Approximate active parameter count N for MODEL_FLOPS = 6*N*D."""
        n = 0
        d, hd = self.d_model, self.head_dim
        for mixer, mlp in self.layer_kinds:
            if mixer in (ATTN, ATTN_SWA, ATTN_LOCAL):
                n += d * self.num_heads * hd  # q
                n += 2 * d * self.num_kv_heads * hd  # k, v
                n += self.num_heads * hd * d  # o
            elif mixer == RGLRU:
                r = self.rnn_dim
                n += 2 * d * r + r * d  # two in-branches + out
                n += self.conv_width * r + 2 * r  # conv + gates (depthwise-ish)
            elif mixer == RWKV:
                n += 4 * d * d + d * d  # r,k,v,g + output
            if mlp == MLP:
                mult = 3 if self.act == "swiglu" else 2
                n += mult * d * self.d_ff
            elif mlp == MOE:
                n += d * self.num_experts  # router
                n += self.top_k * 3 * d * self.d_ff  # active experts only
            elif mlp == RWKV_CM:
                n += 2 * d * self.d_ff
        if self.is_encdec:
            # decoder cross-attention (self-attn counted above via layer_kinds)
            n += self.num_layers * (2 * d * self.num_kv_heads * hd + 2 * d * self.num_heads * hd)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return n

    def total_params(self) -> int:
        """Total parameter count (MoE counts all experts)."""
        n = self.active_params_per_token_matmul()
        for mixer, mlp in self.layer_kinds:
            if mlp == MOE:
                n += (self.num_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
