"""Analytic roofline terms per (arch x shape x mesh x knobs).

The port's counterpart of the reference's ``launch/analytic.py``, the same
arithmetic over ``models.config`` line for line (its ``Terms`` equal the
reference's with ``==``): FLOPs, HBM bytes and wire bytes per device per
step, derived from the architecture and the sharding configuration.  The
terms count work and bytes; they hold no device's rates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..models import config as C

BF16 = 2
F32 = 4

# how many forward-equivalent passes a train step costs:
#   fwd (1) + backward (2) + remat recompute (full: ~1, dots: ~0.5)
REMAT_MULT = {"none": 3.0, "dots": 3.5, "full": 4.0}

# activation read/write passes per layer per token over the residual stream
# (norms, projections in/out, residual adds, dispatch copies), empirical for
# transformer blocks; doubled-ish by backward and remat recompute
ACT_RW_PASSES = 16.0


@dataclasses.dataclass
class Terms:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    detail: Dict[str, float]


def _attn_eff_len(cfg: C.ModelConfig, mixer: str, s: int) -> float:
    """Effective KV length each query pays for (our flash computes the full
    causal square — no block skipping; banded pays ~1.5x the window)."""
    if mixer == C.ATTN:
        return float(s)
    if mixer == C.ATTN_SWA:
        return min(s, 1.5 * cfg.attn_window)
    if mixer == C.ATTN_LOCAL:
        return min(s, 1.5 * cfg.local_window)
    return 0.0


def _fwd_flops(cfg: C.ModelConfig, tokens: float, s_attn: float, decode: bool) -> Tuple[float, Dict[str, float]]:
    """Forward FLOPs for `tokens` tokens with attention span ``s_attn``."""
    d, hd = cfg.d_model, cfg.head_dim
    mm = 0.0
    attn = 0.0
    for mixer, mlp in cfg.layer_kinds:
        if mixer in (C.ATTN, C.ATTN_SWA, C.ATTN_LOCAL):
            mm += 2 * tokens * d * (cfg.num_heads + 2 * cfg.num_kv_heads + cfg.num_heads) * hd
            span = s_attn if decode else _attn_eff_len(cfg, mixer, int(s_attn))
            attn += 4 * tokens * span * cfg.num_heads * hd  # QK^T + AV
        elif mixer == C.RGLRU:
            r = cfg.rnn_dim
            mm += 2 * tokens * (2 * d * r + r * d + 2 * r * r) + tokens * r * cfg.conv_width * 2
        elif mixer == C.RWKV:
            mm += 2 * tokens * (5 * d * d + d * d)  # r,k,v,g,w-lora + out
            # chunked linear attention: intra-chunk (2 CxC matmuls per head)
            # + state update; C = 32
            attn += tokens * cfg.num_heads * (4 * 32 * hd + 6 * hd * hd)
        if mlp == C.MLP:
            mult = 3 if cfg.act == "swiglu" else 2
            mm += 2 * tokens * mult * d * cfg.d_ff
        elif mlp == C.MOE:
            mm += 2 * tokens * d * cfg.num_experts  # router
            mult = 3 if cfg.act == "swiglu" else 2
            # capacity-padded expert compute (dropping MoE computes the pad)
            mm += 2 * tokens * cfg.top_k * cfg.capacity_factor * mult * d * cfg.d_ff
        elif mlp == C.RWKV_CM:
            mm += 2 * tokens * 2 * d * cfg.d_ff + 2 * tokens * d * d
    if cfg.is_encdec:
        # decoder cross-attention projections + scores (per decoder token)
        mm += 2 * tokens * d * 2 * (cfg.num_heads + cfg.num_kv_heads) * hd
        attn += 4 * tokens * s_attn * cfg.num_heads * hd
    mm += 2 * tokens * d * cfg.vocab_size  # unembed (embed lookup is a gather)
    return mm + attn, {"matmul": mm, "attention": attn}


def _param_bytes(cfg: C.ModelConfig, dtype_bytes: int) -> float:
    return cfg.total_params() * dtype_bytes


def analytic_terms(
    cfg: C.ModelConfig,
    kind: str,               # train | prefill | decode
    seq_len: int,
    global_batch: int,
    mesh_shape: Dict[str, int],
    remat: str = "full",
    fsdp: bool = True,
    moment_dtype: str = "float32",
    serve_fsdp: bool = False,
    grad_compress: bool = False,
    kv_dedup_factor: float = 1.0,   # unique-page fraction after HPDedup-KV
    act_rules: Dict[str, str] | None = None,
) -> Terms:
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    chips = tp * dp
    P = cfg.total_params()
    mom_b = F32 if moment_dtype == "float32" else BF16
    seq_sp = (act_rules or {}).get("seq", "model") == "model"

    if kind == "train":
        dec_tokens = min(cfg.decoder_slots, 448) if cfg.is_encdec else seq_len
        tokens = global_batch * dec_tokens
        enc_tokens = global_batch * seq_len if cfg.is_encdec else 0
        fwd, detail = _fwd_flops(cfg, tokens, dec_tokens, decode=False)
        if cfg.is_encdec:  # encoder forward (bidirectional full attention)
            d, hd = cfg.d_model, cfg.head_dim
            enc_mm = 2 * enc_tokens * cfg.encoder_layers * (
                4 * d * cfg.num_heads * hd + (2 if cfg.act != "swiglu" else 3) * d * cfg.d_ff
            )
            enc_attn = 4 * enc_tokens * seq_len * cfg.num_heads * hd * cfg.encoder_layers
            fwd += enc_mm + enc_attn
            detail["encoder"] = enc_mm + enc_attn
        flops = REMAT_MULT[remat] * fwd / chips

        t_dev = (tokens + enc_tokens) / dp
        # HBM traffic: weights (fwd+bwd reads of the bf16 cast, model-sharded),
        # optimizer state (read+write p/m/v), activations (residual-stream
        # passes + saved-carry RW), flash attention re-reads K/V once in bwd.
        w_traffic = 2 * (P * BF16) / tp
        opt_traffic = 2 * (P / chips if fsdp else P / tp) * (F32 + 2 * mom_b)
        act_traffic = ACT_RW_PASSES * cfg.num_layers * t_dev * cfg.d_model * BF16
        hbm = w_traffic + opt_traffic + act_traffic

        # wire: grad sync (ring AR over dp of model-sharded grads) + FSDP
        # weight AG (fwd+bwd+remat passes) + seq-SP boundary AG/RS per layer
        # + MoE psum (2x activation bytes per MoE layer).
        # int8 + error feedback (train.compression) carries ~1 byte per
        # grad element on the wire instead of 2 (plus ~2% scales)
        grad_bytes = 1.02 if grad_compress else BF16
        grad_sync = 2 * (P * grad_bytes / tp)
        fsdp_ag = (2.5 if fsdp else 0.0) * (P * BF16 / tp)
        sp = (4.0 if seq_sp else 2.0) * cfg.num_layers * t_dev * cfg.d_model * BF16
        moe_layers = sum(1 for _, m in cfg.layer_kinds if m == C.MOE)
        moe = 2.0 * moe_layers * t_dev * cfg.d_model * BF16
        wire = grad_sync + fsdp_ag + sp + moe
        detail.update(grad_sync=grad_sync, fsdp_ag=fsdp_ag, sp=sp, moe=moe)
        return Terms(flops, hbm, wire, detail)

    if kind == "prefill":
        tokens = global_batch * seq_len
        fwd, detail = _fwd_flops(cfg, tokens, seq_len, decode=False)
        flops = fwd / chips
        t_dev = tokens / dp
        kv_layers = sum(1 for m, _ in cfg.layer_kinds if m in (C.ATTN, C.ATTN_SWA, C.ATTN_LOCAL))
        cache_write = kv_layers * t_dev * 2 * cfg.num_kv_heads * cfg.head_dim * BF16 / max(tp, 1)
        hbm = (P * BF16) / tp + ACT_RW_PASSES / 2 * cfg.num_layers * t_dev * cfg.d_model * BF16 + cache_write
        sp = (4.0 if seq_sp else 2.0) * cfg.num_layers * t_dev * cfg.d_model * BF16
        wire = sp + (P * BF16 / tp if serve_fsdp else 0.0)
        return Terms(flops, hbm, wire, detail)

    # decode: one token per sequence against a cache of seq_len
    tokens = global_batch
    span = seq_len
    for m, _ in cfg.layer_kinds:
        if m == C.ATTN_SWA:
            span = min(span, cfg.attn_window)
        if m == C.ATTN_LOCAL:
            span = min(span, cfg.local_window)
    fwd, detail = _fwd_flops(cfg, tokens, span, decode=True)
    flops = fwd / chips
    # weights read once; attention caches read once (sharded over batch/seq).
    # serve_fsdp: weights stored /chips, all-gathered over "data" per step.
    kv_layers = sum(1 for m, _ in cfg.layer_kinds if m in (C.ATTN, C.ATTN_SWA, C.ATTN_LOCAL))
    cache_bytes = kv_layers * global_batch * span * 2 * cfg.num_kv_heads * cfg.head_dim * BF16
    cache_bytes *= kv_dedup_factor  # HPDedup'd pages: unique fraction only
    if cfg.is_encdec:
        cache_bytes += cfg.num_layers * global_batch * seq_len * 2 * cfg.num_kv_heads * cfg.head_dim * BF16
    state = 0.0
    for m, _ in cfg.layer_kinds:
        if m == C.RWKV:
            state += global_batch * cfg.num_heads * cfg.head_dim**2 * F32
        if m == C.RGLRU:
            state += global_batch * cfg.rnn_dim * F32
    hbm = (P * BF16) / tp + 2 * cache_bytes / chips + 2 * state / dp  # read + where-update rewrite
    # TP all-reduce of the token activations per layer (2 per layer, ring 2x)
    wire = 4 * cfg.num_layers * tokens * cfg.d_model * BF16 / dp
    if serve_fsdp:
        wire += P * BF16 / tp  # per-step weight all-gather over "data"
    detail.update(cache_bytes_per_dev=cache_bytes / chips)
    return Terms(flops, hbm, wire, detail)
