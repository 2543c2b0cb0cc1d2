"""Whisper-style encoder-decoder (arXiv:2212.04356) on the shared layers.

The port's counterpart of the reference's ``models/encdec.py``.  The conv
audio front end is a stub, as there: the encoder takes frame embeddings (B,
S_enc, d), adds the sinusoidal position table and runs bidirectional
attention layers.  The decoder is causal (RoPE, as the reference's), with a
cross-attention layer per block whose K/V over the encoder states are
computed once by ``encode_prefill`` and cached.  Embeddings are tied.
Parameters take the reference's layout::

    {"embed": (V, d), "enc_final_ln", "dec_final_ln": (d,),
     "enc_scan": {"ln1", "attn", "ln2", "mlp"},                # each (L_enc, ...)
     "dec_scan": {"ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"}}

``encode`` and ``train_loss`` take the reference's ``remat``: ``"full"`` and
``"dots"`` alike recompute each encoder and decoder layer from its input in
the backward pass, as the reference's encoder-decoder does.

The decode cache is the reference's dictionary: ``self_k``/``self_v``
(layers, B, slots, KVH, hd) and ``cross_k``/``cross_v`` (layers, B, S_enc,
KVH, hd).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..act_sharding import (RESIDUAL, block_input, fsdp_gather, local_sum, sequence_parallel,
                            shard_act, split_sequence)
from . import config as C
from .attention import (attention_decode, attention_train, cross_attention_decode,
                        init_attention, project_kv, valid_slots)
from .layers import (ParamFactory, dtype_const, init_mlp, map_dict, mlp_apply, rms_norm,
                     rms_norm_in, rope_angles, sequence_whole, sinusoidal_positions,
                     token_losses)
from .transformer import check_remat, default_positions, lookup, remat_call, unstack
from .vocab import plan_ce, vocab_ce_sum


def _enc_layer_init(pf: ParamFactory, cfg: C.ModelConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": pf.zeros((d,), ("embed",)),
            "attn": init_attention(pf, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
            "ln2": pf.zeros((d,), ("embed",)),
            "mlp": init_mlp(pf, d, cfg.d_ff, cfg.act)}


def _dec_layer_init(pf: ParamFactory, cfg: C.ModelConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": pf.zeros((d,), ("embed",)),
            "self_attn": init_attention(pf, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
            "ln_x": pf.zeros((d,), ("embed",)),
            "cross_attn": init_attention(pf, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
            "ln2": pf.zeros((d,), ("embed",)),
            "mlp": init_mlp(pf, d, cfg.d_ff, cfg.act)}


def encdec_tree(pf, cfg: C.ModelConfig) -> Dict:
    """The parameter tree that ``pf`` makes (``transformer.decoder_tree``)."""
    d = cfg.d_model
    return {"embed": pf.embedding((cfg.vocab_size, d), ("vocab", "embed")),
            "enc_final_ln": pf.zeros((d,), ("embed",)),
            "dec_final_ln": pf.zeros((d,), ("embed",)),
            "enc_scan": pf.stack(lambda: _enc_layer_init(pf, cfg), cfg.encoder_layers),
            "dec_scan": pf.stack(lambda: _dec_layer_init(pf, cfg), cfg.num_layers)}


def init_encdec_params(generator: torch.Generator, cfg: C.ModelConfig) -> Dict:
    return encdec_tree(ParamFactory(generator, getattr(torch, cfg.param_dtype)), cfg)


def cast_params(params: Dict, cfg: C.ModelConfig) -> Dict:
    """Every weight but the two final norms in the compute dtype."""
    dt = getattr(torch, cfg.compute_dtype)
    return {k: v if k.endswith("final_ln") else map_dict(lambda t: t.to(dt), v)
            for k, v in params.items()}


def _layers(stack: Dict, n: int, cfg: C.ModelConfig) -> List[Dict]:
    return unstack(stack, n, getattr(torch, cfg.compute_dtype))


def _mlp(p: Dict, h: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    return mlp_apply(h, p["w_in"], p.get("w_gate"), p["w_out"], cfg.act)


def _layer_remat(remat: str) -> str:
    """The encoder-decoder's policy for a layer: "dots" recomputes it whole."""
    check_remat(remat)
    return "none" if remat == "none" else "full"


def _enc_layer(lp: Dict, cfg: C.ModelConfig, x: torch.Tensor) -> torch.Tensor:
    lp = map_dict(fsdp_gather, lp)
    x = shard_act(x, RESIDUAL)
    h = rms_norm_in(x, lp["ln1"], cfg.norm_eps)
    x = x + shard_act(attention_train(lp["attn"], h, None, causal=False, use_rope=False)[0],
                      RESIDUAL)
    h = rms_norm_in(x, lp["ln2"], cfg.norm_eps)
    return x + shard_act(_mlp(lp["mlp"], h, cfg), RESIDUAL)


def encode(params: Dict, embeds: torch.Tensor, cfg: C.ModelConfig,
           remat: str = "none") -> torch.Tensor:
    """Frame embeddings (B, S_enc, d) -> encoder states (B, S_enc, d) in the
    compute dtype.  Under a mesh the encoder runs on the residual stream's
    sequence split, in a train step and in a prefill alike
    (``act_sharding.split_sequence``), as the reference's GSPMD splits it,
    and the states stay split along the sequence; else they are whole."""
    policy = _layer_remat(remat)
    b, s, d = embeds.shape
    x = embeds.to(getattr(torch, cfg.compute_dtype))
    x = x + sinusoidal_positions(s, d, device=x.device).to(x.dtype)[None]
    with split_sequence():
        for lp in _layers(params["enc_scan"], cfg.encoder_layers, cfg):
            x = remat_call(functools.partial(_enc_layer, lp, cfg), policy, x)
        x = rms_norm(x, fsdp_gather(params["enc_final_ln"]), cfg.norm_eps)
        # on the split, each decoder layer projects its cross K/V on each
        # rank's block, then gathers them; off it, the cross-attention takes
        # them whole
        return x if sequence_parallel() else sequence_whole(x)


def _embed(params: Dict, tokens: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    """The reference's decoder input: the row cast to the compute dtype, then
    scaled by sqrt(d) in it."""
    x = lookup(params["embed"], tokens).to(getattr(torch, cfg.compute_dtype))
    return x * dtype_const(cfg.d_model ** 0.5, x)


def _dec_layer(lp: Dict, positions: torch.Tensor, cfg: C.ModelConfig, x: torch.Tensor,
               enc: torch.Tensor) -> torch.Tensor:
    lp = map_dict(fsdp_gather, lp)
    x = shard_act(x, RESIDUAL)
    h = rms_norm_in(x, lp["ln1"], cfg.norm_eps)
    x = x + shard_act(attention_train(lp["self_attn"], h, positions, causal=True,
                                      rope_theta=cfg.rope_theta)[0], RESIDUAL)
    h = rms_norm_in(x, lp["ln_x"], cfg.norm_eps)
    kv = project_kv(lp["cross_attn"], block_input(enc))
    x = x + shard_act(attention_train(lp["cross_attn"], h, positions, kv_override=kv)[0],
                      RESIDUAL)
    h = rms_norm_in(x, lp["ln2"], cfg.norm_eps)
    return x + shard_act(_mlp(lp["mlp"], h, cfg), RESIDUAL)


def _decoder_hidden(params: Dict, enc: torch.Tensor, tokens: torch.Tensor,
                    cfg: C.ModelConfig, remat: str) -> torch.Tensor:
    policy = _layer_remat(remat)
    x = _embed(params, tokens, cfg)
    positions = default_positions(tokens)
    for lp in _layers(params["dec_scan"], cfg.num_layers, cfg):
        x = remat_call(functools.partial(_dec_layer, lp, positions, cfg), policy, x, enc)
    return rms_norm(x, fsdp_gather(params["dec_final_ln"]), cfg.norm_eps)


def _logits(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ table.to(x.dtype).T


def decoder_logits(params: Dict, enc: torch.Tensor, tokens: torch.Tensor,
                   cfg: C.ModelConfig, remat: str = "none") -> torch.Tensor:
    """The teacher-forced decoder over tokens (B, S) against the encoder
    states: (B, S, V) logits in the compute dtype."""
    return _logits(params["embed"], _decoder_hidden(params, enc, tokens, cfg, remat))


def _loss_sum(table, x, targets, mask) -> torch.Tensor:
    return (token_losses(_logits(table, x), targets) * mask).sum()


def train_loss(params: Dict, batch: Dict[str, torch.Tensor], cfg: C.ModelConfig,
               remat: str = "none") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token loss of a batch {"encoder_embeds": (B, S_enc, d),
    "decoder_tokens", "targets": (B, S) int, "mask": (B, S) float}:
    ``(loss, {"ce_loss", "moe_aux"})`` (aux 0): ``softmax_cross_entropy`` of
    the decoder's logits, the loss head under a mesh on each rank's rows
    and sequence block with the table whole (``local_sum``; Whisper's
    51,865 do not split 16 ways), or where the vocabulary's split has more
    than one rank, vocabulary-parallel in one chunk whose logits backward
    keeps (``vocab.vocab_ce_sum``; the reference takes this loss unchunked
    and without remat)."""
    enc = encode(params, batch["encoder_embeds"], cfg, remat)
    x = _decoder_hidden(params, enc, batch["decoder_tokens"], cfg, remat)
    mask, targets = batch["mask"], batch["targets"]
    table = fsdp_gather(params["embed"])
    plan = plan_ce(table, x, targets, mask, True, x.shape[1])
    if plan is not None:
        total = vocab_ce_sum(table, x, targets, mask, plan, True, keep_logits=True)
    else:
        total = local_sum(_loss_sum, (table, (None, None)), (x, ("batch", "seq", None)),
                          (targets, ("batch", "seq")), (mask, ("batch", "seq")))
    loss = total / mask.sum().clamp(min=1.0)
    return loss, {"ce_loss": loss, "moe_aux": torch.zeros((), device=loss.device)}


def init_dec_cache(cfg: C.ModelConfig, batch: int, self_slots: int, enc_slots: int,
                   device=None) -> Dict[str, torch.Tensor]:
    dtype = getattr(torch, cfg.compute_dtype)
    shape = (cfg.num_layers, batch)
    kv = (cfg.num_kv_heads, cfg.head_dim)
    return {"self_k": torch.zeros(shape + (self_slots,) + kv, dtype=dtype, device=device),
            "self_v": torch.zeros(shape + (self_slots,) + kv, dtype=dtype, device=device),
            "cross_k": torch.zeros(shape + (enc_slots,) + kv, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape + (enc_slots,) + kv, dtype=dtype, device=device)}


@torch.no_grad()
def encode_prefill(params: Dict, embeds: torch.Tensor, cfg: C.ModelConfig,
                   self_slots: int, cache: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode and compute every decoder layer's cross-attention K/V once:
    (encoder states, a cache with ``self_slots`` empty self-attention
    slots; ``cache``: a zeroed one of that shape to fill instead).  Under a
    mesh the states stay split along the sequence (``encode``) and each
    layer's K/V is projected on each rank's block, then placed as the
    cache is, as ``_dec_layer`` takes them in a train step."""
    enc = encode(params, embeds, cfg)
    if cache is None:
        cache = init_dec_cache(cfg, embeds.shape[0], self_slots, embeds.shape[1],
                               device=embeds.device)
    with split_sequence():
        for i, lp in enumerate(_layers(params["dec_scan"], cfg.num_layers, cfg)):
            cache["cross_k"][i], cache["cross_v"][i] = project_kv(lp["cross_attn"],
                                                                  block_input(enc))
    return enc, cache


def decode_step(params: Dict, cache: Dict[str, torch.Tensor], tokens: torch.Tensor, pos: int,
                cfg: C.ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder token (B, 1) at ``pos`` against the self-attention cache
    (taking its K/V in place) and the cross-attention memory; returns the
    (B, V) logits in the compute dtype.  ``params`` come from
    ``cast_params``."""
    x = _embed(params, tokens, cfg)
    positions = torch.full(tuple(tokens.shape), pos, dtype=torch.int32, device=x.device)
    rope = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    valid = valid_slots(cache["self_k"].shape[2], pos, False, device=x.device)
    for i, lp in enumerate(_layers(params["dec_scan"], cfg.num_layers, cfg)):
        lp = map_dict(fsdp_gather, lp)
        x = shard_act(x, ("batch", None, "embed_act"))  # as transformer.decode_step
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attention_decode(lp["self_attn"], h, cache["self_k"][i], cache["self_v"][i],
                                 pos, rope, valid)
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        x = x + cross_attention_decode(lp["cross_attn"], h, cache["cross_k"][i],
                                       cache["cross_v"][i])
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp(lp["mlp"], h, cfg)
    x = rms_norm(shard_act(x, ("batch", None, "embed_act")), params["dec_final_ln"],
                 cfg.norm_eps)
    return (x @ params["embed"].T)[:, 0, :], cache
