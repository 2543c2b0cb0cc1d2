"""Decoder-only transformer for the ``(ATTN, MLP)`` block pattern.

The port's counterpart of the reference's ``models/transformer.py`` for the
dense decoder: ``init_decoder_params``, ``train_loss`` (``forward_train``,
``logits_from_hidden``, ``chunked_ce_loss``), ``prefill``, ``init_cache`` and
``decode_step``.  The reference stacks the layers of its ``scan_groups`` and
scans over them; here the same stacking is a leading layer axis on every
layer weight and on the cache, and the layers run as a loop.  Parameters are
a plain dictionary::

    {"embed": (V, d), "unembed": (d, V), "final_ln": (d,),
     "layers": {"ln1", "ln2": (L, d), "wq": (L, d, H, hd), "wk", "wv": (L, d, KVH, hd),
                "wo": (L, H, hd, d), "w_in", "w_gate": (L, d, ff), "w_out": (L, ff, d)}}

For serving, ``cast_params`` casts them to the compute dtype once, at load;
the reference casts each layer's weights on every step (``cast_tree``), which
gives the same numbers.  ``train_loss`` and ``prefill`` cast on every call,
as the reference does, so that gradients reach float32 master weights.
``final_ln`` stays in the parameter dtype, as the reference leaves it.
Sharding hints (``shard_act``), ``scan_mode`` and the reference's ``remat``
policies have no counterpart here: the layers run as a loop and autograd
keeps their activations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import config as C
from .attention import KVCache, attention_decode, attention_train, init_attention, init_kv_cache
from .layers import ParamFactory, mlp_apply, rms_norm, rope_angles, token_losses

LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out")
# The loss head's sequence chunk: each chunk's (B, chunk, V) logits are
# recomputed in the backward pass instead of kept.
LOSS_CHUNK = 512


def check_supported(cfg: C.ModelConfig) -> None:
    """The port runs the dense decoder with SwiGLU, untied embeddings and
    standard RoPE; anything else waits for the rest of the model stack."""
    if (cfg.is_encdec or cfg.block_pattern != ((C.ATTN, C.MLP),) or cfg.mrope_sections
            or cfg.tie_embeddings or not cfg.embed_inputs or cfg.act != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense (ATTN, MLP) decoder is ported (ROADMAP.md, modules "
            f"to port, 'The other block kinds')")


def init_decoder_params(generator: torch.Generator, cfg: C.ModelConfig) -> Dict:
    """Random parameters in ``cfg.param_dtype`` on the generator's device,
    with the reference's initialiser scales, drawn layer by layer."""
    check_supported(cfg)
    pf = ParamFactory(generator, getattr(torch, cfg.param_dtype))
    d = cfg.d_model
    params: Dict = {"embed": pf.embedding((cfg.vocab_size, d)),
                    "unembed": pf.normal((d, cfg.vocab_size)),
                    "final_ln": pf.zeros((d,))}
    layers = []
    for _ in range(cfg.num_layers):
        layer = {"ln1": pf.zeros((d,)), "ln2": pf.zeros((d,))}
        layer.update(init_attention(pf, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim))
        layer.update(w_in=pf.normal((d, cfg.d_ff)), w_out=pf.normal((cfg.d_ff, d)),
                     w_gate=pf.normal((d, cfg.d_ff)))
        layers.append(layer)
    params["layers"] = {k: torch.stack([layer[k] for layer in layers]) for k in LAYER_KEYS}
    return params


def cast_params(params: Dict, cfg: C.ModelConfig) -> Dict:
    """Every weight but ``final_ln`` in ``cfg.compute_dtype``."""
    dt = getattr(torch, cfg.compute_dtype)
    return {"embed": params["embed"].to(dt), "unembed": params["unembed"].to(dt),
            "final_ln": params["final_ln"],
            "layers": {k: v.to(dt) for k, v in params["layers"].items()}}


def _layers(params: Dict, cfg: C.ModelConfig) -> List[Dict[str, torch.Tensor]]:
    """Each layer's weights in the compute dtype, cast from the stacked
    parameters on this call (the reference's per-layer ``cast_tree``).  The
    stacks are cast whole and unbound, so the backward pass stacks each
    weight's layer gradients once."""
    dt = getattr(torch, cfg.compute_dtype)
    per_key = {k: params["layers"][k].to(dt).unbind(0) for k in LAYER_KEYS}
    return [{k: per_key[k][i] for k in LAYER_KEYS} for i in range(cfg.num_layers)]


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


def _embed(params: Dict, tokens: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(getattr(torch, cfg.compute_dtype))


def forward_train(params: Dict, tokens: torch.Tensor, positions: torch.Tensor,
                  cfg: C.ModelConfig,
                  cache: Optional[KVCache] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward of tokens (B, S) -> final hidden states (B, S, d) in
    the compute dtype, and the MoE aux loss (0 for the dense decoder).  A
    ``cache`` takes each layer's rotated K and V in its first S slots."""
    x = _embed(params, tokens, cfg)
    s = tokens.shape[1]
    for i, p in enumerate(_layers(params, cfg)):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        out, k, v = attention_train(p, h, positions, rope_theta=cfg.rope_theta)
        if cache is not None:
            cache.k[i, :, :s] = k
            cache.v[i, :, :s] = v
        x = x + out
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_apply(h, p["w_in"], p["w_gate"], p["w_out"], cfg.act)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def logits_from_hidden(params: Dict, x: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    return x @ params["unembed"].to(x.dtype)


def _chunk_loss(params: Dict, x: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                cfg: C.ModelConfig) -> torch.Tensor:
    return (token_losses(logits_from_hidden(params, x, cfg), targets) * mask).sum()


def chunked_ce_loss(params: Dict, x: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                    cfg: C.ModelConfig) -> torch.Tensor:
    """Cross-entropy (with the reference's 1e-4 z-loss) in 512-token chunks,
    so the (B, S, V) logits never exist whole: each chunk's logits, in the
    compute dtype and then float32, are recomputed in the backward pass
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).
    A length that 512 does not divide is evaluated in one chunk.  The sum
    over the chunks is divided by ``max(sum(mask), 1)``."""
    s = x.shape[1]
    c = min(LOSS_CHUNK, s)
    if s % c:
        c = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + checkpoint(_chunk_loss, params, x[:, i:i + c], targets[:, i:i + c],
                                   mask[:, i:i + c], cfg, use_reentrant=False)
    return total / mask.sum().clamp(min=1.0)


def train_loss(params: Dict, batch: Dict[str, torch.Tensor],
               cfg: C.ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token loss of a batch {"inputs", "targets": (B, S) int,
    "mask": (B, S) float, optional "positions"}: ``(total, {"ce_loss",
    "moe_aux"})``, with total = ce_loss + 0.01 * moe_aux."""
    tokens = batch["inputs"]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(tokens)
    x, aux = forward_train(params, tokens, positions, cfg)
    loss = chunked_ce_loss(params, x, batch["targets"], batch["mask"], cfg)
    return loss + 0.01 * aux, {"ce_loss": loss, "moe_aux": aux}


@torch.no_grad()
def prefill(params: Dict, tokens: torch.Tensor, positions: Optional[torch.Tensor],
            cfg: C.ModelConfig, slots: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Forward of tokens (B, S) at positions (B, S) (``None``: 0 to S - 1)
    that also fills a decode cache: returns the last position's (B, V)
    logits in the compute dtype and a ``KVCache`` of (layers, B, slots, KVH,
    hd) holding each layer's rotated K and V in its first S slots.
    ``slots`` defaults to S, as the reference's cache; give more for
    ``decode_step`` to continue at position S."""
    b, s = tokens.shape
    slots = s if slots is None else slots
    if positions is None:
        positions = _positions(tokens)
    if slots < s:
        raise ValueError(f"a cache of {slots} slots cannot hold {s} tokens")
    cache = init_cache(cfg, b, slots, device=tokens.device)
    x, _ = forward_train(params, tokens, positions, cfg, cache=cache)
    return logits_from_hidden(params, x[:, -1:], cfg)[:, 0], cache


def init_cache(cfg: C.ModelConfig, batch: int, slots: int, device=None) -> KVCache:
    """Decode cache of every layer: k, v of (layers, batch, slots, KVH, hd)."""
    return init_kv_cache(batch, slots, cfg.num_kv_heads, cfg.head_dim,
                         getattr(torch, cfg.compute_dtype), cfg.num_layers, device=device)


def decode_step(params: Dict, cache: KVCache, tokens: torch.Tensor, pos: int,
                cfg: C.ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: tokens (B, 1) int at position ``pos`` against the
    cache, which takes the tokens' K/V in place; returns the (B, V) logits in
    the compute dtype and the cache.  ``params`` come from ``cast_params``."""
    x = params["embed"][tokens]  # (B, 1, d)
    positions = torch.full(tokens.shape, pos, dtype=torch.int32, device=x.device)
    rope = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    valid = torch.arange(cache.k.shape[2], device=x.device) <= pos
    lp = params["layers"]
    for i in range(cfg.num_layers):
        h = rms_norm(x, lp["ln1"][i], cfg.norm_eps)
        attn = {k: lp[k][i] for k in ("wq", "wk", "wv", "wo")}
        x = x + attention_decode(attn, h, cache.k[i], cache.v[i], pos, rope, valid)
        h = rms_norm(x, lp["ln2"][i], cfg.norm_eps)
        x = x + mlp_apply(h, lp["w_in"][i], lp["w_gate"][i], lp["w_out"][i], cfg.act)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x @ params["unembed"]
    return logits[:, 0, :], cache
