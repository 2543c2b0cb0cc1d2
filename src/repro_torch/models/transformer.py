"""Decoder-only transformer for the ``(ATTN, MLP)`` block pattern.

The port's counterpart of the reference's ``models/transformer.py`` for the
dense decoder's serving path: ``init_decoder_params``, ``init_cache`` and
``decode_step``.  The reference stacks the layers of its ``scan_groups`` and
scans over them; here the same stacking is a leading layer axis on every
layer weight and on the cache, and the layers run as a loop.  Parameters are
a plain dictionary::

    {"embed": (V, d), "unembed": (d, V), "final_ln": (d,),
     "layers": {"ln1", "ln2": (L, d), "wq": (L, d, H, hd), "wk", "wv": (L, d, KVH, hd),
                "wo": (L, H, hd, d), "w_in", "w_gate": (L, d, ff), "w_out": (L, ff, d)}}

``cast_params`` casts them to the compute dtype once, at load; the reference
casts each layer's weights on every step (``cast_tree``), which gives the
same numbers.  ``final_ln`` stays in the parameter dtype, as the reference
leaves it.  Sharding hints (``shard_act``) and ``scan_mode`` have no
counterpart on one card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import config as C
from .attention import KVCache, attention_decode, init_attention, init_kv_cache
from .layers import ParamFactory, mlp_apply, rms_norm, rope_angles

LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out")


def check_supported(cfg: C.ModelConfig) -> None:
    """The port runs the dense decoder with SwiGLU, untied embeddings and
    standard RoPE; anything else waits for the rest of the model stack."""
    if (cfg.is_encdec or cfg.block_pattern != ((C.ATTN, C.MLP),) or cfg.mrope_sections
            or cfg.tie_embeddings or not cfg.embed_inputs or cfg.act != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense (ATTN, MLP) decoder is ported (ROADMAP.md, modules "
            f"to port, 'Model stack and training')")


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
