"""Specs for activations: batches and decode caches.

The port's counterpart of the reference's ``sharding/specs.py``, built
*structurally* (mirroring how the model builds its batches and caches), so
a dimension that happens to equal the batch size can never be mis-sharded.

Decode-cache policy:
* batch dim -> ("pod","data") when divisible (decode_32k: B=128 over 32);
* B=1 (long_500k): KV slots shard over "data" instead (sequence parallel
  decode) and recurrent state widths shard over "model";
* KV heads / RWKV heads / rnn width -> "model" when divisible.

``cache_pspecs`` gives the reference's specs in the port's cache layout
(``transformer.init_cache``: one stacked ``KVCache`` or a list of layers,
where the reference has ``scan``/``pos{j}`` and ``rem{j}``).
"""

from __future__ import annotations

from typing import Dict

from ..act_sharding import mesh_shape, spec_entry
from ..models import config as C
from ..models.attention import KVCache
from ..models.rglru import RGLRUState
from ..models.rwkv6 import RWKVState
from ..models.transformer import stacked_cache, window_of
from .partition import batch_dim_spec


def _div(n: int, mesh, axis: str) -> bool:
    sizes = mesh_shape(mesh)
    return axis in sizes and n % sizes[axis] == 0 and n > 0


def _batch_entry(mesh, batch: int):
    b = batch_dim_spec(mesh, batch)
    return spec_entry(b or ())


def batch_pspecs(cfg: C.ModelConfig, kind: str, batch: int, mesh) -> Dict[str, tuple]:
    """Specs of the train/prefill batch dictionary (``launch.dryrun.input_specs``)."""
    b = _batch_entry(mesh, batch)
    tok = (b, None)
    emb = (b, None, None)
    if cfg.is_encdec:
        return {"encoder_embeds": emb, "decoder_tokens": tok, "targets": tok, "mask": tok}
    specs = {"targets": tok, "mask": tok}
    if cfg.embed_inputs and cfg.family not in ("vlm",):
        specs["inputs"] = tok
    else:
        specs["embeds"] = emb
    if kind == "prefill":
        specs.pop("targets", None)
        specs.pop("mask", None)
    return specs


def _kv_seq_shard(mesh, batch_spec, slots: int):
    """KV slots shard over "model" (sequence-parallel decode attention); with
    an unsharded batch (long_500k) they take "data" too."""
    axes = []
    rem = slots
    if batch_spec is None and _div(slots, mesh, "data"):
        axes.append("data")
        rem //= mesh_shape(mesh)["data"]
    if _div(rem, mesh, "model"):
        axes.append("model")
    return tuple(axes) if axes else None


def _kv_spec(cfg: C.ModelConfig, mesh, batch: int, slots: int, grouped: bool) -> KVCache:
    b = batch_dim_spec(mesh, batch)
    seq = _kv_seq_shard(mesh, b, slots)
    kvh = None
    if not (seq and "model" in seq) and _div(cfg.num_kv_heads, mesh, "model"):
        kvh = "model"
    dims = (None,) if grouped else ()
    spec = dims + (spec_entry(b or ()), spec_entry(seq or ()), kvh, None)
    return KVCache(spec, spec)


def _rglru_spec(cfg: C.ModelConfig, mesh, batch: int, grouped: bool) -> RGLRUState:
    b = _batch_entry(mesh, batch)
    rnn = "model" if _div(cfg.rnn_dim, mesh, "model") else None
    dims = (None,) if grouped else ()
    return RGLRUState(dims + (b, rnn), dims + (b, None, rnn))


def _rwkv_spec(cfg: C.ModelConfig, mesh, batch: int, grouped: bool) -> RWKVState:
    b = _batch_entry(mesh, batch)
    h = "model" if _div(cfg.num_heads, mesh, "model") else None
    d = "model" if h is None and _div(cfg.d_model, mesh, "model") else None
    dims = (None,) if grouped else ()
    return RWKVState(dims + (b, h, None, None), dims + (b, d), dims + (b, d))


def _layer_cache_spec(cfg: C.ModelConfig, mixer: str, mesh, batch: int, slots: int,
                      grouped: bool):
    if mixer in (C.ATTN, C.ATTN_SWA, C.ATTN_LOCAL):
        w = window_of(cfg, mixer)
        return _kv_spec(cfg, mesh, batch, min(w, slots) if w else slots, grouped)
    if mixer == C.RGLRU:
        return _rglru_spec(cfg, mesh, batch, grouped)
    if mixer == C.RWKV:
        return _rwkv_spec(cfg, mesh, batch, grouped)
    raise ValueError(mixer)


def _encdec_spec(cfg: C.ModelConfig, mesh, batch: int, enc_slots: int) -> Dict[str, tuple]:
    bax = batch_dim_spec(mesh, batch)
    b = spec_entry(bax or ())
    seq = _kv_seq_shard(mesh, bax, enc_slots) if enc_slots else None
    kvh = None
    if not (seq and "model" in seq) and _div(cfg.num_kv_heads, mesh, "model"):
        kvh = "model"
    return {
        "self_k": (None, b, None, kvh, None),
        "self_v": (None, b, None, kvh, None),
        "cross_k": (None, b, spec_entry(seq or ()), kvh, None),
        "cross_v": (None, b, spec_entry(seq or ()), kvh, None),
    }


def cache_pspecs(cfg: C.ModelConfig, mesh, batch: int, slots: int, enc_slots: int = 0):
    """The spec tree of the decode cache (``Model.init_cache``): the stacked
    ``KVCache`` (layers first) of a model whose every layer attends with one
    window, else one entry per layer."""
    if cfg.is_encdec:
        return _encdec_spec(cfg, mesh, batch, enc_slots)
    if stacked_cache(cfg):
        return _layer_cache_spec(cfg, cfg.layer_kinds[0][0], mesh, batch, slots, True)
    return [_layer_cache_spec(cfg, m, mesh, batch, slots, False) for m, _ in cfg.layer_kinds]
