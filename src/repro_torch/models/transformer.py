"""Decoder-only transformer over every block kind of the zoo.

The port's counterpart of the reference's ``models/transformer.py``:
``init_decoder_params``, ``train_loss`` (``forward_train``,
``logits_from_hidden``, ``chunked_ce_loss``), ``prefill``, ``init_cache``
and ``decode_step``, for any ``block_pattern`` of (mixer, mlp) kinds: full,
sliding-window and local attention, RG-LRU and RWKV6 time-mix mixers; the
SwiGLU/GELU MLP, the MoE and RWKV6 channel-mix.  Parameters take the
reference's layout, a plain dictionary::

    {"embed": (V, d), "unembed": (d, V) (absent when tied), "final_ln": (d,),
     "scan": {"pos0": layer, ..., "pos{P-1}": layer},   # each leaf (G, ...)
     "rem0": layer, ...}                                # the remainder layers
    layer = {"ln1", "ln2": (d,), "mixer": {...}, "mlp": {...}}

where the ``P`` layers of the pattern repeat ``G = num_layers // P`` times
and the ``num_layers % P`` remainder layers follow unstacked (RecurrentGemma:
26 = 8 x 3 + 2).  The reference scans over the groups; here the layers run
as a loop, group by group.  The stacking decides the weight decay (a
leaf of two or more dimensions decays: a stacked norm scale does, a
remainder layer's does not), so it is kept.

For serving, ``cast_params`` casts the weights to the compute dtype once, at
load; the reference casts each layer's weights on every step (``cast_tree``),
which gives the same numbers.  ``train_loss`` and ``prefill`` cast on every
call, as the reference does, so that gradients reach float32 master weights.
``shard_act`` marks the reference's sharding sites (a no-op outside a
mesh; ``act_sharding``); ``scan_mode`` has no counterpart here.
The reference's ``remat`` policies do (``forward_train``, ``train_loss``):
``"none"`` keeps every activation for the backward pass; ``"full"``
recomputes each ``block_pattern`` group (the reference's checkpoint unit;
the remainder layers are never recomputed) from its input in the backward
pass; ``"dots"`` keeps only the weight products' outputs of each group and
recomputes the rest, attention included.  Remat changes memory, not
numbers.

The decode cache of a model whose every layer is attention with one window
is a single ``KVCache`` of (layers, B, slots, KVH, hd) (the server pages
it); any other model's is a list with one cache per layer: a ``KVCache`` of
(B, slots, KVH, hd), an ``RGLRUState`` or an ``RWKVState``.  A windowed
layer keeps ``min(window, slots)`` slots as a ring.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..act_sharding import (RESIDUAL, current_rules, fsdp_gather, is_dtensor, keeping_result,
                            local_call, local_sum, remat_unit, rows_split_only, shard_act,
                            whole_of)
from . import config as C
from .attention import (KVCache, attention_decode, attention_train, init_attention,
                        init_kv_cache, valid_slots)
from .layers import (ParamFactory, dtype_const, init_mlp, map_dict, mlp_apply, rms_norm,
                     rms_norm_in, rope_angles, token_losses)
from .moe import init_moe, moe_apply
from .vocab import plan_ce, plan_lookup, vocab_ce_sum, vocab_lookup
from .rglru import RGLRUState, init_rglru, init_rglru_state, rglru_decode, rglru_train
from .rwkv6 import (RWKVState, init_rwkv_cm, init_rwkv_state, init_rwkv_tm, rwkv_cm_decode,
                    rwkv_cm_train, rwkv_tm_decode, rwkv_tm_train)

ATTENTION = (C.ATTN, C.ATTN_SWA, C.ATTN_LOCAL)
# The loss head's sequence chunk: each chunk's (B, chunk, V) logits are
# recomputed in the backward pass instead of kept.
LOSS_CHUNK = 512
# Decode routes its one token a row with this capacity factor (the
# reference's decode_step), training and prefill with the config's.
DECODE_CAPACITY_FACTOR = 4.0

# The reference's remat policies.
REMAT = ("none", "full", "dots")
# What "dots" keeps (``checkpoint_dots_with_no_batch_dims``): the outputs of
# products without a batch dimension, which x @ W folds to.
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

LayerCache = Union[KVCache, RGLRUState, RWKVState]
Cache = Union[KVCache, List[LayerCache]]


def window_of(cfg: C.ModelConfig, mixer: str) -> int:
    """The attention window of a mixer kind (0: full attention)."""
    return {C.ATTN: 0, C.ATTN_SWA: cfg.attn_window, C.ATTN_LOCAL: cfg.local_window}[mixer]


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def _init_layer(pf: ParamFactory, cfg: C.ModelConfig, mixer: str, mlp: str) -> Dict:
    d = cfg.d_model
    p: Dict = {"ln1": pf.zeros((d,), ("embed",)), "ln2": pf.zeros((d,), ("embed",))}
    if mixer in ATTENTION:
        p["mixer"] = init_attention(pf, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    elif mixer == C.RGLRU:
        p["mixer"] = init_rglru(pf, d, cfg.rnn_dim, cfg.conv_width)
    elif mixer == C.RWKV:
        p["mixer"] = init_rwkv_tm(pf, d, cfg.num_heads, cfg.head_dim)
    else:
        raise ValueError(mixer)
    if mlp == C.MLP:
        p["mlp"] = init_mlp(pf, d, cfg.d_ff, cfg.act)
    elif mlp == C.MOE:
        p["mlp"] = init_moe(pf, d, cfg.d_ff, cfg.num_experts, cfg.act)
    elif mlp == C.RWKV_CM:
        p["mlp"] = init_rwkv_cm(pf, d, cfg.d_ff)
    else:
        raise ValueError(mlp)
    return p


def decoder_tree(pf, cfg: C.ModelConfig) -> Dict:
    """The parameter tree that ``pf`` makes: tensors (``ParamFactory``) or
    their logical axes (``AxesFactory``), layer by layer."""
    d = cfg.d_model
    params: Dict = {"embed": pf.embedding((cfg.vocab_size, d), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        params["unembed"] = pf.normal((d, cfg.vocab_size), ("embed", "vocab"))
    params["final_ln"] = pf.zeros((d,), ("embed",))
    if cfg.scan_groups:
        params["scan"] = {
            f"pos{j}": pf.stack(lambda m=mixer, f=mlp: _init_layer(pf, cfg, m, f),
                                cfg.scan_groups)
            for j, (mixer, mlp) in enumerate(cfg.block_pattern)}
    for j, (mixer, mlp) in enumerate(cfg.remainder_kinds):
        params[f"rem{j}"] = _init_layer(pf, cfg, mixer, mlp)
    return params


def init_decoder_params(generator: torch.Generator, cfg: C.ModelConfig) -> Dict:
    """Random parameters in ``cfg.param_dtype`` on the generator's device,
    with the reference's initialiser scales, drawn layer by layer."""
    return decoder_tree(ParamFactory(generator, getattr(torch, cfg.param_dtype)), cfg)


def cast_params(params: Dict, cfg: C.ModelConfig) -> Dict:
    """The weights for decoding: every layer weight in ``cfg.compute_dtype``,
    ``final_ln`` in the parameter dtype (as the reference leaves it), and
    ``unembed`` (d, V) in the compute dtype (the embedding's transpose when
    tied).  A tied ``embed`` stays in the parameter dtype: the reference
    scales the looked-up row by sqrt(d) before it rounds it."""
    dt = getattr(torch, cfg.compute_dtype)
    out = {k: map_dict(lambda t: t.to(dt), v) for k, v in params.items()
           if k not in ("embed", "unembed", "final_ln")}
    out["final_ln"] = params["final_ln"]
    if cfg.tie_embeddings:
        out["embed"] = params["embed"]
        out["unembed"] = params["embed"].to(dt).T
    else:
        out["embed"] = params["embed"].to(dt)
        out["unembed"] = params["unembed"].to(dt)
    return out


def unstack(stack: Dict, n: int, dt: torch.dtype) -> List[Dict]:
    """The ``n`` layers of a stacked tree, each leaf cast to ``dt`` whole and
    then unbound (so the backward pass stacks each weight's layer gradients
    once)."""
    per = map_dict(lambda t: t.to(dt).unbind(0), stack)
    return [map_dict(lambda ts: ts[i], per) for i in range(n)]


def layers_of(params: Dict, cfg: C.ModelConfig) -> List[Tuple[str, str, Dict]]:
    """Each layer's (mixer kind, mlp kind, weights in the compute dtype), in
    order: the pattern's groups, then the remainder.  The weights are cast
    from the parameters on this call (the reference's per-layer
    ``cast_tree``)."""
    dt = getattr(torch, cfg.compute_dtype)
    out = []
    if cfg.scan_groups:
        per_pos = [unstack(params["scan"][f"pos{j}"], cfg.scan_groups, dt)
                   for j in range(cfg.pattern_period)]
        for g in range(cfg.scan_groups):
            for j, (mixer, mlp) in enumerate(cfg.block_pattern):
                out.append((mixer, mlp, per_pos[j][g]))
    for j, (mixer, mlp) in enumerate(cfg.remainder_kinds):
        out.append((mixer, mlp, map_dict(lambda t: t.to(dt), params[f"rem{j}"])))
    return out


# ---------------------------------------------------------------------------
# Forward (train and prefill).
# ---------------------------------------------------------------------------


def default_positions(inputs: torch.Tensor) -> torch.Tensor:
    """0 to S - 1 for each row of inputs (B, S, ...); on a DTensor split
    along its rows only, placed as its rows are (each rank makes its own),
    so that the rotary angles are made for each rank's rows."""
    b, s = inputs.shape[:2]
    if is_dtensor(inputs) and rows_split_only(inputs):
        from torch.distributed.tensor import DTensor

        local = inputs._local_tensor
        pos = torch.arange(s, dtype=torch.int32, device=local.device).expand(local.shape[0], s)
        return DTensor.from_local(pos, inputs.device_mesh, inputs.placements, run_check=False)
    return torch.arange(s, dtype=torch.int32, device=inputs.device).expand(b, s)


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at int ``tokens`` (B, S).  Under a mesh whose
    vocabulary split has more than one rank, each rank looks up the tokens
    of its shard (``vocab.vocab_lookup``) and the sum lands placed as the
    residual stream (reduce-scattered onto its sequence split, or
    all-reduced); else on each rank's batch rows with the table whole
    (DTensor's rule for the lookup's backward, ``index_put``, fails on
    split tokens, torch 2.11)."""
    table = fsdp_gather(table)
    axis = plan_lookup(table, tokens)
    if axis is not None:
        return shard_act(vocab_lookup(table, tokens, axis), RESIDUAL)
    return local_call(lambda t, tab: tab[t.long()], (tokens, ("batch", None)), (table, (None, None)))


def embed_inputs(params: Dict, inputs: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    """Tokens (B, S) int looked up in ``embed`` (times sqrt(d) when tied,
    in the table's dtype), or embeddings (B, S, d) float taken as they are;
    either in the compute dtype."""
    if inputs.is_floating_point():
        x = inputs
    else:
        x = lookup(params["embed"], inputs)
        if cfg.tie_embeddings:
            x = x * dtype_const(cfg.d_model ** 0.5, x)
    return x.to(getattr(torch, cfg.compute_dtype))


def _mixer_train(p: Dict, h: torch.Tensor, positions: torch.Tensor, cfg: C.ModelConfig,
                 mixer: str):
    """A mixer over the sequence: (output, what prefill's cache keeps)."""
    if mixer in ATTENTION:
        out, k, v = attention_train(p, h, positions, causal=True, window=window_of(cfg, mixer),
                                    rope_theta=cfg.rope_theta,
                                    mrope_sections=cfg.mrope_sections)
        return out, (k, v)
    if mixer == C.RGLRU:
        return rglru_train(p, h)
    if mixer == C.RWKV:
        return rwkv_tm_train(p, h, cfg.num_heads, cfg.head_dim)
    raise ValueError(mixer)


def _mlp_train(p: Dict, h: torch.Tensor, cfg: C.ModelConfig, mlp: str,
               capacity_factor: float):
    if mlp == C.MLP:
        return mlp_apply(h, p["w_in"], p.get("w_gate"), p["w_out"], cfg.act), None
    if mlp == C.MOE:
        return moe_apply(p, whole_of(h), top_k=cfg.top_k, capacity_factor=capacity_factor,
                         act=cfg.act)
    if mlp == C.RWKV_CM:
        return rwkv_cm_train(p, h), None
    raise ValueError(mlp)


def check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} is not one of {REMAT}")


def _dots_policy(ctx, op, *args, **kwargs):
    if keeping_result():  # a result kept through ``act_sharding.keep``
        return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.alias.default
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(fn: Callable, remat: str, *args):
    """``fn(*args)`` under a remat policy: as it is (``"none"``), recomputed
    whole in the backward pass (``"full"``), or recomputed but for the
    outputs of its weight products (``"dots"``).  Under a mesh the unit
    runs, and is recomputed, under the rules active now, and its local
    regions keep their inputs only (``act_sharding.remat_unit``)."""
    if remat == "none":
        return fn(*args)
    check_remat(remat)
    rules = current_rules()
    runs, handed = [], {}

    def unit(*a):
        # the unit's later runs are the backward pass's reruns
        rerun = bool(runs)
        runs.append(None)
        with remat_unit(rules, remat == "dots" and rerun, handed, rerun):
            return fn(*a)

    if remat == "full":
        return checkpoint(unit, *args, use_reentrant=False)
    return checkpoint(unit, *args, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   _dots_policy))


def _run_layers(layers: List[Tuple[str, str, Dict]], positions: torch.Tensor,
                cfg: C.ModelConfig, caches: List[Optional[LayerCache]], x: torch.Tensor,
                aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers (``layers_of``'s entries) over x, the MoE aux loss added to
    ``aux``; each layer with a cache stores its state in it."""
    for (mixer, mlp, p), lc in zip(layers, caches):
        p = map_dict(fsdp_gather, p)
        x = shard_act(x, RESIDUAL)
        h = rms_norm_in(x, p["ln1"], cfg.norm_eps)
        out, state = _mixer_train(p["mixer"], h, positions, cfg, mixer)
        x = x + shard_act(out, RESIDUAL)
        h2 = rms_norm_in(x, p["ln2"], cfg.norm_eps)
        y, a = _mlp_train(p["mlp"], h2, cfg, mlp, cfg.capacity_factor)
        x = x + shard_act(y, RESIDUAL)
        if a is not None:
            aux = aux + a
        if lc is not None:
            _store(lc, state, whole_of(h2))
    return x, aux


def forward_train(params: Dict, inputs: torch.Tensor, positions: torch.Tensor,
                  cfg: C.ModelConfig, cache: Optional[Cache] = None,
                  remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward of tokens (B, S) or embeddings (B, S, d) -> final
    hidden states (B, S, d) in the compute dtype, and the MoE aux loss summed
    over the layers (float32; 0 without MoE).  A ``cache`` (``init_cache``)
    takes each layer's state after the sequence (``_store``).  ``remat``
    applies to each ``block_pattern`` group (module docstring)."""
    check_remat(remat)
    x = embed_inputs(params, inputs, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = layers_of(params, cfg)
    caches = [None if cache is None else layer_cache(cache, i) for i in range(len(layers))]
    period = cfg.pattern_period
    grouped = cfg.scan_groups * period
    for g in range(0, grouped, period):
        unit = slice(g, g + period)
        x, aux = remat_call(functools.partial(_run_layers, layers[unit], positions, cfg,
                                              caches[unit]), remat, x, aux)
    x, aux = _run_layers(layers[grouped:], positions, cfg, caches[grouped:], x, aux)
    return rms_norm(x, fsdp_gather(params["final_ln"]), cfg.norm_eps), aux


def _ring(x: torch.Tensor, slots: int) -> torch.Tensor:
    """The cache of ``slots`` slots that K or V x (B, S, KVH, hd) leaves:
    position t at slot ``t % slots`` for the last ``min(S, slots)``
    positions, zeros in the slots after a shorter prompt (a dense cache
    holds every position at its own slot)."""
    s = x.shape[1]
    if s < slots:
        tail = torch.zeros((x.shape[0], slots - s) + tuple(x.shape[2:]), dtype=x.dtype,
                           device=x.device)
        return torch.cat([x, tail], dim=1)
    x = x[:, s - slots:]
    r = s % slots  # the slot of the first position kept
    return torch.cat([x[:, slots - r:], x[:, :slots - r]], dim=1) if r else x


def _store(lc: LayerCache, state, h2: torch.Tensor) -> None:
    """Write a layer's state after the prompt into its (fresh) cache, whole:
    an attention layer's K/V as ``_ring`` lays them out, a recurrent
    layer's state, and RWKV's channel-mix shift (the last ``ln2`` output).
    Whole-tensor copies, so that a cache placed on a mesh takes them on
    each rank's shard."""
    if isinstance(lc, KVCache):
        k, v = state
        lc.k.copy_(_ring(k, lc.k.shape[1]))
        lc.v.copy_(_ring(v, lc.v.shape[1]))
    elif isinstance(lc, RGLRUState):
        lc.h.copy_(state.h)
        lc.conv.copy_(state.conv)
    else:
        lc.s.copy_(state.s)
        lc.shift_tm.copy_(state.shift_tm)
        lc.shift_cm.copy_(h2[:, -1])


def _unembed(table: torch.Tensor, x: torch.Tensor, tied: bool) -> torch.Tensor:
    """Logits of x against the output table: ``embed`` transposed when the
    embeddings are tied, else ``unembed``."""
    w = table.to(x.dtype)
    return x @ (w.T if tied else w)


def logits_from_hidden(params: Dict, x: torch.Tensor, cfg: C.ModelConfig) -> torch.Tensor:
    tied = cfg.tie_embeddings
    return _unembed(params["embed"] if tied else params["unembed"], x, tied)


def _chunk_loss(table: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor, tied: bool) -> torch.Tensor:
    return (token_losses(_unembed(table, x, tied), targets) * mask).sum()


def loss_chunk(s: int) -> int:
    """The loss head's chunk for a sequence of ``s``: ``LOSS_CHUNK``, or
    ``s`` where that does not divide it."""
    c = min(LOSS_CHUNK, s)
    return s if s % c else c


def _ce_sum(table: torch.Tensor, x: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
            tied: bool) -> torch.Tensor:
    s = x.shape[1]
    c = loss_chunk(s)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + checkpoint(_chunk_loss, table, x[:, i:i + c], targets[:, i:i + c],
                                   mask[:, i:i + c], tied, use_reentrant=False)
    return total


def chunked_ce_loss(params: Dict, x: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                    cfg: C.ModelConfig) -> torch.Tensor:
    """Cross-entropy (with the reference's 1e-4 z-loss) in 512-token chunks,
    so the (B, S, V) logits never exist whole: each chunk's logits, in the
    compute dtype and then float32, are recomputed in the backward pass
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).
    A length that 512 does not divide is evaluated in one chunk.  The sum
    over the chunks is divided by ``max(sum(mask), 1)``.

    Under a mesh whose "vocab_act" split has more than one rank, each rank
    takes the chunk's logits of its ``V / m`` columns only
    (``vocab.vocab_ce_sum``: the row max, the sum of exponentials and the
    target's logit combined across ranks, each chunk's logits made again
    in backward).  Else the loss head runs on each rank's rows and
    sequence block (the reference's chunks take the "seq" split where the
    vocabulary cannot), the output table whole (``local_sum``): DTensor's
    rules for the label gather fail on a split vocabulary (torch 2.13) and
    its lookup's backward on split rows (torch 2.11)."""
    tied = cfg.tie_embeddings
    table = fsdp_gather(params["embed"] if tied else params["unembed"])
    plan = plan_ce(table, x, targets, mask, tied, loss_chunk(x.shape[1]))
    if plan is not None:
        total = vocab_ce_sum(table, x, targets, mask, plan, tied)
    else:
        total = local_sum(functools.partial(_ce_sum, tied=tied), (table, (None, None)),
                          (x, ("batch", "seq", None)), (targets, ("batch", "seq")),
                          (mask, ("batch", "seq")))
    return total / mask.sum().clamp(min=1.0)


def train_loss(params: Dict, batch: Dict[str, torch.Tensor], cfg: C.ModelConfig,
               remat: str = "none") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token loss of a batch {"inputs": (B, S) int or "embeds":
    (B, S, d), "targets": (B, S) int, "mask": (B, S) float, optional
    "positions": (B, S) or (3, B, S)}: ``(total, {"ce_loss", "moe_aux"})``,
    with total = ce_loss + 0.01 * moe_aux; ``remat`` as in
    ``forward_train``."""
    inputs = batch.get("embeds", batch.get("inputs"))
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(inputs)
    x, aux = forward_train(params, inputs, positions, cfg, remat=remat)
    loss = chunked_ce_loss(params, x, batch["targets"], batch["mask"], cfg)
    return loss + 0.01 * aux, {"ce_loss": loss, "moe_aux": aux}


@torch.no_grad()
def prefill(params: Dict, inputs: torch.Tensor, positions: Optional[torch.Tensor],
            cfg: C.ModelConfig, slots: Optional[int] = None,
            cache: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """Forward of tokens (B, S) or embeddings (B, S, d) at positions (B, S)
    or (3, B, S) (``None``: 0 to S - 1) that also fills a decode cache
    (``init_cache(cfg, B, slots)``): returns the last position's (B, V)
    logits in the compute dtype and the cache.  ``slots`` defaults to S, as
    the reference's cache; give more for ``decode_step`` to continue at
    position S.  A full-attention layer needs ``slots >= S``; a windowed
    one keeps the last ``min(window, slots, S)`` positions in ring order
    (the reference scatters every position into its ring, which writes a
    slot more than once when S exceeds the window).  ``cache``: a zeroed
    cache of that many slots to fill (a sharded prefill's, placed by
    ``cache_pspecs``) instead of a new one."""
    b, s = inputs.shape[:2]
    slots = s if slots is None else slots
    if positions is None:
        positions = default_positions(inputs)
    if slots < s and any(m == C.ATTN for m, _ in cfg.layer_kinds):
        raise ValueError(f"a cache of {slots} slots cannot hold {s} tokens")
    if cache is None:
        cache = init_cache(cfg, b, slots, device=inputs.device)
    x, _ = forward_train(params, inputs, positions, cfg, cache=cache)
    return logits_from_hidden(params, x[:, -1:], cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Caches and decode.
# ---------------------------------------------------------------------------


def stacked_cache(cfg: C.ModelConfig) -> bool:
    """Whether the decode cache is one ``KVCache`` for every layer: every
    mixer attends, all with one window."""
    kinds = {m for m, _ in cfg.layer_kinds}
    return kinds <= set(ATTENTION) and len({window_of(cfg, m) for m in kinds}) == 1


def _layer_cache_init(cfg: C.ModelConfig, mixer: str, batch: int, slots: int, dtype,
                      device) -> LayerCache:
    if mixer in ATTENTION:
        w = window_of(cfg, mixer)
        return init_kv_cache(batch, min(w, slots) if w else slots, cfg.num_kv_heads,
                             cfg.head_dim, dtype, device=device)
    if mixer == C.RGLRU:
        return init_rglru_state(batch, cfg.rnn_dim, cfg.conv_width, dtype, device=device)
    if mixer == C.RWKV:
        return init_rwkv_state(batch, cfg.num_heads, cfg.head_dim, cfg.d_model, dtype,
                               device=device)
    raise ValueError(mixer)


def init_cache(cfg: C.ModelConfig, batch: int, slots: int, device=None) -> Cache:
    """The zeroed decode cache (see the module's docstring)."""
    dtype = getattr(torch, cfg.compute_dtype)
    if stacked_cache(cfg):
        w = window_of(cfg, cfg.layer_kinds[0][0])
        return init_kv_cache(batch, min(w, slots) if w else slots, cfg.num_kv_heads,
                             cfg.head_dim, dtype, cfg.num_layers, device=device)
    return [_layer_cache_init(cfg, m, batch, slots, dtype, device) for m, _ in cfg.layer_kinds]


def layer_cache(cache: Cache, i: int) -> LayerCache:
    """Layer i's cache (views into a stacked cache)."""
    if isinstance(cache, KVCache):
        return KVCache(cache.k[i], cache.v[i])
    return cache[i]


def decode_step(params: Dict, cache: Cache, tokens: torch.Tensor, pos: int, cfg: C.ModelConfig,
                capacity_factor: float = DECODE_CAPACITY_FACTOR) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B, 1) int (or embeddings (B, 1, d)) at
    position ``pos`` against the cache, which takes the step's state in
    place; returns the (B, V) logits in the compute dtype and the cache.
    ``params`` come from ``cast_params``.  MoE layers route with capacity
    factor 4, as the reference's decode does, unless ``capacity_factor``
    says otherwise."""
    x = embed_inputs(params, tokens, cfg)
    positions = torch.full(tuple(tokens.shape[:2]), pos, dtype=torch.int32, device=x.device)
    rope = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    masks: Dict = {}
    for i, (mixer, mlp, p) in enumerate(layers_of(params, cfg)):
        p = map_dict(fsdp_gather, p)
        lc = layer_cache(cache, i)
        # under a mesh the residual stream whole on "model": the row-split
        # output products leave partial sums, summed here (TP's all-reduce)
        x = shard_act(x, ("batch", None, "embed_act"))
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if mixer in ATTENTION:
            key = (lc.k.shape[1], window_of(cfg, mixer) > 0)
            if key not in masks:
                masks[key] = valid_slots(key[0], pos, key[1], device=x.device)
            out = attention_decode(p["mixer"], h, lc.k, lc.v, pos, rope, masks[key])
        elif mixer == C.RGLRU:
            out, st = rglru_decode(p["mixer"], h, lc)
            lc.h.copy_(st.h)
            lc.conv.copy_(st.conv)
        else:
            out, s_new, shift = rwkv_tm_decode(p["mixer"], h, lc.s, lc.shift_tm, cfg.num_heads,
                                               cfg.head_dim)
            lc.s.copy_(s_new)
            lc.shift_tm.copy_(shift)
        x = x + out
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if mlp == C.RWKV_CM:
            out, shift = rwkv_cm_decode(p["mlp"], h, lc.shift_cm)
            lc.shift_cm.copy_(shift)
        else:
            out, _ = _mlp_train(p["mlp"], h, cfg, mlp, capacity_factor)
        x = x + out
    x = rms_norm(shard_act(x, ("batch", None, "embed_act")), params["final_ln"], cfg.norm_eps)
    return (x @ params["unembed"])[:, 0, :], cache
