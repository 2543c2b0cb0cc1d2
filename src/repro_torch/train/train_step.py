"""Train/serve step builders: the port's counterpart of the reference's
``train/train_step.py``.

The reference's steps are pure functions that ``jax.jit`` compiles (with the
parameters donated).  Here they run eagerly: gradients come from
``torch.autograd.grad`` over the parameter leaves (float32 tensors with
``requires_grad``), and ``AdamW.update_in_place`` writes the update into
those leaves and the moments into the optimizer state's, so the returned
``params`` and state hold the tensors passed in.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..act_sharding import activation_rules, is_dtensor
from ..models.model import impl
from ..pytree import flatten_with_path, leaves, tree_map, unflatten_like
from .optimizer import AdamW


def trainable(params):
    """The parameter tree as leaves that autograd tracks (shares storage)."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def _value_and_grad(model, params, batch):
    loss, metrics = model.train_loss(params, batch)
    if is_dtensor(loss):  # sharded: a partial sum over the batch shards, made whole
        loss = loss.full_tensor()
        metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
    # zeros for a leaf the loss does not use (a VLM fed embeddings skips its
    # table), as the reference's jax.grad gives
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten_like(params, grads)


def make_train_step(model, opt: AdamW) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, loss, metrics)."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _value_and_grad(model, params, batch)
        opt_state = opt.update_in_place(grads, opt_state, params)
        return params, opt_state, loss, metrics

    return train_step


def _require_dtensors(tree, what: str) -> None:
    plain = [".".join(path) for path, leaf in flatten_with_path(tree) if not is_dtensor(leaf)]
    if plain:
        raise ValueError(f"sharded step: {len(plain)} {what} leaves are not DTensors "
                         f"(first: {plain[0]}); place them with distribute_tree")


def make_sharded_train_step(model, opt: AdamW, mesh, microbatches: int = 1,
                            rules=None) -> Callable:
    """``make_train_step``'s step (``make_grad_accum_train_step``'s with
    ``microbatches`` > 1) under ``activation_rules(mesh, rules)``: with the
    parameters, the AdamW state and the batch placed as DTensors
    (``sharding.param_pspecs`` / ``batch_pspecs`` + ``distribute_tree``),
    DTensor's propagation splits the step as GSPMD does for the reference
    (``PERF.md`` lists where the model takes its operands whole or local),
    under any of the model's remat policies.

    Each call checks that every parameter, moment and batch leaf is a
    DTensor, since the rules take a plain tensor as replicated (the step
    count, a host scalar, is the one plain leaf)."""
    step = (make_train_step(model, opt) if microbatches == 1
            else make_grad_accum_train_step(model, opt, microbatches))

    def train_step(params, opt_state, batch):
        _require_dtensors(params, "parameter")
        _require_dtensors((opt_state.mu, opt_state.nu), "AdamW moment")
        _require_dtensors(batch, "batch")
        with activation_rules(mesh, rules):
            return step(params, opt_state, batch)

    return train_step


def _split_rows(x, n: int) -> list:
    """A batch leaf's ``n`` microbatches: microbatch i is the global rows
    ``i B / n`` to ``(i + 1) B / n``, as the reference's ``reshape(n, B / n)``
    takes them.  A DTensor is gathered once along the mesh axes that split
    its rows, and each microbatch placed as it was (each rank keeping its
    own part), so which rows share a microbatch does not depend on the
    mesh."""
    size = x.shape[0] // n
    if not is_dtensor(x):
        return [x[i * size:(i + 1) * size] for i in range(n)]
    from torch.distributed.tensor import Replicate, Shard

    mesh, split = x.device_mesh, x.placements
    whole = x.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                                  for p in split])
    return [whole[i * size:(i + 1) * size].redistribute(mesh, split) for i in range(n)]


def make_grad_accum_train_step(model, opt: AdamW, microbatches: int) -> Callable:
    """Gradient accumulation: the batch split into ``microbatches`` slices
    along its first axis (``_split_rows``), taken one after another (the
    reference's scan), their gradients summed in float32 and divided by the
    count before one optimizer update."""

    def train_step(params, opt_state, batch):
        for v in batch.values():
            rows = v.to_local().shape[0] if is_dtensor(v) else v.shape[0]
            if rows % microbatches:
                raise ValueError(f"batch of {rows} rows (on this rank) does not split into "
                                 f"{microbatches} microbatches")
        loss_sum = 0.0
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        parts = {k: _split_rows(v, microbatches) for k, v in batch.items()}
        for i in range(microbatches):
            part = {k: v[i] for k, v in parts.items()}
            loss, _, g = _value_and_grad(model, params, part)
            for acc, gi in zip(leaves(grads), leaves(g)):
                acc.add_(gi)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g: g / microbatches, grads)
        opt_state = opt.update_in_place(grads, opt_state, params)
        return params, opt_state, loss_sum / microbatches, {}

    return train_step


def make_serve_step(model) -> Callable:
    """(params, cache, tokens, pos) -> (logits, cache).  ``params`` may be the
    float32 masters: they are cast to the compute dtype on each call, as the
    reference casts, which costs nothing for weights already cast."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        mod = impl(model.cfg)
        return mod.decode_step(mod.cast_params(params, model.cfg), cache, tokens, pos, model.cfg)

    return serve_step


def make_prefill_step(model) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def placed_cache(model, mesh, batch: int, slots: int, enc_slots: int = 0):
    """A zeroed decode cache of ``model`` placed on ``mesh`` by
    ``sharding.cache_pspecs`` (each rank allocating its shard)."""
    from ..models import encdec, transformer
    from ..sharding import cache_pspecs, empty_placed

    cfg = model.cfg
    meta = (encdec.init_dec_cache(cfg, batch, slots, enc_slots, device="meta") if cfg.is_encdec
            else transformer.init_cache(cfg, batch, slots, device="meta"))
    return empty_placed(meta, cache_pspecs(cfg, mesh, batch, slots, enc_slots), mesh)


def make_sharded_prefill_step(model, mesh, slots: int = 0, rules=None) -> Callable:
    """(params, batch) -> (last-position logits, cache): ``model.prefill``
    under ``activation_rules(mesh, rules)`` on placed parameters and batch,
    into a cache placed by ``cache_pspecs`` (``placed_cache``) of ``slots``
    slots (0: the prompt's length; an encoder-decoder model's decoder slots
    and its frames)."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill_step(params, batch):
        _require_dtensors(params, "parameter")
        _require_dtensors(batch, "batch")
        x = batch.get("encoder_embeds", batch.get("embeds", batch.get("inputs")))
        b, s = x.shape[:2]
        if cfg.is_encdec:
            cache = placed_cache(model, mesh, b, slots or cfg.decoder_slots, s)
        else:
            cache = placed_cache(model, mesh, b, slots or s)
        with activation_rules(mesh, rules):
            return model.prefill(params, batch, slots or None, cache=cache)

    return prefill_step


def make_sharded_serve_step(model, mesh, rules=None) -> Callable:
    """``make_serve_step``'s step under ``activation_rules(mesh, rules)``: the
    parameters, the cache (``placed_cache``) and the tokens placed as
    DTensors (the tokens replicated, as the reference's), checked on each
    call; the cache takes the step's state in place."""
    step = make_serve_step(model)

    def serve_step(params, cache, tokens, pos):
        _require_dtensors(params, "parameter")
        _require_dtensors(cache, "cache")
        _require_dtensors(tokens, "token")
        with activation_rules(mesh, rules):
            return step(params, cache, tokens, pos)

    return serve_step
