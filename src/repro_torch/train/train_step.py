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
    grads = torch.autograd.grad(loss, leaves(params))
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
        raise ValueError(f"sharded train step: {len(plain)} {what} leaves are not DTensors "
                         f"(first: {plain[0]}); place them with distribute_tree")


def make_sharded_train_step(model, opt: AdamW, mesh) -> Callable:
    """``make_train_step``'s step under ``activation_rules(mesh)``: with the
    parameters, the AdamW state and the batch placed as DTensors
    (``sharding.param_pspecs`` / ``batch_pspecs`` + ``distribute_tree``),
    DTensor's propagation splits the step as GSPMD does for the reference
    (``PERF.md`` lists where the model takes its operands whole or local).

    Each call checks that every parameter, moment and batch leaf is a
    DTensor, since the rules take a plain tensor as replicated (the step
    count, a host scalar, is the one plain leaf).  Only remat ``"none"``
    runs: a checkpoint's recompute around the model's local regions fails
    in DTensor's dispatch (torch 2.11)."""
    if model.remat != "none":
        raise ValueError(f"the sharded train step runs remat 'none' only, not {model.remat!r}")
    step = make_train_step(model, opt)

    def train_step(params, opt_state, batch):
        _require_dtensors(params, "parameter")
        _require_dtensors((opt_state.mu, opt_state.nu), "AdamW moment")
        _require_dtensors(batch, "batch")
        with activation_rules(mesh):
            return step(params, opt_state, batch)

    return train_step


def make_grad_accum_train_step(model, opt: AdamW, microbatches: int) -> Callable:
    """Gradient accumulation: the batch split into ``microbatches`` slices
    along its first axis, taken one after another (the reference's scan),
    their gradients summed in float32 and divided by the count before one
    optimizer update."""

    def train_step(params, opt_state, batch):
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} rows does not split into {microbatches} microbatches")
        size = b // microbatches
        loss_sum = 0.0
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        for i in range(microbatches):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
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
