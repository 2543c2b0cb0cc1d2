"""The reference's remat policies ("none", "full", "dots") in the port's
``train_loss`` (``repro_torch.models.transformer``, ``encdec``, ``Model``),
on the CPU.

* Each policy against the reference's ``train_loss(..., remat=...)`` on the
  smoke variants of TinyLlama, Mixtral (MoE, sliding window: the banded
  schedule), RecurrentGemma (RG-LRU, local attention, a remainder layer)
  and Whisper (encoder-decoder) at S = 1,024, two flash chunks, computing
  in float32: the loss within 1e-5, every gradient within 1e-4.
* The port's three policies give the same loss and gradients within 1e-6.
* What each policy recomputes, counted by op and not by clock: "full"
  reruns each group's weight products in the backward pass, "dots" keeps
  their outputs and reruns the attention's batched products, "none"
  reruns neither; and the activations kept outside the checkpoints shrink.
* Any other policy raises ``ValueError``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as RC
import repro.models as RM
from repro_torch.configs import get_config
from repro_torch.models import build_model, encdec, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.pytree import flatten_with_path, leaves

ARCHS = ["tinyllama-1.1b", "mixtral-8x7b", "recurrentgemma-2b", "whisper-small"]
POLICIES = ["none", "full", "dots"]
S = 1024
LOSS_TOL, GRAD_TOL, SAME_TOL = 1e-5, 1e-4, 1e-6


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reference's smoke config and weights as numpy (norm scales
    random, so they act), and the port's config."""
    cfg = RC.get_config(arch, smoke=True).replace(compute_dtype="float32")
    rng = np.random.default_rng(0)

    def randomize(path, x):
        if getattr(path[-1], "key", "").startswith("ln") or "final_ln" in str(path[-1]):
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        return np.array(x)

    tree = jax.tree_util.tree_map_with_path(randomize, jax.tree.map(
        np.asarray, RM.build_model(cfg).init(jax.random.PRNGKey(0))))
    port_cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    return cfg, tree, port_cfg


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (1, S + 1)).astype(np.int32)
    mask = np.ones((1, S), np.float32)
    mask[:, -5:] = 0.0
    batch = {"targets": toks[:, 1:], "mask": mask}
    if cfg.is_encdec:
        batch["encoder_embeds"] = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
        batch["decoder_tokens"] = toks[:, :-1]
    else:
        batch["inputs"] = toks[:, :-1]
    return batch


@functools.lru_cache(maxsize=None)
def _port(arch, remat):
    """The port's loss and gradients (numpy, in the reference's leaf order)
    under ``remat``."""
    _, tree, cfg = _pair(arch)
    params = params_from_jax(tree, cfg)
    for t in leaves(params):
        t.requires_grad_(True)
    loss, _ = build_model(cfg, remat=remat).train_loss(
        params, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    loss.backward()
    return loss.item(), [("/".join(p), t.grad.numpy()) for p, t in flatten_with_path(params)]


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_under_remat_matches_reference(arch, remat):
    cfg, tree, port_cfg = _pair(arch)
    ref = RM.build_model(cfg, remat=remat)
    args = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, _batch(cfg))
    (want, _), want_g = jax.jit(jax.value_and_grad(ref.train_loss, has_aux=True))(*args)
    got, grads = _port(arch, remat)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g), port_cfg)
    for (path, g), w in zip(grads, leaves(want_g)):
        np.testing.assert_allclose(g, w.numpy(), atol=GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_policies_give_the_same_numbers(arch):
    loss, grads = _port(arch, "none")
    for remat in ("full", "dots"):
        other, other_grads = _port(arch, remat)
        np.testing.assert_allclose(other, loss, rtol=SAME_TOL, atol=SAME_TOL, err_msg=remat)
        for (path, g), (_, h) in zip(grads, other_grads):
            np.testing.assert_allclose(h, g, atol=SAME_TOL, err_msg=f"{remat} {path}")


class _Ops(TorchDispatchMode):
    """Counts the matrix products dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.counts["mm"] += 1
        elif name in ("bmm", "baddbmm"):
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(remat):
    """Products dispatched by the backward pass of TinyLlama's smoke model
    at 256 tokens, and the bytes kept for it outside any checkpoint."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    for t in leaves(params):
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=torch.Generator().manual_seed(1))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": torch.ones(2, 256)}
    kept = []

    def pack(t):
        kept.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        x, _ = transformer.forward_train(params, batch["inputs"],
                                         transformer.default_positions(batch["inputs"]), cfg,
                                         remat=remat)
    with _Ops() as ops:
        x.float().square().sum().backward()
    return ops.counts, sum(kept)


def test_policies_recompute_what_the_reference_recomputes():
    none, none_kept = _backward_products("none")
    full, full_kept = _backward_products("full")
    dots, dots_kept = _backward_products("dots")
    # the weight products rerun under "full" only, the attention's forward
    # products (QK^T, PV) under both
    assert full["mm"] > none["mm"] == dots["mm"]
    assert full["bmm"] > none["bmm"] and dots["bmm"] > none["bmm"]
    assert full_kept < none_kept and dots_kept < none_kept


def test_unknown_policy_raises():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    with pytest.raises(ValueError):
        build_model(cfg, remat="dot")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    toks = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(ValueError):
        transformer.forward_train(params, toks, transformer.default_positions(toks), cfg,
                                  remat="everything")
    wcfg = get_config("whisper-small", smoke=True)
    wparams = encdec.init_encdec_params(torch.Generator().manual_seed(0), wcfg)
    with pytest.raises(ValueError):
        encdec.encode(wparams, torch.zeros(1, 8, wcfg.d_model), wcfg, remat="Full")
