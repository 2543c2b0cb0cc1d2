"""The port's dense decoder on the training and prefill paths against the
reference, on the CPU at smoke size, for all four dense configs.

The reference's weights come over through ``models.convert.params_from_jax``
(its gradient tree through the same converter).  Both packages compute in
float32 unless a case says bf16:

* configs: ``dataclasses.asdict`` of every dense id, full and smoke, equals
  the reference's (the other ids: ``tests/test_torch_block_models.py``);
* ``train_loss`` and its ``ce_loss`` within 1e-5 (bf16: 2e-2), every
  gradient within 1e-4 (float32);
* ``prefill`` logits and K/V caches within 1e-4 (bf16: 5e-2), and a
  ``decode_step`` continuing from the cache within 1e-4 (bf16: 5e-2) of the
  reference's decode step from its own cache.  The caches' entries reach
  about 8, where a bf16 step is 2^-5, and a layer's input that rounds one
  step apart in a few elements (the two frameworks sum the matrix products
  in another order) moves most of the next layer's K and V by a step or
  two; so a cache's bf16 tolerance is 5e-2 of its largest entry (at least
  5e-2), the logits' stays absolute;
* Phi-3-medium groups 4 query heads to a KV head (40 over 10); its smoke
  config has 2, so a smoke variant with 8 heads over 2 covers the grouping.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
import repro.models.layers as RL
from repro_torch.configs import get_config
from repro_torch.models import build_model, layers, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.pytree import flatten_with_path, leaves

DENSE = ["tinyllama-1.1b", "deepseek-67b", "yi-34b", "phi3-medium-14b"]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
GRAD_TOL = 1e-4
FOUR_GROUPS = {"num_heads": 8, "num_kv_heads": 2}  # Phi-3-medium's 4 query heads a KV head
CASES = [(a, dt, {}) for a in DENSE for dt in ("float32", "bfloat16")] + [
    ("phi3-medium-14b", dt, FOUR_GROUPS) for dt in ("float32", "bfloat16")]
CASE_IDS = [f"{a}-{dt}{'-4groups' if x else ''}" for a, dt, x in CASES]


def _ref_fn(fn, compute_dtype):
    """The reference's function, compiled in float32 (for speed); in bf16
    called op by op, as the reference's tests call it, since a compiled bf16
    function may keep float32 between operations."""
    return jax.jit(fn) if compute_dtype == "float32" else fn


@functools.lru_cache(maxsize=None)
def _ref_init(arch, extra_items=()):
    """The reference's initial weights of a smoke config (float32 whatever
    the compute dtype), as numpy; made once per config."""
    cfg = RC.get_config(arch, smoke=True).replace(**dict(extra_items))
    return jax.tree.map(np.asarray, RM.build_model(cfg).init(jax.random.PRNGKey(0)))


def _pair(arch, compute_dtype, extra=None, seed=0):
    """The reference's smoke model with random weights (norm scales too, so
    the ``(1 + scale)`` path is exercised), its parameters as numpy, and the
    port's config and parameters carrying the same weights."""
    cfg = RC.get_config(arch, smoke=True).replace(compute_dtype=compute_dtype, **(extra or {}))
    ref = RM.build_model(cfg)
    tree = jax.tree.map(np.copy, _ref_init(arch, tuple(sorted((extra or {}).items()))))
    rng = np.random.default_rng(seed)
    layer = tree["scan"]["pos0"]
    for name in ("ln1", "ln2"):
        layer[name] = rng.normal(0, 0.2, layer[name].shape).astype(np.float32)
    tree["final_ln"] = rng.normal(0, 0.2, tree["final_ln"].shape).astype(np.float32)
    port_cfg = get_config(arch, smoke=True).replace(compute_dtype=compute_dtype, **(extra or {}))
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    return ref, tree, port_cfg, params_from_jax(tree, port_cfg)


def _batch(vocab, b, s, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[:, -3:] = 0.0  # a padded tail
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_match_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(RC.get_config(arch, smoke))


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):  # max(sum(mask), 1) guards the empty mask
        got = layers.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                           torch.from_numpy(m))
        want = RL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    bf16 = torch.from_numpy(logits).to(torch.bfloat16)  # cast to float32 before the log-sum-exp
    assert layers.token_losses(bf16, torch.from_numpy(labels)).dtype == torch.float32


@pytest.mark.parametrize("arch,compute_dtype,extra", CASES, ids=CASE_IDS)
def test_train_loss_and_grads_match_reference(arch, compute_dtype, extra):
    ref, tree, cfg, params = _pair(arch, compute_dtype, extra)
    batch = _batch(cfg.vocab_size, 2, 24)
    args = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch)
    if compute_dtype == "float32":
        (want, want_m), want_g = jax.jit(jax.value_and_grad(ref.train_loss, has_aux=True))(*args)
    else:
        want, want_m = ref.train_loss(*args)
    for t in leaves(params):
        t.requires_grad_(True)
    got, got_m = build_model(cfg).train_loss(params, _torch_batch(batch))
    assert got.dtype == torch.float32
    tol = LOSS_TOL[compute_dtype]
    np.testing.assert_allclose(got.item(), float(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_m["ce_loss"].item(), float(want_m["ce_loss"]), rtol=tol,
                               atol=tol)
    assert got_m["moe_aux"].item() == float(want_m["moe_aux"]) == 0.0
    got.backward()
    assert all(t.grad is not None and t.grad.dtype == torch.float32 for t in leaves(params))
    if compute_dtype != "float32":
        return
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g), cfg)
    for (path, t), w in zip(flatten_with_path(params), leaves(want_g)):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), atol=GRAD_TOL, err_msg="/".join(path))


def test_train_loss_in_512_token_chunks_matches_reference():
    """1,024 tokens: two loss chunks, each recomputed in the backward pass,
    and attention over two of the reference's 512-key chunks (one layer, to
    keep the reference's run short)."""
    ref, tree, cfg, params = _pair("tinyllama-1.1b", "float32", {"num_layers": 1})
    batch = _batch(cfg.vocab_size, 1, 1024)
    (want, _), want_g = jax.jit(jax.value_and_grad(ref.train_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    params["unembed"].requires_grad_(True)
    wq = params["scan"]["pos0"]["mixer"]["wq"].requires_grad_(True)
    got, _ = transformer.train_loss(params, _torch_batch(batch), cfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(params["unembed"].grad.numpy(),
                               np.asarray(want_g["unembed"]), atol=GRAD_TOL)
    np.testing.assert_allclose(wq.grad.numpy(),
                               np.asarray(want_g["scan"]["pos0"]["mixer"]["wq"]), atol=GRAD_TOL)


def test_attention_train_refuses_lengths_the_reference_rejects():
    ref, tree, cfg, params = _pair("tinyllama-1.1b", "float32", {"num_layers": 1})
    batch = _batch(cfg.vocab_size, 1, 600)
    with pytest.raises(AssertionError):
        ref.train_loss(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    with pytest.raises(ValueError, match="multiple of 512"):
        transformer.train_loss(params, _torch_batch(batch), cfg)


@pytest.mark.parametrize("arch,compute_dtype,extra", CASES, ids=CASE_IDS)
def test_prefill_and_decode_match_reference(arch, compute_dtype, extra):
    ref, tree, cfg, params = _pair(arch, compute_dtype, extra)
    jparams = jax.tree.map(jnp.asarray, tree)
    b, s = 2, 20
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    want, want_cache = _ref_fn(ref.prefill, compute_dtype)(jparams, {"inputs": jnp.asarray(toks)})
    model = build_model(cfg)
    got, cache = model.prefill(params, {"inputs": torch.from_numpy(toks)}, slots=s + 1)
    tol = LOGIT_TOL[compute_dtype]
    assert got.dtype == getattr(torch, compute_dtype) and got.shape == (b, cfg.vocab_size)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)
    want_kv = want_cache["scan"]["pos0"]
    for mine, theirs in ((cache.k, want_kv.k), (cache.v, want_kv.v)):
        assert mine.shape == (cfg.num_layers, b, s + 1, cfg.num_kv_heads, cfg.head_dim)
        theirs = np.asarray(theirs, np.float32)
        scale = 1.0 if compute_dtype == "float32" else max(1.0, float(np.abs(theirs).max()))
        np.testing.assert_allclose(mine[:, :, :s].float().numpy(), theirs, atol=tol * scale)
        assert not mine[:, :, s:].any()
    # one decode step at position S continues both caches (the reference's
    # padded to S + 1 slots)
    pad = [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]
    want_cache["scan"]["pos0"] = type(want_kv)(jnp.pad(want_kv.k, pad), jnp.pad(want_kv.v, pad))
    nxt = np.array([[5], [17]], np.int32)
    want, _ = _ref_fn(ref.decode_step, compute_dtype)(jparams, want_cache, jnp.asarray(nxt),
                                                      jnp.int32(s))
    got, cache = model.load(params).decode_step(cache, torch.from_numpy(nxt), s)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


def test_prefill_then_decode_equals_longer_prefill():
    """The check the card runs at full width: prefill of S - 1 tokens and one
    decode step give the last-token logits of a prefill of S tokens; a cache
    too small for the prompt is refused."""
    _, _, cfg, params = _pair("phi3-medium-14b", "float32", FOUR_GROUPS)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 16)))
    want, _ = transformer.prefill(params, toks, None, cfg)
    _, cache = transformer.prefill(params, toks[:, :-1], None, cfg, slots=16)
    got, _ = transformer.decode_step(transformer.cast_params(params, cfg), cache, toks[:, -1:],
                                     15, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="slots"):
        transformer.prefill(params, toks, None, cfg, slots=15)
