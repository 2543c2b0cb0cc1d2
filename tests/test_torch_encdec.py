"""The port's Whisper-style encoder-decoder (``repro_torch.models.encdec``)
against the reference's, on the CPU at Whisper-small's smoke size.

The reference's weights come over through ``params_from_jax`` (the norm
scales made random so they act).  Float32 unless a case says bf16, with the
dense tests' tolerances:

* ``train_loss`` (encoder over stub frame embeddings, decoder with
  cross-attention) within 1e-5 (bf16 2e-2), every gradient within 1e-4;
* ``encode_prefill``: the encoder states and every layer's cross-attention
  K/V within 1e-4 (bf16 5e-2 of the largest entry);
* 6 ``decode_step``s against the self and cross caches: logits within 1e-4
  (bf16 5e-2), and the self-attention cache after them;
* decode continues a teacher-forced pass: each step's logits equal the
  train path's at that position (the check the card runs at full size).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models as RM
from repro_torch.configs import get_config
from repro_torch.models import build_model, encdec
from repro_torch.models.convert import params_from_jax
from repro_torch.pytree import flatten_with_path, leaves

ARCH = "whisper-small"
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(compute_dtype, seed=0):
    cfg = RC.get_config(ARCH, smoke=True).replace(compute_dtype=compute_dtype)
    ref = RM.build_model(cfg)
    rng = np.random.default_rng(seed)

    def randomize(path, x):
        if "ln" in getattr(path[-1], "key", ""):
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        return np.array(x)

    tree = jax.tree_util.tree_map_with_path(randomize, jax.tree.map(
        np.asarray, ref.init(jax.random.PRNGKey(0))))
    port_cfg = get_config(ARCH, smoke=True).replace(compute_dtype=compute_dtype)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    return ref, tree, port_cfg, params_from_jax(tree, port_cfg)


def _batch(cfg, b=2, s=32, frames=48, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[:, -2:] = 0.0
    return {"encoder_embeds": rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32),
            "decoder_tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _close(got, want, tol, scaled=False, msg=""):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if scaled else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale, err_msg=msg)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(compute_dtype):
    ref, tree, cfg, params = _pair(compute_dtype)
    batch = _batch(cfg)
    args = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch)
    if compute_dtype == "float32":
        (want, _), want_g = jax.jit(jax.value_and_grad(ref.train_loss, has_aux=True))(*args)
    else:
        want, _ = ref.train_loss(*args)
    for t in leaves(params):
        t.requires_grad_(True)
    got, metrics = build_model(cfg).train_loss(params, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
    tol = LOSS_TOL[compute_dtype]
    np.testing.assert_allclose(got.item(), float(want), rtol=tol, atol=tol)
    assert metrics["moe_aux"].item() == 0.0
    got.backward()
    if compute_dtype != "float32":
        return
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g), cfg)
    for (path, t), w in zip(flatten_with_path(params), leaves(want_g)):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), atol=1e-4, err_msg="/".join(path))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_encode_prefill_and_decode_match_reference(compute_dtype):
    ref, tree, cfg, params = _pair(compute_dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    batch = _batch(cfg)
    tol, scaled = LOGIT_TOL[compute_dtype], compute_dtype != "float32"
    embeds = batch["encoder_embeds"]
    want_enc, want_cache = ref.prefill(jp, {"encoder_embeds": jnp.asarray(embeds)})
    model = build_model(cfg)
    enc, cache = model.prefill(params, {"encoder_embeds": torch.from_numpy(embeds)})
    _close(enc, want_enc, tol, scaled, "encoder states")
    assert set(cache) == set(want_cache)
    for key in cache:
        assert tuple(cache[key].shape) == want_cache[key].shape, key
        _close(cache[key], want_cache[key], tol, scaled, key)
    model.load(params)
    step = jax.jit(ref.decode_step) if compute_dtype == "float32" else ref.decode_step
    toks = batch["decoder_tokens"]
    for pos in range(6):
        want, want_cache = step(jp, want_cache, jnp.asarray(toks[:, pos:pos + 1]),
                                jnp.int32(pos))
        got, cache = model.decode_step(cache, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert got.dtype == getattr(torch, compute_dtype)
        _close(got, want, tol, msg=f"step {pos}")
    _close(cache["self_k"], want_cache["self_k"], tol, scaled, "self_k")


def test_decode_follows_the_teacher_forced_decoder():
    """Each decode step's logits are the train path's at that position."""
    _, _, cfg, params = _pair("float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, s=8).items()}
    enc = encdec.encode(params, batch["encoder_embeds"], cfg)
    logits = encdec.decoder_logits(params, enc, batch["decoder_tokens"], cfg)
    _, cache = encdec.encode_prefill(params, batch["encoder_embeds"], cfg, self_slots=8)
    cast = encdec.cast_params(params, cfg)
    for pos in range(8):
        got, cache = encdec.decode_step(cast, cache, batch["decoder_tokens"][:, pos:pos + 1], pos,
                                        cfg)
        np.testing.assert_allclose(got.numpy(), logits[:, pos].numpy(), atol=1e-4)
