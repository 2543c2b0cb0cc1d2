"""The port's decoder over the other block kinds on the prefill and decode
paths against the reference, on the CPU at smoke size (the configs and
helpers of ``tests/test_torch_block_models.py``), with the dense tests'
tolerances:

* ``prefill`` logits within 1e-4 (bf16 5e-2) and every layer's cache (K/V
  rings, RG-LRU and RWKV states) within 1e-4 (bf16 5e-2 of its largest
  entry), then a ``decode_step`` at position S from that cache against the
  reference's decode step from the same cache: logits and the new cache
  likewise;
* Qwen2-VL from embeddings at three distinct position streams;
* prefill then decode against a longer prefill, past the smoke windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import build_model, transformer
from repro_torch.pytree import leaves
from test_torch_block_models import (BLOCKS, CASE_IDS, CASES, LOGIT_TOL, _as_ref_layout,
                                     _close_trees, _pair, _ref_fn)


@pytest.mark.parametrize("arch,compute_dtype", CASES, ids=CASE_IDS)
def test_prefill_caches_and_decode_match_reference(arch, compute_dtype):
    ref, tree, cfg, params = _pair(arch, compute_dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    b, s = 2, 32
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    want, want_cache = _ref_fn(ref.prefill, compute_dtype)(jparams, {"inputs": jnp.asarray(toks)})
    model = build_model(cfg)
    got, cache = model.prefill(params, {"inputs": torch.from_numpy(toks)}, slots=s + 1)
    tol = LOGIT_TOL[compute_dtype]
    scaled = compute_dtype != "float32"
    assert got.dtype == getattr(torch, compute_dtype) and got.shape == (b, cfg.vocab_size)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)
    mine = _as_ref_layout(cache, cfg)
    # a full-attention layer holds S + 1 slots, the reference's S: the last is empty
    for leaf in leaves(mine):
        if leaf.ndim >= 4 and leaf.shape[-3] == s + 1:
            assert not leaf[..., s, :, :].any()
    _close_trees(_trim(mine, s), want_cache, tol, scaled, "prefill cache")
    # one decode step at position S from the port's cache, in both packages
    # (copied out: the port's step writes its cache in place while the
    # reference's dispatch may still read)
    ref_cache = jax.tree.unflatten(jax.tree.structure(want_cache),
                                   [jnp.array(t.float().numpy(), copy=True).astype(_jnp_dtype(t))
                                    for t in leaves(mine)])
    nxt = np.array([[5], [17]], np.int32)
    want, want_cache = _ref_fn(ref.decode_step, compute_dtype)(jparams, ref_cache,
                                                               jnp.asarray(nxt), jnp.int32(s))
    got, cache = model.load(params).decode_step(cache, torch.from_numpy(nxt), s)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)
    _close_trees(_as_ref_layout(cache, cfg), want_cache, tol, scaled, "decoded cache")


def _jnp_dtype(t):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[t.dtype]


def _trim(tree, s):
    """Full-attention K/V cut to the reference's S slots."""
    if isinstance(tree, dict):
        return {k: _trim(v, s) for k, v in tree.items()}
    return type(tree)(*(t[..., :s, :, :] if t.ndim >= 4 and t.shape[-3] == s + 1 else t
                        for t in tree))


def test_qwen2_vl_embeddings_at_three_position_streams_match_reference():
    """The VLM path: embeddings in, (3, B, S) positions whose temporal,
    height and width streams differ; ``train_loss`` and ``prefill``."""
    ref, tree, cfg, params = _pair("qwen2-vl-7b", "float32")
    rng = np.random.default_rng(3)
    b, s = 2, 24
    embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(s), np.arange(s) // 4, np.arange(s) % 4])[:, None].repeat(b, 1)
    pos = pos.astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"embeds": embeds, "positions": pos, "targets": toks,
             "mask": np.ones((b, s), np.float32)}
    jp = jax.tree.map(jnp.asarray, tree)
    want, _ = jax.jit(ref.train_loss)(jp, jax.tree.map(jnp.asarray, batch))
    got, _ = build_model(cfg).train_loss(params, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want, want_cache = jax.jit(ref.prefill)(jp, {"embeds": jnp.asarray(embeds),
                                                 "positions": jnp.asarray(pos)})
    got, cache = build_model(cfg).prefill(params, {"embeds": torch.from_numpy(embeds),
                                                   "positions": torch.from_numpy(pos)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    _close_trees(_as_ref_layout(cache, cfg), want_cache, 1e-4, False, "prefill cache")
    same, _ = build_model(cfg).prefill(params, {"embeds": torch.from_numpy(embeds),
                                                "positions": torch.from_numpy(pos[0])})
    assert not torch.allclose(same, got, atol=1e-3)  # the streams matter


def test_prefill_then_decode_equals_longer_prefill_for_every_block_kind():
    """The card's check at smoke size: prefill of S - 1 tokens (S - 32 and
    32 decode steps for RWKV6, whose prefill takes multiples of 32) then
    decode, against a prefill of S tokens; past the smoke windows of 32, so
    the rings wrap."""
    for arch in BLOCKS:
        _, _, cfg, params = _pair(arch, "float32")
        # MoE at a capacity no token overflows, in prefill and decode
        no_drop = cfg.num_experts / max(cfg.top_k, 1)
        cfg = cfg.replace(capacity_factor=no_drop)
        s = 96
        toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, s)))
        want, _ = transformer.prefill(params, toks, None, cfg)
        start = s - 32 if arch == "rwkv6-1.6b" else s - 1
        _, cache = transformer.prefill(params, toks[:, :start], None, cfg, slots=s)
        model = build_model(cfg).load(params)
        for pos in range(start, s):
            got, cache = model.decode_step(cache, toks[:, pos:pos + 1], pos,
                                           capacity_factor=no_drop)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, err_msg=arch)
