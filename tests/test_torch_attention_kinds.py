"""The port's attention kinds (``repro_torch.models.attention``) and
position encodings against the reference, on the CPU in float32.

* Sliding-window / local attention over a whole sequence: at S > window
  both packages take the banded chunk schedule (``_banded_attend``,
  ``banded_attend``); outputs within 1e-5 (and at S <= window, where both
  mask the flash form).  Lengths: what the reference's banded path takes
  past 512 is taken; what its flash path rejects raises ``ValueError``.
* Ring decode: 3 x window steps of ``attention_decode`` against a
  ``min(window, slots)``-slot ring, outputs and caches within 1e-5 of the
  reference's ``attention_decode(window=...)``.
* Cross-attention: ``kv_override`` over a memory of another length, and the
  read-only decode against it.
* M-RoPE with three distinct position streams within 1e-5 of the
  reference's; with equal streams it equals standard RoPE bit for bit.
  Whisper's sinusoidal table equals the reference's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
import repro.models.layers as RL
from repro.models.layers import ParamFactory as RefFactory
from repro.models.layers import unzip_params
from repro_torch.models import attention, layers

D, H, KVH, HD = 32, 4, 2, 8
TOL = 1e-5


def _params(seed=0):
    p, _ = unzip_params(RA.init_attention(RefFactory(jax.random.PRNGKey(seed), jnp.float32),
                                          D, H, KVH, HD))
    p = jax.tree.map(np.array, p)
    return p, {k: torch.from_numpy(v) for k, v in p.items()}


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


def _ref_train(p, x, pos, **kw):
    fn = jax.jit(lambda p_, x_, pos_: RA.attention_train(p_, x_, pos_, **kw))
    return np.asarray(fn(p, jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("s,window", [(128, 32), (128, 64), (64, 32), (32, 64), (1024, 256)],
                         ids=["banded-4", "banded-2", "banded-1", "short", "banded-long"])
def test_windowed_attention_matches_reference(s, window, monkeypatch):
    p, pt = _params()
    x, pos = _x(2, s), _pos(2, s)
    calls = []
    banded = RA._banded_attend
    monkeypatch.setattr(RA, "_banded_attend", lambda *a, **kw: calls.append(1) or banded(*a, **kw))
    want = _ref_train(p, x, pos, window=window, rope_theta=1e4)
    assert bool(calls) == (s > window)  # the reference's banded schedule, past the window
    got, k, v = attention.attention_train(pt, torch.from_numpy(x), torch.from_numpy(pos),
                                          window=window, rope_theta=1e4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert k.shape == v.shape == (2, s, KVH, HD)


def test_window_lengths_refused_as_the_reference_refuses():
    """600 tokens: the reference's banded path takes a window of 200 (600 and
    200 are multiples of 200), its flash path asserts for a window of 256."""
    p, pt = _params()
    x, pos = _x(1, 600), _pos(1, 600)
    want = _ref_train(p, x, pos, window=200)
    got = attention.attention_train(pt, torch.from_numpy(x), torch.from_numpy(pos), window=200)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    with pytest.raises(AssertionError):
        _ref_train(p, x, pos, window=256)
    with pytest.raises(ValueError, match="multiple of 512"):
        attention.attention_train(pt, torch.from_numpy(x), torch.from_numpy(pos), window=256)


@pytest.mark.parametrize("slots,window", [(16, 16), (40, 16), (12, 16)],
                         ids=["ring-is-window", "slots-over-window", "slots-under-window"])
def test_ring_decode_matches_reference_past_the_window(slots, window):
    """The cache keeps ``min(window, slots)`` slots as a ring (the
    reference's ``init_cache``); 3 x window steps wrap it several times."""
    p, pt = _params()
    ring = min(window, slots)
    ref_cache = RA.init_kv_cache(2, ring, KVH, HD, jnp.float32)
    cache = attention.init_kv_cache(2, ring, KVH, HD, torch.float32)
    step = jax.jit(lambda c, x_, pos_: RA.attention_decode(p, x_, c, pos_, window=window,
                                                           rope_theta=1e4))
    for pos in range(3 * window):
        x = _x(2, 1, seed=100 + pos)
        want, ref_cache = step(ref_cache, jnp.asarray(x), jnp.int32(pos))
        rope = layers.rope_angles(torch.full((2, 1), pos), HD, 1e4)
        valid = attention.valid_slots(ring, pos, True)
        got = attention.attention_decode(pt, torch.from_numpy(x), cache.k, cache.v, pos, rope,
                                         valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=f"pos {pos}")
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref_cache.k), atol=TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(ref_cache.v), atol=TOL)


def test_cross_attention_matches_reference():
    p, pt = _params()
    x, mem = _x(2, 24), _x(2, 40, seed=2)
    k, v = (np.asarray(jnp.einsum("bsd,dhk->bshk", jnp.asarray(mem), p[w])) for w in ("wk", "wv"))
    want = _ref_train(p, x, _pos(2, 24), kv_override=(jnp.asarray(k), jnp.asarray(v)))
    mk, mv = attention.project_kv(pt, torch.from_numpy(mem))
    np.testing.assert_allclose(mk.numpy(), k, atol=TOL)
    got = attention.attention_train(pt, torch.from_numpy(x), None, kv_override=(mk, mv))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    want, _ = RA.attention_decode(p, jnp.asarray(x[:, :1]), RA.KVCache(jnp.asarray(k),
                                                                        jnp.asarray(v)),
                                  jnp.int32(7), cross=True)
    got = attention.cross_attention_decode(pt, torch.from_numpy(x[:, :1]), mk, mv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_bidirectional_attention_without_rope_matches_reference():
    """The encoder's attention: no mask, no rotation."""
    p, pt = _params()
    x = _x(2, 48)
    want = _ref_train(p, x, _pos(2, 48), causal=False, use_rope=False)
    got = attention.attention_train(pt, torch.from_numpy(x), None, causal=False, use_rope=False)
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=TOL)


SECTIONS = (1, 1, 2)   # head_dim / 2 = 4 bands


def test_mrope_matches_reference_with_distinct_streams():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 10, H, HD)).astype(np.float32)
    pos3 = rng.integers(0, 500, (3, 2, 10)).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(q), jnp.asarray(pos3), 1e6, SECTIONS)
    got = layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos3), 1e6, SECTIONS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    p, pt = _params()
    x = _x(2, 10)
    want = _ref_train(p, x, pos3, rope_theta=1e6, mrope_sections=SECTIONS)
    got = attention.attention_train(pt, torch.from_numpy(x), torch.from_numpy(pos3),
                                    rope_theta=1e6, mrope_sections=SECTIONS)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="sum"):
        layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos3), 1e6, (1, 1, 1))


def test_mrope_with_equal_streams_is_standard_rope_bit_for_bit():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 10, H, HD)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, (2, 10)).astype(np.int32))
    plain = layers.apply_rope(q, pos, 1e6)
    assert torch.equal(layers.apply_rope(q, pos, 1e6, SECTIONS), plain)
    assert torch.equal(layers.apply_rope(q, pos.expand(3, 2, 10), 1e6, SECTIONS), plain)


def test_sinusoidal_positions_match_reference_bit_for_bit():
    for s, d in ((1024, 768), (7, 64)):
        got = layers.sinusoidal_positions(s, d)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(RL.sinusoidal_positions(s, d)))
