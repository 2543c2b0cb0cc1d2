"""The port's paged decode attention against the reference's Pallas kernel.

The same seeded numpy inputs go through ``repro.kernels.paged_attention``
(interpret mode) and the port's plain version (``paged_attention_torch``,
through the ``paged_attention`` wrapper on the CPU), at the reference tests'
shapes, with pages shared between rows, a row of length 0 (whose every
logit is masked: both return the mean of V over the row's slots), and bf16.
Tolerances are the reference tests' own: float32 atol 3e-5, bf16 atol and
rtol 0.05.  The CUDA kernel is held against the plain version in
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as ref_paged_attention
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_torch


def _inputs(rng, b, h, kvh, d, ps, pps, npages=None, zero_row=True):
    npages = npages or pps * b + 4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((npages, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, kvh, d)).astype(np.float32)
    table = rng.integers(0, npages, (b, pps)).astype(np.int32)
    table[:, 0] = 1  # page 1 shared by every row (a deduplicated prefix)
    lengths = rng.integers(ps, ps * pps + 1, (b,)).astype(np.int32)
    if zero_row:
        lengths[-1] = 0
    return q, kp, vp, table, lengths


def _ref(arrays, dtype=jnp.float32):
    q, kp, vp, table, lengths = arrays
    out = ref_paged_attention(jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
                              jnp.asarray(vp, dtype), jnp.asarray(table), jnp.asarray(lengths),
                              interpret=True)
    return np.asarray(out, np.float32)


def _port(arrays, dtype=torch.float32):
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in arrays)
    return paged_attention(q.to(dtype), kp.to(dtype), vp.to(dtype), table, lengths)


@pytest.mark.parametrize("B,H,KVH,D,ps,pps", [
    (2, 4, 2, 32, 16, 4),
    (3, 8, 8, 64, 32, 3),
    (2, 8, 2, 16, 8, 5),
    (1, 16, 4, 128, 8, 2),
    (3, 32, 4, 64, 16, 6),   # TinyLlama's heads
])
def test_plain_matches_pallas(B, H, KVH, D, ps, pps):
    arrays = _inputs(np.random.default_rng(B * 100 + H), B, H, KVH, D, ps, pps)
    got = _port(arrays)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), _ref(arrays), atol=3e-5)
    np.testing.assert_array_equal(got.numpy(), paged_attention_torch(
        *(torch.from_numpy(a) for a in arrays)).numpy())


def test_length_zero_row_is_the_mean_of_v():
    q, kp, vp, table, lengths = _inputs(np.random.default_rng(5), 2, 4, 2, 32, 16, 3)
    lengths[:] = 0
    got = _port((q, kp, vp, table, lengths)).numpy()
    np.testing.assert_allclose(got, _ref((q, kp, vp, table, lengths)), atol=3e-5)
    for i in range(2):
        mean = vp[table[i]].reshape(-1, 2, 32).mean(axis=0)  # (KVH, D)
        np.testing.assert_allclose(got[i], np.repeat(mean, 2, axis=0), atol=3e-5)


def test_shared_pages_give_identical_rows():
    rng = np.random.default_rng(7)
    q1 = rng.standard_normal((1, 4, 32)).astype(np.float32)
    q = np.concatenate([q1, q1])
    kp = rng.standard_normal((6, 16, 2, 32)).astype(np.float32)
    vp = rng.standard_normal((6, 16, 2, 32)).astype(np.float32)
    table = np.asarray([[0, 2, 4], [0, 2, 4]], np.int32)
    lengths = np.asarray([48, 48], np.int32)
    got = _port((q, kp, vp, table, lengths)).numpy()
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got, _ref((q, kp, vp, table, lengths)), atol=3e-5)
    # a page id repeated inside one row
    table = np.asarray([[3, 3, 3], [3, 0, 3]], np.int32)
    np.testing.assert_allclose(_port((q, kp, vp, table, lengths)).numpy(),
                               _ref((q, kp, vp, table, lengths)), atol=3e-5)


@pytest.mark.parametrize("B,H,KVH,D,ps,pps", [(2, 4, 2, 32, 8, 3), (4, 32, 4, 64, 16, 4)])
def test_bf16_matches_pallas(B, H, KVH, D, ps, pps):
    arrays = _inputs(np.random.default_rng(9 + B), B, H, KVH, D, ps, pps, npages=5 + B)
    got = _port(arrays, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _ref(arrays, jnp.bfloat16),
                               atol=0.05, rtol=0.05)


def test_out_of_range_page_ids_are_clamped():
    q, kp, vp, table, lengths = _inputs(np.random.default_rng(11), 2, 4, 2, 32, 16, 3)
    wild = table.copy()
    wild[0, 1], wild[1, 2] = -5, 10_000
    np.testing.assert_array_equal(
        _port((q, kp, vp, wild, lengths)).numpy(),
        _port((q, kp, vp, np.clip(wild, 0, kp.shape[0] - 1), lengths)).numpy())


def test_rejects_bad_shapes():
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _inputs(np.random.default_rng(3), 2, 4, 2, 32, 16, 3))
    with pytest.raises(ValueError, match="multiple"):
        paged_attention(q[:, :3], kp, vp, table, lengths)
    with pytest.raises(TypeError):
        paged_attention(q, kp, vp, table.long(), lengths)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, table[:1], lengths)
