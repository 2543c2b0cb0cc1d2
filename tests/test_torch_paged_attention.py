"""The port's paged decode attention against the reference's Pallas kernel.

The same seeded numpy inputs go through ``repro.kernels.paged_attention``
(interpret mode) and the port's plain version (``paged_attention_torch``,
through the ``paged_attention`` wrapper on the CPU), at the reference tests'
shapes, with pages shared between rows, a row of length 0 (whose every
logit is masked: both return the mean of V over the row's slots), and bf16.
Tolerances are the reference tests' own: float32 atol 3e-5, bf16 atol and
rtol 0.05.  The CUDA kernel is held against the plain version in
``tests/test_torch_gpu.py``.

``paged_attention_split_torch`` spells out the kernel's split-and-merge
arithmetic (per-split max, sum and weighted V, merged with log-sum-exp
weights).  It is held against the reference at several split sizes at the
same float32 atol 3e-5: the merge only regroups the softmax's sums, every
weight ``e^(m_s - M)`` is at most 1 and the outputs are of order 1, so the
regrouping moves a result by a few float32 rounding steps (some 1e-7 at
these sizes), far inside the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as ref_paged_attention
from repro_torch.kernels.paged_attention import (
    SPLIT_TOKENS,
    bf16_err_ratio,
    paged_attention,
    paged_attention_split_torch,
    paged_attention_torch,
    split_pages,
)


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


def _split_edge_inputs(rng, h, kvh, d, ps, pps, split):
    """Rows of length 0, 1, one page, one token into a page, exactly one
    split, one split + 1, ending on each later split edge, and the full
    table; later splits of the short rows are wholly past their lengths."""
    edges = [0, 1, ps, ps + 3, split * ps, split * ps + 1, pps * ps - 1, pps * ps]
    edges += [s * split * ps for s in range(2, -(-pps // split))]
    lengths = np.asarray(sorted({min(e, pps * ps) for e in edges}), np.int32)
    b = lengths.size
    q, kp, vp, table, _ = _inputs(rng, b, h, kvh, d, ps, pps, zero_row=False)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("split", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("H,KVH,D,ps,pps", [(4, 2, 32, 16, 7), (8, 2, 16, 8, 6)])
def test_split_merge_matches_pallas(split, H, KVH, D, ps, pps):
    arrays = _split_edge_inputs(np.random.default_rng(split * 10 + D), H, KVH, D, ps, pps, split)
    got = paged_attention_split_torch(*(torch.from_numpy(a) for a in arrays), split)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _ref(arrays), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), paged_attention_torch(
        *(torch.from_numpy(a) for a in arrays)).numpy(), atol=3e-5)


@pytest.mark.parametrize("split", [1, 2, 5])
def test_split_merge_length_zero_rows_are_the_mean_of_v(split):
    """Every split of a length-0 row is used (each logit at NEG_INF, each
    split's max NEG_INF): the merge gives the mean of V over every slot."""
    q, kp, vp, table, lengths = _inputs(np.random.default_rng(21), 3, 4, 2, 32, 16, 5)
    lengths[:] = 0
    got = paged_attention_split_torch(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)), split).numpy()
    np.testing.assert_allclose(got, _ref((q, kp, vp, table, lengths)), atol=3e-5)
    for i in range(3):
        mean = vp[table[i]].reshape(-1, 2, 32).mean(axis=0)
        np.testing.assert_allclose(got[i], np.repeat(mean, 2, axis=0), atol=3e-5)


def test_split_merge_bf16_matches_pallas():
    arrays = _split_edge_inputs(np.random.default_rng(4), 8, 2, 32, 16, 6, 4)
    t = [torch.from_numpy(a) for a in arrays]
    got = paged_attention_split_torch(t[0].bfloat16(), t[1].bfloat16(), t[2].bfloat16(),
                                      t[3], t[4], 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _ref(arrays, jnp.bfloat16),
                               atol=0.05, rtol=0.05)


@pytest.mark.parametrize("split", [2, 4])
def test_bf16_err_ratio_passes_rounding_and_fails_a_misweighted_merge(split):
    """The bf16 limit scaled to the outputs passes the split-and-merge
    arithmetic against the reference's bf16 kernel, and fails a merge that
    weighs every other split 1.3x, which atol/rtol 0.05 lets through."""
    b, h, kvh, d, ps, pps = 4, 8, 2, 64, 16, 16
    arrays = _inputs(np.random.default_rng(31 + split), b, h, kvh, d, ps, pps, zero_row=False)
    arrays[4][:] = ps * pps  # every row its whole table, 256 tokens
    want = torch.from_numpy(_ref(arrays, jnp.bfloat16)).bfloat16()
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in arrays)
    t16 = [x.bfloat16() for x in (q, kp, vp)]
    assert bf16_err_ratio(paged_attention_split_torch(*t16, table, lengths, split), want) <= 1
    k = t16[1][table.long()].float().reshape(b, pps * ps, kvh, d)
    v = t16[2][table.long()].float().reshape(b, pps * ps, kvh, d)
    logits = torch.einsum("bkgd,btkd->bkgt",
                          t16[0].float().reshape(b, kvh, h // kvh, d) * d ** -0.5, k)
    odd = (torch.arange(pps * ps) // (split * ps)) % 2 == 1
    logits = logits + torch.where(odd, float(np.log(1.3)), 0.0)
    bad = torch.einsum("bkgt,btkd->bkgd", torch.softmax(logits, -1), v).reshape(b, h, d)
    bad = bad.bfloat16()
    torch.testing.assert_close(bad.float(), want.float(), atol=0.05, rtol=0.05)
    assert bf16_err_ratio(bad, want) > 1


@pytest.mark.parametrize("pps,page,want", [
    (1, 16, 1), (7, 16, 7), (16, 16, 16), (17, 16, 16), (128, 16, 16), (128, 32, 8), (3, 32, 3),
])
def test_split_pages(pps, page, want):
    assert split_pages(pps, page) == want
    assert want * page <= max(SPLIT_TOKENS, page)
