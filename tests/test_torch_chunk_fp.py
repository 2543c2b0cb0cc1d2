"""The chunk kernel's order of work against the reference, on the CPU.

``ops.chunk_fingerprint_batched_torch`` repeats the arithmetic of the CUDA
chunk gather + fingerprint kernel (``csrc/cdc.cu``) in its order: 16-byte
units aligned by the start's phase, groups reduced a batch at a time, the
constant zero-group sum, one fold per key set.  The same seeded rows and
chunks go through it, through the port's plain version
(``chunk_fingerprint_torch``) and through the reference's fused gather
(``_chunk_fp_jit``, its Pallas kernel in interpret mode); the digests must
be equal, bit for bit.  ``tests/test_torch_gpu.py`` holds the kernel itself
against the plain version on the card.
"""

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as ROPS
from repro_torch.kernels import ops
from repro_torch.kernels.cdc import SEG_BYTES
from repro_torch.kernels.fingerprint import NUM_HASHES, SEEDS, _finish, _fold, fingerprint_torch
from repro_torch.kernels.ref import chunk_edge_cases

ROWS = 24
G = ops.CHUNK_FP_BATCH


def _rows(kind: str, seed: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros((ROWS, 520), dtype=np.uint32)
    if kind == "ones":
        return np.full((ROWS, 520), 0xFFFFFFFF, dtype=np.uint32)
    x = np.random.default_rng(seed).integers(0, 2**32, size=(ROWS, 520), dtype=np.uint32)
    x[0] = 0           # zero bytes
    x[1] = 0xFFFFFFFF  # every byte 0xFF
    return x


def _chunks(case: str, max_size: int) -> tuple:
    """(starts, lens) of one family of edge shapes (``ref.chunk_edge_cases``,
    the card tests' too), or of random chunks; all but ``outside`` inside
    the payload."""
    if case != "random":
        return chunk_edge_cases(ROWS, max_size, G)[case]
    rng = np.random.default_rng(max_size)
    lens = rng.integers(1, max_size + 1, size=40)
    starts = np.array([rng.integers(0, ROWS * SEG_BYTES - n + 1) for n in lens], dtype=np.int64)
    return starts, lens.astype(np.int32)


def _reference(x: np.ndarray, starts: np.ndarray, lens: np.ndarray, w_pad: int) -> np.ndarray:
    pad = (-starts.size) % 256  # the reference's fingerprint tile
    s = np.concatenate([starts, np.zeros(pad, dtype=np.int64)]).astype(np.int32)
    n = np.concatenate([lens, np.zeros(pad, dtype=np.int32)])
    out = ROPS._chunk_fp_jit(jnp.asarray(x), jnp.asarray(s), jnp.asarray(n), w_pad, True)
    return np.asarray(out)[: starts.size]


def _port(fn, x, starts, lens, w_pad, **kw) -> np.ndarray:
    t = torch.from_numpy(x.view(np.int32))
    out = fn(t, torch.from_numpy(starts), torch.from_numpy(lens), w_pad, **kw)
    return out.numpy().view(np.uint32)


def test_zero_group_sums_follow_the_hash():
    """The constant zero-group sums equal what the group sum gives a zero
    group: one fold of each from the seed, finished, is the digest of a
    128-word block of zeros."""
    z = fingerprint_torch(torch.zeros((1, 128), dtype=torch.int32)).numpy().view(np.uint32)[0]
    for k in range(NUM_HASHES):
        h = _fold(torch.tensor([SEEDS[k]]), ops.ZERO_GROUP_SUMS[k], 0)
        assert int(_finish(h, 128)[0]) == int(z[k])


@pytest.mark.parametrize("w_pad", [1024, 4096])
@pytest.mark.parametrize("case", ["phases", "halos", "payload_end", "random"])
@pytest.mark.parametrize("kind", ["random", "zeros", "ones"])
def test_batched_order_matches_reference(kind, case, w_pad):
    x = _rows(kind, seed=w_pad)
    starts, lens = _chunks(case, 4 * w_pad)
    assert starts.min() >= 0 and (starts + lens).max() <= ROWS * SEG_BYTES
    want = _reference(x, starts, lens, w_pad)
    np.testing.assert_array_equal(_port(ops.chunk_fingerprint_torch, x, starts, lens, w_pad), want)
    np.testing.assert_array_equal(
        _port(ops.chunk_fingerprint_batched_torch, x, starts, lens, w_pad), want)


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_batched_order_at_other_batch_sizes(batch):
    """The order of work does not change the digests: any batch size."""
    x = _rows("random", seed=batch)
    starts, lens = _chunks("phases", 4096)
    np.testing.assert_array_equal(
        _port(ops.chunk_fingerprint_batched_torch, x, starts, lens, 1024, batch=batch),
        _port(ops.chunk_fingerprint_torch, x, starts, lens, 1024))


@pytest.mark.parametrize("w_pad", [128, 4096])
def test_batched_order_outside_the_payload(w_pad):
    """Bytes before offset 0 and past the payload read as zero; lengths of 0
    and below hash an empty image (the reference does not define these)."""
    x = _rows("random", seed=7)
    starts, lens = _chunks("outside", 4 * w_pad)
    np.testing.assert_array_equal(
        _port(ops.chunk_fingerprint_batched_torch, x, starts, lens, w_pad),
        _port(ops.chunk_fingerprint_torch, x, starts, lens, w_pad))
