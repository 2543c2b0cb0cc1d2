"""The port's fingerprint-frequency histogram against the reference.

The same seeded numpy counts go through ``repro.kernels.ops.ffh_counts``
(the Pallas kernel in interpret mode), the reference's ``ffh_ref`` and the
port's plain version (``ffh_torch``, through ``ops.ffh_counts`` on the CPU),
its oracle and ``core.ffh.ffh_from_counts``: all equal, exactly.  The CUDA
kernel is held against the plain version in ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import ffh_ref as ref_ffh_ref
from repro_torch.core.ffh import ffh_from_counts
from repro_torch.kernels import ops
from repro_torch.kernels.histogram import LANES, NBINS_DEFAULT, TILE, ffh, ffh_torch
from repro_torch.kernels.ref import ffh_ref


def _counts(n, seed, hi=60):
    """Heavy-tailed occurrence counts (most 1, then 2, ...) with zeros,
    negatives and values far above the bins mixed in."""
    rng = np.random.default_rng(seed)
    c = rng.geometric(0.45, size=n).astype(np.int32)
    c[rng.random(n) < 0.1] = 0
    neg = rng.random(n) < 0.05
    c[neg] = -rng.integers(1, 5, size=int(neg.sum()))
    big = rng.random(n) < 0.03
    c[big] = rng.integers(hi, 10 * hi, size=int(big.sum()))
    if n:
        c[0] = np.iinfo(np.int32).min
        c[-1] = np.iinfo(np.int32).max
    return c


def test_constants_match_reference():
    from repro.kernels import histogram as ref_hist

    assert (TILE, LANES, NBINS_DEFAULT) == (ref_hist.TILE, ref_hist.LANES, ref_hist.NBINS_DEFAULT)


@pytest.mark.parametrize("n", [1, 3, 1000, 1024, 5000])
@pytest.mark.parametrize("nbins", [1, 2, 3, 40, 128])
def test_ffh_matches_pallas_and_oracles(n, nbins):
    c = _counts(n, seed=n * 1000 + nbins)
    want = np.asarray(ref_ops.ffh_counts(c, nbins, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(ref_ffh_ref(jnp.asarray(c), nbins)))
    t = torch.from_numpy(c)
    for got in (ffh_torch(t, nbins), ops.ffh_counts(c, nbins, device="cpu"),
                ops.ffh_counts(t, nbins), ffh(t, nbins), ffh_ref(t, nbins)):
        assert got.dtype == torch.int32 and got.shape == (nbins,)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ffh_from_counts(c[c > 0].astype(np.int64), max_bins=nbins), want)


def test_ffh_empty_and_all_ignored():
    for c in (np.zeros(0, np.int32), np.zeros(7, np.int32), -np.ones(9, np.int32)):
        assert not ops.ffh_counts(c, 40, device="cpu").any()


def test_ffh_rejects_bad_input():
    with pytest.raises(TypeError):
        ffh(torch.ones(8, dtype=torch.int64))
    with pytest.raises(TypeError):
        ffh(torch.ones((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        ffh(torch.ones(8, dtype=torch.int32), nbins=0)


def test_ffh_counts_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        ops.ffh_counts(np.ones(8, np.int32))
