"""Fingerprint Frequency Histogram (FFH).

The FFH of a fingerprint multiset F is ``f = {f_1, f_2, ...}`` where ``f_j``
is the number of *distinct* fingerprints appearing exactly ``j`` times in F
(paper §IV-A). It is the sufficient statistic consumed by the unseen
estimator.

Host path: ``ffh_from_sample`` (numpy); the estimator calls it on every
estimation interval.
"""

from __future__ import annotations

import numpy as np


def occurrence_counts(sample: np.ndarray) -> np.ndarray:
    """Occurrence count of each distinct fingerprint in ``sample``."""
    if sample.size == 0:
        return np.zeros(0, dtype=np.int64)
    _, counts = np.unique(sample, return_counts=True)
    return counts


def ffh_from_counts(counts: np.ndarray, max_bins: int = 0) -> np.ndarray:
    """FFH ``f`` with ``f[j-1] = #{distinct fp with count == j}``.

    ``max_bins``: if positive, clip/pad to that many bins (counts beyond the
    last bin accumulate into it — matching the kernel's overflow-bin
    semantics).
    """
    if counts.size == 0:
        return np.zeros(max_bins, dtype=np.int64)
    top = int(counts.max())
    nbins = max_bins if max_bins > 0 else top
    f = np.zeros(nbins, dtype=np.int64)
    clipped = np.minimum(counts, nbins)
    np.add.at(f, clipped - 1, 1)
    return f


def ffh_from_sample(sample: np.ndarray, max_bins: int = 0) -> np.ndarray:
    return ffh_from_counts(occurrence_counts(sample), max_bins=max_bins)


def sample_size_of_ffh(f: np.ndarray) -> int:
    """Total sample size implied by an FFH: sum_j j * f_j."""
    j = np.arange(1, len(f) + 1)
    return int(np.dot(j, f))


def distinct_of_ffh(f: np.ndarray) -> int:
    """Distinct fingerprints implied by an FFH: sum_j f_j."""
    return int(np.sum(f))
