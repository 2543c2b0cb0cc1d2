"""Independent oracles for the fingerprint kernel.

``fingerprint_ref`` whitens every chunk in one shot over the whole array (no
chunk loop, no lane-sum helper shared with the kernel's plain version), so a
fault in ``kernels.fingerprint`` cannot hide behind shared code.
``fingerprint_golden_numpy`` is a third model in numpy uint64 arithmetic
mod 2^32; the tests pin both to the golden digests.  ``cdc_golden_buffer``
makes the byte buffers of the golden chunking cases
(``tests/golden/cdc_digests.json``).
"""

from __future__ import annotations

import numpy as np
import torch

from .fingerprint import LANES, NUM_HASHES, PRIME1, PRIME2, PRIME3, PRIME4, PRIME5, SEEDS

_M = 0xFFFFFFFF


def _mulmod(a: torch.Tensor, b) -> torch.Tensor:
    # 16-bit limbs of ``a``: each partial product stays below 2^48
    return (((a >> 16) * b & 0xFFFF) << 16) + (a & 0xFFFF) * b & _M


def fingerprint_ref(blocks: torch.Tensor) -> torch.Tensor:
    """Oracle for ``kernels.fingerprint``: (B, W) 32-bit words (any integer
    dtype holding uint32 bit patterns) -> (B, NUM_HASHES) int64 in [0, 2^32)."""
    b, w = blocks.shape
    assert w % LANES == 0
    chunks = w // LANES
    x3 = (blocks.to(torch.int64) & _M).reshape(b, chunks, LANES)
    lane = torch.arange(LANES, dtype=torch.int64, device=blocks.device)
    outs = []
    for which in range(NUM_HASHES):
        keys = ((lane * 0x9E3779B9 + 0xA5A5A5A5 + 0x01000193 * which) & _M) | 1
        lane_mult = ((lane * PRIME4 + SEEDS[which]) & _M) | 1
        # all-chunk whitening in one shot (the kernel loops; the oracle doesn't)
        t = _mulmod(x3 ^ keys, PRIME1)
        t = t ^ (t >> 15)
        t = _mulmod(t, PRIME2)
        s = (_mulmod(t, lane_mult).sum(dim=2)) & _M  # (B, chunks)
        h = torch.full((b,), SEEDS[which], dtype=torch.int64, device=blocks.device)
        for c in range(chunks):
            v = (h + _mulmod(s[:, c], PRIME3)) & _M
            h = _mulmod(((v << 13) | (v >> 19)) & _M, PRIME1)
            h = h ^ ((c + 1) * PRIME5 & _M)
        h = h ^ w
        h = h ^ (h >> 15)
        h = _mulmod(h, PRIME2)
        h = h ^ (h >> 13)
        h = _mulmod(h, PRIME3)
        outs.append(h ^ (h >> 16))
    return torch.stack(outs, dim=1)


def fingerprint_golden_numpy(blocks: np.ndarray) -> np.ndarray:
    """Independent golden model with Python/numpy uint64 arithmetic mod 2^32."""
    M = np.uint64(0xFFFFFFFF)
    b, w = blocks.shape
    chunks = w // LANES
    lane = np.arange(LANES, dtype=np.uint64)
    out = np.zeros((b, NUM_HASHES), dtype=np.uint64)
    P1, P2, P3, P4, P5 = (np.uint64(int(p)) for p in (PRIME1, PRIME2, PRIME3, PRIME4, PRIME5))
    for which in range(NUM_HASHES):
        seed = np.uint64(int(SEEDS[which]))
        keys = ((lane * np.uint64(0x9E3779B9) + np.uint64(0xA5A5A5A5 + 0x01000193 * which)) & M) | np.uint64(1)
        lane_mult = (((lane * P4) & M) + seed & M) | np.uint64(1)
        x = blocks.astype(np.uint64).reshape(b, chunks, LANES)
        t = ((x ^ keys[None, None, :]) * P1) & M
        t = t ^ (t >> np.uint64(15))
        t = (t * P2) & M
        s = np.zeros((b, chunks), dtype=np.uint64)
        for c in range(chunks):
            s[:, c] = np.sum((t[:, c, :] * lane_mult[None, :]) & M, axis=1) & M
        h = np.full((b,), seed, dtype=np.uint64)
        for c in range(chunks):
            v = (h + (s[:, c] * P3) & M) & M
            h = (((v << np.uint64(13)) | (v >> np.uint64(19))) & M) * P1 & M
            h = h ^ ((np.uint64(c + 1) * P5) & M)
        h = h ^ np.uint64(w)
        h = h ^ (h >> np.uint64(15))
        h = (h * P2) & M
        h = h ^ (h >> np.uint64(13))
        h = (h * P3) & M
        h = h ^ (h >> np.uint64(16))
        out[:, which] = h
    return out.astype(np.uint32)


def _cdc_mix_bytes(n: int, salt: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint64)
    v = i * np.uint64(2654435761) + np.uint64(salt) * np.uint64(40503) + np.uint64(11)
    v = (v ^ (v >> np.uint64(13))) * np.uint64(0x9E3779B97F4A7C15)
    return ((v >> np.uint64(29)) & np.uint64(0xFF)).astype(np.uint8)


def cdc_golden_buffer(name: str, n: int, salt: int) -> np.ndarray:
    """The (n,) uint8 buffer of a golden chunking case: ``"mix"`` bytes, or
    for ``"repeat"`` one half of them twice."""
    if name == "mix":
        return _cdc_mix_bytes(n, salt)
    half = _cdc_mix_bytes(n // 2, salt)
    return np.concatenate([half, half])
