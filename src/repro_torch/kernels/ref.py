"""Independent oracles for the fingerprint kernel.

``fingerprint_ref`` whitens every chunk in one shot over the whole array (no
chunk loop, no lane-sum helper shared with the kernel's plain version), so a
fault in ``kernels.fingerprint`` cannot hide behind shared code.
``fingerprint_golden_numpy`` is a third model in numpy uint64 arithmetic
mod 2^32; the tests pin both to the golden digests.  ``cdc_golden_buffer``
makes the byte buffers of the golden chunking cases
(``tests/golden/cdc_digests.json``), and ``chunk_edge_cases`` the chunks
that test the chunk kernel's edges.  ``ffh_ref`` counts the histogram with
``bincount``, where ``kernels.histogram``'s plain version compares one-hot.
"""

from __future__ import annotations

import numpy as np
import torch

from .cdc import SEG_BYTES
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


def ffh_ref(counts: torch.Tensor, nbins: int) -> torch.Tensor:
    """Oracle for the FFH: (nbins,) int32, counts clipped to ``nbins``,
    counts of 0 or below excluded."""
    clipped = torch.clamp(counts.reshape(-1).to(torch.int64), max=nbins)
    return torch.bincount(clipped[clipped >= 1] - 1, minlength=nbins).to(torch.int32)


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


def chunk_edge_cases(rows: int, max_size: int, batch: int) -> dict:
    """Chunks at the edges of the chunk kernel, over ``rows`` rows of payload:
    family name -> (starts int64, lens int32).

    * ``phases``: every start phase mod 4, in a row and across one, at
      lengths 1, 511, 512, 513, ``batch`` groups (of 512 bytes) and one
      byte either side, and ``max_size`` and one byte less;
    * ``halos``: chunks that cross 1 to 8 row boundaries (as far as
      ``max_size`` reaches);
    * ``payload_end``: chunks that end at the payload's last byte;
    * ``outside``: chunks that start before byte 0, reach past the payload
      or lie beyond it, and lengths of 0 and below (only the port defines
      these: such bytes read as zero).

    ``rows`` must be at least 12.
    """
    total = rows * SEG_BYTES
    lengths = [1, 511, 512, 513, batch * 512 - 1, batch * 512, batch * 512 + 1,
               max_size - 1, max_size]
    phases = [(base + ph, n) for n in lengths
              for base in (0, 2040, 3 * SEG_BYTES - 700, 5 * SEG_BYTES + 508) for ph in range(4)]
    halos = []
    for k in range(1, 9):
        for ph in range(4):
            start = 3 * SEG_BYTES - 5 - ph
            n = min(max_size, 5 + ph + (k - 1) * SEG_BYTES + 1 + 97 * k)
            if (start + n - 1) // SEG_BYTES - start // SEG_BYTES == k:
                halos.append((start, n))
    payload_end = [(total - n, n) for n in lengths]
    outside = [(-3, 7), (-2049, max_size), (-1, 1), (-max_size, max_size), (-max_size - 9, 5),
               (total - 5, max_size), (total - 1001, max_size), (total - 1, 2), (total, 3),
               (total + 10, 100), (5, 0), (7, -5), (9, -2000), (-10**9, 50),
               (3, max_size + 1000)]
    return {name: (np.array([s for s, _ in pairs], dtype=np.int64),
                   np.array([n for _, n in pairs], dtype=np.int32))
            for name, pairs in (("phases", phases), ("halos", halos),
                                ("payload_end", payload_end), ("outside", outside))}
