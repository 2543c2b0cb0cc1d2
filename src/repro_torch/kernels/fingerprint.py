"""Lane-parallel 128-bit block fingerprinting.

The port's counterpart of the reference's Pallas kernel.  The hash is the
reference's, bit for bit (the digests are part of the on-disk contract:
``tests/golden/fingerprint_digests.json``):

* a block of ``W`` 32-bit words is viewed as ``W/128`` chunks of 128 lanes;
* for each of four key sets, each chunk is whitened lane-wise (xor with
  per-lane Weyl keys, multiply by odd constants, xor-shift) and reduced over
  the lanes with a weighted wrapping uint32 sum;
* chunk digests fold in order through an xxhash-style round, the block
  length is xored in, and the xxhash32 avalanche finishes each digest:
  4 x 32 bits = a 128-bit fingerprint.

``fingerprint_torch`` is the plain PyTorch version; ``fingerprint`` takes it
for a CPU tensor and launches the CUDA kernel (``csrc/fingerprint.cu``) for
a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LANES = 128         # chunk width; the word dim must be a multiple
NUM_HASHES = 4      # 4 x 32-bit = 128-bit fingerprint

# xxhash32 primes (odd -> invertible multipliers mod 2^32).
PRIME1 = 2654435761
PRIME2 = 2246822519
PRIME3 = 3266489917
PRIME4 = 668265263
PRIME5 = 374761393

SEEDS = (0x02CC5D05, 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 values in [0, 2^32) (``b`` a tensor or
    int), splitting ``b`` into 16-bit halves so that no intermediate passes
    2^49: int64 products stay exact and never rely on overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl13(v: torch.Tensor) -> torch.Tensor:
    return ((v << 13) & _M32) | (v >> 19)


def _fold(h: torch.Tensor, s, c) -> torch.Tensor:
    """One key set's fold of chunk ``c``'s lane sum ``s`` into its digest ``h``."""
    return _mul32(_rotl13((h + _mul32(s, PRIME3)) & _M32), PRIME1) ^ (((c + 1) * PRIME5) & _M32)


def _finish(h: torch.Tensor, w: int) -> torch.Tensor:
    """One key set's digest word from ``h``, for a block of ``w`` words."""
    h = h ^ w
    h = _mul32(h ^ (h >> 15), PRIME2)
    h = _mul32(h ^ (h >> 13), PRIME3)
    return h ^ (h >> 16)


def _lane_constants(which: int, device):
    lane = torch.arange(LANES, dtype=torch.int64, device=device)
    keys = ((lane * 0x9E3779B9 + (0xA5A5A5A5 + 0x01000193 * which)) & _M32) | 1
    lane_mult = ((lane * PRIME4 + SEEDS[which]) & _M32) | 1
    return keys, lane_mult


def _group_sum(words: torch.Tensor, keys: torch.Tensor, lane_mult: torch.Tensor) -> torch.Tensor:
    """One key set's lane-weighted wrapping sum of 128-word groups ``words``
    (int64 in [0, 2^32), groups along the last dim)."""
    t = _mul32(words ^ keys, PRIME1)
    t = t ^ (t >> 15)
    return _mul32(_mul32(t, PRIME2), lane_mult).sum(dim=-1) & _M32


def fingerprint_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, W) int32 words -> (B, NUM_HASHES) int32 digests.

    The int32 tensors carry uint32 bit patterns; the arithmetic runs in
    int64 masked to 32 bits, one 128-word chunk at a time, as the kernel
    walks it.
    """
    b, w = x.shape
    if w % LANES:
        raise ValueError(f"W={w} must be a multiple of LANES={LANES}")
    words = x.to(torch.int64) & _M32
    out = torch.empty((b, NUM_HASHES), dtype=torch.int64, device=x.device)
    for which in range(NUM_HASHES):
        keys, lane_mult = _lane_constants(which, x.device)
        h = torch.full((b,), SEEDS[which], dtype=torch.int64, device=x.device)
        for c in range(w // LANES):
            h = _fold(h, _group_sum(words[:, c * LANES:(c + 1) * LANES], keys, lane_mult), c)
        out[:, which] = _finish(h, w)
    return (out - ((out >> 31) << 32)).to(torch.int32)


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words -> (B, NUM_HASHES) int32 digests on ``x``'s device.

    ``W`` must be a multiple of ``LANES`` (``ops.fingerprint_blocks`` pads).
    A CPU tensor goes through ``fingerprint_torch``; a CUDA tensor through
    the kernel, on the current stream.
    """
    if x.dtype != torch.int32 or x.dim() != 2:
        raise TypeError(f"expected a (B, W) int32 tensor, got {x.dtype} {tuple(x.shape)}")
    b, w = x.shape
    if w % LANES:
        raise ValueError(f"W={w} must be a multiple of LANES={LANES}")
    if x.device.type == "cpu":
        return fingerprint_torch(x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte rows: pass a contiguous, aligned tensor")
    out = torch.empty((b, NUM_HASHES), dtype=torch.int32, device=x.device)
    if b == 0:
        return out
    lib = _build.library("fingerprint")
    with torch.cuda.device(x.device):  # launch in the context of x's card
        err = lib.fingerprint_launch(
            ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_longlong(b),
            ctypes.c_int(w),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    _build.check(err, "fingerprint")
    _build.count_launch("fingerprint")
    return out
