"""Content-defined chunking boundary candidates: the Gear rolling hash.

The port's counterpart of the reference's Pallas kernel.  A byte stream is
cut at content-defined positions so that an insert or delete moves only a
few chunk boundaries.  The Gear recurrence

    h_i = (h_{i-1} << 1 + GEAR[b_i]) mod 2^32,    cut candidate iff
    (h_i & (avg_size - 1)) == 0

forgets a byte after 32 one-bit shifts, so it equals the windowed sum

    h_i = sum_{j=0}^{31} GEAR[b_{i-j}] << j      (mod 2^32, b_k = 0 for k<0)

and every position's hash follows from its trailing 32 bytes alone.

Layout (the reference's, so flags compare directly): byte streams are packed
on the host into rows of ``SEG_BYTES`` payload bytes, each prefixed by a
``HALO_BYTES`` halo carrying the previous row's tail (``pack_haloed``).
Rows are little-endian uint32 words.  The output is one uint32 word per
payload word with the candidate flags of its 4 bytes in bits 0..3.

``GEAR[b] = avalanche32(b * PRIME1 + GEAR_SEED)``: the kernel computes it
inline; the host code uses ``gear_table()``, the same values.

``cdc_candidates_torch`` is the plain PyTorch version; ``cdc_candidates``
takes it for a CPU tensor and launches the CUDA kernel (``csrc/cdc.cu``)
for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .fingerprint import PRIME1, PRIME2, PRIME3, _mul32

SEG_BYTES = 2048      # payload bytes per row
SEG_WORDS = SEG_BYTES // 4
HALO_BYTES = 32       # previous row's tail carried per row (= WINDOW)
HALO_WORDS = HALO_BYTES // 4
TILE_R = 32           # rows are padded to a multiple of this
WINDOW = 32           # rolling-hash window: 1-bit shifts vanish after 32 steps
GEAR_SEED = 0x1F83D9AB

_M32 = 0xFFFFFFFF
# rows per step of the plain version: bounds its int64 temporaries
_PLAIN_ROWS = 4096


def gear_table() -> np.ndarray:
    """The 256-entry Gear table, host-side (numpy uint32, wrapping)."""
    h = np.arange(256, dtype=np.uint32) * np.uint32(PRIME1) + np.uint32(GEAR_SEED)
    h ^= h >> np.uint32(15)
    h *= np.uint32(PRIME2)
    h ^= h >> np.uint32(13)
    h *= np.uint32(PRIME3)
    h ^= h >> np.uint32(16)
    return h


def _gear_mix(b: torch.Tensor) -> torch.Tensor:
    """GEAR[b] elementwise for int64 bytes, as ``gear_table``."""
    h = (_mul32(b, PRIME1) + GEAR_SEED) & _M32
    h = h ^ (h >> 15)
    h = _mul32(h, PRIME2)
    h = h ^ (h >> 13)
    h = _mul32(h, PRIME3)
    return h ^ (h >> 16)


def _check_rows(haloed: torch.Tensor, avg_size: int) -> None:
    if haloed.dtype != torch.int32 or haloed.dim() != 2:
        raise TypeError(f"expected (R, W) int32 rows, got {haloed.dtype} {tuple(haloed.shape)}")
    r, wtot = haloed.shape
    if wtot != HALO_WORDS + SEG_WORDS:
        raise ValueError(f"row width {wtot} != HALO_WORDS + SEG_WORDS = {HALO_WORDS + SEG_WORDS}")
    if r % TILE_R:
        raise ValueError(f"R={r} must be a multiple of TILE_R={TILE_R}")
    if avg_size & (avg_size - 1) or avg_size < 2:
        raise ValueError(f"avg_size must be a power of two >= 2, got {avg_size}")


def cdc_candidates_torch(haloed: torch.Tensor, avg_size: int) -> torch.Tensor:
    """Plain version: (R, HALO_WORDS + SEG_WORDS) int32 rows -> (R, SEG_WORDS)
    int32 flag words.

    For payload byte phase ``k`` of word ``t``, term ``j`` of the windowed
    sum reads stream byte ``(t*4 + k) - j``; with ``k - j = 4q + c`` that
    byte is phase ``c`` of word ``t + q``, a column slice of the gear-mixed
    phase arrays.  int64 arithmetic masked to 32 bits, a block of rows at a
    time.
    """
    r = haloed.shape[0]
    out = torch.empty((r, SEG_WORDS), dtype=torch.int32, device=haloed.device)
    mask = avg_size - 1
    for a in range(0, r, _PLAIN_ROWS):
        x = haloed[a:a + _PLAIN_ROWS].to(torch.int64) & _M32
        g = [_gear_mix((x >> (8 * c)) & 0xFF) for c in range(4)]
        flags = torch.zeros((x.shape[0], SEG_WORDS), dtype=torch.int64, device=x.device)
        for k in range(4):
            h = torch.zeros_like(flags)
            for j in range(WINDOW):
                m = k - j
                c = m & 3
                col = HALO_WORDS + ((m - c) >> 2)
                h = h + ((g[c][:, col:col + SEG_WORDS] << j) & _M32)
            flags |= (((h & mask) == 0).to(torch.int64)) << k
        out[a:a + x.shape[0]] = flags.to(torch.int32)
    return out


def cdc_candidates(haloed: torch.Tensor, avg_size: int) -> torch.Tensor:
    """Candidate flags for packed haloed rows, on ``haloed``'s device.

    ``haloed`` is (R, HALO_WORDS + SEG_WORDS) int32 (uint32 bits) from
    ``pack_haloed`` with R a multiple of TILE_R; returns (R, SEG_WORDS) int32
    with bit k of word t flagging payload byte ``t*4 + k`` as a cut
    candidate.  A CPU tensor goes through ``cdc_candidates_torch``; a CUDA
    tensor through the kernel, on the current stream.
    """
    _check_rows(haloed, avg_size)
    if haloed.device.type == "cpu":
        return cdc_candidates_torch(haloed, avg_size)
    if not haloed.is_contiguous() or haloed.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte rows: pass a contiguous, aligned tensor")
    r = haloed.shape[0]
    out = torch.empty((r, SEG_WORDS), dtype=torch.int32, device=haloed.device)
    lib = _build.library("cdc")
    with torch.cuda.device(haloed.device):
        err = lib.cdc_candidates_launch(
            ctypes.c_void_p(haloed.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_longlong(r),
            ctypes.c_uint(avg_size - 1),
            ctypes.c_void_p(torch.cuda.current_stream(haloed.device).cuda_stream),
        )
    _build.check(err, "cdc_candidates")
    _build.count_launch("cdc_candidates")
    return out


def pack_haloed(buffers) -> tuple[np.ndarray, list[tuple[int, int, int]]]:
    """Pack byte buffers into the kernel's haloed row layout.

    Returns ``(rows, spans)``: ``rows`` is (R_pad, HALO_WORDS + SEG_WORDS)
    uint32 (little-endian packed, R_pad a TILE_R multiple, zero-padded) and
    ``spans[i] = (row_start, n_rows, n_bytes)`` locates buffer ``i``'s rows.
    Each buffer starts on a fresh row with a zero halo — buffers never share
    window history, matching the zero-prefix hash contract — and row ``r``'s
    halo is the same buffer's bytes ``[r*SEG_BYTES - 32, r*SEG_BYTES)``.
    """
    parts = []
    spans = []
    row = 0
    for buf in buffers:
        data = np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
        n = data.size
        n_rows = -(-n // SEG_BYTES)
        spans.append((row, n_rows, n))
        if n_rows == 0:
            continue
        padded = np.zeros(n_rows * SEG_BYTES, dtype=np.uint8)
        padded[:n] = data
        halo = np.zeros((n_rows, HALO_BYTES), dtype=np.uint8)
        if n_rows > 1:
            tails = padded[: (n_rows - 1) * SEG_BYTES].reshape(n_rows - 1, SEG_BYTES)
            halo[1:] = tails[:, -HALO_BYTES:]
        parts.append(np.concatenate([halo, padded.reshape(n_rows, SEG_BYTES)], axis=1))
        row += n_rows
    pad_rows = (-row) % TILE_R
    if pad_rows or row == 0:
        pad_rows = pad_rows or TILE_R
        parts.append(np.zeros((pad_rows, HALO_BYTES + SEG_BYTES), dtype=np.uint8))
    rows = np.concatenate(parts, axis=0)
    return rows.view("<u4"), spans


def unpack_candidates(flags: np.ndarray, span: tuple[int, int, int]) -> np.ndarray:
    """Candidate byte positions for one buffer from the kernel's flag words.

    ``flags`` is the full (R, SEG_WORDS) uint32 output; ``span`` is the
    buffer's ``(row_start, n_rows, n_bytes)`` from ``pack_haloed``.  Flag bit
    k of word t in row r is stream byte ``r*SEG_BYTES + t*4 + k`` — the
    little-endian byte-in-word order the packing used.
    """
    row0, n_rows, n = span
    if n_rows == 0:
        return np.empty(0, dtype=np.int64)
    w = flags[row0:row0 + n_rows]
    bits = (w[:, :, None] >> np.arange(4, dtype=np.uint32)[None, None, :]) & np.uint32(1)
    flat = bits.reshape(-1)[:n]
    return np.nonzero(flat)[0]
