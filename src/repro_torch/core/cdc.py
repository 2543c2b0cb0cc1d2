"""Content-defined chunking front end: byte buffers -> chunk fingerprints.

``ContentDefinedChunker`` turns raw byte streams into variable-size chunks
cut at content-defined boundaries (Gear rolling hash, ``kernels.cdc``) and
hands each chunk a 64-bit fingerprint, feeding the same ``ReplayBatch``
columns every engine already ingests.  Three backends, bit-identical:

* ``device``  — the fused path (the default): one upload of the packed
  haloed rows to ``device``, the candidate kernel, a compaction of the flags
  on the card into candidate positions (only those cross to the host), the
  greedy min/max selection on the host (sequential but O(#chunks)), then
  the fused gather + fingerprint kernel over the *same resident* rows.  The
  bytes never come back.  On ``device="cpu"`` the same code runs the plain
  PyTorch versions.
* ``numpy``   — vectorized windowed-sum candidates on the host + one batched
  fingerprint call over the packed chunk matrix, on ``device``.
* ``scalar``  — the per-byte reference oracle (``chunk_boundaries_scalar``):
  the literal rolling-hash recurrence + per-chunk fingerprints.

Boundary semantics (all backends): cut candidates are byte positions ``i``
with ``(H_i & (avg_size-1)) == 0`` where ``H_i`` hashes the trailing
32-byte window (zero-prefixed at stream start); ``select_boundaries`` then
greedily takes the first candidate at least ``min_size`` into the current
chunk, forcing a cut at ``max_size``, with a final sub-``min_size`` tail
allowed.  Chunks are fingerprinted zero-padded to ``max_size`` with the true
length mixed in (``kernels.ops.chunk_fp64``), so boundary math and hashing
are decoupled and every backend hashes identical images.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.cdc import SEG_BYTES, WINDOW, gear_table, pack_haloed
from ..kernels.ops import (
    as_rows,
    candidate_positions,
    cdc_candidate_flags,
    cdc_chunk_fingerprints,
    chunk_fp64,
    digests_to_host,
    fingerprint_blocks,
)
from .batch_replay import ReplayBatch

_GEAR = gear_table()
# seed making the scalar recurrence equal the zero-prefixed windowed sum:
# h_init * 2^(i+1) must cancel the GEAR[0] terms of the implicit zero prefix,
# i.e. h_init = -GEAR[0] mod 2^32
_H_INIT = (int(_GEAR[0]) * 0xFFFFFFFF) & 0xFFFFFFFF

# host seconds of each stage of the device backend, summed over calls
STAGES = ("pack", "upload", "candidates", "select", "chunk_fp")


@dataclass(frozen=True)
class CDCConfig:
    """Chunking parameters; validated against the kernel layout limits."""

    min_size: int = 2048
    avg_size: int = 4096
    max_size: int = 16384

    def __post_init__(self):
        if self.min_size < 2 * WINDOW:
            raise ValueError(f"min_size must be >= {2 * WINDOW}, got {self.min_size}")
        if self.avg_size & (self.avg_size - 1):
            raise ValueError(f"avg_size must be a power of two, got {self.avg_size}")
        if not self.min_size < self.avg_size <= self.max_size:
            raise ValueError(
                f"need min_size < avg_size <= max_size, got "
                f"{self.min_size}/{self.avg_size}/{self.max_size}")
        if self.max_size % 512:
            # max_size/4 words must be a LANES multiple for the fingerprint tile
            raise ValueError(f"max_size must be a multiple of 512, got {self.max_size}")
        if self.max_size > 16384:
            # (TILE_B, max_size/4) uint32 must fit VMEM next to scratch
            raise ValueError(f"max_size must be <= 16384, got {self.max_size}")


def select_boundaries(candidates: np.ndarray, n: int, min_size: int, max_size: int) -> np.ndarray:
    """Greedy boundary selection over sorted candidate positions.

    Shared verbatim by every backend — the scalar oracle's cut rule
    ("first position with length >= min_size that is a candidate or reaches
    max_size") expressed over the sparse candidate array.  Returns chunk end
    offsets (exclusive); the final tail may be shorter than ``min_size``.
    """
    ends: List[int] = []
    cand_ends = np.asarray(candidates, dtype=np.int64) + 1
    start = 0
    while start < n:
        lo = int(np.searchsorted(cand_ends, start + min_size))
        if lo < cand_ends.size and cand_ends[lo] <= min(start + max_size, n):
            end = int(cand_ends[lo])
        elif start + max_size <= n:
            end = start + max_size
        else:
            end = n
        ends.append(end)
        start = end
    return np.asarray(ends, dtype=np.int64)


def chunk_boundaries_scalar(data, min_size: int, avg_size: int, max_size: int) -> np.ndarray:
    """Per-byte reference oracle: the literal Gear recurrence + cut rule."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    gear = _GEAR
    mask = avg_size - 1
    h = _H_INIT
    n = data.size
    ends: List[int] = []
    start = 0
    for i, b in enumerate(data.tolist()):
        h = ((h << 1) + int(gear[b])) & 0xFFFFFFFF
        length = i + 1 - start
        if length >= min_size and ((h & mask) == 0 or length >= max_size):
            ends.append(i + 1)
            start = i + 1
    if start < n:
        ends.append(n)
    return np.asarray(ends, dtype=np.int64)


def _candidates_numpy(data: np.ndarray, avg_size: int) -> np.ndarray:
    """Vectorized windowed-sum candidates: H_i = sum_j GEAR[b_{i-j}] << j."""
    g = _GEAR[data]
    gz = np.concatenate([np.full(WINDOW - 1, _GEAR[0], dtype=np.uint32), g])
    n = data.size
    h = np.zeros(n, dtype=np.uint32)
    for j in range(WINDOW):
        h += gz[WINDOW - 1 - j: WINDOW - 1 - j + n] << np.uint32(j)
    return np.nonzero((h & np.uint32(avg_size - 1)) == 0)[0]


def _chunk_matrix(buffers: Sequence[np.ndarray], ends_per: Sequence[np.ndarray],
                  max_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack every chunk zero-padded into a (C, max_size) uint8 matrix."""
    lens: List[int] = []
    rows: List[np.ndarray] = []
    for data, ends in zip(buffers, ends_per):
        start = 0
        for end in ends.tolist():
            rows.append(data[start:end])
            lens.append(end - start)
            start = end
    mat = np.zeros((len(rows), max_size), dtype=np.uint8)
    for i, row in enumerate(rows):
        mat[i, : row.size] = row
    return mat, np.asarray(lens, dtype=np.int64)


def chunk_starts(spans, ends_per) -> Tuple[np.ndarray, np.ndarray]:
    """Global payload byte offsets and lengths of every chunk, in order."""
    starts: List[np.ndarray] = []
    lens: List[np.ndarray] = []
    for (row0, _, _), ends in zip(spans, ends_per):
        n = np.diff(ends, prepend=0)
        starts.append(row0 * SEG_BYTES + ends - n)
        lens.append(n)
    if not starts:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    return np.concatenate(starts), np.concatenate(lens)


class ContentDefinedChunker:
    """Byte buffers -> (chunk ends, chunk fingerprints) -> ReplayBatch.

    ``backend`` is ``"device"`` / ``"numpy"`` / ``"scalar"`` or ``None`` for
    ``"device"`` — all bit-exact.  Every backend hashes on ``device``
    (default ``"cuda"``, which raises where no card is present; pass
    ``"cpu"`` to run on the host).  ``stage_seconds`` sums the host seconds
    of each stage of the device backend over calls.
    """

    def __init__(self, min_size: int = 2048, avg_size: int = 4096,
                 max_size: int = 16384, backend: Optional[str] = None, device="cuda"):
        self.config = CDCConfig(min_size, avg_size, max_size)
        if backend not in (None, "device", "numpy", "scalar"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend or "device"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ContentDefinedChunker(device={device!r}) needs a CUDA device and none "
                "is available; pass device='cpu' to run on the host")
        self.stage_seconds: Dict[str, float] = dict.fromkeys(STAGES, 0.0)

    def _timed(self, stage: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.stage_seconds[stage] += t1 - t0
        return t1

    def _device_ends(self, bufs) -> Tuple[torch.Tensor, list, List[np.ndarray]]:
        """Rows resident on ``device``, their spans, and each buffer's ends."""
        cfg = self.config
        t = time.perf_counter()
        haloed, spans = pack_haloed(bufs)
        t = self._timed("pack", t)
        rows = as_rows(haloed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = self._timed("upload", t)
        flags = cdc_candidate_flags(rows, cfg.avg_size)
        cands = candidate_positions(flags, spans)
        del flags
        t = self._timed("candidates", t)
        ends_per = [select_boundaries(c, span[2], cfg.min_size, cfg.max_size)
                    for c, span in zip(cands, spans)]
        self._timed("select", t)
        return rows, spans, ends_per

    # -- boundaries ---------------------------------------------------------

    def chunk(self, data) -> np.ndarray:
        """Chunk end offsets (exclusive) for one buffer."""
        return self.chunk_many([data])[0]

    def chunk_many(self, buffers) -> List[np.ndarray]:
        cfg = self.config
        bufs = [np.ascontiguousarray(b, dtype=np.uint8).reshape(-1) for b in buffers]
        if self.backend == "scalar":
            return [chunk_boundaries_scalar(b, cfg.min_size, cfg.avg_size, cfg.max_size)
                    for b in bufs]
        if self.backend == "numpy":
            return [select_boundaries(_candidates_numpy(b, cfg.avg_size), b.size,
                                      cfg.min_size, cfg.max_size) for b in bufs]
        return self._device_ends(bufs)[2]

    # -- boundaries + fingerprints ------------------------------------------

    def chunk_fingerprints(self, data) -> Tuple[np.ndarray, np.ndarray]:
        """(ends, fp64) for one buffer."""
        return self.chunk_fingerprints_many([data])[0]

    def chunk_fingerprints_many(self, buffers) -> List[Tuple[np.ndarray, np.ndarray]]:
        cfg = self.config
        bufs = [np.ascontiguousarray(b, dtype=np.uint8).reshape(-1) for b in buffers]

        if self.backend == "device":
            # fused path: rows upload once; candidate positions (small) come
            # back for selection; the gather+fingerprint launch reuses the
            # resident rows
            rows, spans, ends_per = self._device_ends(bufs)
            t = time.perf_counter()
            starts, lens = chunk_starts(spans, ends_per)
            fps = cdc_chunk_fingerprints(rows, starts, lens, cfg.max_size)
            self._timed("chunk_fp", t)
        else:
            if self.backend == "scalar":
                ends_per = [chunk_boundaries_scalar(b, cfg.min_size, cfg.avg_size,
                                                    cfg.max_size) for b in bufs]
            else:
                ends_per = [select_boundaries(_candidates_numpy(b, cfg.avg_size), b.size,
                                              cfg.min_size, cfg.max_size) for b in bufs]
            mat, lens_arr = _chunk_matrix(bufs, ends_per, cfg.max_size)
            if not mat.shape[0]:
                fp128 = np.empty((0, 4), dtype=np.uint32)
            elif self.backend == "scalar":
                # per-chunk hashing (no batching) — the throughput baseline
                fp128 = np.concatenate(
                    [digests_to_host(fingerprint_blocks(mat[i:i + 1].view("<u4"), self.device))
                     for i in range(mat.shape[0])])
            else:
                fp128 = digests_to_host(fingerprint_blocks(mat.view("<u4"), self.device))
            fps = chunk_fp64(fp128, lens_arr)

        out: List[Tuple[np.ndarray, np.ndarray]] = []
        pos = 0
        for ends in ends_per:
            c = ends.size
            out.append((ends, fps[pos:pos + c]))
            pos += c
        return out

    # -- engine ingest ------------------------------------------------------

    def batch_from_buffers(self, stream_ids: Sequence[int], buffers,
                           lba_next: Optional[Dict[int, int]] = None,
                           ) -> Tuple[ReplayBatch, np.ndarray]:
        """Chunk buffers into aligned ``ReplayBatch`` columns.

        Each chunk occupies one logical slot: LBAs are per-stream running
        counters (``lba_next`` carries them across calls), so byte streams
        append and never overwrite.  Returns the batch plus the aligned
        chunk-length column for byte-weighted accounting.
        """
        if len(stream_ids) != len(buffers):
            raise ValueError("stream_ids and buffers must align")
        lba_next = lba_next if lba_next is not None else {}
        results = self.chunk_fingerprints_many(buffers)
        streams: List[np.ndarray] = []
        lbas: List[np.ndarray] = []
        fps: List[np.ndarray] = []
        lens: List[np.ndarray] = []
        for sid, (ends, fp) in zip(stream_ids, results):
            c = ends.size
            nxt = lba_next.get(sid, 0)
            streams.append(np.full(c, sid, dtype=np.int32))
            lbas.append(np.arange(nxt, nxt + c, dtype=np.int64))
            lba_next[sid] = nxt + c
            fps.append(fp)
            lens.append(np.diff(ends, prepend=0))
        cat = lambda parts, dt: (np.concatenate(parts) if parts
                                 else np.empty(0, dtype=dt))
        batch = ReplayBatch(cat(streams, np.int32), cat(lbas, np.int64),
                            cat(fps, np.uint64))
        return batch, cat(lens, np.int64)
