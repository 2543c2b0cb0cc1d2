"""Byte-backed workload generators with known duplication structure.

The synthetic TRACE_DTYPE templates (core.traces) draw *fingerprints*; these
generators draw *bytes*, so the content-defined chunker is exercised on the
streams it exists for — snapshot re-ingestion with shifted content:

* ``vm_image_workload`` — per stream, a random base image plus successive
  versions derived by insert/delete/overwrite edits.  Inserts and deletes
  shift everything after the edit point, which is exactly what fixed-size
  blocking cannot dedup and CDC can.
* ``log_append_workload`` — an append-only log whose full content is
  re-ingested at every snapshot (the classic backup pattern).

Each generator tracks its ground truth exactly: ``fresh_bytes`` counts bytes
never seen before (base images + inserted/overwriting content — random, so
self-collisions are negligible), and ``boundary_events`` counts the O(1)
chunk-damage sites (edit points, snapshot tails) where CDC may fail to dedup
previously-seen bytes.  ``analytic_bounds`` turns these into the
Niesen-style envelope (arXiv 1701.04451: achievable dedup is the stream's
content redundancy, degraded only by chunking granularity):

    upper = dup_bytes_true / total_bytes          (no chunker beats content)
    lower = upper - boundary_events * 4*max_size / total_bytes

— each damage site can spoil at most a handful of ``max_size`` chunks (the
chunk containing the edit, its neighbours re-cut by min/max constraints, and
the resynchronization chunk; 4x is a safe envelope).  A correct chunker must
land measured byte dedup inside [lower, upper]; ``tests/test_analytic_bounds``
gates every engine's replay against it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from ..core.batch_replay import ReplayBatch
from ..core.cdc import ContentDefinedChunker
from ..core.fingerprint import OP_WRITE, TRACE_DTYPE


@dataclass
class ByteWorkload:
    """Aligned (stream_ids[i], buffers[i]) ingestion order + ground truth."""

    name: str
    stream_ids: List[int] = field(default_factory=list)
    buffers: List[np.ndarray] = field(default_factory=list)
    fresh_bytes: int = 0
    boundary_events: int = 0

    @property
    def total_bytes(self) -> int:
        return int(sum(b.size for b in self.buffers))

    def add(self, sid: int, data: np.ndarray, fresh: int, events: int) -> None:
        self.stream_ids.append(sid)
        self.buffers.append(data)
        self.fresh_bytes += fresh
        self.boundary_events += events


def vm_image_workload(num_streams: int = 2, base_size: int = 256 * 1024,
                      versions: int = 3, edits_per_version: int = 3,
                      edit_size: int = 2048, seed: int = 0) -> ByteWorkload:
    """Snapshot streams: random base image + insert/delete/overwrite edits."""
    rng = np.random.default_rng(seed)
    w = ByteWorkload("vm_image")
    images = []
    for sid in range(num_streams):
        img = rng.integers(0, 256, size=base_size, dtype=np.uint8)
        images.append(img)
        w.add(sid, img, fresh=img.size, events=0)
    for _ in range(versions):
        for sid in range(num_streams):
            img = images[sid]
            for _ in range(edits_per_version):
                op = int(rng.integers(0, 3))
                pos = int(rng.integers(0, max(1, img.size - edit_size)))
                if op == 0:  # insert
                    new = rng.integers(0, 256, size=edit_size, dtype=np.uint8)
                    img = np.concatenate([img[:pos], new, img[pos:]])
                    w.fresh_bytes += edit_size
                elif op == 1:  # delete
                    img = np.concatenate([img[:pos], img[pos + edit_size:]])
                else:  # overwrite in place
                    img = img.copy()
                    new = rng.integers(0, 256, size=edit_size, dtype=np.uint8)
                    img[pos:pos + edit_size] = new
                    w.fresh_bytes += edit_size
            images[sid] = img
            # each edit site + the version's tail is an O(1) damage site
            w.add(sid, img, fresh=0, events=edits_per_version + 1)
    return w


def log_append_workload(num_streams: int = 2, snapshots: int = 4,
                        append_size: int = 64 * 1024, seed: int = 1) -> ByteWorkload:
    """Append-only logs, full content re-ingested at every snapshot."""
    rng = np.random.default_rng(seed)
    w = ByteWorkload("log_append")
    logs = [np.empty(0, dtype=np.uint8) for _ in range(num_streams)]
    for snap in range(snapshots):
        for sid in range(num_streams):
            fresh = rng.integers(0, 256, size=append_size, dtype=np.uint8)
            logs[sid] = np.concatenate([logs[sid], fresh])
            # the previous snapshot's tail chunk is re-cut when the log grows
            w.add(sid, logs[sid], fresh=append_size, events=1 if snap else 0)
    return w


def analytic_bounds(workload: ByteWorkload, max_size: int) -> Tuple[float, float]:
    """(lower, upper) envelope for the byte-weighted dedup ratio."""
    total = workload.total_bytes
    if total == 0:
        return 0.0, 0.0
    upper = (total - workload.fresh_bytes) / total
    lower = max(0.0, upper - workload.boundary_events * 4 * max_size / total)
    return lower, upper


def byte_trace(chunker: ContentDefinedChunker,
               workload: ByteWorkload) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk a workload into a merged TRACE_DTYPE trace + aligned lengths.

    LBAs are per-stream running chunk counters (byte streams append, never
    overwrite) and timestamps follow ingestion order, so any engine replays
    it like every other trace; the aligned chunk-length column feeds the
    byte-weighted stats (``trace_stats(trace, chunk_bytes=lens)``).
    """
    batch, lens = chunker.batch_from_buffers(workload.stream_ids, workload.buffers)
    return batches_trace([batch]), lens


def batches_trace(batches: Sequence[ReplayBatch]) -> np.ndarray:
    """One TRACE_DTYPE write trace of ``batches`` in order (for example one
    ``batch_from_buffers`` call per snapshot round, ``lba_next`` carried);
    timestamps follow ingestion order."""
    n = sum(len(b) for b in batches)
    trace = np.zeros(n, dtype=TRACE_DTYPE)
    trace["ts"] = np.arange(n, dtype=np.int64)
    trace["op"] = OP_WRITE
    if batches:
        trace["stream"] = np.concatenate([b.stream for b in batches])
        trace["lba"] = np.concatenate([b.lba for b in batches])
        trace["fp"] = np.concatenate([b.fp for b in batches])
    return trace
