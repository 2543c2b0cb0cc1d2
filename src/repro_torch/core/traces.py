"""Synthetic multi-tenant I/O trace generation (paper §V-A).

The FIU traces are not redistributable, so we synthesize streams whose
statistics match the paper's Tables I/III and Figures 1/5:

* per-template write ratio and duplicate ratio,
* temporal locality of duplicates — the distance between adjacent
  occurrences of a block is geometric (good locality) or uniform over
  history (weak locality, Cloud-FTP-like),
* spatial locality — writes/duplicates/reads arrive in LBA-sequential runs
  with template-specific mean lengths (FIU-web's duplicate runs are ~1 block,
  which is why its dedup ratio collapses as the threshold grows — Fig. 5),
* cross-stream content overlap of 0–40% for streams from one template
  (Sun et al. MSST'16, cited by the paper).

Templates: ``mail`` (FIU-mail), ``ftp`` (Cloud-FTP), ``web`` (FIU-web),
``home`` (FIU-home / remote desktop).  Workloads A/B/C mix them 3:1 / 1:1 /
1:3 good:weak locality by stream counts, exactly as §V-A.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .fingerprint import OP_READ, OP_WRITE, TRACE_DTYPE


@dataclass(frozen=True)
class StreamTemplate:
    name: str
    write_ratio: float        # share of requests that are writes (Table III)
    dup_ratio: float          # share of writes duplicating earlier content
    locality: str             # "geometric" (good) or "uniform" (weak)
    locality_scale: float     # mean back-distance of a duplicate (geometric)
    write_run_mean: float     # mean LBA-sequential write-run length
    dup_run_mean: float       # mean duplicate-run length (spatial locality)
    read_run_mean: float      # mean sequential-read-run length
    ptype_fraction: float     # share of content DIODE would classify P-type
    rate: float               # relative request rate (trace interleaving)


TEMPLATES: Dict[str, StreamTemplate] = {
    # FIU-mail: 91% writes, ~91% duplicate writes, strong temporal locality,
    # long duplicate runs (threshold-insensitive, Fig. 5).
    "mail": StreamTemplate("mail", 0.91, 0.90, "geometric", 800.0, 8.0, 10.0, 6.0, 0.0, 8.0),
    # Cloud-FTP: 84% writes, ~21% duplicates, WEAK temporal locality
    # (uniform distances, Fig. 1), fairly long dup runs, 14% P-type content.
    "ftp": StreamTemplate("ftp", 0.84, 0.21, "uniform", 0.0, 10.0, 8.0, 12.0, 0.142, 8.0),
    # FIU-web: 73% writes, ~55% duplicates, good locality but SINGLE-BLOCK
    # duplicate runs (threshold 1->2 drops the ratio ~38%, Fig. 5).
    "web": StreamTemplate("web", 0.73, 0.55, "geometric", 1500.0, 4.0, 1.3, 8.0, 0.0, 0.25),
    # FIU-home (remote desktop): 90% writes, ~30% duplicates, medium
    # locality, short dup runs (steadily threshold-sensitive).
    "home": StreamTemplate("home", 0.90, 0.30, "geometric", 8000.0, 5.0, 3.0, 6.0, 0.0, 0.8),
}

# Workload mixes from §V-A (counts of streams per template).
WORKLOADS: Dict[str, Dict[str, int]] = {
    "A": {"mail": 15, "ftp": 5, "home": 8, "web": 4},
    "B": {"mail": 10, "ftp": 10, "home": 6, "web": 6},
    "C": {"mail": 5, "ftp": 15, "home": 6, "web": 6},
}


class _FpSpace:
    """Fingerprint allocator: globally unique ints + per-template shared pools."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self._next = 1
        self.pools: Dict[str, np.ndarray] = {}

    def fresh(self, n: int) -> np.ndarray:
        out = np.arange(self._next, self._next + n, dtype=np.uint64)
        self._next += n
        return out

    def pool(self, template: str, size: int) -> np.ndarray:
        if template not in self.pools:
            self.pools[template] = self.fresh(size)
        return self.pools[template]


def generate_stream(
    stream_id: int,
    template: StreamTemplate,
    n_requests: int,
    fp_space: _FpSpace,
    overlap: float,
    seed: int,
) -> np.ndarray:
    """Generate one stream's requests (timestamps are exponential arrivals)."""
    rng = np.random.default_rng(seed)
    recs = np.zeros(n_requests, dtype=TRACE_DTYPE)
    history_fp: List[int] = []  # fingerprints in write order
    pool = fp_space.pool(template.name, max(1024, n_requests // 4))

    # run-level probabilities that hit the template's per-BLOCK targets:
    # q_dup: P(write run is a dup run) s.t. dup blocks / write blocks = r
    # q_read: P(run is a read run) s.t. read requests fraction = 1 - wr
    wr, lr = template.write_ratio, template.read_run_mean
    r, ld, lf = template.dup_ratio, template.dup_run_mean, template.write_run_mean
    q_dup = r * lf / (ld * (1.0 - r) + r * lf)
    lw = q_dup * ld + (1.0 - q_dup) * lf
    q_read = (1.0 - wr) * lw / (wr * lr + (1.0 - wr) * lw)

    i = 0
    write_cursor = 0
    t = 0.0
    while i < n_requests:
        t += rng.exponential(1.0 / template.rate)
        if history_fp and rng.random() < q_read:
            # sequential read run
            run = max(1, int(rng.geometric(1.0 / template.read_run_mean)))
            start = int(rng.integers(0, max(1, write_cursor)))
            for j in range(min(run, n_requests - i)):
                recs[i] = (int(t * 1e6) + i, stream_id, OP_READ, start + j, 0)
                i += 1
            continue

        dup = history_fp and rng.random() < q_dup
        if dup:
            run = max(1, int(rng.geometric(1.0 / template.dup_run_mean)))
            run = min(run, n_requests - i, len(history_fp))
            # temporal locality: how far back the duplicated content sits
            if template.locality == "geometric":
                back = int(rng.geometric(1.0 / template.locality_scale))
                if back + run > len(history_fp):
                    # history shorter than the drawn distance: fall back to a
                    # uniform draw so early trace sections are not degenerately
                    # head-heavy.
                    back = int(rng.integers(run, len(history_fp) + 1))
            else:  # uniform over all history — weak locality
                back = int(rng.integers(run, len(history_fp) + 1))
            src = max(0, len(history_fp) - back)
            fps = [history_fp[min(src + j, len(history_fp) - 1)] for j in range(run)]
        else:
            run = max(1, int(rng.geometric(1.0 / template.write_run_mean)))
            run = min(run, n_requests - i)
            if overlap > 0.0 and rng.random() < overlap:
                start = int(rng.integers(0, max(1, pool.size - run)))
                fps = [int(f) for f in pool[start : start + run]]
            else:
                fps = [int(f) for f in fp_space.fresh(run)]

        for j in range(run):
            recs[i] = (int(t * 1e6) + i, stream_id, OP_WRITE, write_cursor, fps[j])
            history_fp.append(fps[j])
            write_cursor += 1
            i += 1

    return recs[:i]


def generate_workload(
    name: str,
    total_requests: int = 300_000,
    seed: int = 0,
    mix: Optional[Dict[str, int]] = None,
    overlap_range: Tuple[float, float] = (0.0, 0.4),
) -> Tuple[np.ndarray, Dict[int, str]]:
    """Generate a merged multi-stream workload.

    Returns (trace sorted by timestamp, {stream_id: template_name}).
    Request counts per stream are proportional to template rates, matching
    the paper's setup where mail streams dominate request volume.
    """
    mix = mix or WORKLOADS[name]
    rng = np.random.default_rng(seed)
    fp_space = _FpSpace(seed + 1)

    streams: List[Tuple[int, StreamTemplate]] = []
    sid = 0
    for tname, count in mix.items():
        for _ in range(count):
            streams.append((sid, TEMPLATES[tname]))
            sid += 1
    total_rate = sum(t.rate for _, t in streams)

    parts = []
    stream_of: Dict[int, str] = {}
    for stream_id, tpl in streams:
        n = max(64, int(total_requests * tpl.rate / total_rate))
        overlap = float(rng.uniform(*overlap_range))
        parts.append(
            generate_stream(stream_id, tpl, n, fp_space, overlap, seed + 17 * stream_id + 3)
        )
        stream_of[stream_id] = tpl.name

    trace = np.concatenate(parts)
    trace = trace[np.argsort(trace["ts"], kind="stable")]
    return trace, stream_of


def trace_stats(trace: np.ndarray, chunk_bytes: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Summary statistics in the shape of the paper's Table III.

    ``chunk_bytes`` (aligned per-record chunk lengths, as returned next to a
    byte-backed trace by ``data.byte_workloads.byte_trace``) switches on the
    content-defined-chunking summaries: a log2 chunk-size histogram, size
    percentiles, and byte-weighted duplication structure — a variable-size
    chunk stream's record-count dup ratio and its byte dup ratio legitimately
    differ, and capacity claims need the byte-weighted one.
    """
    writes = trace[trace["op"] == OP_WRITE]
    fps = writes["fp"]
    _, first_idx, counts = np.unique(fps, return_index=True, return_counts=True)
    dup_writes = len(fps) - len(first_idx)
    stats: Dict[str, float] = {
        "requests": int(len(trace)),
        "write_ratio": float(len(writes) / max(1, len(trace))),
        "dup_ratio": float(dup_writes / max(1, len(writes))),
        "unique_blocks": int(len(first_idx)),
        "dup_writes": int(dup_writes),
    }
    if chunk_bytes is None:
        return stats
    chunk_bytes = np.asarray(chunk_bytes)
    if chunk_bytes.shape != (len(trace),):
        raise ValueError(
            f"chunk_bytes must align with the trace: {chunk_bytes.shape} vs {len(trace)}")
    w_lens = chunk_bytes[trace["op"] == OP_WRITE].astype(np.int64)
    total = int(w_lens.sum())
    # byte-weighted duplication: every write after a fingerprint's first
    # occurrence re-writes bytes already stored
    is_first = np.zeros(len(fps), dtype=bool)
    is_first[first_idx] = True
    unique_bytes = int(w_lens[is_first].sum())
    # log2-binned size histogram: bin k counts chunks in [2^k, 2^(k+1))
    nz = w_lens[w_lens > 0]
    hist: Dict[str, int] = {}
    if nz.size:
        bins = np.floor(np.log2(nz)).astype(np.int64)
        for k, c in zip(*np.unique(bins, return_counts=True)):
            hist[str(int(k))] = int(c)
    stats.update({
        "chunk_count": int(len(fps)),
        "chunk_bytes_total": total,
        "chunk_size_mean": float(w_lens.mean()) if len(fps) else 0.0,
        "chunk_size_p50": float(np.median(w_lens)) if len(fps) else 0.0,
        "chunk_size_min": int(w_lens.min()) if len(fps) else 0,
        "chunk_size_max": int(w_lens.max()) if len(fps) else 0,
        "chunk_size_hist_log2": hist,
        "unique_bytes": unique_bytes,
        "dup_bytes": total - unique_bytes,
        "byte_dup_ratio": float((total - unique_bytes) / max(1, total)),
        "fp_max_occurrences": int(counts.max()) if counts.size else 0,
        "fp_mean_occurrences": float(counts.mean()) if counts.size else 0.0,
    })
    return stats


def is_ptype(fp: int, fraction: float) -> bool:
    """Deterministic pseudo-classification of content as P-type (for DIODE)."""
    return (int(fp) * 2654435761 % 1000) < int(fraction * 1000)
