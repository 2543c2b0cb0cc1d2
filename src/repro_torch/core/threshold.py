"""Spatial-locality-aware per-stream dedup threshold (paper §IV-C).

Inline dedup only eliminates *sequences* of duplicate blocks of length >= T
(fragmentation control, as in iDedup).  HPDedup adapts T per stream:

    T = (1 - r) * mean_dup_run_len + r * mean_read_run_len

where ``r`` is the stream's read ratio, ``V_w[L]`` counts duplicate runs of
length L and ``V_r[L]`` counts sequential-read runs of length L (64 bins
each; runs longer than 64 accumulate in the last bin).  Both vectors reset
when the stream's dedup ratio drops by >50% since the last threshold update.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .statetree import from_pairs, pairs

VEC_LEN = 64
INITIAL_THRESHOLD = 16


class SpatialThreshold:
    """Per-stream adaptive duplicate-sequence threshold."""

    def __init__(self, initial: int = INITIAL_THRESHOLD, t_min: int = 1, t_max: int = VEC_LEN):
        self.initial = initial
        self.t_min = t_min
        self.t_max = t_max
        self.v_w: Dict[int, np.ndarray] = {}
        self.v_r: Dict[int, np.ndarray] = {}
        self.threshold: Dict[int, float] = {}
        self.reads: Dict[int, int] = {}
        self.writes: Dict[int, int] = {}
        self.dups: Dict[int, int] = {}
        self._ratio_at_update: Dict[int, float] = {}
        self.updates = 0

    def _ensure(self, stream: int) -> None:
        if stream not in self.v_w:
            self.v_w[stream] = np.zeros(VEC_LEN, dtype=np.int64)
            self.v_r[stream] = np.zeros(VEC_LEN, dtype=np.int64)
            self.threshold[stream] = float(self.initial)
            self.reads[stream] = 0
            self.writes[stream] = 0
            self.dups[stream] = 0
            self._ratio_at_update[stream] = 0.0

    # -- data collection ------------------------------------------------------
    def record_dup_run(self, stream: int, length: int) -> None:
        if length <= 0:
            return
        self._ensure(stream)
        self.v_w[stream][min(length, VEC_LEN) - 1] += 1

    def record_read_run(self, stream: int, length: int) -> None:
        if length <= 0:
            return
        self._ensure(stream)
        self.v_r[stream][min(length, VEC_LEN) - 1] += 1

    def record_request(self, stream: int, is_read: bool, is_dup_write: bool = False) -> None:
        self._ensure(stream)
        if is_read:
            self.reads[stream] += 1
        else:
            self.writes[stream] += 1
            if is_dup_write:
                self.dups[stream] += 1

    # -- threshold update ------------------------------------------------------
    def get(self, stream: int) -> int:
        self._ensure(stream)
        return int(round(self.threshold[stream]))

    def update(self, stream: int) -> int:
        """Recompute T for a stream from its V_w / V_r histograms."""
        self._ensure(stream)
        lengths = np.arange(1, VEC_LEN + 1, dtype=np.float64)
        vw, vr = self.v_w[stream], self.v_r[stream]
        n_dup_runs, n_read_runs = vw.sum(), vr.sum()
        mean_dup = float(np.dot(lengths, vw) / n_dup_runs) if n_dup_runs else float(self.initial)
        mean_read = float(np.dot(lengths, vr) / n_read_runs) if n_read_runs else 0.0
        total = self.reads[stream] + self.writes[stream]
        r = self.reads[stream] / total if total else 0.0
        if n_read_runs == 0:
            # no read evidence: fragmentation pressure unknown, trust write side
            t = mean_dup * (1 - r) + r * self.initial
        else:
            t = (1 - r) * mean_dup + r * mean_read
        t = float(np.clip(t, self.t_min, self.t_max))
        self.threshold[stream] = t
        self.updates += 1

        # reset rule: dedup-ratio drop >50% since last update clears history
        ratio = self.dups[stream] / self.writes[stream] if self.writes[stream] else 0.0
        if self._ratio_at_update[stream] > 0 and ratio < 0.5 * self._ratio_at_update[stream]:
            vw[:] = 0
            vr[:] = 0
        self._ratio_at_update[stream] = ratio
        return int(round(t))

    def update_all(self) -> Dict[int, int]:
        return {s: self.update(s) for s in list(self.threshold.keys())}

    # -- snapshot/restore ------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "v_w": [[s, v.tolist()] for s, v in self.v_w.items()],
            "v_r": [[s, v.tolist()] for s, v in self.v_r.items()],
            "threshold": pairs(self.threshold),
            "reads": pairs(self.reads),
            "writes": pairs(self.writes),
            "dups": pairs(self.dups),
            "ratio_at_update": pairs(self._ratio_at_update),
            "updates": self.updates,
        }

    def load_snapshot(self, tree: dict) -> None:
        self.v_w = {int(s): np.asarray(v, dtype=np.int64) for s, v in tree["v_w"]}
        self.v_r = {int(s): np.asarray(v, dtype=np.int64) for s, v in tree["v_r"]}
        self.threshold = from_pairs(tree["threshold"], value=float)
        self.reads = from_pairs(tree["reads"], value=int)
        self.writes = from_pairs(tree["writes"], value=int)
        self.dups = from_pairs(tree["dups"], value=int)
        self._ratio_at_update = from_pairs(tree["ratio_at_update"], value=float)
        self.updates = int(tree["updates"])
