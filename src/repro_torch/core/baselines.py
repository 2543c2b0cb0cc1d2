"""Baselines the paper compares against (§V).

* ``IDedup`` — locality-based inline-only dedup (Srinivasan et al. FAST'12):
  one global LRU fingerprint cache over the mixed stream, fixed sequence
  threshold (4 in the paper's experiments), no post-processing (non-exact).
* ``PurePostProcessing`` — every write lands on disk; an idle-time pass
  dedups afterwards (El-Shimi et al. ATC'12 / DEDIS).  Exact, but peak
  capacity = the full undeduplicated footprint.
* ``DIODE`` — dynamic inline-offline dedup (Tang et al. MASCOTS'16):
  file-extension classes decide whether a block enters the inline path
  (P-type — compressed/encrypted/media — bypasses it), with a single global
  adaptive threshold.  We model the extension hint as a deterministic
  per-fingerprint classification with the template's P-type fraction
  (Cloud-FTP: 14.2%, per the paper).

All three run over the same ``BlockStore`` and report the same metrics as
HPDedup so benchmark tables compare like for like.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .cache import GlobalCache
from .fingerprint import OP_WRITE, TRACE_DTYPE
from .fp_index import FingerprintIndex
from .hybrid import HPDedup, HybridReport
from .inline_engine import InlineMetrics
from .postprocess import PostProcessEngine, PostProcessMetrics
from .store import BlockStore
from .threshold import SpatialThreshold
from .traces import TEMPLATES, is_ptype


def make_idedup(
    cache_entries: int, threshold: int = 4, policy: str = "lru", seed: int = 0, *, device="cuda"
) -> HPDedup:
    """iDedup = HPDedup minus prioritization, adaptivity and post-processing."""
    return HPDedup(
        cache_entries=cache_entries,
        policy=policy,
        adaptive_threshold=False,
        fixed_threshold=threshold,
        prioritized=False,
        seed=seed,
        device=device,
    )


class PurePostProcessing:
    """No inline phase: writes land on disk; dedup happens in idle time."""

    def __init__(self, *, device="cuda"):
        self.device = device
        self.store = BlockStore(device=device)
        self.post = PostProcessEngine(self.store)
        self.metrics = InlineMetrics()
        self._total_writes = 0
        self._dup_writes = 0
        self._seen: FingerprintIndex = FingerprintIndex(device=device)

    def write_batch(self, streams, lbas, fps) -> np.ndarray:
        from .batch_replay import postproc_write_batch

        return postproc_write_batch(self, streams, lbas, fps)

    def replay(self, trace: np.ndarray) -> "PurePostProcessing":
        assert trace.dtype == TRACE_DTYPE
        for rec in trace:
            if rec["op"] != OP_WRITE:
                self.store.read(int(rec["stream"]), int(rec["lba"]))
                continue
            stream, lba, fp = int(rec["stream"]), int(rec["lba"]), int(rec["fp"])
            self._total_writes += 1
            if fp in self._seen:
                self._dup_writes += 1
            else:
                self._seen.add(fp)
            self.store.write_new_block(stream, lba, fp)
            self.metrics.writes += 1
        return self

    def replay_batched(self, trace: np.ndarray, batch_size: int = 8192) -> "PurePostProcessing":
        from .batch_replay import postproc_replay

        return postproc_replay(self, trace, batch_size)

    def finish(self) -> HybridReport:
        self.post.run_to_exact()
        return HybridReport(
            inline=self.metrics,
            post=self.post.metrics,
            peak_disk_blocks=self.store.peak_blocks,
            final_disk_blocks=self.store.live_blocks,
            unique_fingerprints=self.store.unique_fingerprints(),
            total_writes=self._total_writes,
            total_dup_writes=self._dup_writes,
        )

    # -- snapshot/restore ---------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "store": self.store.snapshot(),
            "metrics": self.metrics.snapshot(),
            "post_metrics": self.post.metrics.snapshot(),
            "total_writes": self._total_writes,
            "dup_writes": self._dup_writes,
            "seen": sorted(self._seen),
        }

    def load_snapshot(self, tree: dict) -> None:
        self.store.load_snapshot(tree["store"])
        self.metrics = InlineMetrics.from_snapshot(tree["metrics"])
        self.post.metrics = PostProcessMetrics.from_snapshot(tree["post_metrics"])
        self._total_writes = int(tree["total_writes"])
        self._dup_writes = int(tree["dup_writes"])
        self._seen = FingerprintIndex((int(fp) for fp in tree["seen"]), device=self.device)

    @classmethod
    def restore(cls, tree: dict, *, device="cuda") -> "PurePostProcessing":
        engine = cls(device=device)
        engine.load_snapshot(tree)
        return engine


class DIODE:
    """File-type-hinted hybrid dedup with one global adaptive threshold."""

    def __init__(
        self,
        cache_entries: int,
        stream_templates: Optional[Dict[int, str]] = None,
        policy: str = "lru",
        seed: int = 0,
        *,
        device="cuda",
    ):
        self._config = dict(
            cache_entries=cache_entries,
            stream_templates=dict(stream_templates or {}),
            policy=policy,
            seed=seed,
        )
        self.device = device
        self.store = BlockStore(device=device)
        self.cache = GlobalCache(cache_entries, policy=policy, device=device)
        self.post = PostProcessEngine(self.store)
        self.metrics = InlineMetrics()
        self.thresholds = SpatialThreshold()  # single pseudo-stream -1 = global
        self.stream_templates = stream_templates or {}
        self._total_writes = 0
        self._dup_writes = 0
        self._seen: FingerprintIndex = FingerprintIndex(device=device)
        self._run: list = []
        self._run_next_lba: Optional[int] = None
        self._run_stream: Optional[int] = None
        self._writes_since_update = 0

    def _ptype_fraction(self, stream: int) -> float:
        tname = self.stream_templates.get(stream)
        if tname is None:
            return 0.0
        return TEMPLATES[tname].ptype_fraction

    # -- write path -------------------------------------------------------------
    def _flush_run(self) -> None:
        if not self._run:
            return
        t = self.thresholds.get(-1)
        self.thresholds.record_dup_run(-1, len(self._run))
        if len(self._run) >= t:
            for stream, lba, fp, pba in self._run:
                # TOCTOU guard (same as HPDedup's run decision): the cached
                # pair may point at a PBA freed — or freed and recycled —
                # since the cache hit; deduping against it would map this
                # LBA onto dead or foreign content
                if self.store.fp_of_pba.get(pba) != fp:
                    self._write_through(stream, lba, fp)
                    continue
                self.store.map_duplicate(stream, lba, pba)
                self.metrics.inline_dups += 1
        else:
            for stream, lba, fp, pba in self._run:
                self._write_through(stream, lba, fp)
        self._run = []
        self._run_next_lba = None
        self._run_stream = None

    def _write_through(self, stream: int, lba: int, fp: int) -> None:
        pba = self.store.write_new_block(stream, lba, fp)
        self.cache.admit(stream, fp, pba)

    def on_write(self, stream: int, lba: int, fp: int) -> bool:
        self._total_writes += 1
        self.metrics.writes += 1
        if fp in self._seen:
            self._dup_writes += 1
        else:
            self._seen.add(fp)
        self.thresholds.record_request(-1, is_read=False)

        # DIODE's defining move: P-type content bypasses the inline phase
        if is_ptype(fp, self._ptype_fraction(stream)):
            self._flush_run()
            self.store.write_new_block(stream, lba, fp)  # no cache admission
            return False

        pba = self.cache.lookup(stream, fp)
        if pba is not None:
            self.metrics.cache_hits += 1
            if self._run and self._run_stream == stream and lba == self._run_next_lba:
                self._run.append((stream, lba, fp, pba))
                self._run_next_lba = lba + 1
            else:
                self._flush_run()
                self._run = [(stream, lba, fp, pba)]
                self._run_next_lba = lba + 1
                self._run_stream = stream
            return True
        self._flush_run()
        self._write_through(stream, lba, fp)
        self._maybe_update_threshold()
        return False

    def _maybe_update_threshold(self) -> None:
        self._writes_since_update += 1
        if self._writes_since_update >= 8192:
            self.thresholds.update(-1)
            self._writes_since_update = 0

    def write_batch(self, streams, lbas, fps) -> np.ndarray:
        from .batch_replay import diode_write_batch

        return diode_write_batch(self, streams, lbas, fps)

    def replay(self, trace: np.ndarray) -> "DIODE":
        assert trace.dtype == TRACE_DTYPE
        for rec in trace:
            if rec["op"] == OP_WRITE:
                self.on_write(int(rec["stream"]), int(rec["lba"]), int(rec["fp"]))
            else:
                self._flush_run()
                self.thresholds.record_request(-1, is_read=True)
                self.store.read(int(rec["stream"]), int(rec["lba"]))
        self._flush_run()
        return self

    def replay_batched(self, trace: np.ndarray, batch_size: int = 8192) -> "DIODE":
        from .batch_replay import diode_replay

        return diode_replay(self, trace, batch_size)

    # -- snapshot/restore ---------------------------------------------------------
    def snapshot(self) -> dict:
        config = dict(self._config)
        config["stream_templates"] = [[s, t] for s, t in config["stream_templates"].items()]
        return {
            "config": config,
            "store": self.store.snapshot(),
            "cache": self.cache.snapshot(),
            "metrics": self.metrics.snapshot(),
            "post_metrics": self.post.metrics.snapshot(),
            "thresholds": self.thresholds.snapshot(),
            "total_writes": self._total_writes,
            "dup_writes": self._dup_writes,
            "seen": sorted(self._seen),
            "run": [list(it) for it in self._run],
            "run_next_lba": self._run_next_lba,
            "run_stream": self._run_stream,
            "writes_since_update": self._writes_since_update,
        }

    def check_snapshot_config(self, tree: dict) -> None:
        """Raise (without mutating) if ``tree`` came from a differently-
        parameterized engine — state would restore but live capacities/
        policies would not."""
        config = dict(tree["config"])
        config["stream_templates"] = {int(s): t for s, t in config["stream_templates"]}
        if config != self._config:
            raise ValueError(
                "snapshot engine config differs from this engine's; "
                f"snapshot {config!r} vs live {self._config!r}"
            )

    def load_snapshot(self, tree: dict) -> None:
        self.check_snapshot_config(tree)
        self.store.load_snapshot(tree["store"])
        self.cache.load_snapshot(tree["cache"])
        self.metrics = InlineMetrics.from_snapshot(tree["metrics"])
        self.post.metrics = PostProcessMetrics.from_snapshot(tree["post_metrics"])
        self.thresholds.load_snapshot(tree["thresholds"])
        self._total_writes = int(tree["total_writes"])
        self._dup_writes = int(tree["dup_writes"])
        self._seen = FingerprintIndex((int(fp) for fp in tree["seen"]), device=self.device)
        self._run = [(int(s), int(lba), int(fp), int(pba)) for s, lba, fp, pba in tree["run"]]
        self._run_next_lba = None if tree["run_next_lba"] is None else int(tree["run_next_lba"])
        self._run_stream = None if tree["run_stream"] is None else int(tree["run_stream"])
        self._writes_since_update = int(tree["writes_since_update"])

    @classmethod
    def restore(cls, tree: dict, *, device="cuda") -> "DIODE":
        config = dict(tree["config"])
        config["stream_templates"] = {int(s): t for s, t in config["stream_templates"]}
        engine = cls(**config, device=device)
        engine.load_snapshot(tree)
        return engine

    def finish(self) -> HybridReport:
        self._flush_run()
        self.post.run_to_exact()
        self.metrics.cache_inserted = self.cache.inserted
        return HybridReport(
            inline=self.metrics,
            post=self.post.metrics,
            peak_disk_blocks=self.store.peak_blocks,
            final_disk_blocks=self.store.live_blocks,
            unique_fingerprints=self.store.unique_fingerprints(),
            total_writes=self._total_writes,
            total_dup_writes=self._dup_writes,
        )
