"""HPDedup: the hybrid prioritized deduplication mechanism (paper §III).

Fuses the inline phase (fingerprint cache + LDSS prioritization + spatial
thresholds) with the post-processing phase (exact background dedup) over one
BlockStore, and keeps the fingerprint cache coherent across post-processing
merges.  This is the object the data pipeline and the serving KV-dedup layer
embed; trace replay drives it directly for the paper-validation benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np

from .fingerprint import OP_WRITE, TRACE_DTYPE
from .fp_index import FingerprintIndex
from .inline_engine import InlineDedupEngine, InlineMetrics
from .postprocess import PostProcessEngine, PostProcessMetrics
from .store import BlockStore


@dataclass
class HybridReport:
    inline: InlineMetrics
    post: PostProcessMetrics
    peak_disk_blocks: int
    final_disk_blocks: int
    unique_fingerprints: int
    total_writes: int
    total_dup_writes: int

    @property
    def inline_dedup_ratio(self) -> float:
        """Share of duplicate writes identified by inline caching (Fig. 6)."""
        return self.inline.inline_dups / self.total_dup_writes if self.total_dup_writes else 0.0

    @property
    def capacity_requirement(self) -> int:
        """Max disk blocks ever resident — the paper's Fig. 7 metric."""
        return self.peak_disk_blocks

    @property
    def avg_hits_of_cached_fingerprints(self) -> float:
        """Inline dedup hits per fingerprint admitted to the cache (Table IV)."""
        inserted = self.inline.cache_inserted
        return self.inline.inline_dups / inserted if inserted else 0.0


class HPDedup:
    """Hybrid prioritized deduplication over a block store."""

    def __init__(
        self,
        cache_entries: int = 32768,
        policy: str = "lru",
        sampling_rate: float = 0.15,
        interval_factor: float = 0.5,
        adaptive_threshold: bool = True,
        fixed_threshold: int = 4,
        prioritized: bool = True,
        use_jax_estimator: bool = False,
        use_unseen: bool = True,
        postprocess_period: int = 0,
        data_buffer_blocks: int = 4096,
        seed: int = 0,
        *,
        device="cuda",
    ):
        """``postprocess_period``: if > 0, run a post-processing pass every
        that many writes (interleaved idle-time model); 0 defers it to the
        end of replay.  ``use_jax_estimator`` keeps the reference's name (it
        is a config key of the snapshot tree) and selects the batched
        float32 solver of ``core.unseen``.  ``device`` is where every
        fingerprint index of the engine lives; it is not part of the config,
        so snapshot trees stay those of the reference."""
        # full constructor config: snapshots embed it so ``restore`` can
        # rebuild an identically-parameterized engine before loading state
        self._config = dict(
            cache_entries=cache_entries,
            policy=policy,
            sampling_rate=sampling_rate,
            interval_factor=interval_factor,
            adaptive_threshold=adaptive_threshold,
            fixed_threshold=fixed_threshold,
            prioritized=prioritized,
            use_jax_estimator=use_jax_estimator,
            use_unseen=use_unseen,
            postprocess_period=postprocess_period,
            data_buffer_blocks=data_buffer_blocks,
            seed=seed,
        )
        self.device = device
        self.store = BlockStore(data_buffer_blocks=data_buffer_blocks, device=device)
        self.inline = InlineDedupEngine(
            self.store,
            cache_entries=cache_entries,
            policy=policy,
            sampling_rate=sampling_rate,
            interval_factor=interval_factor,
            adaptive_threshold=adaptive_threshold,
            fixed_threshold=fixed_threshold,
            prioritized=prioritized,
            use_jax_estimator=use_jax_estimator,
            use_unseen=use_unseen,
            seed=seed,
            device=device,
        )
        self.post = PostProcessEngine(self.store)
        self.postprocess_period = postprocess_period
        self._writes_since_post = 0
        self._total_writes = 0
        self._dup_writes = 0
        # all-time seen fingerprints: a set-compatible exact index whose
        # batched probes run through the device-layout hash table
        self._seen_fps: FingerprintIndex = FingerprintIndex(device=device)

    # -- request ingestion -------------------------------------------------------
    def write(self, stream: int, lba: int, fp: int) -> bool:
        self._total_writes += 1
        if fp in self._seen_fps:
            self._dup_writes += 1  # ground truth for ratio metrics
        else:
            self._seen_fps.add(fp)
        deduped = self.inline.on_write(stream, lba, fp)
        self._writes_since_post += 1
        if self.postprocess_period and self._writes_since_post >= self.postprocess_period:
            self.run_postprocess()
        return deduped

    def read(self, stream: int, lba: int) -> Optional[int]:
        return self.inline.on_read(stream, lba)

    def write_batch(self, streams, lbas, fps) -> np.ndarray:
        """Columnar write ingestion: equivalent to calling ``write`` once per
        record, but with the vectorized batched pre-pass (see
        ``core.batch_replay``).  Returns per-record inline-dedup flags."""
        from .batch_replay import hpdedup_write_batch

        return hpdedup_write_batch(self, streams, lbas, fps)

    def replay(self, trace: np.ndarray) -> "HPDedup":
        """Replay a merged trace (TRACE_DTYPE records in timestamp order).

        This is the per-record reference path; ``replay_batched`` is the
        fast columnar path and must produce an identical ``HybridReport``.
        """
        assert trace.dtype == TRACE_DTYPE
        for rec in trace:
            if rec["op"] == OP_WRITE:
                self.write(int(rec["stream"]), int(rec["lba"]), int(rec["fp"]))
            else:
                self.read(int(rec["stream"]), int(rec["lba"]))
        self.inline.flush()
        return self

    def replay_batched(self, trace: np.ndarray, batch_size: int = 8192) -> "HPDedup":
        """Columnar batched replay — same semantics as ``replay``."""
        from .batch_replay import hpdedup_replay

        return hpdedup_replay(self, trace, batch_size)

    # -- post-processing -----------------------------------------------------------
    def run_postprocess(self, to_exact: bool = False, max_merges: Optional[int] = None) -> None:
        """One idle-time pass; ``max_merges`` budgets it (cluster cleanup
        windows bound per-shard work so foreground traffic can interleave)."""
        self.inline.flush()
        merged = self.post.run_to_exact() if to_exact else self.post.run(max_merges=max_merges)
        # keep the fingerprint cache coherent with the merged PBAs
        for fp, pba in merged.items():
            holder = getattr(self.inline.cache, "owner", {}).get(fp)
            if holder is not None:
                self.inline.cache.streams[holder].insert(fp, pba)
            elif hasattr(self.inline.cache, "cache") and fp in self.inline.cache.cache:
                self.inline.cache.cache.insert(fp, pba)
        self._writes_since_post = 0

    # -- online GC -------------------------------------------------------------
    def run_gc(
        self, max_moves: Optional[int] = None, max_merges: Optional[int] = None
    ) -> Dict[str, int]:
        """One epoch-drain + compaction step (see ``core.gc.gc_engine``).

        Decision-neutral by default: inline dedup decisions and the final
        ``HybridReport`` are bit-exact with a run that never calls this.
        ``max_merges`` additionally runs a budgeted post-process window,
        which (like ``run_postprocess``) is schedule-visible.
        """
        from .gc import gc_engine

        return gc_engine(self, max_moves=max_moves, max_merges=max_merges)

    # -- snapshot/restore ---------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe state tree; valid at any batch boundary (pending runs
        included).  The tree is plain JSON and equals the reference
        engine's, so either package restores the other's."""
        return {
            "config": dict(self._config),
            "store": self.store.snapshot(),
            "inline": self.inline.snapshot(),
            "post_metrics": self.post.metrics.snapshot(),
            "writes_since_post": self._writes_since_post,
            "total_writes": self._total_writes,
            "dup_writes": self._dup_writes,
            "seen_fps": sorted(self._seen_fps),
        }

    def check_snapshot_config(self, tree: dict) -> None:
        """Raise (without mutating) if ``tree`` came from a differently-
        parameterized engine: an in-place load would restore state but keep
        the live capacities/policies, so every future decision could diverge
        — reject loudly, like the version gate and the cluster's
        ring-parameter check."""
        if tree["config"] != self._config:
            raise ValueError(
                "snapshot engine config differs from this engine's; "
                f"snapshot {tree['config']!r} vs live {self._config!r}"
            )

    def load_snapshot(self, tree: dict) -> None:
        self.check_snapshot_config(tree)
        self.store.load_snapshot(tree["store"])
        self.inline.load_snapshot(tree["inline"])
        self.post.metrics = PostProcessMetrics.from_snapshot(tree["post_metrics"])
        self._writes_since_post = int(tree["writes_since_post"])
        self._total_writes = int(tree["total_writes"])
        self._dup_writes = int(tree["dup_writes"])
        # the index table is derived state: rebuilt from the serialized key
        # list, never persisted itself (snapshot format unchanged)
        self._seen_fps = FingerprintIndex(
            (int(fp) for fp in tree["seen_fps"]), device=self.device
        )

    @classmethod
    def restore(cls, tree: dict, *, device="cuda") -> "HPDedup":
        engine = cls(**tree["config"], device=device)
        engine.load_snapshot(tree)
        return engine

    # -- reporting --------------------------------------------------------------------
    def finish(self, run_post_to_exact: bool = True) -> HybridReport:
        self.inline.flush()
        if run_post_to_exact:
            self.run_postprocess(to_exact=True)
        m = self.inline.metrics
        m.cache_inserted = self.inline.cache.inserted
        return HybridReport(
            inline=m,
            post=self.post.metrics,
            peak_disk_blocks=self.store.peak_blocks,
            final_disk_blocks=self.store.live_blocks,
            unique_fingerprints=self.store.unique_fingerprints(),
            total_writes=self._total_writes,
            total_dup_writes=self._dup_writes,
        )


def replay_trace(trace: Iterable, engine: HPDedup) -> HybridReport:
    engine.replay(np.asarray(trace, dtype=TRACE_DTYPE))
    return engine.finish()
