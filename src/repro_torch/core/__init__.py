"""HPDedup core on PyTorch: the inline write path of the reference package.

Public surface (each the counterpart of ``repro.core``'s name):

* ``Engine`` — the protocol every dedup engine implements; ``run_replay``
  drives any engine, batched or scalar, over a merged trace.
* ``HPDedup`` / ``HybridReport`` — the hybrid prioritized dedup mechanism.
* baselines: ``make_idedup``, ``PurePostProcessing``, ``DIODE``.
* ``ReplayBatch`` — columnar batched ingestion (``core.batch_replay``).
* ``ContentDefinedChunker`` — content-defined chunking of raw byte streams
  (Gear rolling hash on the card, ``kernels.cdc``) into ``ReplayBatch``
  columns, with ``CDCConfig`` (``core.cdc``).
* ``FingerprintIndex`` — the exact membership layer every probe in the
  stack routes through: a hash table on the card (CUDA kernels) or on the
  host (numpy) over an authoritative host key set (``core.fp_index``).
* ``StreamLocalityEstimator`` — reservoir + unseen-estimator LDSS tracking.
* ``PrioritizedCache`` / ``GlobalCache`` — fingerprint caches.
* ``SpatialThreshold`` — per-stream adaptive duplicate-sequence threshold.
* ``BlockStore`` / ``PostProcessEngine`` — storage substrate + exact phase.
* ``generate_workload`` — FIU-like synthetic multi-tenant traces.

Every class that holds a fingerprint index, and the chunker, takes
``device`` (default ``"cuda"``); pass ``device="cpu"`` to run on the host.
"""

from typing import Protocol, runtime_checkable

import numpy as np

from .baselines import DIODE, PurePostProcessing, make_idedup
from .batch_replay import (
    DEFAULT_BATCH_SIZE,
    ReplayBatch,
    engine_finish_replay,
    engine_ingest,
    run_replay,
)
from .cdc import CDCConfig, ContentDefinedChunker
from .cache import ARCCache, GlobalCache, LFUCache, LRUCache, PrioritizedCache
from .ffh import ffh_from_counts, ffh_from_sample, occurrence_counts
from .fingerprint import OP_READ, OP_WRITE, TRACE_DTYPE, host_fingerprint
from .fp_index import FingerprintIndex
from .hybrid import HPDedup, HybridReport
from .inline_engine import InlineDedupEngine
from .ldss import HoltPredictor, StreamLocalityEstimator
from .postprocess import PostProcessEngine
from .reservoir import Reservoir
from .segment_tree import FenwickSegments
from .store import BlockStore
from .threshold import SpatialThreshold
from .traces import TEMPLATES, WORKLOADS, generate_workload, trace_stats
from .unseen import (
    ldss_batch,
    ldss_from_counts,
    unseen_estimate_from_counts,
    unseen_estimate_ref,
    unseen_estimate_torch_from_counts,
)


@runtime_checkable
class Engine(Protocol):
    """One interface from trace ingest to reporting: columnar batches
    in, a ``HybridReport`` out (``replay`` is the per-record oracle)."""

    def write_batch(self, streams, lbas, fps) -> np.ndarray:
        """Ingest aligned (stream, lba, fingerprint) columns; returns the
        per-record inline-dedup flags."""
        ...

    def replay(self, trace: np.ndarray) -> "Engine":
        """Replay a merged TRACE_DTYPE trace in timestamp order."""
        ...

    def finish(self) -> HybridReport:
        """Flush, run the exact post-processing phase, and report."""
        ...


__all__ = [
    "Engine",
    "ReplayBatch",
    "run_replay",
    "engine_ingest",
    "engine_finish_replay",
    "DEFAULT_BATCH_SIZE",
    "DIODE",
    "PurePostProcessing",
    "make_idedup",
    "CDCConfig",
    "ContentDefinedChunker",
    "ARCCache",
    "GlobalCache",
    "LFUCache",
    "LRUCache",
    "PrioritizedCache",
    "ffh_from_counts",
    "ffh_from_sample",
    "occurrence_counts",
    "OP_READ",
    "OP_WRITE",
    "TRACE_DTYPE",
    "host_fingerprint",
    "FingerprintIndex",
    "HPDedup",
    "HybridReport",
    "InlineDedupEngine",
    "HoltPredictor",
    "StreamLocalityEstimator",
    "PostProcessEngine",
    "Reservoir",
    "FenwickSegments",
    "BlockStore",
    "SpatialThreshold",
    "TEMPLATES",
    "WORKLOADS",
    "generate_workload",
    "trace_stats",
    "ldss_batch",
    "ldss_from_counts",
    "unseen_estimate_from_counts",
    "unseen_estimate_ref",
    "unseen_estimate_torch_from_counts",
]
