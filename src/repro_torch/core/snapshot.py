"""Versioned snapshot/restore for the whole dedup engine stack.

The port's counterpart of the reference's ``core/snapshot.py``, with the
same format, version and kinds, so either package restores the other's
trees.  Every engine (``HPDedup`` — including its ``make_idedup``
configuration — ``DIODE``, ``PurePostProcessing`` and ``ShardedCluster``)
serializes to a *state tree*: nested dicts/lists of JSON scalars only
(``core.statetree`` documents the encoding rules).  ``snapshot_engine``
wraps an engine's tree in a self-describing envelope::

    {"format": "hpdedup-state-tree", "version": 2,
     "kind": "hpdedup" | "diode" | "postproc" | "cluster",
     "state": {...}}

Guarantees:

* **Bit-exact resumption.**  A snapshot taken at any batch boundary —
  pending duplicate runs, reservoir RNG state, eviction RNG state, Fenwick
  slot layout, LRU/LFU/ARC ordering and all counters included — restores an
  engine whose every future decision matches the original's, so finishing an
  interrupted replay yields a ``HybridReport`` identical to the
  uninterrupted run's.
* **Serializability.**  ``json.dumps(tree)`` round-trips losslessly.  The
  device an engine's fingerprint indexes live on is not part of the tree:
  ``restore_engine`` takes it as an argument.
* **Versioning.**  ``version`` gates compatibility: trees from any other
  writer version — newer or older — are rejected loudly instead of
  restored wrongly (an old tree lacks state the bit-exact guarantee needs,
  e.g. the raw Fenwick node array added in version 2).

``HybridReport`` (de)serialization lives here too: golden-report fixtures
and the cluster's retired-shard ledger both persist reports as JSON.
"""

from __future__ import annotations

from .baselines import DIODE, PurePostProcessing
from .cluster import ShardedCluster
from .hybrid import HPDedup, HybridReport
from .inline_engine import InlineMetrics
from .postprocess import PostProcessMetrics

SNAPSHOT_FORMAT = "hpdedup-state-tree"
# version 2: FenwickSegments trees carry the raw node array (version-1 trees
# would re-derive it from weights, which can drift by ULPs and break the
# bit-exact-resumption guarantee — so they are rejected, not fixed up), and
# cluster configs carry the monotonic PBA-namespace counter.
SNAPSHOT_VERSION = 2

_KINDS = {
    "hpdedup": HPDedup,
    "diode": DIODE,
    "postproc": PurePostProcessing,
    "cluster": ShardedCluster,
}


def _kind_of(engine) -> str:
    for kind, cls in _KINDS.items():
        if type(engine) is cls:
            return kind
    raise TypeError(
        f"no snapshot support for engine type {type(engine).__name__}; "
        f"known kinds: {sorted(_KINDS)}"
    )


def _check_envelope(tree: dict) -> None:
    if not isinstance(tree, dict) or tree.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"not a {SNAPSHOT_FORMAT} snapshot: {type(tree).__name__}")
    version = tree.get("version")
    if version != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot version {version} not supported (this build reads "
            f"version {SNAPSHOT_VERSION}); refusing a possibly-lossy restore"
        )
    if tree.get("kind") not in _KINDS:
        raise ValueError(f"unknown engine kind {tree.get('kind')!r}")


def snapshot_engine(engine) -> dict:
    """Engine -> versioned, JSON-serializable state tree."""
    return {
        "format": SNAPSHOT_FORMAT,
        "version": SNAPSHOT_VERSION,
        "kind": _kind_of(engine),
        "state": engine.snapshot(),
    }


def restore_engine(tree: dict, *, device="cuda"):
    """State tree -> a fresh engine, bit-exact with the snapshotted one, its
    fingerprint indexes on ``device`` (the card by default)."""
    _check_envelope(tree)
    return _KINDS[tree["kind"]].restore(tree["state"], device=device)


def check_engine_compatible(engine, tree: dict) -> None:
    """Raise, without mutating ``engine``, if ``tree`` cannot load into it
    in place: envelope format/version, engine kind, and — where the engine
    kind embeds one — the constructor config.  ``ShardedCluster`` runs this
    over every shard *before* loading any, so a mismatch rejects cleanly
    instead of leaving the cluster half-restored."""
    _check_envelope(tree)
    kind = _kind_of(engine)
    if kind != tree["kind"]:
        raise ValueError(f"snapshot is for kind {tree['kind']!r}, engine is {kind!r}")
    check = getattr(engine, "check_snapshot_config", None)
    if check is not None:
        check(tree["state"])


def load_engine_state(engine, tree: dict) -> None:
    """Load a state tree into an *existing* engine in place.

    Object identity is preserved all the way down (stores, caches,
    estimators), so process-local wiring — ``BlockStore.on_free`` reclaim
    hooks, estimator callbacks — survives the restore.  The engine must be
    of the snapshotted kind (and, for clusters, shape).
    """
    check_engine_compatible(engine, tree)
    engine.load_snapshot(tree["state"])


# ---------------------------------------------------------------------------
# HybridReport (de)serialization.
# ---------------------------------------------------------------------------


def report_to_tree(report: HybridReport) -> dict:
    return {
        "inline": report.inline.snapshot(),
        "post": report.post.snapshot(),
        "peak_disk_blocks": report.peak_disk_blocks,
        "final_disk_blocks": report.final_disk_blocks,
        "unique_fingerprints": report.unique_fingerprints,
        "total_writes": report.total_writes,
        "total_dup_writes": report.total_dup_writes,
    }


def report_from_tree(tree: dict) -> HybridReport:
    return HybridReport(
        inline=InlineMetrics.from_snapshot(tree["inline"]),
        post=PostProcessMetrics.from_snapshot(tree["post"]),
        peak_disk_blocks=int(tree["peak_disk_blocks"]),
        final_disk_blocks=int(tree["final_disk_blocks"]),
        unique_fingerprints=int(tree["unique_fingerprints"]),
        total_writes=int(tree["total_writes"]),
        total_dup_writes=int(tree["total_dup_writes"]),
    )
