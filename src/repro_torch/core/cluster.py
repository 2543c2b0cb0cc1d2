"""Sharded dedup cluster: consistent-hash fingerprint partitioning.

The port's counterpart of the reference's ``core/cluster.py``: the same
ring (bit-equal ``uint64`` points and routing), executor, replication,
resharding and snapshot trees.  Every shard's engine — and so every
``FingerprintIndex`` table it holds — lives on the cluster's ``device``
(the card by default); on a card, all shards launch the index kernels on
one CUDA stream (see ``ParallelShardExecutor``).

Scales the single-node engine toward the ROADMAP's production cluster the
way CASStor partitions its block store: every record is routed to one of N
*shards* — each a complete, independent ``Engine`` (fingerprint cache, LDSS
estimator, spatial thresholds, ``BlockStore``) — by **consistent hashing on
the content fingerprint**.  Because a given fingerprint always lands on the
same shard, per-shard seen-sets/fingerprint tables partition the global
fingerprint space exactly: aggregate duplicate counts, unique-fingerprint
counts and the post-exactness invariant (one block per live fingerprint)
all match a single monolithic engine, while the cache/estimator/store state
per shard stays small enough to serve heavy multi-tenant traffic.

``ShardedCluster`` implements the same ``Engine`` protocol as the engines
it wraps (``write_batch`` / ``replay`` / ``finish``), so the data pipeline,
the serving layer and every benchmark can swap a single engine for a
cluster without code changes:

* **Routing** — ``routing="fingerprint"`` (default) consistent-hashes the
  fingerprint; ``routing="stream"`` pins whole streams to shards (FASTEN's
  stream-affinity placement: better locality per shard, but cross-shard
  duplicates stay unmerged — per-shard exactness only).
* **Batched scatter** — ``replay_batched`` reuses the columnar
  ``ReplayBatch`` machinery: shard ids for a whole chunk come from one
  vectorized hash + ``searchsorted`` over the ring, the chunk scatters into
  per-shard sub-batches in one pass (``ReplayBatch.scatter``), and each
  sub-batch runs through the shard's batched replay loop — the batched
  throughput win carries over per shard.
* **Read routing** — under fingerprint partitioning the LBA mapping for a
  key lives wherever its *content* hashed, so the cluster keeps a routing
  directory ((stream, lba) -> shard, the routing tier's metadata) updated
  on writes; reads consult it (unknown keys fall back to the stream hash).
  Batched chunks take a vectorized directory path when no read in the
  chunk touches a key written in the same chunk, and replay the chunk's
  routing per record otherwise, so batched routing is exactly the scalar
  routing and per-shard record sequences are identical in both paths.
* **Parallel execution** — ``start_executor()`` attaches a
  ``ParallelShardExecutor``: one long-lived worker thread per shard, a
  pipelined coordinator that routes/scatters chunk k+1 while the shards
  drain chunk k, and a deterministic barrier-and-merge (``_sync``) before
  anything reads or migrates shard state.  Per-shard sub-batch sequences
  are identical to the serial path's, so ``HybridReport``, snapshots and
  every differential harness stay bit-exact.
* **Post-processing** — the exact phase runs *shard-locally*
  (CASStor-style idle cleanup windows): ``run_postprocess`` sweeps every
  shard, optionally budgeted per shard (``max_merges_per_shard``), and
  reports blocks reclaimed via the stores' reclaim counters.
* **Reporting** — ``finish`` aggregates per-shard ``HybridReport``s with
  ``aggregate_reports`` (plus any shards retired by shrinks); with one
  shard the cluster is bit-exact against the engine it wraps.
* **Elasticity + durability** — ``resize(new_num_shards)`` grows/shrinks
  the live cluster, migrating only the fingerprints the ring's
  minimal-remap property moves (ARCHITECTURE.md, "Elastic resharding");
  ``snapshot()``/``restore`` round-trip the whole cluster — every shard
  engine, the routing directory, retired reports — through a versioned
  JSON state tree such that a restored cluster is bit-exact on all future
  writes (``core.snapshot``).

PBA namespaces: each shard's store allocates from a disjoint PBA range
(``pba_stride`` apart), so physical ids stay globally unique — the serving
layer keys KV pages by PBA across the whole cluster.  Namespace slots are
handed out by a cluster-lifetime monotonic counter (persisted in snapshots)
rather than derived from shard indices: a slot retired by a shrink may still
have live blocks migrated onto surviving shards, so a later grow must never
allocate from that range again.
"""

from __future__ import annotations

import functools
import queue
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .batch_replay import (
    DEFAULT_BATCH_SIZE,
    ReplayBatch,
    _fp_column,
    engine_finish_replay,
    engine_run_batch,
)
from .fingerprint import OP_WRITE, TRACE_DTYPE
from .hybrid import HPDedup, HybridReport
from .inline_engine import InlineMetrics
from .postprocess import PostProcessMetrics
from .statetree import from_pairs, pairs

# Packed (stream, lba) routing-directory keys: stream << LBA_BITS | lba.
# 2^40 block addresses per stream (4 PiB volumes at 4 KB blocks) covers every
# workload here; larger LBAs would alias directory entries (routing would
# still be deterministic, just no longer key-exact).
_LBA_BITS = 40


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 finalizer: uint64 keys -> well-mixed uint64."""
    x = np.asarray(x, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class ConsistentHashRing:
    """Consistent-hash ring with virtual nodes and vectorized lookups.

    Each shard owns ``vnodes`` points on the uint64 ring; a key belongs to
    the first point clockwise from its hash.  Adding shard N+1 only inserts
    new points, so keys either stay put or move to the new shard — the
    minimal-remap property that lets a cluster grow without re-sharding
    the whole fingerprint space.
    """

    def __init__(self, num_shards: int, vnodes: int = 64, seed: int = 0):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        owners = np.repeat(np.arange(num_shards, dtype=np.int64), vnodes)
        salts = np.tile(np.arange(vnodes, dtype=np.uint64), num_shards)
        points = _splitmix64(
            owners.astype(np.uint64) * np.uint64(0x100000001B3)
            ^ (salts << np.uint64(20))
            ^ np.uint64(seed)
        )
        order = np.argsort(points, kind="stable")
        self.points = points[order]
        self.owners = owners[order]
        self.num_shards = num_shards
        # per-r successor tables, built lazily: row i = the first r *distinct
        # physical* owners met walking clockwise from ring position i
        self._succ: Dict[int, np.ndarray] = {}

    def _ring_idx(self, keys: np.ndarray) -> np.ndarray:
        h = _splitmix64(np.asarray(keys, dtype=np.uint64))
        idx = np.searchsorted(self.points, h, side="left")
        # past the last point: wrap to the ring's first point
        idx[idx == self.points.size] = 0
        return idx

    def shard_of_many(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized ring lookup: one hash + one searchsorted per batch."""
        return self.owners[self._ring_idx(keys)]

    def shard_of(self, key: int) -> int:
        return int(self.shard_of_many(np.asarray([key], dtype=np.uint64))[0])

    def _successor_table(self, r: int) -> np.ndarray:
        """(num_points, r) table: first ``r`` distinct physical shards from
        each ring position.  Successive vnodes of one shard are skipped — a
        replica set never places two copies on the same physical shard."""
        table = self._succ.get(r)
        if table is None:
            n = self.owners.size
            doubled = np.concatenate([self.owners, self.owners])
            table = np.empty((n, r), dtype=np.int64)
            for i in range(n):
                got = 0
                for owner in doubled[i : i + n]:
                    if owner not in table[i, :got]:
                        table[i, got] = owner
                        got += 1
                        if got == r:
                            break
            self._succ[r] = table
        return table

    def owners_of_many(self, keys: np.ndarray, r: int) -> np.ndarray:
        """Replica placement: for each key, the ``r`` distinct physical
        shards owning its copies, primary first.  Column 0 is identical to
        ``shard_of_many`` — replication never re-homes the primary, so all
        engine decisions are unchanged by R.  Requires r <= num_shards."""
        if not 1 <= r <= self.num_shards:
            raise ValueError(f"r must be in [1, {self.num_shards}], got {r}")
        idx = self._ring_idx(keys)
        if r == 1:
            return self.owners[idx][:, None]
        return self._successor_table(r)[idx]


_SHUTDOWN = object()


class ShardWorkerError(RuntimeError):
    """A shard worker thread raised mid-replay.

    The shard's engine state is undefined past the failing sub-batch, so the
    error is *sticky*: every later ``barrier()`` re-raises until the executor
    is closed (recover by discarding the cluster and restoring the last
    snapshot, exactly like a failed ``resize``)."""


class ParallelShardExecutor:
    """One long-lived worker thread per shard, with a deterministic barrier.

    The concurrency model (ARCHITECTURE.md, "Concurrency model"):

    * **Thread ownership** — between a ``submit`` and the next ``barrier``,
      shard ``s``'s engine is touched *only* by worker thread ``s``.  Shards
      share no mutable state (disjoint fingerprint partitions, stores, caches,
      RNGs), so workers never need locks; numpy work and kernel launches
      inside a shard drop the GIL and overlap across workers.
    * **One stream on a card** — a worker thread launches on its current
      CUDA stream, which is the device's default stream for a new thread,
      so every shard's index launches queue on that one stream, in the
      order each worker issues them; a probe's pinned keys stay alive on
      its flags tensor until the worker reads them.
    * **Ordering** — each worker drains its own FIFO queue, so a shard
      executes exactly the sub-batch sequence the coordinator submitted, in
      order.  That sequence is identical to the serial path's, which is the
      whole determinism argument: per-shard engine state — and therefore
      ``HybridReport``, snapshots and every differential harness — is
      bit-exact regardless of how the OS schedules the workers.
    * **Backpressure** — queues are bounded (``max_queued`` work items per
      shard); a coordinator that routes faster than shards drain blocks in
      ``submit``, which caps pipeline memory at ``max_queued`` chunks.
    * **Errors** — a worker exception is recorded, the worker keeps draining
      (so barriers never deadlock) but skips all further work for that shard,
      and the next ``barrier``/``submit`` raises ``ShardWorkerError``.
    """

    def __init__(self, num_shards: int, max_queued: int = 4, name: str = "shard"):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self._queues: List[queue.Queue] = [queue.Queue(maxsize=max_queued) for _ in range(num_shards)]
        self._errors: List[Optional[BaseException]] = [None] * num_shards
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, args=(s,), name=f"{name}-{s}", daemon=True)
            for s in range(num_shards)
        ]
        for t in self._threads:
            t.start()

    def _worker(self, s: int) -> None:
        q = self._queues[s]
        while True:
            item = q.get()
            if item is _SHUTDOWN:
                return
            if isinstance(item, threading.Event):
                item.set()  # barrier marker: always answered, even after errors
                continue
            if self._errors[s] is None:
                try:
                    item()
                except BaseException as e:  # noqa: BLE001 - re-raised at barrier
                    self._errors[s] = e

    def _check_errors(self) -> None:
        for s, e in enumerate(self._errors):
            if e is not None:
                raise ShardWorkerError(
                    f"shard {s} worker failed: {e!r}; shard state is undefined "
                    "— discard the cluster and restore from the last snapshot"
                ) from e

    def failed_shards(self) -> Dict[int, BaseException]:
        """Shard index -> the first exception its worker raised (empty when
        healthy).  The teardown path uses this to mark exactly the faulted
        shards poisoned instead of re-raising mid-shutdown."""
        return {s: e for s, e in enumerate(self._errors) if e is not None}

    def submit(self, shard: int, fn: Callable[[], object]) -> None:
        """Enqueue ``fn`` on shard ``shard``'s worker (FIFO per shard).
        Blocks when the shard's queue is full (backpressure).  A fault is
        lane-local: submitting to the faulted lane raises, submitting to a
        healthy lane proceeds (the fault still surfaces at the next
        barrier) — so one poisoned shard cannot abort a scatter half-way
        and strand routed-but-unexecuted work on the healthy lanes."""
        if self._closed:
            raise RuntimeError("executor is closed")
        e = self._errors[shard]
        if e is not None:
            raise ShardWorkerError(
                f"shard {shard} worker failed: {e!r}; shard state is undefined "
                "— discard the cluster and restore from the last snapshot"
            ) from e
        self._queues[shard].put(fn)

    def barrier(self) -> None:
        """Wait until every worker has drained its queue; re-raise the first
        worker error.  After ``barrier`` returns, the coordinator may touch
        shard engines directly (report/snapshot/resize/scalar paths)."""
        if self._closed:
            raise RuntimeError("executor is closed")
        events = [threading.Event() for _ in range(self.num_shards)]
        for q, ev in zip(self._queues, events):
            q.put(ev)
        for ev in events:
            ev.wait()
        self._check_errors()

    def close(self) -> None:
        """Shut the workers down (queued work still drains first)."""
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(_SHUTDOWN)
        for t in self._threads:
            t.join()

    def __enter__(self) -> "ParallelShardExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def aggregate_reports(reports: Sequence[HybridReport]) -> HybridReport:
    """Sum per-shard reports into one cluster-level ``HybridReport``.

    With fingerprint routing the shards partition the fingerprint space, so
    summed ``unique_fingerprints`` / ``total_dup_writes`` equal the global
    single-engine values; under stream routing they over-count content
    duplicated across shards (per-shard exactness only).  Peak disk blocks
    is the sum of per-shard peaks — exact while shards only grow (no
    overwrites before the finish-time cleanup), an upper bound otherwise.
    """
    inline = InlineMetrics()
    post = PostProcessMetrics()
    peak = final = uniq = writes = dups = 0
    for r in reports:
        m = r.inline
        inline.writes += m.writes
        inline.reads += m.reads
        inline.inline_dups += m.inline_dups
        inline.cache_hits += m.cache_hits
        inline.broken_runs += m.broken_runs
        inline.cache_inserted += m.cache_inserted
        for s, v in m.per_stream_dups.items():
            inline.per_stream_dups[s] = inline.per_stream_dups.get(s, 0) + v
        for s, v in m.per_stream_writes.items():
            inline.per_stream_writes[s] = inline.per_stream_writes.get(s, 0) + v
        post.passes += r.post.passes
        post.merges += r.post.merges
        post.blocks_reclaimed += r.post.blocks_reclaimed
        peak += r.peak_disk_blocks
        final += r.final_disk_blocks
        uniq += r.unique_fingerprints
        writes += r.total_writes
        dups += r.total_dup_writes
    return HybridReport(
        inline=inline,
        post=post,
        peak_disk_blocks=peak,
        final_disk_blocks=final,
        unique_fingerprints=uniq,
        total_writes=writes,
        total_dup_writes=dups,
    )


def _locked(fn):
    """Coordinator mutual exclusion: every public entry point that submits
    worker work or reads shard state runs under the cluster's reentrant
    lock, so a snapshot from one thread can never interleave with another
    thread's submission loop and serialize an engine a worker is mutating
    (the run_gc(wait=False)-vs-snapshot race).  Workers never take this
    lock, so holding it across a barrier cannot deadlock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


class _ReplicaStore:
    """One physical shard's replica-side state (coordinator-owned).

    Replicas are content-addressed mirrors, not engines: a shard holds at
    most one copy of each fingerprint replicated onto it, refcounted by the
    number of live (stream, lba) keys referencing that content.  Alongside
    the copies it keeps, per *primary* shard, the ordered oplog of every
    record routed to that primary since the last cluster checkpoint — the
    roll-forward log ``recover_shard`` replays into a rebuilt engine.

    Only the coordinator thread touches replica stores (routing time /
    barrier points), so they need no locking of their own.
    """

    __slots__ = ("oplog", "copies", "limbo")

    def __init__(self):
        # primary shard -> [[seq, stream, lba, fp, op, ts], ...] in seq order
        self.oplog: Dict[int, List[list]] = {}
        self.copies: Dict[int, int] = {}  # fp -> live keys referencing it here
        # fps whose count hit zero while GC grace was armed: the dict entry
        # (the physical copy) stays until a barrier point drains the limbo
        self.limbo: List[int] = []

    def log(self, primary: int, entry: list) -> None:
        self.oplog.setdefault(primary, []).append(entry)

    def add_copy(self, fp: int) -> None:
        self.copies[fp] = self.copies.get(fp, 0) + 1

    def drop_copy(self, fp: int, deferred: bool) -> None:
        n = self.copies.get(fp)
        if n is None:
            return  # copy was placed while this shard was dead; nothing here
        if n <= 1:
            if deferred:
                self.copies[fp] = 0  # logical free now, physical at drain
                self.limbo.append(fp)
            else:
                del self.copies[fp]
        else:
            self.copies[fp] = n - 1

    def drain_limbo(self) -> int:
        """Barrier point: physically drop copies whose count is still zero.
        A fingerprint re-replicated since its logical free stays live."""
        dropped = 0
        for fp in self.limbo:
            if self.copies.get(fp) == 0:
                del self.copies[fp]
                dropped += 1
        self.limbo = []
        return dropped

    @property
    def blocks(self) -> int:
        """Physical replica blocks held (limbo'd copies still occupy one)."""
        return len(self.copies)

    def to_tree(self) -> dict:
        return {
            "oplog": {str(p): log for p, log in self.oplog.items()},
            "copies": pairs(self.copies),
            "limbo": list(self.limbo),
        }

    @classmethod
    def from_tree(cls, tree: dict) -> "_ReplicaStore":
        rs = cls()
        rs.oplog = {int(p): [list(e) for e in log] for p, log in tree["oplog"].items()}
        rs.copies = from_pairs(tree["copies"], value=int)
        rs.limbo = [int(fp) for fp in tree["limbo"]]
        return rs


class ShardedCluster:
    """N per-shard engines behind one ``Engine`` protocol."""

    def __init__(
        self,
        num_shards: int = 4,
        engine_factory: Optional[Callable[[int], object]] = None,
        routing: str = "fingerprint",
        vnodes: int = 64,
        seed: int = 0,
        pba_stride: int = 1 << 48,
        replication_factor: int = 1,
        *,
        device="cuda",
        **engine_kwargs,
    ):
        """``device`` is where the default factory's engines keep their
        fingerprint indexes (the card by default; ``"cpu"`` on the host) and
        where restored and recovered shards go.  It is not an engine kwarg
        and not part of the snapshot tree, so trees stay the reference's."""
        if routing not in ("fingerprint", "stream"):
            raise ValueError(f"routing must be 'fingerprint' or 'stream', got {routing!r}")
        if replication_factor < 1:
            raise ValueError(f"replication_factor must be >= 1, got {replication_factor}")
        if replication_factor > 1 and routing != "fingerprint":
            raise ValueError("replication requires fingerprint routing")
        self.device = device
        if engine_factory is None:
            self._engine_kwargs: Optional[dict] = dict(engine_kwargs)
            engine_factory = lambda shard: HPDedup(
                seed=seed + shard, device=device, **engine_kwargs
            )
        elif engine_kwargs:
            raise ValueError("engine_kwargs only apply to the default HPDedup factory")
        else:
            self._engine_kwargs = None  # custom factory: not serializable
        self.num_shards = num_shards
        self.routing = routing
        self._vnodes = vnodes
        self._seed = seed
        self._pba_stride = pba_stride
        self._engine_factory = engine_factory
        # monotonic PBA-namespace allocator: every shard engine ever created
        # gets its own stride slot, never reused — a slot retired by a shrink
        # still has live blocks migrated onto surviving shards, so recreating
        # it on a later grow must not re-allocate from its old range
        self._next_namespace = 0
        # set by run_gc(): shards created later (resize grows) inherit it
        self._gc_deferred = False
        self.ring = ConsistentHashRing(num_shards, vnodes=vnodes, seed=seed)
        self.shards: List = [self._make_shard_engine(i) for i in range(num_shards)]
        self._directory: Dict[int, int] = {}  # packed (stream, lba) -> shard
        # reports of shards drained and removed by ``resize`` shrinks: their
        # accrued counters stay part of the cluster's aggregate report
        self._retired_reports: List[HybridReport] = []
        self.shard_reports: Optional[List[HybridReport]] = None
        # optional thread-per-shard executor (``start_executor``); None means
        # every entry point runs shards serially on the calling thread
        self._executor: Optional[ParallelShardExecutor] = None
        # True while any submitted work may still be queued on a worker —
        # the coordinator must barrier before touching a shard engine inline
        self._workers_dirty = False
        # parallel-dispatch floor: chunks whose largest per-shard sub-batch
        # is smaller run inline on the coordinator instead of being
        # scattered to all workers (thread handoff + GIL thrash costs more
        # than the work on tiny sub-batches; measured 0.41x on a 1-CPU host
        # under fingerprint routing).  Plain attribute, not serialized.
        self.min_parallel_batch = 2048
        # coordinator mutual exclusion (see _locked) + executor fault state:
        # shards whose worker raised are poisoned until fail/recover or a
        # snapshot reload re-establishes their state
        self._lock = threading.RLock()
        self._poisoned: Dict[int, BaseException] = {}
        self._init_replication(replication_factor)

    def _init_replication(self, factor: int) -> None:
        """Replication bookkeeping (all coordinator-owned; see the
        "Replication & recovery" section of ARCHITECTURE.md).

        ``factor`` is the *requested* R; the effective R is clamped to the
        live shard count (never silently dropping copies — a warning marks
        the degradation) and re-evaluated on resize."""
        self.replication_factor = factor
        self._failed: set = set()
        self.failover_reads = 0
        self.failover_misses = 0
        self._rep_seq = 0  # cluster-global record sequence for oplog ordering
        self._rep_chunk = 0  # chunk counter: recovery replays the original
        # chunk alignment (engine state is chunk-boundary-sensitive by
        # design: triggers split batches, replay_batched flushes per call)
        self._rep_scalar = False  # transient: routing for the scalar path?
        # authoritative (packed key -> current fingerprint): drives replica
        # copy placement, eager overwrite fan-out, and mirror rebuilds
        self._rep_keys: Dict[int, int] = {}
        if factor > 1:
            self._replicas: List[Optional[_ReplicaStore]] = [
                _ReplicaStore() for _ in range(self.num_shards)
            ]
            self._since_ckpt = [0] * self.num_shards
            # per-shard engine state trees at the last checkpoint: the base
            # recover_shard restores before rolling the oplog forward
            from .snapshot import snapshot_engine

            self._ckpt: List[Optional[dict]] = [snapshot_engine(e) for e in self.shards]
        else:
            self._replicas = [None] * self.num_shards
            self._since_ckpt = [0] * self.num_shards
            self._ckpt = [None] * self.num_shards
        self._warn_if_clamped()

    @property
    def effective_replication(self) -> int:
        """Requested R clamped to the current shard count."""
        return min(self.replication_factor, self.num_shards)

    def _warn_if_clamped(self) -> None:
        """Clamp + warn, never silently drop: R beyond the live shard count
        degrades gracefully to one copy per shard, loudly."""
        if self.replication_factor > self.num_shards:
            warnings.warn(
                f"replication_factor={self.replication_factor} exceeds "
                f"{self.num_shards} shards; placing "
                f"{self.effective_replication} copies until the cluster grows",
                RuntimeWarning,
                stacklevel=3,
            )

    @property
    def replica_blocks(self) -> int:
        """Physical blocks held by replica stores cluster-wide (the storage
        cost of R > 1; the FASTEN dedup-ratio-vs-R denominator adds this)."""
        return sum(rs.blocks for rs in self._replicas if rs is not None)

    def _resync_replication(self) -> None:
        """Wholesale replication rebuild at a quiesced topology change
        (resize): re-derive the authoritative key->fp map from the flushed
        engines, re-place every content mirror on the *new* ring, truncate
        the oplogs, and take a fresh checkpoint of every shard.  Only valid
        with all shards live and every mapping final."""
        self._replicas = [
            _ReplicaStore() if self.replication_factor > 1 else None
            for _ in range(self.num_shards)
        ]
        self._since_ckpt = [0] * self.num_shards
        if self.replication_factor <= 1:
            self._ckpt = [None] * self.num_shards
            self._rep_keys = {}
            return
        rep: Dict[int, int] = {}
        for engine in self.shards:
            store = engine.store
            for (stream, lba), pba in store.lba_map.items():
                rep[(stream << _LBA_BITS) + lba] = int(store.fp_of_pba[pba])
        self._rep_keys = rep
        r = self.effective_replication
        if r > 1 and rep:
            fps = np.fromiter(rep.values(), dtype=np.uint64, count=len(rep))
            owners = self.ring.owners_of_many(fps, r)
            for fp, row in zip(fps.tolist(), owners[:, 1:].tolist()):
                for o in row:
                    self._replicas[o].add_copy(fp)
        from .snapshot import snapshot_engine

        self._ckpt = [snapshot_engine(e) for e in self.shards]

    def _load_replication(self, sub: Optional[dict]) -> None:
        """Install replication state from a snapshot subtree (``None`` —
        e.g. a pre-replication snapshot — means an R == 1 cluster)."""
        if not sub:
            self._init_replication(1)
            return
        self.replication_factor = int(sub["factor"])
        self._failed = set()
        self.failover_reads = int(sub["failover_reads"])
        self.failover_misses = int(sub["failover_misses"])
        self._rep_seq = int(sub["seq"])
        self._rep_chunk = int(sub["chunk"])
        self._rep_scalar = False
        self._rep_keys = from_pairs(sub["rep_keys"], value=int)
        self._since_ckpt = [int(x) for x in sub["since_ckpt"]]
        self._replicas = [
            _ReplicaStore.from_tree(t) if t is not None else None for t in sub["replicas"]
        ]
        self._ckpt = list(sub["ckpt"])

    def _replication_tree(self) -> Optional[dict]:
        """Snapshot subtree for the replication overlay (``None`` at R == 1:
        nothing to carry, and pre-replication snapshots stay loadable)."""
        if self.replication_factor <= 1:
            return None
        return {
            "factor": self.replication_factor,
            "seq": self._rep_seq,
            "chunk": self._rep_chunk,
            "failover_reads": self.failover_reads,
            "failover_misses": self.failover_misses,
            "rep_keys": pairs(self._rep_keys),
            "since_ckpt": list(self._since_ckpt),
            "replicas": [rs.to_tree() if rs is not None else None for rs in self._replicas],
            "ckpt": self._ckpt,
        }

    def _check_poisoned(self) -> None:
        if self._poisoned:
            shards = sorted(self._poisoned)
            raise ShardWorkerError(
                f"shard workers {shards} faulted and their engines are "
                "poisoned; recover with fail_shard()+recover_shard() per "
                "shard, or reload the whole cluster from a snapshot"
            )

    # -- parallel execution --------------------------------------------------------
    def start_executor(self, max_queued: int = 4) -> ParallelShardExecutor:
        """Attach a ``ParallelShardExecutor`` (one worker thread per shard).

        While attached, ``write_batch`` / ``ingest_batched`` /
        ``replay_batched`` scatter per-shard work onto the workers and the
        coordinator pipelines: chunk k+1 is routed and scattered while the
        shards drain chunk k.  The caller owns the lifecycle — call
        ``stop_executor()`` when done (``resize`` restarts it automatically
        because the shard count changes)."""
        with self._lock:
            if self._executor is None:
                self._executor = ParallelShardExecutor(self.num_shards, max_queued=max_queued)
            return self._executor

    def stop_executor(self) -> None:
        """Drain outstanding work, then stop and detach the worker threads.

        Teardown never re-raises a sticky ``ShardWorkerError`` (the fault
        already surfaced — or will — at an engine call): faulted shards are
        recorded as *poisoned* instead, so the cluster is cleanly stoppable
        and restartable after an injected worker fault, and later engine
        calls raise one clear error naming the recovery paths
        (``fail_shard``/``recover_shard`` or a snapshot reload)."""
        with self._lock:
            ex, self._executor = self._executor, None
            self._workers_dirty = False
            if ex is not None:
                try:
                    ex.barrier()
                except ShardWorkerError:
                    self._poisoned.update(ex.failed_shards())
                finally:
                    ex.close()

    def _sync(self) -> None:
        """Barrier-and-merge point: wait for all in-flight shard work before
        the coordinator touches shard engines (reports, snapshots, resize,
        scalar paths, probes).  No-op without an executor."""
        self._check_poisoned()
        ex = self._executor
        if ex is not None:
            try:
                ex.barrier()
            except ShardWorkerError:
                # record *which* shards faulted before propagating, so the
                # cluster stays cleanly stoppable/recoverable afterwards
                self._poisoned.update(ex.failed_shards())
                raise
            self._workers_dirty = False

    def _submit_pinned(self, shard: int, fn: Callable[[], object]) -> None:
        """Submit engine work to a shard's lane with the GC grace period
        pinned: the write is in flight from submission until the worker
        finishes it, so an online-GC step queued behind (or concurrent
        with) it parks any zero-refcount PBA in limbo instead of reclaiming
        the slot while the epoch is still pinned."""
        store = self.shards[shard].store
        tag = store.pin_epoch()

        def _run() -> None:
            try:
                fn()
            finally:
                store.unpin_epoch(tag)

        try:
            self._executor.submit(shard, _run)
        except ShardWorkerError:
            # the lane already faulted: record the poison and skip the
            # submission instead of aborting the whole scatter — healthy
            # lanes keep executing, this lane's records are already in the
            # replication oplog, and the fault surfaces at the call-end
            # barrier with the recovery paths named
            store.unpin_epoch(tag)
            self._poisoned.update(self._executor.failed_shards())
        except BaseException:
            # any other rejection (closed executor) never ran _run: release
            # the pin here or the grace period wedges open and limbo can no
            # longer drain without force
            store.unpin_epoch(tag)
            raise
        else:
            self._workers_dirty = True

    def _run_inline(self, parts, runner) -> None:
        """Coalesced path: run a chunk's sub-batches on the coordinator.
        Any still-queued worker item for these shards must finish first —
        shard engines are single-touch (see ParallelShardExecutor)."""
        if self._workers_dirty:
            self._sync()
        for s, sub in enumerate(parts):
            if sub is not None and s not in self._failed:
                runner(s, sub)

    def _make_shard_engine(self, shard: int):
        """Build shard ``shard``'s engine in the next unused PBA namespace
        slot (slots are cluster-lifetime-unique, not shard-index-derived)."""
        if self._engine_factory is None:
            raise ValueError(
                "this cluster was restored from a snapshot of a custom "
                "engine_factory cluster; growing it requires passing "
                "engine_factory to resize()"
            )
        engine = self._engine_factory(shard)
        engine.store._next_pba += self._next_namespace * self._pba_stride
        engine.store.deferred_reclaim = self._gc_deferred
        self._next_namespace += 1
        return engine

    # -- routing -----------------------------------------------------------------
    def shard_of_fp(self, fp: int) -> int:
        return self.ring.shard_of(int(fp))

    def engine_for(self, fp: int):
        """The shard engine owning ``fp``'s partition (fingerprint routing)."""
        if self.routing != "fingerprint":
            raise ValueError("engine_for(fp) requires fingerprint routing")
        return self.shards[self.shard_of_fp(fp)]

    def engine_for_stream(self, stream: int):
        return self.shards[self.ring.shard_of(int(stream))]

    @staticmethod
    def _packed_keys(streams: np.ndarray, lbas: np.ndarray) -> np.ndarray:
        return (streams.astype(np.int64) << _LBA_BITS) + lbas.astype(np.int64)

    def _route_chunk(self, rb: ReplayBatch) -> np.ndarray:
        """Per-record shard ids for one chunk — identical to scalar routing.

        Writes hash their fingerprint; reads consult the routing directory
        (falling back to the stream hash for never-written keys — or for
        keys whose directory row points at a shard index the cluster no
        longer has, the dangling rows an unmap-then-shrink used to leave
        behind).  The vectorized path is valid whenever no read in the
        chunk touches a key written earlier in the same chunk; otherwise
        the chunk's routing replays per record so directory semantics stay
        exact.  Routing is also the replication choke point: every routed
        record passes through ``_replicate_chunk`` exactly once.
        """
        sid = self._route_chunk_ids(rb)
        if self.replication_factor > 1 or self._failed:
            self._replicate_chunk(rb, sid)
        return sid

    def _route_chunk_ids(self, rb: ReplayBatch) -> np.ndarray:
        if self.num_shards == 1:
            return np.zeros(len(rb), dtype=np.int64)  # identity cluster
        if self.routing == "stream":
            return self.ring.shard_of_many(rb.stream.astype(np.uint64))
        num = self.num_shards
        sid = self.ring.shard_of_many(rb.fp)
        packed = self._packed_keys(rb.stream, rb.lba)
        directory = self._directory
        if rb.op is None:
            directory.update(zip(packed.tolist(), sid.tolist()))
            return sid
        is_w = rb.op == OP_WRITE
        if bool(is_w.all()):
            directory.update(zip(packed.tolist(), sid.tolist()))
            return sid
        r_mask = ~is_w
        w_packed = packed[is_w]
        r_keys = packed[r_mask].tolist()
        stream_sid = self.ring.shard_of_many(rb.stream[r_mask].astype(np.uint64))
        if not bool(np.isin(packed[r_mask], w_packed).any()):
            # no read sees an in-chunk write: pre-chunk directory is exact
            sid = sid.copy()
            lookup = np.fromiter(
                (directory.get(k, d) for k, d in zip(r_keys, stream_sid.tolist())),
                dtype=np.int64,
                count=len(r_keys),
            )
            stale = lookup >= num  # dangling rows -> stream-hash fallback
            if bool(stale.any()):
                lookup[stale] = stream_sid[stale]
            sid[r_mask] = lookup
            directory.update(zip(w_packed.tolist(), sid[is_w].tolist()))
            return sid
        out = np.empty(len(rb), dtype=np.int64)
        read_default = iter(stream_sid.tolist())
        for i, (w, key, fs) in enumerate(zip(is_w.tolist(), packed.tolist(), sid.tolist())):
            if w:
                directory[key] = fs
                out[i] = fs
            else:
                d = next(read_default)
                v = directory.get(key, d)
                out[i] = v if v < num else d
        return out

    # -- replication (R-way placement, failover, recovery logs) --------------------
    def _replica_owners(self, fp: int) -> List[int]:
        """The non-primary replica shards for ``fp``'s content (ring
        successors, distinct physical shards); empty when R_eff == 1."""
        r = self.effective_replication
        if r <= 1:
            return []
        owners = self.ring.owners_of_many(np.asarray([fp], dtype=np.uint64), r)
        return owners[0, 1:].tolist()

    def _drop_replica_copies(self, fp: int) -> None:
        """One key stopped referencing ``fp``: decrement its replica copies.
        While online GC has armed deferred reclaim, a copy whose refcount
        hits zero parks in the replica's limbo and is physically dropped
        only at the next barrier point — the replica-side grace period."""
        deferred = self._gc_deferred
        for o in self._replica_owners(fp):
            rs = self._replicas[o]
            if rs is not None:
                rs.drop_copy(fp, deferred)

    def _drain_replica_limbo(self) -> int:
        """Barrier point: every replica drains its deferred copy frees."""
        return sum(rs.drain_limbo() for rs in self._replicas if rs is not None)

    def _log_entry(self, s: int, entry: list) -> None:
        """Append one oplog entry for primary ``s`` to its R_eff-1 live ring
        successors (the log holders recovery merges)."""
        self._since_ckpt[s] += 1
        num, r = self.num_shards, self.effective_replication
        failed, replicas = self._failed, self._replicas
        logged, j = 0, 1
        while logged < r - 1 and j < num:
            t = (s + j) % num
            if t not in failed and replicas[t] is not None:
                replicas[t].log(s, entry)
                logged += 1
            j += 1

    # control-event ops in the oplog (data records carry the trace op, or
    # -1 for the tsless write_batch path):
    _OP_FLUSH = -2  # engine_finish_replay fired (replay_batched call end)
    _OP_UNMAP = -3  # cluster-level unmap hit this shard's store

    def _log_control(self, s: int, op: int, stream: int = 0, lba: int = 0) -> None:
        """Log a control event for primary ``s``: engine mutations that are
        not routed records (per-call flushes, deletes) must still roll
        forward in sequence during recovery."""
        if self.replication_factor <= 1:
            return
        seq = self._rep_seq
        self._rep_seq += 1
        self._rep_chunk += 1
        self._log_entry(s, [seq, stream, lba, 0, op, 0, self._rep_chunk, 0])

    def _replicate_chunk(self, rb: ReplayBatch, sid: np.ndarray) -> None:
        """Replication bookkeeping for one routed chunk (coordinator only).

        For every record, in routing order: assign the cluster-global
        sequence number, append the record to the oplog of R_eff-1 live
        successors of its *primary* shard (the roll-forward log recovery
        replays), and for writes maintain the authoritative key->fp map
        plus the content mirrors — R_eff-1 replica copies of the new
        fingerprint placed on its ring successors, with eager overwrite
        fan-out dropping the old content's copies.  Records whose primary
        is failed are logged but not executed (recovery replays them);
        reads against a failed primary are served from the mirror
        (``failover_reads``) or counted as misses."""
        factor = self.replication_factor
        failed = self._failed
        replicas = self._replicas
        rep_keys = self._rep_keys
        num = self.num_shards
        r = self.effective_replication
        streams = rb.stream.tolist()
        lbas = rb.lba.tolist()
        fps = rb.fp.tolist()
        sids = sid.tolist()
        ops = rb.op.tolist() if rb.op is not None else None
        tss = rb.ts.tolist() if rb.ts is not None else None
        owners = None
        if factor > 1 and r > 1:
            owners = self.ring.owners_of_many(rb.fp, r)
        self._rep_chunk += 1
        chunk = self._rep_chunk
        scalar = 1 if self._rep_scalar else 0
        for i in range(len(sids)):
            s = sids[i]
            fp = fps[i]
            # op -1 marks a tsless write_batch-style record so recovery can
            # replay it down the same code path it originally took; the
            # chunk id + scalar flag pin the original execution alignment
            # (engine state is chunk-boundary-sensitive, so recovery must
            # re-batch exactly as the live run did)
            op = ops[i] if ops is not None else -1
            is_write = ops is None or ops[i] == OP_WRITE
            seq = self._rep_seq
            self._rep_seq += 1
            if factor > 1:
                entry = [
                    seq, streams[i], lbas[i], fp, op,
                    tss[i] if tss is not None else 0, chunk, scalar,
                ]
                self._log_entry(s, entry)
            packed = (streams[i] << _LBA_BITS) + lbas[i]
            if is_write and factor > 1:
                old = rep_keys.get(packed)
                if old != fp:
                    if old is not None:
                        self._drop_replica_copies(old)
                    rep_keys[packed] = fp
                    if owners is not None:
                        for o in owners[i, 1:].tolist():
                            rs = replicas[o]
                            if rs is not None:
                                rs.add_copy(fp)
            if s in failed and not is_write:
                cur = rep_keys.get(packed)
                if cur is not None and any(
                    replicas[o] is not None and replicas[o].copies.get(cur, 0) > 0
                    for o in self._replica_owners(cur)
                ):
                    self.failover_reads += 1
                else:
                    self.failover_misses += 1

    def probe_fps(self, fps) -> np.ndarray:
        """Cluster-wide exact membership: has any shard ever seen each
        fingerprint?  One vectorized ring lookup routes the batch, then each
        owning shard's ``FingerprintIndex`` is probed with one batched
        launch — the scatter pre-pass's membership primitive, also the
        serving layer's bulk existence check.  Under stream routing a
        fingerprint may live on any shard, so every shard is probed and the
        results OR-ed (still one launch per shard)."""
        keys = np.ascontiguousarray(fps, dtype=np.uint64)
        if keys.size == 0:
            return np.zeros(0, dtype=bool)
        self._check_not_failed("probe_fps")
        self._sync()  # probes read engine state the workers may be mutating
        if self.num_shards == 1:
            return _probe_seen(self.shards[0], keys)
        if self.routing == "stream":
            out = np.zeros(keys.size, dtype=bool)
            for engine in self.shards:
                out |= _probe_seen(engine, keys)
            return out
        sid = self.ring.shard_of_many(keys)
        order = np.argsort(sid, kind="stable")
        counts = np.bincount(sid, minlength=self.num_shards)
        sorted_keys = keys[order]
        flags = np.empty(keys.size, dtype=bool)
        a = 0
        for s, c in enumerate(counts.tolist()):
            if c:
                flags[a : a + c] = _probe_seen(self.shards[s], sorted_keys[a : a + c])
                a += c
        out = np.empty(keys.size, dtype=bool)
        out[order] = flags
        return out

    # -- Engine protocol ----------------------------------------------------------
    @_locked
    def write_batch(self, streams, lbas, fps) -> np.ndarray:
        """Scatter aligned write columns across shards; gather inline flags.

        With an executor attached, each shard's sub-batch runs on its worker
        thread and the flags are gathered after the barrier — per-shard
        record sequences are identical to the serial path, so the flags (and
        all engine state) are bit-exact.  Records routed to a failed shard
        are logged for recovery but not executed; their flags read False."""
        self._check_poisoned()
        rb = ReplayBatch(np.asarray(streams), np.asarray(lbas), _fp_column(fps))
        sid = self._route_chunk(rb)
        out = np.zeros(len(rb), dtype=bool)
        parts, order = rb.scatter(sid, self.num_shards)
        ex = self._executor
        largest = max((len(sub) for sub in parts if sub is not None), default=0)
        if ex is None or self.num_shards == 1 or largest < self.min_parallel_batch:
            if ex is not None and self._workers_dirty:
                self._sync()
            flags = []
            for s, sub in enumerate(parts):
                if sub is not None:
                    if s in self._failed:
                        flags.append(np.zeros(len(sub), dtype=bool))
                    else:
                        flags.append(self.shards[s].write_batch(sub.stream, sub.lba, sub.fp))
        else:
            results: List[Optional[np.ndarray]] = [None] * self.num_shards

            def _run(s, sub):
                results[s] = self.shards[s].write_batch(sub.stream, sub.lba, sub.fp)

            for s, sub in enumerate(parts):
                if sub is not None and s not in self._failed:
                    self._submit_pinned(s, lambda s=s, sub=sub: _run(s, sub))
            self._sync()
            flags = [
                results[s] if results[s] is not None else np.zeros(len(sub), dtype=bool)
                for s, sub in enumerate(parts)
                if sub is not None
            ]
        if flags:
            out[order] = np.concatenate(flags)
        return out

    @_locked
    def replay(self, trace: np.ndarray) -> "ShardedCluster":
        """Scalar reference path: route per record, replay each shard's
        sub-trace through its engine's per-record oracle."""
        assert trace.dtype == TRACE_DTYPE
        self._sync()
        # mark the chunk scalar: recovery must replay these records through
        # the per-record oracle, not the batched replay loop
        self._rep_scalar = True
        try:
            sid = self._route_chunk(ReplayBatch.from_trace(trace))
        finally:
            self._rep_scalar = False
        for s in range(self.num_shards):
            if s in self._failed:
                continue
            idx = np.nonzero(sid == s)[0]
            if idx.size:
                self.shards[s].replay(trace[idx])
        return self

    def ingest_batched(
        self,
        trace: np.ndarray,
        batch_size: int = DEFAULT_BATCH_SIZE,
        parallel: bool = False,
        on_chunk: Optional[Callable[[int], None]] = None,
    ) -> "ShardedCluster":
        """Mid-stream columnar ingest: like ``replay_batched`` but WITHOUT
        the end-of-replay flush, so pending duplicate runs survive the call.
        This is the resumable entry point — ingest part of a trace, take a
        ``snapshot()``, and a restored cluster ingesting the remainder is
        bit-exact with one uninterrupted replay.

        ``parallel=True`` (or an already-attached executor) runs each shard's
        sub-batches on its worker thread, with the coordinator routing and
        scattering chunk k+1 while the shards drain chunk k; the call returns
        only after the barrier, so the cluster is quiescent on exit.  Chunks
        whose largest per-shard sub-batch is below ``min_parallel_batch``
        run inline on the coordinator (same per-shard order, so bit-exact).

        ``on_chunk(i)`` fires after chunk ``i`` is dispatched (not yet
        necessarily drained) — the hook the online-GC harness and benchmark
        use to schedule ``run_gc(wait=False)`` against genuinely in-flight
        traffic."""
        with self._lock:
            self._check_poisoned()
            own = parallel and self._executor is None and self.num_shards > 1
            if own:
                self.start_executor()
            rb = ReplayBatch.from_trace(trace)
            try:
                for i, chunk in enumerate(rb.batches(batch_size * self.num_shards)):
                    ex = self._executor  # on_chunk may fail/recover shards
                    sid = self._route_chunk(chunk)
                    parts, _ = chunk.scatter(sid, self.num_shards)
                    largest = max((len(sub) for sub in parts if sub is not None), default=0)
                    if ex is None or largest < self.min_parallel_batch:
                        if ex is not None:
                            self._run_inline(
                                parts, lambda s, sub: engine_run_batch(self.shards[s], sub)
                            )
                        else:
                            for s, sub in enumerate(parts):
                                if sub is not None and s not in self._failed:
                                    engine_run_batch(self.shards[s], sub)
                    else:
                        for s, sub in enumerate(parts):
                            if sub is not None and s not in self._failed:
                                engine = self.shards[s]
                                self._submit_pinned(
                                    s, lambda engine=engine, sub=sub: engine_run_batch(engine, sub)
                                )
                    if on_chunk is not None:
                        on_chunk(i)
                if self._executor is not None:
                    self._sync()
            finally:
                if own:
                    self.stop_executor()
        return self

    def replay_batched(
        self,
        trace: np.ndarray,
        batch_size: int = DEFAULT_BATCH_SIZE,
        parallel: bool = False,
    ) -> "ShardedCluster":
        """Columnar batched replay: one vectorized route + scatter per chunk,
        then each shard's batched replay loop over its sub-batch.  Chunks are
        ``batch_size * num_shards`` records so per-shard sub-batches stay
        near the tuned batch size.  ``parallel=True`` runs the shards on
        worker threads (pipelined coordinator, see ``ingest_batched``)."""
        with self._lock:
            own = parallel and self._executor is None and self.num_shards > 1
            if own:
                self.start_executor()
            try:
                self.ingest_batched(trace, batch_size, parallel=parallel)
                # the per-call flush is engine-visible state: log it so a
                # failed shard's recovery replays it at the same point
                for s in range(self.num_shards):
                    self._log_control(s, self._OP_FLUSH)
                ex = self._executor
                if ex is None:
                    for s, engine in enumerate(self.shards):
                        if s not in self._failed:
                            engine_finish_replay(engine)
                else:
                    for s, engine in enumerate(self.shards):
                        if s not in self._failed:
                            self._submit_pinned(
                                s, lambda engine=engine: engine_finish_replay(engine)
                            )
                    self._sync()
            finally:
                if own:
                    self.stop_executor()
        return self

    def replay_batched_timed(self, trace: np.ndarray, batch_size: int = DEFAULT_BATCH_SIZE):
        """Serial ``replay_batched`` with a per-phase wall-time breakdown.

        Returns ``{"route": s, "scatter": s, "shard_times": [s, ...]}``.
        This is the *diagnostic* view: it separates coordinator work
        (route + scatter, paid once) from per-shard ingest time, with the
        shards deliberately run serially so the per-phase attribution is
        clean.  The *measured* parallel number comes from
        ``replay_batched_parallel_timed`` — real worker threads, wall clock,
        no modeling (the old ``route + scatter + max(shard_times)`` model is
        kept only as a derived diagnostic in the scaling benchmark).
        """
        import time

        with self._lock:
            self._sync()
            t_route = t_scatter = 0.0
            shard_times = [0.0] * self.num_shards
            rb = ReplayBatch.from_trace(trace)
            for chunk in rb.batches(batch_size * self.num_shards):
                t0 = time.perf_counter()
                sid = self._route_chunk(chunk)
                t1 = time.perf_counter()
                parts, _ = chunk.scatter(sid, self.num_shards)
                t2 = time.perf_counter()
                t_route += t1 - t0
                t_scatter += t2 - t1
                for s, sub in enumerate(parts):
                    if sub is not None and s not in self._failed:
                        t3 = time.perf_counter()
                        engine_run_batch(self.shards[s], sub)
                        shard_times[s] += time.perf_counter() - t3
            for s, engine in enumerate(self.shards):
                if s in self._failed:
                    continue
                t3 = time.perf_counter()
                engine_finish_replay(engine)
                shard_times[s] += time.perf_counter() - t3
            return {"route": t_route, "scatter": t_scatter, "shard_times": shard_times}

    def replay_batched_parallel_timed(
        self, trace: np.ndarray, batch_size: int = DEFAULT_BATCH_SIZE
    ) -> dict:
        """Measured (not modeled) parallel replay: wall-clock seconds for the
        full pipelined run — coordinator routing/scatter overlapped with the
        shard workers, ending at the barrier after the per-shard flush.

        Returns ``{"wall": s, "started_executor": bool}``.  Uses the attached
        executor when one is running (thread-start cost excluded); otherwise
        spins one up for the call and includes its start/stop in the wall
        time, which is the honest end-to-end number for a cold run."""
        import time

        t0 = time.perf_counter()
        self.replay_batched(trace, batch_size=batch_size, parallel=True)
        return {
            "wall": time.perf_counter() - t0,
            "started_executor": self._executor is None,
        }

    def _invalidate_stale_keys(self) -> int:
        """Cross-shard overwrite invalidation (router-driven unref).

        When a key's newest write hashed to a different shard than an older
        one, the old shard still maps the key to stale content; the routing
        directory knows the current owner, so every other shard drops its
        replica (``BlockStore.unmap`` -> refcount drop -> GC).  After the
        sweep, live content is exactly the trace's last write per key —
        the property that makes cluster dedup counts match the monolithic
        oracle even on overwrite-heavy traces.  Callers must flush pending
        duplicate runs first so every mapping is final.
        """
        if self.num_shards == 1 or self.routing != "fingerprint":
            return 0  # keys cannot straddle shards
        directory = self._directory
        dropped = 0
        for s, engine in enumerate(self.shards):
            store = engine.store
            stale = [
                key
                for key in store.lba_map
                if directory.get((key[0] << _LBA_BITS) + key[1], s) != s
            ]
            for key in stale:
                store.unmap(*key)
                dropped += 1
        return dropped

    @_locked
    def finish(self) -> HybridReport:
        """Finish every shard (flush + shard-local exact phase) and aggregate.
        Shards retired by ``resize`` shrinks contribute their accrued
        counters through ``_retired_reports``."""
        self._check_not_failed("finish")
        self._sync()  # barrier-and-merge: no in-flight shard work past here
        for engine in self.shards:
            engine_finish_replay(engine)  # flush pending runs: mappings final
        self._invalidate_stale_keys()
        for engine in self.shards:
            # full barrier: no write is in flight, so every grace period has
            # drained — force-reclaim any limbo left by online GC
            engine.store.collect_limbo(force=True)
        self._drain_replica_limbo()  # replica grace periods drain here too
        self.shard_reports = [engine.finish() for engine in self.shards]
        if self.replication_factor > 1:
            # the exact phase mutated engine state outside the oplog: refresh
            # the recovery base so a later failure rolls forward from here
            self.checkpoint()
        return aggregate_reports(self.shard_reports + self._retired_reports)

    def _check_not_failed(self, what: str) -> None:
        if self._failed:
            raise RuntimeError(
                f"{what} requires every shard live; shards "
                f"{sorted(self._failed)} are failed — recover_shard() first"
            )

    # -- shard-local post-processing (idle cleanup windows) ------------------------
    @_locked
    def run_postprocess(
        self, to_exact: bool = False, max_merges_per_shard: Optional[int] = None
    ) -> int:
        """One CASStor-style cleanup window: each shard runs its exact phase
        locally (optionally budgeted), no cross-shard coordination beyond
        the router's stale-key invalidations.  Returns the number of disk
        blocks reclaimed across the cluster."""
        self._check_not_failed("run_postprocess")
        self._sync()
        before = self.reclaimed_blocks
        for engine in self.shards:
            engine_finish_replay(engine)
        self._invalidate_stale_keys()
        for engine in self.shards:
            if hasattr(engine, "run_postprocess"):
                engine.run_postprocess(to_exact=to_exact, max_merges=max_merges_per_shard)
            elif to_exact:
                engine.post.run_to_exact()
            else:
                engine.post.run(max_merges=max_merges_per_shard)
        if self.replication_factor > 1:
            # postprocess merges are engine state outside the oplog: refresh
            # the recovery base (also truncates the logs — a cheap bound)
            self.checkpoint()
        return self.reclaimed_blocks - before

    # -- online GC (epoch drain + compaction, no quiesce) ---------------------------
    @_locked
    def run_gc(
        self,
        max_moves_per_shard: Optional[int] = None,
        max_merges_per_shard: Optional[int] = None,
        wait: bool = True,
    ) -> Optional[Dict[str, int]]:
        """One online-GC step on every shard (see ``core.gc.gc_engine``).

        The first call arms deferred reclaim cluster-wide: from then on a
        zero-refcount PBA whose epoch is still pinned by an in-flight write
        parks in limbo and is physically reclaimed only after the epoch
        drains.  With an executor attached the per-shard GC steps are queued
        on the shard worker lanes — they interleave with live ingest without
        any quiesce (FIFO order per shard is the only synchronization
        needed; shards share no state).  ``wait=False`` returns immediately
        with ``None`` and lets the steps drain behind subsequent traffic;
        ``wait=True`` barriers and returns the summed per-shard stats.
        """
        from .gc import gc_engine

        self._check_poisoned()
        self._gc_deferred = True
        for engine in self.shards:
            if engine is not None:
                engine.store.deferred_reclaim = True
        ex = self._executor
        slots: List[Optional[Dict[str, int]]] = [None] * self.num_shards

        def _gc(s: int, engine) -> None:
            slots[s] = gc_engine(
                engine, max_moves=max_moves_per_shard, max_merges=max_merges_per_shard
            )

        if ex is None:
            for s, engine in enumerate(self.shards):
                if s not in self._failed:
                    _gc(s, engine)
        else:
            for s, engine in enumerate(self.shards):
                if s in self._failed:
                    continue
                # deliberately unpinned: GC must not pin the epoch it is
                # about to drain
                ex.submit(s, lambda s=s, engine=engine: _gc(s, engine))
            self._workers_dirty = True
            if not wait:
                return None
            self._sync()
        # wait=True is a barrier point: replica-side grace periods drain
        # alongside the engine-side epochs
        self._drain_replica_limbo()
        if self.replication_factor > 1 and not self._failed:
            # GC moves/merges are engine state outside the oplog: refresh
            # the recovery base at the barrier.  (wait=False leaves a window
            # — a shard failing while a queued GC step is unbarriered
            # recovers to pre-GC state; see ARCHITECTURE.md.)
            self.checkpoint()
        totals: Dict[str, int] = {}
        for st in slots:
            for k, v in (st or {}).items():
                totals[k] = totals.get(k, 0) + v
        return totals

    @property
    def reclaimed_blocks(self) -> int:
        """Cluster-wide reclaim counter (see ``BlockStore.freed_blocks``)."""
        return sum(e.store.freed_blocks for e in self.shards if e is not None)

    @property
    def relocated_blocks(self) -> int:
        """Cluster-wide compaction counter (see ``BlockStore.compact``)."""
        return sum(e.store.relocated_blocks for e in self.shards if e is not None)

    # -- invariants ----------------------------------------------------------------
    @_locked
    def check_consistency(self) -> None:
        """Per-shard store invariants + fingerprint-partition disjointness
        (failed shards are skipped — they have no engine to check)."""
        self._sync()
        for s, engine in enumerate(self.shards):
            if s in self._failed:
                continue
            engine.store.check_consistency()
            if self.routing == "fingerprint":
                fps = list(engine.store.fp_table.keys())
                if fps:
                    owners = self.ring.shard_of_many(np.asarray(fps, dtype=np.uint64))
                    assert bool((owners == s).all()), (
                        f"shard {s} stores fingerprints owned by other shards"
                    )

    # -- deletes (cluster-level unmap with replica fan-out) ------------------------
    @_locked
    def unmap(self, stream: int, lba: int) -> Optional[int]:
        """Delete one (stream, lba) key cluster-wide: route through the
        directory, unmap on the owning shard, fan the invalidation out to
        every replica copy, and drop the routing row so a later shrink
        cannot leave it dangling.  Returns the freed PBA (or ``None`` if
        the key was unknown)."""
        self._sync()
        packed = (int(stream) << _LBA_BITS) + int(lba)
        owner = self._directory.get(packed)
        if self.num_shards == 1:
            owner = 0
        if owner is not None and owner < self.num_shards and owner not in self._failed:
            candidates = [owner]
        else:
            # no (valid) directory row — stream routing, the pre-multi-shard
            # era, or a failed owner: probe every live shard for the key
            candidates = [s for s in range(self.num_shards) if s not in self._failed]
        pba = None
        hit = None
        for s in candidates:
            pba = self.shards[s].store.unmap(int(stream), int(lba))
            if pba is not None:
                hit = s
                break
        if hit is None and owner is not None and owner in self._failed:
            hit = owner  # key lives on the dead shard: recovery must unmap it
        if hit is not None:
            self._log_control(hit, self._OP_UNMAP, int(stream), int(lba))
        self._directory.pop(packed, None)
        old = self._rep_keys.pop(packed, None)
        if old is not None:
            self._drop_replica_copies(old)
        return pba

    # -- shard failure and recovery ------------------------------------------------
    @_locked
    def checkpoint(self) -> None:
        """Refresh every shard's recovery base state and truncate the
        roll-forward oplogs (a deterministic barrier point: replica-side
        grace periods drain here too).  Recovery of a failed shard replays
        only the records its primary routed since the last checkpoint, so
        periodic checkpoints bound both oplog memory and recovery time.
        No-op at R == 1 (nothing holds the logs)."""
        self._check_not_failed("checkpoint")
        self._sync()
        if self.replication_factor <= 1:
            return
        from .snapshot import snapshot_engine

        self._drain_replica_limbo()
        self._ckpt = [snapshot_engine(e) for e in self.shards]
        self._since_ckpt = [0] * self.num_shards
        for rs in self._replicas:
            if rs is not None:
                rs.oplog = {}

    @_locked
    def fail_shard(self, s: int) -> None:
        """Kill shard ``s``: its engine (and its replica mirror) are gone.

        Traffic keeps flowing — records whose primary is ``s`` are logged
        to the surviving oplog holders but not executed, reads fail over to
        the content mirrors — until ``recover_shard`` rebuilds the engine.
        A lane poisoned by an injected worker fault is the expected entry
        path: the sticky error is absorbed here (the executor is restarted
        clean) and the shard transitions to cleanly-failed."""
        if self.routing != "fingerprint":
            raise RuntimeError("fail_shard requires fingerprint routing")
        if not 0 <= s < self.num_shards:
            raise IndexError(f"shard {s} out of range")
        if s in self._failed:
            raise ValueError(f"shard {s} is already failed")
        ex = self._executor
        if ex is not None:
            try:
                ex.barrier()
                self._workers_dirty = False
            except ShardWorkerError:
                self._poisoned.update(ex.failed_shards())
            if self._poisoned:
                # sticky worker errors wedge every later submission: replace
                # the executor wholesale (stop_executor absorbs the fault)
                self.stop_executor()
                self.start_executor()
        self._poisoned.pop(s, None)
        self.shards[s] = None
        self._replicas[s] = None
        self._failed.add(s)

    @_locked
    def recover_shard(self, s: int) -> Dict[str, int]:
        """Rebuild failed shard ``s`` bit-exactly: restore its last
        checkpoint state tree, roll the merged surviving oplogs forward
        through the same engine entry points the records originally took,
        and re-derive its replica mirror from the authoritative key map.
        Raises if the oplog is incomplete (R == 1, or every log holder for
        some span also died — data loss is reported, never papered over)."""
        if s not in self._failed:
            raise ValueError(f"shard {s} is not failed")
        self._sync()
        if self._ckpt[s] is None:
            raise RuntimeError(
                f"shard {s} is unrecoverable: no replica log exists at "
                f"replication_factor={self.replication_factor} (need R >= 2)"
            )
        from .snapshot import restore_engine, snapshot_engine

        # merge + dedup the per-primary logs from every surviving holder
        merged: Dict[int, list] = {}
        for rs in self._replicas:
            if rs is None:
                continue
            for e in rs.oplog.get(s, ()):
                merged[e[0]] = e
        log = [merged[k] for k in sorted(merged)]
        if len(log) != self._since_ckpt[s]:
            raise RuntimeError(
                f"shard {s} is unrecoverable: oplog covers {len(log)} of "
                f"{self._since_ckpt[s]} records since the last checkpoint "
                f"(insufficient surviving replicas)"
            )
        engine = restore_engine(self._ckpt[s], device=self.device)
        engine.store.deferred_reclaim = self._gc_deferred
        # roll forward grouped by the *original* chunk ids: engine state is
        # chunk-boundary-sensitive by design (triggers split batches, the
        # per-call flush is an event), so recovery re-batches exactly as
        # the live run executed — same sub-batch per chunk, same entry
        # point per kind (write_batch / batched replay loop / scalar oracle),
        # control events (flush, unmap) applied in sequence
        i, n = 0, len(log)
        while i < n:
            op = log[i][4]
            if op == self._OP_FLUSH:
                engine_finish_replay(engine)
                i += 1
                continue
            if op == self._OP_UNMAP:
                engine.store.unmap(log[i][1], log[i][2])
                i += 1
                continue
            chunk = log[i][6]
            j = i
            while j < n and log[j][6] == chunk:
                j += 1
            run = log[i:j]
            streams = np.asarray([e[1] for e in run], dtype=np.int32)
            lbas = np.asarray([e[2] for e in run], dtype=np.int64)
            fps = np.asarray([e[3] for e in run], dtype=np.uint64)
            if op == -1:
                engine.write_batch(streams, lbas, fps)
            elif run[0][7]:
                sub = np.zeros(len(run), dtype=TRACE_DTYPE)
                sub["stream"], sub["lba"], sub["fp"] = streams, lbas, fps
                sub["op"] = [e[4] for e in run]
                sub["ts"] = [e[5] for e in run]
                engine.replay(sub)
            else:
                rb = ReplayBatch(
                    streams,
                    lbas,
                    fps,
                    op=np.asarray([e[4] for e in run], dtype=np.int8),
                    ts=np.asarray([e[5] for e in run], dtype=np.int64),
                )
                engine_run_batch(engine, rb)
            i = j
        self.shards[s] = engine
        self._failed.discard(s)
        # re-derive this shard's content mirror from the authoritative
        # key->fp map (one copy per key whose fp lists s as a successor)
        rs = _ReplicaStore()
        r = self.effective_replication
        if r > 1 and self._rep_keys:
            fps_arr = np.fromiter(
                self._rep_keys.values(), dtype=np.uint64, count=len(self._rep_keys)
            )
            owners = self.ring.owners_of_many(fps_arr, r)
            for fp, row in zip(fps_arr.tolist(), owners[:, 1:].tolist()):
                if s in row:
                    rs.add_copy(fp)
        self._replicas[s] = rs
        # restore full redundancy with a fresh cluster-wide checkpoint —
        # unless other shards are still down (their recovery does it)
        if not self._failed and not self._poisoned:
            self.checkpoint()
        return {"replayed": len(log), "mirror_copies": rs.blocks}

    # -- elastic resharding --------------------------------------------------------
    @_locked
    def resize(
        self,
        new_num_shards: int,
        reconcile: bool = True,
        engine_factory: Optional[Callable[[int], object]] = None,
    ) -> Dict[str, object]:
        """Grow or shrink the cluster to ``new_num_shards`` shards in place.

        The migration protocol (ARCHITECTURE.md, "Elastic resharding"):

        1. **Quiesce** — flush every shard's pending duplicate runs and drop
           router-stale keys, so all LBA mappings are final.
        2. **Re-ring** — build the new ``ConsistentHashRing`` with the same
           vnodes/seed.  Consistent hashing's minimal-remap property means
           the only fingerprints whose owner changes are those grabbed by
           new shards (grow) or orphaned by removed shards (shrink).
        3. **Migrate** — for exactly those moved fingerprints, transplant the
           ground-truth seen-set membership, the fingerprint-cache entry
           (capacity permitting; stale entries are dropped, mirroring the
           TOCTOU miss rule) and every store structure (fingerprint-table
           rows, PBA metadata, LBA mappings, refcounts, watermarks) to the
           new owner, updating the routing directory so reads and overwrite
           invalidation follow the key.  PBAs are globally unique, so blocks
           move by reference without re-allocation.
        4. **Retire** (shrink) — fully-drained shards are finished and their
           reports parked in ``_retired_reports`` so aggregate counters
           survive the shards' removal.
        5. **Reconcile** — a migrated fingerprint can carry several PBAs
           (inline misses on the old shard); target shards run a shard-local
           post-processing pass to merge them (engines without a mid-stream
           ``run_postprocess`` reconcile at their next idle pass / finish).

        Returns migration stats, including the moved-key fraction the
        minimal-remap property bounds.
        """
        if new_num_shards < 1:
            raise ValueError(f"new_num_shards must be >= 1, got {new_num_shards}")
        if self.routing != "fingerprint":
            raise NotImplementedError(
                "resize() requires fingerprint routing; stream-affinity "
                "clusters would need whole-stream migration"
            )
        self._check_not_failed("resize")
        self._check_poisoned()
        if engine_factory is not None:
            self._engine_factory = engine_factory
            self._engine_kwargs = None
        # quiesce the workers, then drop the executor: its worker count is
        # tied to the (old) shard count.  Restarted after the migration so a
        # live serving front end keeps its parallel path across a resize.
        had_executor = self._executor is not None
        if had_executor:
            self.stop_executor()
        # validate every shard BEFORE any state moves: a failure mid-migration
        # would leave the cluster half-migrated under the old ring
        for s, engine in enumerate(self.shards):
            if _seen_set_of(engine) is None:
                raise TypeError(
                    f"shard {s} engine {type(engine).__name__} exposes no "
                    "ground-truth seen set; resize supports the built-in "
                    "engine types"
                )
        old_num = self.num_shards
        stats: Dict[str, object] = {
            "old_num_shards": old_num,
            "new_num_shards": new_num_shards,
            "moved_fps": 0,
            "moved_blocks": 0,
            "moved_cache_entries": 0,
            "key_population": 0,
            "moved_fraction": 0.0,
            "reconciled_shards": [],
        }
        if new_num_shards == old_num:
            if had_executor:
                self.start_executor()
            return stats

        # 1. quiesce: every mapping final before anything moves.  The
        # stale-key sweep is the cross-shard orphan detector — keys whose
        # newest write re-homed leave zero-refcount blocks on the old owner
        # — and the quiesce point is a full barrier (executor stopped above),
        # so their grace periods have drained: force-reclaim limbo before
        # migration walks the stores
        for engine in self.shards:
            engine_finish_replay(engine)
        self._invalidate_stale_keys()
        for engine in self.shards:
            engine.store.collect_limbo(force=True)

        # 2. re-ring (+ fresh engines for grown shard slots)
        new_ring = ConsistentHashRing(new_num_shards, vnodes=self._vnodes, seed=self._seed)
        for j in range(old_num, new_num_shards):
            self.shards.append(self._make_shard_engine(j))

        # 3. migrate moved fingerprints (seen-set membership is the key
        # population: it covers live *and* freed content, and future
        # ground-truth dup accounting needs both)
        targets_touched = set()
        for s in range(old_num):
            src = self.shards[s]
            fps = sorted(_seen_set_of(src) | set(src.store.fp_table))
            stats["key_population"] += len(fps)
            if not fps:
                continue
            owners = new_ring.shard_of_many(np.asarray(fps, dtype=np.uint64))
            src.store._ensure_reverse()
            src_targets = set()
            for fp, t in zip(fps, owners.tolist()):
                if t == s:
                    continue
                dst = self.shards[t]
                moved_blocks, moved_cache = _migrate_fp(src, dst, fp, self._directory, t)
                stats["moved_fps"] += 1
                stats["moved_blocks"] += moved_blocks
                stats["moved_cache_entries"] += moved_cache
                if moved_blocks:
                    src_targets.add(t)
            if src.store._ever_freed:
                # conservative: targets inheriting blocks from a freed-history
                # source keep the TOCTOU revalidation on (it only costs the
                # staged fast path, never correctness); sources that never
                # freed leave their targets' fast path intact
                for t in src_targets:
                    self.shards[t].store._ever_freed = True
            targets_touched |= src_targets
        for t in targets_touched:
            store = self.shards[t].store
            store.peak_blocks = max(store.peak_blocks, store.live_blocks)

        # single-shard fast path never populates the routing directory (and
        # any rows left from an earlier multi-shard era are stale): with one
        # shard, shard 0 owns every live key, so rewrite its rows before the
        # cluster starts consulting them again
        if old_num == 1:
            directory = self._directory
            for stream, lba in self.shards[0].store.lba_map:
                directory[(stream << _LBA_BITS) + lba] = 0

        # 4. retire drained shards on shrink.  A shard leaving with live
        # blocks means migration missed data — guard with a real exception
        # (asserts vanish under ``python -O``).  If it fires, the cluster is
        # already inconsistent (step 3 moved state per the new ring while
        # ``self.ring`` is still the old one): the exception signals an
        # unrecoverable internal invariant violation, not a clean abort.
        if new_num_shards < old_num:
            for s in range(new_num_shards, old_num):
                live = self.shards[s].store.live_blocks
                if live != 0:
                    raise RuntimeError(
                        f"retiring shard {s} would lose {live} live blocks "
                        "that migration failed to drain; the cluster is in "
                        "an inconsistent half-migrated state — discard it "
                        "and restore from the last snapshot"
                    )
            retired, self.shards = self.shards[new_num_shards:], self.shards[:new_num_shards]
            for engine in retired:
                self._retired_reports.append(engine.finish())
            # scrub directory rows that still point at retired shard ids:
            # migration rewrote the rows of every *live* key, but rows for
            # keys deleted via the raw store (never re-written) would dangle
            self._directory = {
                k: v for k, v in self._directory.items() if v < new_num_shards
            }

        self.ring = new_ring
        self.num_shards = new_num_shards
        if stats["key_population"]:
            stats["moved_fraction"] = stats["moved_fps"] / stats["key_population"]

        # 5. reconcile duplicates that crossed shard boundaries
        if reconcile:
            for t in sorted(targets_touched):
                engine = self.shards[t]
                if hasattr(engine, "run_postprocess"):
                    engine.run_postprocess()
                    stats["reconciled_shards"].append(t)
        # replication overlay follows the new topology wholesale: mirrors
        # re-placed on the new ring, oplogs truncated, fresh checkpoints of
        # the post-reconcile engines (recovery must not replay reconcile)
        self._resync_replication()
        self._warn_if_clamped()
        if had_executor:
            self.start_executor()  # fresh workers sized to the new ring
        return stats

    # -- snapshot/restore ----------------------------------------------------------
    @_locked
    def snapshot(self) -> dict:
        """Cluster state tree: per-shard engine trees (each in its own
        versioned envelope), the routing directory, the reports of retired
        shards, and the replication overlay (when R > 1).  The ring is a
        pure function of (num_shards, vnodes, seed) and is rebuilt on
        restore.  Serialization holds the coordinator lock and barriers the
        workers first, so a snapshot is always a consistent barrier state —
        never a mid-mutation view (and never while a shard is failed: a
        dead engine has no tree; recover first)."""
        from .snapshot import report_to_tree, snapshot_engine

        self._check_not_failed("snapshot")
        self._sync()  # snapshots are barrier states: no in-flight sub-batches
        return {
            "config": {
                "num_shards": self.num_shards,
                "routing": self.routing,
                "vnodes": self._vnodes,
                "seed": self._seed,
                "pba_stride": self._pba_stride,
                "next_namespace": self._next_namespace,
                "engine_kwargs": self._engine_kwargs,
            },
            "shards": [snapshot_engine(engine) for engine in self.shards],
            "directory": pairs(self._directory),
            "retired": [report_to_tree(r) for r in self._retired_reports],
            "replication": self._replication_tree(),
        }

    @_locked
    def load_snapshot(self, tree: dict) -> None:
        """Load a snapshot into this cluster *in place* (shard engines keep
        their identity, so wired-up hooks like ``BlockStore.on_free``
        survive).  Shard count and engine kinds must match; use
        ``ShardedCluster.restore`` for a from-scratch rebuild.  Poisoned
        lanes are healed here — reloading a known-good snapshot is the
        documented alternative to ``fail_shard``/``recover_shard``."""
        from .snapshot import check_engine_compatible, report_from_tree

        ex = self._executor
        if ex is not None:
            try:
                ex.barrier()
                self._workers_dirty = False
            except ShardWorkerError:
                # the wedged executor would poison every later submission:
                # replace it (stop_executor absorbs the sticky fault)
                self._poisoned.update(ex.failed_shards())
                self.stop_executor()
                self.start_executor()
        config = tree["config"]
        if config["num_shards"] != self.num_shards:
            raise ValueError(
                f"snapshot has {config['num_shards']} shards but this cluster "
                f"has {self.num_shards}; restore with ShardedCluster.restore"
            )
        if len(tree["shards"]) != self.num_shards:
            raise ValueError(
                f"snapshot is corrupt: config says {self.num_shards} shards "
                f"but carries {len(tree['shards'])} shard trees"
            )
        if (
            config["routing"],
            config["vnodes"],
            config["seed"],
            config["pba_stride"],
        ) != (self.routing, self._vnodes, self._seed, self._pba_stride):
            raise ValueError(
                "snapshot ring/namespace parameters (routing, vnodes, seed, "
                "pba_stride) differ from this cluster's"
            )
        # validate every shard tree BEFORE any shard mutates (same rule as
        # resize's pre-checks): a kind/config mismatch on shard k would
        # otherwise leave shards 0..k-1 on snapshot state and the rest live
        for engine, engine_tree in zip(self.shards, tree["shards"]):
            check_engine_compatible(engine, engine_tree)
        for engine, engine_tree in zip(self.shards, tree["shards"]):
            engine.load_snapshot(engine_tree["state"])
        self._next_namespace = int(config["next_namespace"])
        self._directory = from_pairs(tree["directory"], value=int)
        self._retired_reports = [report_from_tree(r) for r in tree["retired"]]
        self.shard_reports = None
        self._gc_deferred = any(e.store.deferred_reclaim for e in self.shards)
        self._load_replication(tree.get("replication"))
        self._poisoned.clear()  # every shard's state was just re-established

    @classmethod
    def restore(cls, tree: dict, *, device="cuda") -> "ShardedCluster":
        from .snapshot import report_from_tree, restore_engine

        config = tree["config"]
        if len(tree["shards"]) != config["num_shards"]:
            raise ValueError(
                f"snapshot is corrupt: config says {config['num_shards']} "
                f"shards but carries {len(tree['shards'])} shard trees"
            )
        # shard engines come from their own snapshot trees (PBA namespaces
        # baked in), so bypass the ctor's shard construction entirely
        cluster = cls.__new__(cls)
        cluster.device = device
        cluster.num_shards = config["num_shards"]
        cluster.routing = config["routing"]
        cluster._vnodes = config["vnodes"]
        cluster._seed = config["seed"]
        cluster._pba_stride = config["pba_stride"]
        cluster._next_namespace = int(config["next_namespace"])
        if config["engine_kwargs"] is not None:
            engine_kwargs, seed = dict(config["engine_kwargs"]), config["seed"]
            cluster._engine_kwargs = engine_kwargs
            cluster._engine_factory = lambda shard: HPDedup(
                seed=seed + shard, device=device, **engine_kwargs
            )
        else:
            # custom-factory cluster: only a later grow needs the factory
            # again (resize() accepts one)
            cluster._engine_kwargs = None
            cluster._engine_factory = None
        cluster.ring = ConsistentHashRing(
            cluster.num_shards, vnodes=cluster._vnodes, seed=cluster._seed
        )
        cluster.shards = [restore_engine(t, device=device) for t in tree["shards"]]
        cluster._directory = from_pairs(tree["directory"], value=int)
        cluster._retired_reports = [report_from_tree(r) for r in tree["retired"]]
        cluster.shard_reports = None
        cluster._executor = None  # executors are process-local, never restored
        cluster._workers_dirty = False
        cluster.min_parallel_batch = 2048
        # a snapshot taken mid-GC carries per-store deferred flags; shards
        # grown later must inherit the cluster-wide arming decision
        cluster._gc_deferred = any(e.store.deferred_reclaim for e in cluster.shards)
        cluster._lock = threading.RLock()
        cluster._poisoned = {}
        cluster._load_replication(tree.get("replication"))
        return cluster


def _seen_set_of(engine) -> Optional[set]:
    """The engine's ground-truth seen-fingerprint set (None if unknown).

    For the built-in engines this is a ``FingerprintIndex`` (a ``set``
    subclass), so membership transplants during resharding keep its
    device-layout table coherent through the overridden mutators."""
    for attr in ("_seen_fps", "_seen"):
        seen = getattr(engine, attr, None)
        if isinstance(seen, set):
            return seen
    return None


def _probe_seen(engine, keys: np.ndarray) -> np.ndarray:
    """Batched seen-membership for one shard: the built-in engines expose a
    ``FingerprintIndex`` (one vectorized launch); a custom engine with a
    plain set falls back to host probes."""
    seen = _seen_set_of(engine)
    if seen is None:
        raise TypeError(
            f"engine {type(engine).__name__} exposes no seen-fingerprint "
            "index; cluster-wide probes support the built-in engine types"
        )
    probe = getattr(seen, "contains_many", None)
    if probe is not None:
        return probe(keys)
    return np.fromiter(map(seen.__contains__, keys.tolist()), dtype=bool, count=keys.size)


def _cache_of(engine):
    """The engine's fingerprint cache frontend (None for PurePostProcessing)."""
    inline = getattr(engine, "inline", None)
    if inline is not None:
        return inline.cache
    return getattr(engine, "cache", None)


def _migrate_fp(src, dst, fp: int, directory: Dict[int, int], t: int):
    """Move one fingerprint's whole footprint from shard ``src`` to ``dst``.

    Caller must have quiesced both engines (no pending runs, no staged
    writes) and ensured ``src.store``'s reverse index is fresh.  Returns
    ``(blocks_moved, cache_entries_moved)``.
    """
    src_store, dst_store = src.store, dst.store

    # ground-truth seen membership follows the fingerprint's new owner
    src_seen, dst_seen = _seen_set_of(src), _seen_set_of(dst)
    if src_seen is not None and fp in src_seen:
        src_seen.discard(fp)
        if dst_seen is not None:
            dst_seen.add(fp)

    # cache entry: validate against the (still-source-resident) store first —
    # a stale pair (PBA freed or re-fingerprinted) is dropped, exactly like
    # the inline TOCTOU rule treats stale hits as misses
    moved_cache = 0
    src_cache, dst_cache = _cache_of(src), _cache_of(dst)
    if src_cache is not None and hasattr(src_cache, "evict_fp"):
        owner_stream = getattr(src_cache, "owner", {}).get(fp, 0)
        pba = src_cache.evict_fp(fp)
        if (
            pba is not None
            and dst_cache is not None
            and src_store.fp_of_pba.get(pba) == fp
            and dst_cache.migrate_in(owner_stream, fp, pba)
        ):
            moved_cache = 1

    pbas = src_store.extract_fp(fp)
    if not pbas:
        return 0, moved_cache
    for pba in pbas:
        keys = src_store.lbas_of_pba.pop(pba, set())
        dst_store.fp_of_pba[pba] = fp
        dst_store.refcount[pba] = src_store.refcount.pop(pba)
        del src_store.fp_of_pba[pba]
        src_store.live_blocks -= 1
        dst_store.live_blocks += 1
        src_store.buffer.invalidate(pba)
        for key in keys:
            del src_store.lba_map[key]
            dst_store.lba_map[key] = pba
            directory[(key[0] << _LBA_BITS) + key[1]] = t
            if key[1] >= dst_store._lba_watermark.get(key[0], 0):
                dst_store._lba_watermark[key[0]] = key[1] + 1
        if not dst_store._reverse_dirty:
            dst_store.lbas_of_pba[pba] = set(keys)
    # absorb keeps the destination's fingerprint index and duplicate-
    # candidate set coherent (a migrated fp landing on a shard that already
    # holds it is exactly the cross-shard duplicate reconcile later merges)
    dst_store.absorb_fp(fp, pbas)
    return len(pbas), moved_cache
