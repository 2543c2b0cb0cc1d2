"""Multi-tenant training-data ingest pipeline with HPDedup inline dedup.

The training-cluster analogue of the paper's primary-storage write path:
token streams from multiple tenants (the paper's VMs) are framed into
fixed-size token blocks, fingerprinted in batches (the fingerprint kernel
on the card, ``kernels.ops.fingerprint_ints``), and passed through the
hybrid dedup engine.  Blocks that survive dedup are admitted to the sample
store and assembled into global batches; the post-processing phase runs
between steps (idle time) and removes inline misses before blocks are
re-served.

Everything is checkpointable: tenant cursors, reservoir/estimator state and
the fingerprint cache survive restarts, so restarted runs neither re-train
on deduped blocks nor double-admit (exactly-once sample accounting).

The counterpart of ``repro.data.pipeline`` with the same names, arguments
and state trees, plus ``device`` (default ``"cuda"``, which raises without
a card): where the blocks are hashed and where the engine's fingerprint
indexes and LDSS solver live.  It is not part of any state tree.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import HPDedup, ShardedCluster, load_engine_state, snapshot_engine
from ..kernels.ops import fingerprint_ints


@dataclasses.dataclass
class TenantSpec:
    """A synthetic tenant stream: token blocks with controllable duplication.

    ``dup_ratio``: probability a generated block repeats earlier content of
    this tenant; ``overlap_group``: tenants sharing a group also share a
    content pool (cross-tenant duplicates, the paper's 0-40% user overlap);
    ``locality``: "good" duplicates recent blocks, "weak" duplicates uniform
    history.
    """

    tenant_id: int
    rate: float = 1.0
    dup_ratio: float = 0.3
    locality: str = "good"
    overlap_group: Optional[str] = None
    overlap_prob: float = 0.2


class TenantStream:
    """One tenant's token blocks, drawn from a numpy generator: the same
    seed gives the reference's blocks, bit for bit."""

    def __init__(self, spec: TenantSpec, block_tokens: int, vocab: int, seed: int,
                 shared_pools: Dict[str, List[np.ndarray]], token_probs: Optional[np.ndarray] = None):
        self.spec = spec
        self.block_tokens = block_tokens
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.history: List[np.ndarray] = []
        self.shared_pools = shared_pools
        self.token_probs = token_probs  # skewed unigram dist -> learnable data
        # ``rng.choice(vocab, size, p=token_probs)`` looks ``rng.random(size)``
        # up in p's normalised cumulative sum; the sum is taken once here
        # instead of once a block (the same draws and the same tokens)
        self._token_cdf = None
        if token_probs is not None:
            self._token_cdf = np.asarray(token_probs, dtype=np.float64).cumsum()
            self._token_cdf /= self._token_cdf[-1]
        self.emitted = 0

    def next_block(self) -> np.ndarray:
        s = self.spec
        pool = self.shared_pools.setdefault(s.overlap_group, []) if s.overlap_group else None
        if self.history and self.rng.random() < s.dup_ratio:
            if s.locality == "good":
                back = min(len(self.history), 1 + int(self.rng.geometric(1.0 / 32)))
            else:
                back = int(self.rng.integers(1, len(self.history) + 1))
            block = self.history[-back]
        elif pool is not None and pool and self.rng.random() < s.overlap_prob:
            block = pool[int(self.rng.integers(0, len(pool)))]
        else:
            if self._token_cdf is not None:
                u = self.rng.random(self.block_tokens)
                block = self._token_cdf.searchsorted(u, side="right").astype(np.int32)
            else:
                block = self.rng.integers(0, self.vocab, size=self.block_tokens, dtype=np.int32)
            if pool is not None and len(pool) < 4096:
                pool.append(block)
        self.history.append(block)
        if len(self.history) > 65536:
            self.history.pop(0)
        self.emitted += 1
        return block

    def state_dict(self) -> dict:
        # full history: restores must regenerate the *exact* content stream
        # (exactly-once sample accounting).  The history is bounded at 65536
        # blocks; production would store content-addressed references.
        return {"emitted": self.emitted, "rng": self.rng.bit_generator.state,
                "history": [h.tolist() for h in self.history]}

    def load_state(self, st: dict) -> None:
        self.emitted = st["emitted"]
        self.rng.bit_generator.state = st["rng"]
        self.history = [np.asarray(h, dtype=np.int32) for h in st["history"]]


@dataclasses.dataclass
class PipelineMetrics:
    blocks_in: int = 0
    blocks_deduped_inline: int = 0
    blocks_admitted: int = 0
    post_removed: int = 0

    @property
    def dedup_saving(self) -> float:
        return self.blocks_deduped_inline / self.blocks_in if self.blocks_in else 0.0


class DedupIngestPipeline:
    """Ingest -> fingerprint (card, batched) -> HPDedup -> batch assembly.

    ``num_shards > 1`` swaps the single engine for a ``ShardedCluster``
    (consistent-hash fingerprint partitioning) behind the same ``Engine``
    protocol — the ingest path is unchanged because it only ever calls
    ``write_batch``.
    """

    def __init__(
        self,
        tenants: Sequence[TenantSpec],
        block_tokens: int = 256,
        vocab: int = 32000,
        cache_entries: int = 8192,
        fingerprint_batch: int = 64,
        postprocess_every_blocks: int = 4096,
        token_skew: float = 1.2,
        num_shards: int = 1,
        parallel_shards: bool = False,
        snapshot_every_blocks: int = 0,
        seed: int = 0,
        *,
        device="cuda",
    ):
        """``snapshot_every_blocks``: if > 0, refresh ``last_snapshot`` (a
        full, JSON-serializable pipeline state tree) every that many ingested
        blocks, so a crashed ingest run resumes from the last snapshot with
        bit-identical batches.  ``device``: where blocks are fingerprinted
        and the engine's indexes live (the card by default)."""
        self.device = device
        self.block_tokens = block_tokens
        self.vocab = vocab
        self.fingerprint_batch = fingerprint_batch
        self._pools: Dict[str, List[np.ndarray]] = {}
        if token_skew > 0:
            probs = 1.0 / np.arange(1, vocab + 1) ** token_skew
            probs /= probs.sum()
        else:
            probs = None
        self.streams = {
            t.tenant_id: TenantStream(t, block_tokens, vocab, seed + 101 * t.tenant_id, self._pools, probs)
            for t in tenants
        }
        self.rates = np.array([t.rate for t in tenants], dtype=np.float64)
        self.rates /= self.rates.sum()
        self.tenant_ids = [t.tenant_id for t in tenants]
        if num_shards > 1:
            # cluster-backed ingest: fingerprint-partitioned shards, each
            # with a slice of the cache budget and its own shard-local
            # idle-time post-processing window
            self.engine = ShardedCluster(
                num_shards=num_shards,
                cache_entries=max(1, cache_entries // num_shards),
                policy="lru",
                use_jax_estimator=True,
                postprocess_period=postprocess_every_blocks,
                seed=seed,
                device=device,
            )
            if parallel_shards:
                # shard worker threads: each write_batch scatters to the
                # shards concurrently (barrier-and-merge keeps the flags
                # and all snapshots bit-exact with the serial path)
                self.engine.start_executor()
        else:
            self.engine = HPDedup(
                cache_entries=cache_entries,
                policy="lru",
                use_jax_estimator=True,
                postprocess_period=postprocess_every_blocks,
                seed=seed,
                device=device,
            )
        self.rng = np.random.default_rng(seed + 7)
        self.metrics = PipelineMetrics()
        # block store: fingerprint -> token block (the "disk")
        self.block_content: Dict[int, np.ndarray] = {}
        self._lba: Dict[int, int] = {}  # per-tenant next logical block address
        self._fifo = np.zeros(0, dtype=np.int32)  # admitted tokens awaiting batching
        # periodic crash-recovery snapshots (see ctor docstring)
        self.snapshot_every_blocks = snapshot_every_blocks
        self.last_snapshot: Optional[dict] = None
        self._blocks_at_snapshot = 0

    # -- ingest ----------------------------------------------------------------
    def _ingest_chunk(self) -> List[Tuple[int, np.ndarray, int]]:
        """Pull a batch of blocks, fingerprint them in one kernel launch."""
        picks = self.rng.choice(len(self.tenant_ids), size=self.fingerprint_batch, p=self.rates)
        blocks, tenants = [], []
        for p in picks:
            tid = self.tenant_ids[int(p)]
            blocks.append(self.streams[tid].next_block())
            tenants.append(tid)
        fps = fingerprint_ints(np.stack(blocks), device=self.device)
        return [(tenants[i], blocks[i], int(fps[i])) for i in range(len(blocks))]

    def _refill(self) -> None:
        """Ingest one fingerprint batch; admitted tokens join the flat FIFO.

        The whole chunk flows through the engine's columnar ``write_batch``
        (Engine protocol) — one batched cache/estimator pre-pass instead of
        one Python call chain per block.
        """
        chunk = self._ingest_chunk()
        tenants = np.empty(len(chunk), dtype=np.int64)
        lbas = np.empty(len(chunk), dtype=np.int64)
        fps = np.empty(len(chunk), dtype=np.uint64)
        for i, (tid, _, fp) in enumerate(chunk):
            tenants[i] = tid
            lba = self._lba.get(tid, 0)
            self._lba[tid] = lba + 1
            lbas[i] = lba
            fps[i] = fp
        flags = self.engine.write_batch(tenants, lbas, fps)
        self.metrics.blocks_in += len(chunk)
        admitted_blocks = []
        for (tid, block, fp), deduped in zip(chunk, flags.tolist()):
            if deduped:
                self.metrics.blocks_deduped_inline += 1
                continue
            if fp not in self.block_content:
                self.block_content[fp] = block
            self.metrics.blocks_admitted += 1
            admitted_blocks.append(block)
        if admitted_blocks:
            self._fifo = np.concatenate([self._fifo, *admitted_blocks])
        if (
            self.snapshot_every_blocks
            and self.metrics.blocks_in - self._blocks_at_snapshot >= self.snapshot_every_blocks
        ):
            self.last_snapshot = self.state_dict()
            self._blocks_at_snapshot = self.metrics.blocks_in

    def next_batch(self, batch_size: int, seq_len: int) -> Dict[str, np.ndarray]:
        need = batch_size * (seq_len + 1)
        while self._fifo.size < need:
            self._refill()
        arr = self._fifo[:need].reshape(batch_size, seq_len + 1)
        self._fifo = self._fifo[need:]
        return {
            "inputs": arr[:, :-1].astype(np.int32),
            "targets": arr[:, 1:].astype(np.int32),
            "mask": np.ones((batch_size, seq_len), dtype=np.float32),
        }

    def batches(self, batch_size: int, seq_len: int) -> Iterator[Dict[str, np.ndarray]]:
        """Global batches of (inputs, targets, mask) from deduped blocks,
        without end.  Unlike the reference's generator, which an exception in
        ``next_batch`` (a failed fingerprint launch) ends for good, the
        iterator calls ``next_batch`` again on the next ``next``, so a
        trainer can retry or restore after such a failure."""
        return iter(functools.partial(self.next_batch, batch_size, seq_len), None)

    # -- checkpointable state ------------------------------------------------------
    def _estimators(self) -> List:
        """Per-shard LDSS estimators (a single-engine pipeline has one)."""
        engines = self.engine.shards if isinstance(self.engine, ShardedCluster) else [self.engine]
        return [e.inline.estimator for e in engines]

    def state_dict(self) -> dict:
        return {
            "fifo": self._fifo.tolist(),
            "lba": dict(self._lba),
            "rng": self.rng.bit_generator.state,
            "streams": {tid: s.state_dict() for tid, s in self.streams.items()},
            # full engine state tree: caches, LDSS estimators + reservoir
            # RNGs, spatial thresholds, block store(s) and pending runs —
            # a restored pipeline's dedup decisions are bit-identical
            "engine": snapshot_engine(self.engine),
            # estimator-only view kept for pre-snapshot checkpoint readers
            "estimator": [est.state_dict() if est else None for est in self._estimators()],
            "metrics": dataclasses.asdict(self.metrics),
            # the overlap groups' shared content pools: without them a
            # restored tenant of a group draws from an empty pool, and its
            # stream leaves the uninterrupted run's (the reference's tree
            # lacks this key; ``load_state`` still reads such trees)
            "pools": {g: [b.tolist() for b in pool] for g, pool in self._pools.items()},
        }

    def load_state(self, st: dict) -> None:
        self._fifo = np.asarray(st["fifo"], dtype=np.int32)
        self._lba = {int(k): v for k, v in st["lba"].items()}
        self.rng.bit_generator.state = st["rng"]
        for tid, s in st["streams"].items():
            self.streams[int(tid)].load_state(s)
        if "pools" in st:
            self._pools.clear()  # in place: every stream holds this dict
            for g, pool in st["pools"].items():
                self._pools[g] = [np.asarray(b, dtype=np.int32) for b in pool]
        if "engine" in st:
            load_engine_state(self.engine, st["engine"])
        else:
            # legacy checkpoint: only estimator state was persisted
            est_states = st["estimator"]
            if isinstance(est_states, dict) or est_states is None:
                est_states = [est_states]  # legacy single-engine checkpoints
            estimators = self._estimators()
            if len(est_states) != len(estimators):
                raise ValueError(
                    f"checkpoint has {len(est_states)} shard estimator state(s) but this "
                    f"pipeline has {len(estimators)} — restore with the same num_shards"
                )
            for est, est_st in zip(estimators, est_states):
                if est is not None and est_st:
                    est.load_state(est_st)
        self.metrics = PipelineMetrics(**st["metrics"])
