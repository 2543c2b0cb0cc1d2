"""Async multi-tenant serving front end with measured p50/p99 QoS.

The paper's core mechanism — per-stream temporal-locality estimation driving
prioritized cache allocation (§III-C) — is a multi-tenant QoS policy, and
this module is where it finally meets real concurrent traffic: hundreds of
client streams are multiplexed over one dedup ``Engine`` (a single
``HPDedup``, a ``ShardedCluster``, or the engine inside a ``DedupKVServer``)
by an asyncio front end that

* **closes columnar batches by size or age** — writes buffer until either
  ``max_batch`` records are waiting or the oldest has waited ``max_delay``
  seconds, then the whole batch flows through the engine's columnar
  ``write_batch`` on a dedicated executor thread (batches execute strictly
  in closing order, so the engine sees one deterministic interleaving);
* **keeps per-tenant estimator state** — tenants are the engine's streams,
  so the LDSS estimator, the prioritized cache and the spatial thresholds
  all see exactly the per-tenant structure the paper describes; the front
  end adds per-tenant latency/QoS accounting on top;
* **applies cache-contention admission control** — while the inline
  fingerprint cache is contended (occupancy >= ``contention_ratio``), each
  tenant's in-flight budget is proportional to its share of the predicted
  LDSS mass: low-locality tenants queue at the door instead of polluting
  the batch pipeline (the front-end analogue of the cache's own
  prioritized admission), with a floor so nobody starves;
* **exerts backpressure** — a global ``max_pending`` bound on buffered +
  in-flight writes; producers ``await`` when the pipeline is full;
* **supports live ``resize()`` and ``run_gc()`` under traffic** — the
  cluster's elastic-resharding protocol and online GC run on the engine
  executor thread, serialized behind the batches already queued, while new
  writes keep buffering.

Determinism contract: the executed interleaving (the concatenation of
batches in execution order) replayed through a fresh identically-configured
engine yields a bit-exact ``HybridReport`` (``executed_trace``).

The counterpart of ``repro.serving.frontend``, with its logic as it is: the
front end is host code (the standard library and numpy) over any engine of
``repro_torch.core``, whose fingerprint indexes may lie on the card.  Only
the engine thread touches the engine's tensors; the admission caps read
host-side counters (``cache.total``, ``estimator.predicted``) and never a
tensor.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TenantQoS:
    """Per-tenant serving statistics (latencies in seconds)."""

    submitted: int = 0
    completed: int = 0
    deduped: int = 0
    throttled: int = 0  # writes that waited on the admission cap
    latencies: List[float] = dataclasses.field(default_factory=list)

    def percentile_ms(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies), q) * 1e3)


class AsyncDedupFrontend:
    """Asyncio multiplexer: many client streams -> columnar engine batches."""

    def __init__(
        self,
        engine,
        max_batch: int = 1024,
        max_delay: float = 0.002,
        max_pending: int = 16384,
        admission_control: bool = True,
        admission_budget: Optional[int] = None,
        contention_ratio: float = 0.95,
        min_tenant_share: float = 1 / 64,
        record_trace: bool = False,
        parallel_shards: bool = True,
    ):
        # a DedupKVServer multiplexes through its embedded dedup engine
        if hasattr(engine, "dedup") and hasattr(engine.dedup, "write_batch"):
            engine = engine.dedup
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay)
        self.max_pending = int(max_pending)
        self.admission_control = admission_control
        # total in-flight writes the contended-cache admission policy divides
        # among tenants; size it near the expected client concurrency so the
        # per-tenant caps actually bind (default: the backpressure bound)
        self.admission_budget = int(admission_budget) if admission_budget else self.max_pending
        self.contention_ratio = float(contention_ratio)
        self.min_tenant_share = float(min_tenant_share)
        self.record_trace = record_trace
        self._owns_cluster_executor = False
        if (
            parallel_shards
            and hasattr(engine, "start_executor")
            and getattr(engine, "num_shards", 1) > 1
        ):
            engine.start_executor()
            self._owns_cluster_executor = True
        # engine thread: every engine touch (batches, resize) runs here, one
        # at a time, in submission order — the determinism backbone
        self._engine_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="dedup-engine")
        self._buf_tenants: List[int] = []
        self._buf_lbas: List[int] = []
        self._buf_fps: List[int] = []
        self._buf_futs: List[asyncio.Future] = []
        self._buf_t0: List[float] = []
        self._timer: Optional[asyncio.TimerHandle] = None
        self._sem = asyncio.Semaphore(self.max_pending)
        self._drained = asyncio.Event()  # pulsed after every batch completes
        self._inflight: Dict[int, int] = {}
        self._next_lba: Dict[int, int] = {}
        self.tenants: Dict[int, TenantQoS] = {}
        self.batches_executed = 0
        self.records_executed = 0
        self._executed: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._cap_memo: Optional[Tuple[Dict[int, int], int]] = None
        self._closed = False
        self._inflight_batches = 0

    # -- QoS plumbing ----------------------------------------------------------
    def _qos(self, tenant: int) -> TenantQoS:
        q = self.tenants.get(tenant)
        if q is None:
            q = self.tenants[tenant] = TenantQoS()
        return q

    def _engines(self) -> List:
        shards = getattr(self.engine, "shards", None)
        return list(shards) if shards is not None else [self.engine]

    def _cache_fill(self) -> float:
        """Aggregate inline fingerprint-cache occupancy across shards."""
        total = cap = 0
        for e in self._engines():
            cache = getattr(getattr(e, "inline", None), "cache", None)
            if cache is None:
                continue
            cap += cache.capacity
            occ = getattr(cache, "total", None)
            if occ is None:  # GlobalCache keeps a plain dict
                occ = len(getattr(cache, "cache", ()))
            total += occ
        return total / cap if cap else 0.0

    def _predicted_ldss(self) -> Dict[int, float]:
        """Predicted per-tenant LDSS merged across shard estimators."""
        merged: Dict[int, float] = {}
        for e in self._engines():
            est = getattr(getattr(e, "inline", None), "estimator", None)
            if est is None:
                continue
            for s, v in est.predicted.items():
                if v is not None:
                    merged[s] = merged.get(s, 0.0) + max(float(v), 0.0)
        return merged

    def _tenant_cap(self, tenant: int) -> int:
        """In-flight budget for ``tenant``.

        Uncontended cache -> effectively unlimited (the global backpressure
        bound still applies).  Contended -> proportional to the tenant's
        share of predicted LDSS mass, floored at ``min_tenant_share`` so
        low-locality tenants are throttled, never starved."""
        if not self.admission_control:
            return self.max_pending
        memo = self._cap_memo
        if memo is None:
            caps: Dict[int, int] = {}
            default = self.max_pending
            if self._cache_fill() >= self.contention_ratio:
                pred = self._predicted_ldss()
                mass = sum(pred.values())
                if mass > 0.0:
                    for s, v in pred.items():
                        share = max(v / mass, self.min_tenant_share)
                        caps[s] = max(1, int(self.admission_budget * share))
                    # tenants the estimator hasn't ranked yet get the floor
                    # share while the cache is contended
                    default = max(1, int(self.admission_budget * self.min_tenant_share))
            memo = self._cap_memo = (caps, default)
        caps, default = memo
        return caps.get(tenant, default)

    # -- batching core ---------------------------------------------------------
    def _schedule_flush(self) -> None:
        loop = asyncio.get_running_loop()
        if len(self._buf_futs) >= self.max_batch:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._flush()
        elif self._timer is None:
            self._timer = loop.call_later(self.max_delay, self._on_timer)

    def _on_timer(self) -> None:
        self._timer = None
        self._flush()

    def _flush(self) -> None:
        """Close the open batch and hand it to the engine thread."""
        if not self._buf_futs:
            return
        tenants = np.asarray(self._buf_tenants, dtype=np.int64)
        lbas = np.asarray(self._buf_lbas, dtype=np.int64)
        fps = np.asarray(self._buf_fps, dtype=np.uint64)
        futs = self._buf_futs
        t0s = self._buf_t0
        self._buf_tenants, self._buf_lbas, self._buf_fps = [], [], []
        self._buf_futs, self._buf_t0 = [], []
        loop = asyncio.get_running_loop()
        self._inflight_batches += 1
        job = loop.run_in_executor(self._engine_pool, self._execute_batch, tenants, lbas, fps)
        job.add_done_callback(lambda f, futs=futs, t0s=t0s, tenants=tenants: (
            self._on_batch_done(f, futs, t0s, tenants)
        ))

    def _execute_batch(self, tenants: np.ndarray, lbas: np.ndarray, fps: np.ndarray):
        """Engine-thread body: one columnar write_batch (shards may fan out
        onto the cluster's own worker threads underneath)."""
        if self.record_trace:
            self._executed.append((tenants, lbas, fps))
        return self.engine.write_batch(tenants, lbas, fps)

    def _on_batch_done(self, job, futs, t0s, tenants) -> None:
        now = time.perf_counter()
        self.batches_executed += 1
        self.records_executed += len(futs)
        self._inflight_batches -= 1
        self._cap_memo = None  # estimator/cache state moved: recompute caps
        err = job.exception()
        flags = None if err is not None else job.result()
        for i, fut in enumerate(futs):
            tenant = int(tenants[i])
            self._inflight[tenant] -= 1
            self._sem.release()
            q = self._qos(tenant)
            if err is not None:
                if not fut.done():
                    fut.set_exception(err)
                continue
            q.completed += 1
            deduped = bool(flags[i])
            q.deduped += int(deduped)
            q.latencies.append(now - t0s[i])
            if not fut.done():
                fut.set_result(deduped)
        # wake admission-cap waiters so they re-check their budget
        self._drained.set()
        self._drained.clear()

    # -- client surface --------------------------------------------------------
    async def write(self, tenant: int, fp: int, lba: Optional[int] = None) -> bool:
        """Submit one write for ``tenant``; resolves to the inline-dedup flag.

        ``lba`` defaults to the tenant's next sequential logical block (the
        common log-append shape); pass it explicitly for overwrite traffic."""
        if self._closed:
            raise RuntimeError("frontend is closed")
        q = self._qos(tenant)
        q.submitted += 1
        t0 = time.perf_counter()
        inflight = self._inflight
        if self.admission_control and inflight.get(tenant, 0) >= self._tenant_cap(tenant):
            q.throttled += 1
            while inflight.get(tenant, 0) >= self._tenant_cap(tenant):
                await self._drained.wait()
        await self._sem.acquire()  # global backpressure
        inflight[tenant] = inflight.get(tenant, 0) + 1
        if lba is None:
            lba = self._next_lba.get(tenant, 0)
            self._next_lba[tenant] = lba + 1
        fut = asyncio.get_running_loop().create_future()
        self._buf_tenants.append(int(tenant))
        self._buf_lbas.append(int(lba))
        self._buf_fps.append(int(fp))
        self._buf_futs.append(fut)
        self._buf_t0.append(t0)
        self._schedule_flush()
        return await fut

    async def drain(self) -> None:
        """Flush the open batch and wait for every queued batch to complete."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._flush()
        while self._inflight_batches > 0 or self._buf_futs:
            await self._drained.wait()
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._flush()

    async def resize(self, new_num_shards: int, **kw) -> dict:
        """Elastic resharding under live traffic.

        The resize job is queued on the engine thread *behind* every batch
        already closed, and new writes keep buffering while it runs — the
        quiesce/migrate/reconcile protocol itself is ``ShardedCluster.resize``
        (which restarts the cluster's shard workers at the new count)."""
        if not hasattr(self.engine, "resize"):
            raise TypeError(f"{type(self.engine).__name__} does not support resize")
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._flush()  # everything buffered so far lands before the resize
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._engine_pool, lambda: self.engine.resize(new_num_shards, **kw)
        )

    async def run_gc(self, max_moves_per_shard: Optional[int] = None) -> Optional[dict]:
        """One online-GC step behind live traffic.

        Queued on the engine thread *behind* the batches already closed —
        exactly like ``resize`` — but without flushing the open buffer or
        quiescing anything: writes keep buffering, and batches closed after
        this call land behind the GC step.  Requires an engine exposing
        ``run_gc`` (``ShardedCluster`` or a bare ``HPDedup``)."""
        if not hasattr(self.engine, "run_gc"):
            raise TypeError(f"{type(self.engine).__name__} does not support run_gc")
        loop = asyncio.get_running_loop()
        if hasattr(self.engine, "shards"):  # cluster API
            fn = lambda: self.engine.run_gc(max_moves_per_shard=max_moves_per_shard)
        else:
            fn = lambda: self.engine.run_gc(max_moves=max_moves_per_shard)
        return await loop.run_in_executor(self._engine_pool, fn)

    async def close(self) -> None:
        """Drain, stop the engine thread (and the cluster executor we own)."""
        if self._closed:
            return
        await self.drain()
        self._closed = True
        self._engine_pool.shutdown(wait=True)
        if self._owns_cluster_executor:
            self.engine.stop_executor()

    # -- reporting -------------------------------------------------------------
    def executed_trace(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The exact interleaving the engine executed (requires
        ``record_trace=True``): concatenated (tenants, lbas, fps) columns in
        batch execution order — the differential oracle's input."""
        if not self.record_trace:
            raise RuntimeError("construct with record_trace=True to capture the interleaving")
        if not self._executed:
            e = np.zeros(0, dtype=np.int64)
            return e, e.copy(), np.zeros(0, dtype=np.uint64)
        return (
            np.concatenate([t for t, _, _ in self._executed]),
            np.concatenate([l for _, l, _ in self._executed]),
            np.concatenate([f for _, _, f in self._executed]),
        )

    def stats(self) -> dict:
        """Aggregate + per-tenant QoS view (latencies in milliseconds)."""
        all_lat = [v for q in self.tenants.values() for v in q.latencies]
        arr = np.asarray(all_lat) if all_lat else np.zeros(1)
        return {
            "tenants": {
                t: {
                    "submitted": q.submitted,
                    "completed": q.completed,
                    "deduped": q.deduped,
                    "throttled": q.throttled,
                    "p50_ms": round(q.percentile_ms(50), 3),
                    "p99_ms": round(q.percentile_ms(99), 3),
                }
                for t, q in sorted(self.tenants.items())
            },
            "completed": int(sum(q.completed for q in self.tenants.values())),
            "deduped": int(sum(q.deduped for q in self.tenants.values())),
            "throttled": int(sum(q.throttled for q in self.tenants.values())),
            "batches": self.batches_executed,
            "mean_batch": round(self.records_executed / self.batches_executed, 1)
            if self.batches_executed
            else 0.0,
            "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 3) if all_lat else 0.0,
            "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 3) if all_lat else 0.0,
        }
