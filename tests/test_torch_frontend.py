"""The port's async serving front end (``repro_torch.serving.frontend``) on
port engines, against the reference, on the CPU.

* The seven tests of ``tests/test_serving_frontend.py`` and the GC-under-
  traffic test of ``tests/test_gc_online.py``, run on ``repro_torch``
  engines with ``device="cpu"``.  Batch boundaries depend on timing, so
  parity is held as the reference's tests hold it: ``executed_trace()``
  replayed through a fresh engine gives the served ``HybridReport``.
* Each executed trace is also replayed through the reference's engine (its
  cluster gets the ``uint64`` fingerprint column the front end records) and
  the reports are equal, field for field (``_hold_to_reference``).  Where
  the reference's batched cluster hits its ``add_many`` fault (ROADMAP §3)
  on a trace, that case is held to the single-engine oracle's counts
  instead, and the reference's inconsistency is asserted.  The KV server's
  engine runs the LDSS solver in float32 (``use_jax_estimator=True``): its
  report is held to the reference's within 0.02 of inline ratio, its counts
  exactly.
"""

from __future__ import annotations

import asyncio
from dataclasses import asdict

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.serving.frontend import AsyncDedupFrontend as RefFrontend
from repro_torch.serving.frontend import AsyncDedupFrontend, TenantQoS


def _tenant_columns(total=4_000, seed=3, workload="A"):
    trace, _ = P.generate_workload(workload, total_requests=total, seed=seed)
    out = {}
    for t in np.unique(trace["stream"]):
        recs = trace[trace["stream"] == t]
        out[int(t)] = (recs["lba"].astype(np.int64), recs["fp"].astype(np.uint64))
    return out


async def _drive(fe, tenants, conns_per_tenant=4):
    async def conn(t, lbas, fps):
        for lba, fp in zip(lbas.tolist(), fps.tolist()):
            await fe.write(t, fp, lba=lba)

    jobs = []
    for t, (lbas, fps) in tenants.items():
        for c in range(conns_per_tenant):
            jobs.append(conn(t, lbas[c::conns_per_tenant], fps[c::conns_per_tenant]))
    await asyncio.gather(*jobs)


def _make_cluster(n=4, cache_entries=512, pkg=P):
    kw = {"device": "cpu"} if pkg is P else {}
    return pkg.ShardedCluster(num_shards=n, cache_entries=cache_entries, **kw)


COUNTS = ("total_writes", "total_dup_writes", "final_disk_blocks", "unique_fingerprints")


def _counts(rep):
    return tuple(getattr(rep, f) for f in COUNTS)


def _hold_to_reference(rep, cols, make_ref):
    """``rep`` (the port's served report) against the reference's engine
    from ``make_ref()`` fed the executed columns in one ``write_batch``:
    equal field for field; or, where the reference's batched cluster ends
    inconsistent (its ``add_many`` fault), equal counts to a single-engine
    oracle replaying the same writes one by one.  Returns which held."""
    ref = make_ref()
    ref.write_batch(*cols)
    want = ref.finish()
    if asdict(want) == asdict(rep):
        return "reference"
    with pytest.raises(AssertionError, match="authoritative set"):
        ref.check_consistency()
    oracle = P.HPDedup(cache_entries=512, device="cpu")
    for t, lba, fp in zip(*(c.tolist() for c in cols)):
        oracle.write(t, lba, fp)
    assert _counts(rep) == _counts(oracle.finish())
    return "oracle"


def test_per_tenant_counts_match_single_stream_replay():
    tenants = _tenant_columns()

    async def run():
        engine = _make_cluster()
        fe = AsyncDedupFrontend(
            engine, max_batch=128, max_delay=0.001, max_pending=256, record_trace=True
        )
        await _drive(fe, tenants)
        await fe.close()
        return engine.finish(), fe

    rep, fe = asyncio.run(run())

    t_col, l_col, f_col = fe.executed_trace()
    oracle = _make_cluster()
    flags = oracle.write_batch(t_col, l_col, f_col)
    assert oracle.finish() == rep  # bit-exact HybridReport
    _hold_to_reference(rep, (t_col, l_col, f_col), lambda: _make_cluster(pkg=R))

    stats = fe.stats()
    for t, (lbas, _) in tenants.items():
        mask = t_col == t
        assert stats["tenants"][t]["completed"] == int(mask.sum()) == len(lbas)
        assert stats["tenants"][t]["deduped"] == int(flags[mask].sum())


def test_frontend_over_single_engine_and_kv_server():
    """Over a bare ``HPDedup`` and over the port's ``DedupKVServer`` (the
    smoke TinyLlama), whose engine the front end unwraps; the single
    engine's report equals the reference's, the server engine's (float32
    LDSS solver) equals it in counts and within 0.02 of inline ratio."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.dedup_kv import DedupKVServer

    tenants = _tenant_columns(total=2_000, seed=8)

    async def run(engine):
        fe = AsyncDedupFrontend(engine, max_batch=64, max_delay=0.001, record_trace=True)
        await _drive(fe, tenants, conns_per_tenant=2)
        await fe.close()
        return fe

    single = P.HPDedup(cache_entries=512, device="cpu")
    fe1 = asyncio.run(run(single))
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    server = DedupKVServer(build_model(cfg), params, page_tokens=16, max_slots=64,
                           cache_entries=512, device="cpu")
    fe2 = asyncio.run(run(server))
    assert fe2.engine is server.dedup  # unwraps the KV server's engine
    assert fe1.stats()["completed"] == fe2.stats()["completed"] == sum(
        len(l) for l, _ in tenants.values()
    )
    rep1 = single.finish()
    assert _hold_to_reference(rep1, fe1.executed_trace(),
                              lambda: R.HPDedup(cache_entries=512)) == "reference"
    rep2 = server.dedup.finish()
    oracle = P.HPDedup(**server.dedup._config, device="cpu")
    oracle.write_batch(*fe2.executed_trace())
    assert oracle.finish() == rep2
    ref = R.HPDedup(**server.dedup._config)
    ref.write_batch(*fe2.executed_trace())
    want = ref.finish()
    assert _counts(rep2) == _counts(want)
    assert abs(rep2.inline_dedup_ratio - want.inline_dedup_ratio) < 0.02


def test_backpressure_bounds_pending_and_completes():
    tenants = _tenant_columns(total=3_000, seed=5)
    total = sum(len(l) for l, _ in tenants.values())

    async def run():
        engine = _make_cluster(2)
        fe = AsyncDedupFrontend(
            engine, max_batch=32, max_delay=0.0005, max_pending=48, record_trace=True
        )
        peak = 0

        orig = fe._schedule_flush

        def watch():
            nonlocal peak
            peak = max(peak, len(fe._buf_futs) + fe._inflight_batches * fe.max_batch)
            orig()

        fe._schedule_flush = watch
        await _drive(fe, tenants, conns_per_tenant=8)
        await fe.close()
        return engine.finish(), fe, peak

    rep, fe, peak = asyncio.run(run())
    assert fe.stats()["completed"] == total
    # buffered writes never exceed the backpressure bound
    assert peak <= 48 + fe.max_batch
    cols = fe.executed_trace()
    oracle = _make_cluster(2)
    oracle.write_batch(*cols)
    assert oracle.finish() == rep
    _hold_to_reference(rep, cols, lambda: _make_cluster(2, pkg=R))


def test_admission_control_throttles_under_cache_contention():
    # tiny caches -> occupancy crosses contention_ratio early; the Zipf-ish
    # volume skew gives the estimator distinct per-tenant LDSS shares
    tenants = _tenant_columns(total=6_000, seed=2)

    async def run():
        engine = _make_cluster(2, cache_entries=64)
        fe = AsyncDedupFrontend(
            engine,
            max_batch=64,
            max_delay=0.0005,
            max_pending=512,
            admission_budget=8,
            contention_ratio=0.5,
            record_trace=True,
        )
        await _drive(fe, tenants, conns_per_tenant=6)
        await fe.close()
        return engine.finish(), fe

    rep, fe = asyncio.run(run())
    stats = fe.stats()
    assert stats["throttled"] > 0
    # throttled writes still complete: nothing is dropped
    assert stats["completed"] == sum(len(l) for l, _ in tenants.values())
    cols = fe.executed_trace()
    oracle = _make_cluster(2, cache_entries=64)
    oracle.write_batch(*cols)
    assert oracle.finish() == rep
    _hold_to_reference(rep, cols, lambda: _make_cluster(2, cache_entries=64, pkg=R))


def test_live_resize_under_traffic():
    tenants = _tenant_columns(total=4_000, seed=7)
    total = sum(len(l) for l, _ in tenants.values())

    async def run():
        engine = _make_cluster(2)
        fe = AsyncDedupFrontend(engine, max_batch=128, max_delay=0.001, record_trace=True)
        traffic = asyncio.ensure_future(_drive(fe, tenants, conns_per_tenant=4))
        await asyncio.sleep(0.01)
        info = await fe.resize(4)
        await traffic
        await fe.close()
        return engine, fe, info

    engine, fe, info = asyncio.run(run())
    assert engine.num_shards == 4
    assert info["new_num_shards"] == 4
    rep = engine.finish()
    stats = fe.stats()
    assert stats["completed"] == total
    # resize preserves exactness: aggregate exact-dedup counts equal a
    # fixed-layout oracle's over the same executed interleaving, the port's
    # and the reference's
    cols = fe.executed_trace()
    for pkg in (P, R):
        oracle = _make_cluster(2, pkg=pkg)
        oracle.write_batch(*cols)
        orep = oracle.finish()
        assert rep.total_writes == orep.total_writes == total
        assert rep.unique_fingerprints == orep.unique_fingerprints
        assert rep.final_disk_blocks == orep.final_disk_blocks


def test_engine_error_propagates_to_writers():
    class Exploding:
        def write_batch(self, streams, lbas, fps):
            raise RuntimeError("engine down")

    async def run():
        fe = AsyncDedupFrontend(Exploding(), max_batch=4, max_delay=0.0005)
        with pytest.raises(RuntimeError, match="engine down"):
            await fe.write(0, 12345)
        fe._engine_pool.shutdown(wait=False)

    asyncio.run(run())


def test_write_after_close_rejected():
    async def run():
        fe = AsyncDedupFrontend(P.HPDedup(cache_entries=64, device="cpu"))
        await fe.write(0, 99)
        await fe.close()
        with pytest.raises(RuntimeError, match="closed"):
            await fe.write(0, 100)

    asyncio.run(run())


def _overwrite_trace(total=2_000, seed=21, workload="A"):
    """A trace whose second half overwrites the first half's keys with new
    content — every original block's refcount hits zero, feeding the GC."""
    base = P.generate_workload(workload, total_requests=total, seed=seed)[0]
    over = base.copy()
    over["ts"] = over["ts"] + int(base["ts"].max()) + 1
    over["fp"] = over["fp"] ^ np.uint64(0x9E3779B97F4A7C15)
    both = np.concatenate([base, over])
    both.sort(order="ts", kind="stable")
    return both


def test_gc_under_frontend_traffic_matches_executed_interleaving():
    """run_gc steps interleaved with live async traffic, through the shard
    worker threads: the executed interleaving replayed through a fresh
    GC-free cluster (the port's and the reference's) is bit-exact."""
    trace = _overwrite_trace()
    per_tenant = {}
    for t in np.unique(trace["stream"]):
        recs = trace[trace["stream"] == t]
        per_tenant[int(t)] = (recs["lba"].astype(np.int64), recs["fp"].astype(np.uint64))

    async def run():
        engine = _make_cluster(4)
        engine.min_parallel_batch = 0
        fe = AsyncDedupFrontend(
            engine, max_batch=128, max_delay=0.001, max_pending=256, record_trace=True
        )

        async def conn(t, lbas, fps):
            for i, (lba, fp) in enumerate(zip(lbas.tolist(), fps.tolist())):
                await fe.write(t, fp, lba=lba)
                if i % 400 == 399:
                    await fe.run_gc(max_moves_per_shard=64)

        await asyncio.gather(*(conn(t, c[0], c[1]) for t, c in per_tenant.items()))
        stats = await fe.run_gc()
        await fe.close()
        return engine.finish(), fe, stats, engine

    rep, fe, gc_stats, engine = asyncio.run(run())
    assert gc_stats is not None and "moved" in gc_stats
    cols = fe.executed_trace()
    oracle = _make_cluster(4)
    oracle.write_batch(*cols)
    assert oracle.finish() == rep
    engine.check_consistency()
    _hold_to_reference(rep, cols, lambda: _make_cluster(4, pkg=R))


def test_run_gc_over_single_engine_and_unsupported_engines():
    """``run_gc`` on a bare ``HPDedup`` passes ``max_moves``; engines with
    neither ``resize`` nor ``run_gc`` are refused, as in the reference."""

    async def run():
        engine = P.HPDedup(cache_entries=64, device="cpu")
        fe = AsyncDedupFrontend(engine, max_batch=8, max_delay=0.0005, record_trace=True)
        for i in range(40):
            await fe.write(i % 3, 1000 + i % 7, lba=i % 5)
        await fe.drain()
        stats = await fe.run_gc(max_moves_per_shard=4)
        with pytest.raises(TypeError, match="resize"):
            await fe.resize(2)
        await fe.close()
        return engine, fe, stats

    engine, fe, stats = asyncio.run(run())
    assert "moved" in stats
    engine.store.check_consistency()
    cols = fe.executed_trace()
    rep = engine.finish()
    oracle = P.HPDedup(cache_entries=64, device="cpu")
    oracle.write_batch(*cols)
    assert oracle.finish() == rep
    assert _hold_to_reference(rep, cols, lambda: R.HPDedup(cache_entries=64)) == "reference"

    class Plain:
        def write_batch(self, streams, lbas, fps):
            return np.zeros(len(streams), dtype=bool)

    async def refused():
        fe = AsyncDedupFrontend(Plain())
        with pytest.raises(TypeError, match="run_gc"):
            await fe.run_gc()
        await fe.close()

    asyncio.run(refused())


def test_stats_and_qos_equal_reference_frontend():
    """The same single-connection writes through the port's front end over a
    port engine and through the reference's over a reference engine: one
    connection gives one interleaving, so flags, per-tenant counts and the
    executed trace are equal; an empty front end reports zeros alike."""
    writes = [(i % 4, 1 + (i * 7919) % 97, i % 13) for i in range(600)]

    async def run(cls, engine):
        fe = cls(engine, max_batch=16, max_delay=0.0005, record_trace=True)
        flags = [await fe.write(t, fp, lba=lba) for t, fp, lba in writes]
        await fe.close()
        return flags, fe

    mine, fe = asyncio.run(run(AsyncDedupFrontend, P.HPDedup(cache_entries=32, device="cpu")))
    theirs, ref_fe = asyncio.run(run(RefFrontend, R.HPDedup(cache_entries=32)))
    assert mine == theirs
    keys = ("submitted", "completed", "deduped", "throttled")
    for t in range(4):
        got, want = fe.stats()["tenants"][t], ref_fe.stats()["tenants"][t]
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    for a, b in zip(fe.executed_trace(), ref_fe.executed_trace()):
        np.testing.assert_array_equal(a, b)
    assert fe.stats()["batches"] == len(writes)  # each write waits for its flag
    empty = AsyncDedupFrontend(P.HPDedup(cache_entries=8, device="cpu"))
    assert empty.stats()["p99_ms"] == 0.0 and empty.stats()["mean_batch"] == 0.0
    assert TenantQoS().percentile_ms(99) == 0.0
    with pytest.raises(RuntimeError, match="record_trace"):
        empty.executed_trace()
    empty._engine_pool.shutdown(wait=True)


def test_reference_add_many_fault_through_the_frontend():
    """The shortest trace of the reference's ``add_many`` fault (ROADMAP §3;
    pinned for the cluster in ``test_torch_cluster.py``), served one write a
    batch by each package's front end over a one-shard cluster: the
    reference's cluster ends inconsistent, the port's equals the
    single-engine oracle."""
    writes = [(1, 18, 7), (1, 18, 8), (3, 18, 7), (3, 0, 31)]  # (tenant, lba, fp)

    async def run(cls, engine):
        fe = cls(engine, max_batch=1, max_delay=0.0005, record_trace=True)
        for t, lba, fp in writes:
            await fe.write(t, fp, lba=lba)
        await fe.close()
        return fe

    mine = P.ShardedCluster(num_shards=1, cache_entries=16, device="cpu")
    fe = asyncio.run(run(AsyncDedupFrontend, mine))
    assert fe.stats()["batches"] == len(writes)
    theirs = R.ShardedCluster(num_shards=1, cache_entries=16)
    asyncio.run(run(RefFrontend, theirs))
    got = mine.finish()
    theirs.finish()
    mine.check_consistency()
    with pytest.raises(AssertionError, match="authoritative set"):
        theirs.check_consistency()
    oracle = P.HPDedup(cache_entries=16, device="cpu")
    for t, lba, fp in writes:
        oracle.write(t, lba, fp)
    assert _counts(got) == _counts(oracle.finish())
