"""Cluster operations of the port against the reference: resize,
replication with shard failure and recovery, online GC, and snapshots of a
cluster in the middle of all of them.

Each test drives the reference's ``ShardedCluster`` and the port's
(``device="cpu"``) through the same schedule on a trace made from a numpy
seed, and compares what the reference's own tests check — reports, per-shard
reports, ``resize`` and ``run_gc`` stats, ``moved_fps``, replica counts,
live-block digests and snapshot texts — field for field.
"""

import json
import warnings
from dataclasses import asdict

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from test_torch_engine import _overwrite_trace

BATCH = 256


def _cluster(pkg, num_shards, **kw):
    if pkg is P:
        kw["device"] = "cpu"
    kw.setdefault("cache_entries", 512)
    return pkg.ShardedCluster(num_shards=num_shards, **kw)


def _live_digest(cluster):
    """PBA-free view of live content: each key's fingerprint, and how many
    blocks back each fingerprint."""
    keys = sorted((k[0], k[1], int(e.store.fp_of_pba[p]))
                  for e in cluster.shards for k, p in e.store.lba_map.items())
    copies = sorted((int(fp), len(pbas)) for e in cluster.shards
                    for fp, pbas in e.store.fp_table.items())
    return keys, copies


def _state(cluster):
    return {
        "shards": [asdict(r) for r in cluster.shard_reports or []],
        "digest": _live_digest(cluster),
        "replica_blocks": cluster.replica_blocks,
        "reclaimed": cluster.reclaimed_blocks,
        "relocated": cluster.relocated_blocks,
        "tree": json.dumps(R.snapshot_engine(cluster) if isinstance(cluster, R.ShardedCluster)
                           else P.snapshot_engine(cluster)),
    }


def _both(schedule):
    """Run ``schedule(pkg, out)`` on each package; ``out`` collects what it
    returns step by step.  Returns (reference's, port's)."""
    outs = []
    for pkg in (R, P):
        out = []
        schedule(pkg, out)
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def trace():
    return P.generate_workload("B", total_requests=8_000, seed=7)[0]


@pytest.fixture(scope="module")
def oracle_report(trace):
    oracle = P.HPDedup(cache_entries=512, device="cpu")
    oracle.replay(trace)
    return oracle.finish()


# -- resize ----------------------------------------------------------------------------


@pytest.mark.parametrize("n_from,n_to", [(2, 4), (4, 2), (1, 8), (8, 1), (8, 3), (3, 8)])
def test_resize_equals_reference(trace, oracle_report, n_from, n_to):
    cut = BATCH * n_from * 4

    def schedule(pkg, out):
        c = _cluster(pkg, n_from)
        c.ingest_batched(trace[:cut], BATCH)
        out.append(c.resize(n_to))
        c.ingest_batched(trace[cut:], BATCH)
        out.append(asdict(c.finish()))
        out.append(_state(c))
        c.check_consistency()

    ref, mine = _both(schedule)
    assert mine == ref
    assert mine[0]["moved_fps"] > 0 or n_from == n_to
    rep = mine[1]
    for key in ("total_writes", "total_dup_writes", "unique_fingerprints", "final_disk_blocks"):
        assert rep[key] == getattr(oracle_report, key), key


def test_shrink_grow_snapshot_chain_equals_reference(trace):
    """Shrink, snapshot, restore in the other package, grow: namespace slots
    stay lifetime-unique and the chain ends where the reference's does."""
    cut1, cut2 = BATCH * 4 * 2, BATCH * 4 * 2 + BATCH * 2 * 2
    results = {}
    for src, dst in ((R, P), (P, R), (P, P)):
        c = _cluster(src, 4)
        c.ingest_batched(trace[:cut1], BATCH)
        c.resize(2)
        payload = json.dumps(src.snapshot_engine(c))
        c = dst.restore_engine(json.loads(payload), **({"device": "cpu"} if dst is P else {}))
        assert c._next_namespace == 4
        c.ingest_batched(trace[cut1:cut2], BATCH)
        c.resize(4)
        assert c._next_namespace == 6
        c.ingest_batched(trace[cut2:], BATCH)
        results[(src.__name__, dst.__name__)] = (asdict(c.finish()), _state(c)["tree"])
        c.check_consistency()
    first, *rest = results.values()
    assert all(r == first for r in rest)


def test_resize_migrates_cache_and_directory_like_reference(trace):
    def schedule(pkg, out):
        c = _cluster(pkg, 2, cache_entries=4096)
        c.ingest_batched(trace[:BATCH * 2 * 6], BATCH)
        out.append(c.resize(4))
        out.append(sorted(c._directory.items()))
        out.append([sorted(e.inline.cache.owner) for e in c.shards])

    ref, mine = _both(schedule)
    assert mine == ref and mine[0]["moved_cache_entries"] > 0


@pytest.mark.parametrize("num_shards", [2, 4])
def test_resize_under_executor_equals_reference(num_shards):
    trace = _overwrite_trace(seed=3)
    half = len(trace) // 2

    def schedule(pkg, out):
        c = _cluster(pkg, num_shards)
        c.min_parallel_batch = 0
        c.start_executor()
        try:
            c.ingest_batched(trace[:half], BATCH, parallel=True)
            out.append(c.resize(num_shards * 2))
            assert c._executor is not None and c._executor.num_shards == num_shards * 2
            c.ingest_batched(trace[half:], BATCH, parallel=True)
            out.append(asdict(c.finish()))
        finally:
            c.stop_executor()
        out.append(_state(c))

    ref, mine = _both(schedule)
    assert mine == ref


def test_resize_validation_errors():
    c = _cluster(P, 2, cache_entries=64)
    with pytest.raises(ValueError):
        c.resize(0)
    with pytest.raises(NotImplementedError):
        _cluster(P, 2, routing="stream").resize(3)
    assert c.resize(2)["moved_fps"] == 0


# -- replication, failure and recovery -------------------------------------------------------


@pytest.mark.filterwarnings("ignore::RuntimeWarning")  # R=3 on 2 shards clamps
@pytest.mark.parametrize("num_shards", [2, 4, 8])
@pytest.mark.parametrize("factor", [2, 3])
def test_kill_mid_parallel_replay_recover_equals_reference(num_shards, factor):
    trace = _overwrite_trace(total=3_000)
    half = len(trace) // 2
    victim = num_shards - 1

    def schedule(pkg, out):
        c = _cluster(pkg, num_shards, replication_factor=factor)
        c.replay_batched(trace[:half], batch_size=BATCH, parallel=True)
        c.fail_shard(victim)
        c.replay_batched(trace[half:], batch_size=BATCH, parallel=True)
        out.append((c.failover_reads, c.failover_misses))
        out.append(c.recover_shard(victim))
        out.append(asdict(c.finish()))
        out.append(_state(c))

    ref, mine = _both(schedule)
    assert mine == ref and mine[1]["replayed"] > 0
    oracle = _cluster(P, num_shards, replication_factor=factor)
    oracle.replay_batched(trace[:half], batch_size=BATCH)
    oracle.replay_batched(trace[half:], batch_size=BATCH)
    assert asdict(oracle.finish()) == mine[2]
    assert _live_digest(oracle) == mine[3]["digest"]


def test_replication_is_decision_neutral_and_mirrors_track_live_content():
    trace = _overwrite_trace()
    reports = []
    for factor in (1, 2, 3):
        c = _cluster(P, 4, replication_factor=factor)
        rep = c.replay_batched(trace, batch_size=BATCH).finish()
        assert c.replica_blocks == (factor - 1) * rep.final_disk_blocks
        reports.append(rep)
    assert reports[0] == reports[1] == reports[2]


def test_read_failover_and_unmap_fan_out_equal_reference():
    trace = P.generate_workload("A", total_requests=4_000, seed=11)[0]

    def schedule(pkg, out):
        c = _cluster(pkg, 4, replication_factor=2)
        c.replay_batched(trace, batch_size=BATCH)
        keys = sorted(c._rep_keys)[:40]
        for key in keys[:20]:
            out.append(c.unmap(key >> 40, key & ((1 << 40) - 1)))
        out.append(c.replica_blocks)
        c.fail_shard(1)
        c.ingest_batched(trace)
        out.append((c.failover_reads, c.failover_misses))
        for key in keys[20:]:
            out.append(c.unmap(key >> 40, key & ((1 << 40) - 1)))
        out.append(c.recover_shard(1))
        out.append(asdict(c.finish()))
        out.append(_state(c))

    ref, mine = _both(schedule)
    assert mine == ref
    assert mine[20] > 0 and mine[21][0] > 0 and mine[21][1] == 0


def test_recovery_composes_with_online_gc_like_reference():
    trace = _overwrite_trace()
    half = len(trace) // 2

    def schedule(pkg, out):
        c = _cluster(pkg, 4, replication_factor=2)
        c.ingest_batched(trace[:half], batch_size=BATCH)
        out.append(c.run_gc())
        c.fail_shard(3)
        c.ingest_batched(trace[half:], batch_size=BATCH)
        out.append(c.run_gc())
        out.append(c.recover_shard(3))
        out.append(asdict(c.finish()))
        out.append(_state(c))

    ref, mine = _both(schedule)
    assert mine == ref
    plain = _cluster(P, 4, replication_factor=2)
    plain.ingest_batched(trace, batch_size=BATCH)
    assert asdict(plain.finish()) == mine[3]


def test_failure_guards_and_unrecoverable_r1():
    c = _cluster(P, 4, replication_factor=2)
    c.ingest_batched(P.generate_workload("A", total_requests=2_000, seed=1)[0], BATCH)
    c.fail_shard(2)
    for call in (c.finish, c.snapshot, lambda: c.resize(2)):
        with pytest.raises(RuntimeError, match="recover_shard"):
            call()
    with pytest.raises(ValueError, match="already failed"):
        c.fail_shard(2)
    with pytest.raises(IndexError):
        c.fail_shard(9)
    with pytest.raises(ValueError, match="not failed"):
        c.recover_shard(0)
    c.recover_shard(2)
    c.check_consistency()
    single = _cluster(P, 4)
    single.fail_shard(0)
    with pytest.raises(RuntimeError, match="unrecoverable"):
        single.recover_shard(0)
    with pytest.warns(RuntimeWarning, match="exceeds"):
        _cluster(P, 2, replication_factor=3)
    with pytest.raises(ValueError, match="fingerprint routing"):
        _cluster(P, 2, routing="stream", replication_factor=2)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_replicated_cluster_snapshot_crosses_packages(direction):
    """A replicated cluster's tree (oplogs, mirrors, checkpoints) restores in
    the other package, which then survives a shard failure bit for bit."""
    trace = _overwrite_trace(seed=17)
    cut = len(trace) // 3
    src, dst = (R, P) if direction == "reference_to_port" else (P, R)
    live = _cluster(src, 4, replication_factor=2)
    live.ingest_batched(trace[:cut], batch_size=BATCH)
    payload = json.dumps(src.snapshot_engine(live))
    restored = dst.restore_engine(json.loads(payload), **({"device": "cpu"} if dst is P else {}))
    assert json.dumps(dst.snapshot_engine(restored)) == payload
    outs = []
    for c in (live, restored):
        c.fail_shard(0)
        c.ingest_batched(trace[cut:], batch_size=BATCH)
        outs.append((c.recover_shard(0), asdict(c.finish()), _state(c)))
    assert outs[0] == outs[1]


# -- online GC -----------------------------------------------------------------------------


def _run_no_gc(pkg, trace, num_shards):
    c = _cluster(pkg, num_shards)
    c.ingest_batched(trace, batch_size=BATCH)
    return c, c.finish()


def _run_quiesced_gc(pkg, trace, num_shards, stats):
    c = _cluster(pkg, num_shards)
    n = len(trace)
    for lo in range(0, n, n // 3 + 1):
        c.ingest_batched(trace[lo:lo + n // 3 + 1], batch_size=BATCH)
        stats.append(c.run_gc(max_moves_per_shard=64))
    stats.append(c.run_gc())
    return c, c.finish()


def _run_gc_under_load(pkg, trace, num_shards):
    c = _cluster(pkg, num_shards)
    c.min_parallel_batch = 0
    c.start_executor()
    try:
        c.ingest_batched(trace, batch_size=BATCH, parallel=True,
                         on_chunk=lambda i: c.run_gc(wait=False) if i % 2 == 1 else None)
        c.run_gc(wait=True)
        rep = c.finish()
    finally:
        c.stop_executor()
    return c, rep


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_gc_three_modes_equal_reference(num_shards):
    trace = _overwrite_trace()

    def schedule(pkg, out):
        base, rep0 = _run_no_gc(pkg, trace, num_shards)
        stats = []
        quiesced, rep1 = _run_quiesced_gc(pkg, trace, num_shards, stats)
        live, rep2 = _run_gc_under_load(pkg, trace, num_shards)
        assert rep1 == rep0 and rep2 == rep0
        assert _live_digest(quiesced) == _live_digest(base) == _live_digest(live)
        for c in (base, quiesced, live):
            c.check_consistency()
        for c in (quiesced, live):
            assert all(e.store._limbo == [] for e in c.shards)
        out.extend([asdict(rep0), stats, quiesced.relocated_blocks, quiesced.reclaimed_blocks,
                    _state(quiesced)["tree"], _live_digest(live)])

    ref, mine = _both(schedule)
    assert mine == ref
    assert mine[2] > 0


@pytest.mark.parametrize("num_shards", [2, 4])
def test_gc_snapshot_mid_grace_period_crosses_packages(num_shards):
    """A snapshot with limbo entries (frees parked behind pinned epochs)
    taken in the reference restores in the port, which finishes equal."""
    trace = _overwrite_trace()
    n = 3 * len(trace) // 4
    _, rep0 = _run_no_gc(P, trace, num_shards)
    c = _cluster(R, num_shards)
    c.run_gc()
    tags = [e.store.pin_epoch() for e in c.shards]
    c.ingest_batched(trace[:n], batch_size=BATCH)
    limbo = sum(len(e.store._limbo) for e in c.shards)
    assert limbo > 0
    for e, tag in zip(c.shards, tags):
        e.store.unpin_epoch(tag)
    restored = P.restore_engine(json.loads(json.dumps(R.snapshot_engine(c))), device="cpu")
    assert sum(len(e.store._limbo) for e in restored.shards) == limbo
    assert restored._gc_deferred
    outs = []
    for cc in (c, restored):
        cc.ingest_batched(trace[n:], batch_size=BATCH)
        outs.append(cc.run_gc(max_moves_per_shard=64))
        assert asdict(cc.finish()) == asdict(rep0)
        outs.append(_live_digest(cc))
    assert outs[0:2] == outs[2:4]
    restored.check_consistency()


def test_gc_resize_with_orphan_reclaim_equals_reference():
    trace = _overwrite_trace(total=2_000, seed=5)
    n = len(trace) // 2

    def schedule(pkg, out):
        c = _cluster(pkg, 4)
        c.run_gc()
        c.ingest_batched(trace[:n], batch_size=BATCH)
        tags = [e.store.pin_epoch() for e in c.shards]
        c.ingest_batched(trace[n:n + n // 2], batch_size=BATCH)
        for e, tag in zip(c.shards, tags):
            e.store.unpin_epoch(tag)
        out.append(c.resize(2))
        assert all(e.store._limbo == [] for e in c.shards)
        out.append(c.run_gc(max_moves_per_shard=128))
        c.ingest_batched(trace[n + n // 2:], batch_size=BATCH)
        out.append(asdict(c.finish()))
        out.append(_state(c))
        c.check_consistency()

    ref, mine = _both(schedule)
    assert mine == ref and mine[3]["relocated"] > 0


def test_coalesced_and_scattered_write_batch_flags_equal():
    trace = _overwrite_trace(total=1_200, seed=3)
    cols = (trace["stream"], trace["lba"].astype(np.int64), trace["fp"])
    flags = {}
    for floor in (0, 1 << 30):
        c = _cluster(P, 4)
        c.min_parallel_batch = floor
        c.start_executor()
        try:
            flags[floor] = np.concatenate(
                [c.write_batch(*(col[lo:lo + 100] for col in cols))
                 for lo in range(0, len(trace), 100)])
            c.finish()
        finally:
            c.stop_executor()
    assert (flags[0] == flags[1 << 30]).all()


# -- the chip-smoke schedule, small ------------------------------------------------------------


def _smoke_schedule(pkg, trace, chunk, parallel, device_kw):
    """The ``cluster`` phase of ``chip_smoke.py`` at a small size: GC every 4
    chunks; at half, snapshot -> JSON -> restore and carry on; resize 4 -> 8
    at three quarters; at seven eighths fail and recover shard 1."""
    c = pkg.ShardedCluster(num_shards=4, replication_factor=2, cache_entries=512, **device_kw)
    c.min_parallel_batch = 0
    n = len(trace)
    marks = [n // 2, 3 * n // 4, 7 * n // 8, n]
    gc_stats, moved, lo, k = [], None, 0, 0
    for mark in marks:
        for a in range(lo, mark, chunk):
            c.ingest_batched(trace[a:min(a + chunk, mark)], batch_size=chunk // 4,
                             parallel=parallel)
            k += 1
            if k % 4 == 0:
                gc_stats.append(c.run_gc(max_moves_per_shard=512))
        lo = mark
        if mark == n // 2:
            c = pkg.restore_engine(json.loads(json.dumps(pkg.snapshot_engine(c))), **device_kw)
            c.min_parallel_batch = 0
        elif mark == 3 * n // 4:
            moved = c.resize(8)["moved_fps"]
        elif mark == 7 * n // 8:
            c.fail_shard(1)
            c.recover_shard(1)
    rep = c.finish()
    c.check_consistency()
    return asdict(rep), [asdict(r) for r in c.shard_reports], moved, gc_stats


def test_chip_smoke_cluster_schedule_equals_reference():
    trace = P.generate_workload("A", total_requests=24_000, seed=0)[0]
    ref = _smoke_schedule(R, trace, 2_048, False, {})
    serial = _smoke_schedule(P, trace, 2_048, False, {"device": "cpu"})
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no clamp: R=2 fits every shard count
        parallel = _smoke_schedule(P, trace, 2_048, True, {"device": "cpu"})
    assert serial == ref and parallel == ref
    assert ref[2] > 0 and sum(s["moved"] for s in ref[3]) > 0
    oracle = P.HPDedup(cache_entries=512, device="cpu")
    oracle.replay_batched(trace, 2_048)
    want = oracle.finish()
    assert (ref[0]["final_disk_blocks"], ref[0]["unique_fingerprints"]) == \
        (want.final_disk_blocks, want.unique_fingerprints)
