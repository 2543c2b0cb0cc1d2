"""The port's sharded cluster against the reference, and against oracles.

* Ring routing (``shard_of_many``, ``owners_of_many``) equals the
  reference's on random ``uint64`` keys, those at or above 2^63 included.
* ``replay``, ``replay_batched``, ``ingest_batched`` and the parallel
  executor path give the reference's ``HybridReport``, per-shard reports and
  snapshot trees at 1, 2, 4 and 8 shards, on both index backends; one shard
  equals ``HPDedup``.
* Where the reference's batched path hits its ``add_many``-after-a-staged-
  removal fault (ROADMAP §3), the case is kept and the port is held to the
  scalar single-engine oracle there.
* ``test_torch_cluster_property.py`` holds the port to oracles only.
* The launch and probe-route counters lose no count under worker threads.

Everything runs with ``device="cpu"`` on traces made from a numpy seed.
"""

import json
import sys
import threading

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
from dataclasses import asdict

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
import repro_torch.core.fp_index as port_fp_index
from repro_torch.core.fingerprint import OP_WRITE, TRACE_DTYPE
from repro_torch.kernels import _build
from test_torch_engine import backend  # noqa: F401  (the index-backend fixture)

SHARD_COUNTS = [1, 2, 4, 8]


def _cluster(pkg, num_shards, **kw):
    if pkg is P:
        kw["device"] = "cpu"
    kw.setdefault("cache_entries", 256)
    return pkg.ShardedCluster(num_shards=num_shards, **kw)


def _trace_of(ops):
    recs = np.zeros(len(ops), dtype=TRACE_DTYPE)
    for i, (stream, op, lba, fp) in enumerate(ops):
        recs[i] = (i, stream, op, lba, fp if op == 0 else 0)
    return recs


@pytest.fixture(scope="module")
def trace():
    return P.generate_workload("A", total_requests=4_000, seed=11)[0]


# -- ring -----------------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8, 13])
@pytest.mark.parametrize("vnodes,seed", [(64, 0), (16, 7)])
def test_ring_routing_equals_reference(num_shards, vnodes, seed):
    rng = np.random.default_rng(num_shards * 100 + seed)
    keys = rng.integers(0, 2**64 - 1, size=20_000, dtype=np.uint64, endpoint=True)
    keys[:4] = [0, 2**63 - 1, 2**63, 2**64 - 1]
    mine = P.ConsistentHashRing(num_shards, vnodes=vnodes, seed=seed)
    ref = R.ConsistentHashRing(num_shards, vnodes=vnodes, seed=seed)
    np.testing.assert_array_equal(mine.points, ref.points)
    np.testing.assert_array_equal(mine.owners, ref.owners)
    shards = mine.shard_of_many(keys)
    np.testing.assert_array_equal(shards, ref.shard_of_many(keys))
    assert (keys >= np.uint64(2**63)).sum() > 9_000
    for r in range(1, min(num_shards, 4) + 1):
        owners = mine.owners_of_many(keys, r)
        np.testing.assert_array_equal(owners, ref.owners_of_many(keys, r))
        np.testing.assert_array_equal(owners[:, 0], shards)
    assert [mine.shard_of(int(k)) for k in keys[:200].tolist()] == shards[:200].tolist()
    with pytest.raises(ValueError):
        mine.owners_of_many(keys, num_shards + 1)


def test_ring_minimal_remap_on_grow():
    keys = np.random.default_rng(1).integers(0, 2**64 - 1, 5_000, dtype=np.uint64)
    before = P.ConsistentHashRing(4).shard_of_many(keys)
    after = P.ConsistentHashRing(5).shard_of_many(keys)
    moved = before != after
    assert bool((after[moved] == 4).all()) and 0 < int(moved.sum()) < keys.size // 2


# -- the cluster's paths against the reference --------------------------------------


def _run(cluster, path, trace):
    if path == "replay":
        cluster.replay(trace)
    elif path == "replay_batched":
        cluster.replay_batched(trace, batch_size=256)
    elif path == "ingest_batched":
        cluster.ingest_batched(trace[: len(trace) // 2], batch_size=256)
        cluster.ingest_batched(trace[len(trace) // 2:], batch_size=128)
    else:
        cluster.min_parallel_batch = 0  # every chunk through the workers
        cluster.replay_batched(trace, batch_size=256, parallel=True)
    return cluster.finish()


@pytest.mark.parametrize("path", ["replay", "replay_batched", "ingest_batched", "parallel"])
@pytest.mark.parametrize("num_shards", SHARD_COUNTS)
def test_cluster_paths_equal_reference(trace, num_shards, path, backend):
    ref, mine = _cluster(R, num_shards), _cluster(P, num_shards)
    want, got = _run(ref, path, trace), _run(mine, path, trace)
    assert asdict(got) == asdict(want)
    assert [asdict(r) for r in mine.shard_reports] == [asdict(r) for r in ref.shard_reports]
    assert json.dumps(P.snapshot_engine(mine)) == json.dumps(R.snapshot_engine(ref))
    mine.check_consistency()


@pytest.mark.parametrize("workload", ["B", "C"])
def test_one_shard_equals_hpdedup(workload):
    trace = P.generate_workload(workload, total_requests=4_000, seed=2)[0]
    engine = P.HPDedup(cache_entries=256, device="cpu")
    engine.replay(trace)
    want = engine.finish()
    for path in ("replay", "replay_batched", "ingest_batched"):
        assert _run(_cluster(P, 1), path, trace) == want, path


@pytest.mark.parametrize("kind", ["idedup", "diode", "postproc"])
def test_cluster_of_each_engine_kind_equals_reference(kind):
    trace = P.generate_workload("B", total_requests=5_000, seed=2)[0]

    def factory(pkg):
        kw = {"device": "cpu"} if pkg is P else {}
        return {
            "idedup": lambda i: pkg.make_idedup(cache_entries=256, seed=i, **kw),
            "diode": lambda i: pkg.DIODE(cache_entries=256, seed=i, **kw),
            "postproc": lambda i: pkg.PurePostProcessing(**kw),
        }[kind]

    reports = []
    for pkg in (R, P):
        cluster = pkg.ShardedCluster(num_shards=4, engine_factory=factory(pkg),
                                     **({"device": "cpu"} if pkg is P else {}))
        cluster.replay_batched(trace, batch_size=512)
        reports.append(asdict(cluster.finish()))
    assert reports[0] == reports[1]


def test_cluster_accepts_custom_protocol_engine():
    class WrappedEngine:
        """An engine that only has the protocol's methods and a store."""

        def __init__(self, seed: int):
            self._inner = P.HPDedup(cache_entries=256, seed=seed, device="cpu")
            self.store = self._inner.store

        def write_batch(self, streams, lbas, fps):
            return self._inner.write_batch(streams, lbas, fps)

        def replay(self, trace):
            self._inner.replay(trace)
            return self

        def finish(self):
            return self._inner.finish()

    trace = P.generate_workload("B", total_requests=4_000, seed=6)[0]
    oracle = P.HPDedup(cache_entries=256, device="cpu")
    oracle.replay(trace)
    want = oracle.finish()
    for fn in ("replay", "replay_batched"):
        cluster = P.ShardedCluster(num_shards=2, engine_factory=WrappedEngine, device="cpu")
        assert isinstance(cluster, P.Engine)
        getattr(cluster, fn)(trace)
        rep = cluster.finish()
        assert (rep.total_writes, rep.total_dup_writes, rep.unique_fingerprints,
                rep.final_disk_blocks) == (want.total_writes, want.total_dup_writes,
                                           want.unique_fingerprints, want.final_disk_blocks)


def test_write_batch_flags_equal_reference_and_single_engine():
    trace = P.generate_workload("B", total_requests=6_000, seed=7)[0]
    writes = trace[trace["op"] == OP_WRITE]
    single = P.make_idedup(cache_entries=1 << 20, threshold=1, device="cpu")
    mine = P.ShardedCluster(num_shards=4, device="cpu", engine_factory=lambda i: P.make_idedup(
        cache_entries=1 << 20, threshold=1, device="cpu"))
    ref = R.ShardedCluster(num_shards=4, engine_factory=lambda i: R.make_idedup(
        cache_entries=1 << 20, threshold=1))
    flags = {"single": [], "mine": [], "ref": []}
    for a in range(0, len(writes), 500):
        cols = (writes["stream"][a:a + 500], writes["lba"][a:a + 500], writes["fp"][a:a + 500])
        flags["single"] += single.write_batch(*cols).tolist()
        flags["mine"] += mine.write_batch(*cols).tolist()
        flags["ref"] += ref.write_batch(*cols).tolist()
    assert flags["mine"] == flags["ref"] == flags["single"]
    assert asdict(mine.finish()) == asdict(ref.finish())


def test_write_batch_routes_fingerprints_from_2_63_up():
    """A Python list mixing fingerprints at or above 2^63 with smaller ones:
    the port routes and stores each as the exact ``uint64`` (the reference's
    ``np.asarray`` makes the list float64, ROADMAP §3), so the list and the
    ``uint64`` array give the same cluster."""
    fps = [2**63 + 5, 3, 2**63 + 2**40 + 1, 2**64 - 2, 17, 2**63 + 5]
    streams, lbas = np.zeros(len(fps), np.int64), list(range(len(fps)))
    listed = _cluster(P, 4, adaptive_threshold=False, fixed_threshold=1)
    arrayed = _cluster(P, 4, adaptive_threshold=False, fixed_threshold=1)
    flags = listed.write_batch(streams, lbas, fps)
    np.testing.assert_array_equal(
        flags, arrayed.write_batch(streams, lbas, np.asarray(fps, dtype=np.uint64)))
    stored = sorted(int(v) for e in listed.shards for v in e.store.fp_of_pba.values())
    assert stored == sorted(set(fps))
    assert json.dumps(P.snapshot_engine(listed)) == json.dumps(P.snapshot_engine(arrayed))
    listed.check_consistency()  # each fingerprint sits on the shard its ring owns


def test_stream_routing_equals_reference():
    trace = P.generate_workload("B", total_requests=6_000, seed=3)[0]
    ref = _cluster(R, 4, routing="stream")
    mine = _cluster(P, 4, routing="stream")
    ref.replay_batched(trace, batch_size=512)
    mine.replay_batched(trace, batch_size=512)
    assert asdict(mine.finish()) == asdict(ref.finish())
    assert [asdict(r) for r in mine.shard_reports] == [asdict(r) for r in ref.shard_reports]
    for shard_rep in mine.shard_reports:
        assert shard_rep.final_disk_blocks == shard_rep.unique_fingerprints
    mine.check_consistency()


def test_reads_route_to_the_writing_shard_and_probes_equal_reference():
    n = 64
    recs = np.zeros(n, dtype=TRACE_DTYPE)
    recs["ts"] = np.arange(n)
    recs["op"] = np.where(np.arange(n) % 2 == 0, 0, 1)
    recs["lba"] = np.arange(n) // 2
    recs["fp"] = np.arange(1, n + 1, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    recs["fp"][recs["op"] == 1] = 0
    mine, ref = _cluster(P, 4), _cluster(R, 4)
    mine.replay(recs)
    ref.replay(recs)
    for lba in range(n // 2):
        assert sum(e.store.read(0, lba) is not None for e in mine.shards) == 1
    probe = np.concatenate([recs["fp"][::2], recs["fp"][::2] ^ np.uint64(1)])
    np.testing.assert_array_equal(mine.probe_fps(probe), ref.probe_fps(probe))
    assert mine.probe_fps(probe)[: n // 2].all() and not mine.probe_fps(probe)[n // 2:].any()
    assert mine.probe_fps(np.zeros(0, np.uint64)).size == 0


def test_shard_local_cleanup_window_equals_reference():
    trace = P.generate_workload("B", total_requests=6_000, seed=9)[0]
    out = []
    for pkg in (R, P):
        cluster = _cluster(pkg, 4, cache_entries=8)
        cluster.replay_batched(trace)
        out.append([cluster.run_postprocess(max_merges_per_shard=5),
                    cluster.run_postprocess(max_merges_per_shard=5),
                    cluster.run_postprocess(to_exact=True), cluster.reclaimed_blocks,
                    asdict(cluster.finish())])
    assert out[0] == out[1]
    assert out[1][0] > 0 and out[1][1] > 0


def test_pba_namespaces_disjoint(trace):
    cluster = _cluster(P, 4)
    cluster.replay_batched(trace)
    cluster.finish()
    owner = {}
    for s, e in enumerate(cluster.shards):
        for pba in e.store.fp_of_pba:
            assert owner.setdefault(pba, s) == s
            assert s << 48 <= pba < (s + 1) << 48


def test_aggregate_reports_equal_reference(trace):
    mine, ref = _cluster(P, 4), _cluster(R, 4)
    mine.replay_batched(trace)
    ref.replay_batched(trace)
    mine.finish()
    ref.finish()
    assert asdict(P.aggregate_reports(mine.shard_reports)) == \
        asdict(R.aggregate_reports(ref.shard_reports))
    one = mine.shard_reports[0]
    assert P.aggregate_reports([one]) == one


# -- the reference's add_many fault, pinned ------------------------------------------

# The shortest traces found on which the reference's batched cluster leaves a
# shard's fingerprint index inconsistent: a key is freed by an overwrite (a
# staged removal), then written again through ``add_many``, and the
# reference's flush tombstones it (ROADMAP §3).
FAULT_CASES = [
    (1, 1, [(1, 0, 18, 7), (1, 0, 18, 8), (3, 0, 18, 7), (3, 0, 0, 31)]),
    (8, 1, [(3, 0, 7, 16), (0, 1, 10, 40), (1, 1, 18, 21), (2, 0, 9, 38), (0, 0, 8, 33),
            (3, 0, 9, 8), (2, 0, 4, 21), (3, 0, 14, 9), (3, 0, 7, 3), (2, 0, 8, 16),
            (1, 1, 13, 19), (3, 0, 22, 28), (0, 0, 8, 24), (3, 0, 9, 12), (1, 0, 18, 3),
            (3, 0, 15, 3), (2, 1, 8, 22), (1, 0, 7, 3)]),
]


@pytest.mark.parametrize("num_shards,batch_size,ops", FAULT_CASES, ids=["1-shard", "8-shards"])
def test_reference_add_many_fault_case_port_equals_oracle(num_shards, batch_size, ops):
    trace = _trace_of(ops)
    oracle = P.HPDedup(cache_entries=16, device="cpu")
    oracle.replay(trace)
    want = oracle.finish()
    scalar = _cluster(P, num_shards, cache_entries=16)
    scalar.replay(trace)
    batched = _cluster(P, num_shards, cache_entries=16)
    batched.replay_batched(trace, batch_size=batch_size)
    got = scalar.finish()
    assert batched.finish() == got
    assert (got.total_writes, got.total_dup_writes, got.final_disk_blocks,
            got.unique_fingerprints) == (want.total_writes, want.total_dup_writes,
                                         want.final_disk_blocks, want.unique_fingerprints)
    scalar.check_consistency()
    batched.check_consistency()
    # the reference's batched cluster is where the fault shows
    ref = R.ShardedCluster(num_shards=num_shards, cache_entries=16)
    ref.replay_batched(trace, batch_size=batch_size)
    ref.finish()
    with pytest.raises(AssertionError, match="authoritative set"):
        ref.check_consistency()


# -- the executor ---------------------------------------------------------------------


def test_executor_error_is_sticky_and_barrier_waits():
    ex = P.ParallelShardExecutor(3)
    done = []
    try:
        for s in range(3):
            for i in range(20):
                ex.submit(s, lambda s=s, i=i: done.append((s, i)))
        ex.barrier()
        assert sorted(done) == [(s, i) for s in range(3) for i in range(20)]
        ex.submit(1, lambda: 1 / 0)
        with pytest.raises(P.ShardWorkerError, match="shard 1"):
            ex.barrier()
        with pytest.raises(P.ShardWorkerError):
            ex.barrier()
        with pytest.raises(P.ShardWorkerError):
            ex.submit(1, lambda: None)
        ex.submit(0, lambda: done.append("healthy lane"))
        assert set(ex.failed_shards()) == {1}
    finally:
        ex.close()
    assert done[-1] == "healthy lane"
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit(0, lambda: None)


def test_parallel_cluster_worker_fault_poisons_then_reloads(trace):
    cluster = _cluster(P, 2)
    cluster.min_parallel_batch = 0
    cluster.ingest_batched(trace[:1_000], batch_size=128)
    tree = json.loads(json.dumps(P.snapshot_engine(cluster)))
    cluster.start_executor()
    cluster._executor.submit(0, lambda: 1 / 0)
    with pytest.raises(P.ShardWorkerError):
        cluster.ingest_batched(trace[1_000:2_000], batch_size=128)
    cluster.stop_executor()
    with pytest.raises(P.ShardWorkerError, match="poisoned"):
        cluster.ingest_batched(trace[1_000:2_000], batch_size=128)
    P.load_engine_state(cluster, tree)  # a snapshot reload heals the lanes
    cluster.ingest_batched(trace[1_000:], batch_size=128, parallel=True)
    whole = _cluster(P, 2)
    whole.ingest_batched(trace[:1_000], batch_size=128)
    whole.ingest_batched(trace[1_000:], batch_size=128)
    assert cluster.finish() == whole.finish()


# -- counters under threads --------------------------------------------------------------


def _run_threads(target, threads):
    workers = [threading.Thread(target=target, args=(i,)) for i in range(threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update shows
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)


def test_counters_lose_no_count_under_threads():
    """8 threads bump the launch and probe-route counters 10,000 times each
    through their helpers, and 8 threads probe 8 indexes on the host route:
    every count arrives."""
    threads, reps = 8, 10_000
    _build.reset_launches()
    port_fp_index.reset_probe_routes()
    start = threading.Barrier(threads)

    def bump(i):
        start.wait()
        name = ("fp_probe", "fp_insert", "fp_remove", "fingerprint")[i % 4]
        for _ in range(reps):
            _build.count_launch(name)
            port_fp_index.count_probe("table", 3)

    _run_threads(bump, threads)
    assert sum(_build.LAUNCHES.values()) == threads * reps
    assert _build.LAUNCHES["fp_probe"] == 2 * reps
    assert port_fp_index.PROBE_ROUTES["table_calls"] == threads * reps
    assert port_fp_index.PROBE_ROUTES["table_keys"] == 3 * threads * reps

    port_fp_index.reset_probe_routes()
    indexes = [P.FingerprintIndex(range(1, 100), device="cpu") for _ in range(threads)]
    keys = np.arange(1, 9, dtype=np.uint64)

    def probe(i):
        start.wait()
        for _ in range(reps // 10):
            assert indexes[i].contains_many(keys).all()

    _run_threads(probe, threads)
    assert port_fp_index.PROBE_ROUTES["host_calls"] == threads * reps // 10
    assert port_fp_index.PROBE_ROUTES["host_keys"] == 8 * threads * reps // 10
    _build.reset_launches()
    port_fp_index.reset_probe_routes()
    assert sum(_build.LAUNCHES.values()) == 0 and sum(port_fp_index.PROBE_ROUTES.values()) == 0


def test_cluster_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.ShardedCluster(num_shards=2)
    cluster = _cluster(P, 2)
    assert cluster.device == "cpu" and "device" not in cluster._engine_kwargs
    assert all(e.device == "cpu" for e in cluster.shards)
