"""The port's snapshot envelope and online GC against the reference.

* A snapshot taken mid-ingest (``engine_ingest`` / ``ingest_batched``, which
  keep pending duplicate runs open) restores across the two packages in both
  directions: a reference envelope in the port, a port envelope in the
  reference.  Each side finishes the trace with the ``HybridReport`` of the
  uninterrupted run, and the two envelopes' ``json.dumps`` texts are equal.
* Every golden report of ``tests/golden`` loads through the port's
  ``report_from_tree``.
* ``run_gc`` is decision-neutral against a run without GC, and its stats
  dicts equal the reference's, step by step.
* The envelope's version, kind and config guards, and the store's epoch and
  compaction rules, as the reference's own tests state them.

Everything runs with ``device="cpu"`` on traces made from a numpy seed.
"""

import dataclasses
import glob
import json
import os

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.gc import gc_engine as ref_gc_engine
from test_torch_engine import _overwrite_trace, backend  # noqa: F401  (a fixture)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
BATCH = 256
KINDS = ["hpdedup", "idedup", "diode", "postproc", "cluster"]


def _make(pkg, kind, seed=0):
    kw = {"device": "cpu"} if pkg is P else {}
    return {
        "hpdedup": lambda: pkg.HPDedup(cache_entries=256, seed=seed, **kw),
        "idedup": lambda: pkg.make_idedup(cache_entries=256, seed=seed, **kw),
        "diode": lambda: pkg.DIODE(cache_entries=256, seed=seed, **kw),
        "postproc": lambda: pkg.PurePostProcessing(**kw),
        "cluster": lambda: pkg.ShardedCluster(num_shards=4, cache_entries=256, seed=seed, **kw),
    }[kind]()


def _ingest(pkg, engine, trace):
    if isinstance(engine, pkg.ShardedCluster):
        engine.ingest_batched(trace, BATCH)
    else:
        pkg.engine_ingest(engine, trace, BATCH)


def _finish(pkg, engine, trace):
    """Ingest the rest of a trace, flush the pending runs and report."""
    _ingest(pkg, engine, trace)
    if not isinstance(engine, pkg.ShardedCluster):
        pkg.engine_finish_replay(engine)
    return dataclasses.asdict(engine.finish())


@pytest.fixture(scope="module")
def trace():
    return P.generate_workload("B", total_requests=6_000, seed=13)[0]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_envelope_restores_across_packages(trace, kind, direction, backend):
    src, dst = (R, P) if direction == "reference_to_port" else (P, R)
    cut = BATCH * 4 * 3 + 77  # mid-chunk for a single engine: pending runs open
    whole = _make(R, kind)
    want = _finish(R, whole, trace)

    live = _make(src, kind)
    _ingest(src, live, trace[:cut])
    payload = json.dumps(src.snapshot_engine(live))
    kw = {"device": "cpu"} if dst is P else {}
    restored = dst.restore_engine(json.loads(payload), **kw)
    assert json.dumps(dst.snapshot_engine(restored)) == payload
    # the source keeps going too: both finish the trace equal to the whole run
    assert _finish(dst, restored, trace[cut:]) == want
    assert _finish(src, live, trace[cut:]) == want
    assert json.dumps(dst.snapshot_engine(restored)) == json.dumps(src.snapshot_engine(live))


@pytest.mark.parametrize("num_shards", [1, 2, 8])
@pytest.mark.parametrize("kind", ["hpdedup", "diode", "postproc"])
def test_custom_factory_cluster_envelope_equals_reference(trace, kind, num_shards):
    """A cluster of each engine kind through ``engine_factory``: the port's
    tree equals the reference's at the cut, and the restored port cluster
    finishes with the reference's report and per-shard reports."""

    def cluster(pkg):
        return pkg.ShardedCluster(
            num_shards=num_shards, engine_factory=lambda s: _make(pkg, kind, seed=s),
            **({"device": "cpu"} if pkg is P else {}))

    cut = BATCH * num_shards * 5
    ref, mine = cluster(R), cluster(P)
    ref.ingest_batched(trace[:cut], BATCH)
    mine.ingest_batched(trace[:cut], BATCH)
    tree = json.dumps(R.snapshot_engine(ref))
    assert json.dumps(P.snapshot_engine(mine)) == tree
    restored = P.restore_engine(json.loads(tree), device="cpu")
    ref.ingest_batched(trace[cut:], BATCH)
    restored.ingest_batched(trace[cut:], BATCH)
    assert dataclasses.asdict(restored.finish()) == dataclasses.asdict(ref.finish())
    for a, b in zip(restored.shard_reports, ref.shard_reports):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    restored.check_consistency()


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(GOLDEN_DIR, "report_*.json"))),
                         ids=os.path.basename)
def test_golden_reports_load_through_report_from_tree(path):
    with open(path) as f:
        golden = json.load(f)
    mine = P.report_from_tree(golden)
    assert dataclasses.asdict(mine) == dataclasses.asdict(R.report_from_tree(golden))
    assert json.loads(json.dumps(P.report_to_tree(mine))) == golden


def test_report_tree_of_a_run_equals_reference(trace):
    mine = P.HPDedup(cache_entries=128, device="cpu").replay_batched(trace, 512).finish()
    ref = R.HPDedup(cache_entries=128).replay_batched(trace, 512).finish()
    assert json.dumps(P.report_to_tree(mine)) == json.dumps(R.report_to_tree(ref))


@pytest.mark.parametrize("max_moves", [None, 64])
@pytest.mark.parametrize("kind", ["hpdedup", "idedup"])
def test_run_gc_is_decision_neutral_and_stats_equal_reference(kind, max_moves, backend):
    trace = _overwrite_trace()
    n = len(trace)
    step = n // 5 + 1
    nogc = _make(P, kind)
    want = _finish(P, nogc, trace)
    ref, mine = _make(R, kind), _make(P, kind)
    for lo in range(0, n, step):
        for pkg, eng in ((R, ref), (P, mine)):
            pkg.engine_ingest(eng, trace[lo:lo + step], BATCH)
        ref_stats = ref.run_gc(max_moves=max_moves)
        assert mine.run_gc(max_moves=max_moves) == ref_stats
    assert mine.store.relocated_blocks == ref.store.relocated_blocks > 0
    assert _finish(P, mine, trace[:0]) == want
    assert _finish(R, ref, trace[:0]) == want
    mine.store.check_consistency()
    assert json.dumps(P.snapshot_engine(mine)) == json.dumps(R.snapshot_engine(ref))


def test_run_gc_with_merges_equals_reference():
    """``max_merges`` runs a post-process window: schedule-visible, but the
    same schedule gives the reference's stats and report."""
    trace = _overwrite_trace(seed=4)
    ref, mine = _make(R, "hpdedup"), _make(P, "hpdedup")
    for lo in range(0, len(trace), 1_500):
        for pkg, eng in ((R, ref), (P, mine)):
            pkg.engine_ingest(eng, trace[lo:lo + 1_500], BATCH)
        assert mine.run_gc(max_moves=32, max_merges=16) == ref.run_gc(max_moves=32, max_merges=16)
    assert _finish(P, mine, trace[:0]) == _finish(R, ref, trace[:0])


def test_gc_engine_on_each_engine_kind_equals_reference():
    trace = _overwrite_trace(seed=8)
    for kind in ("hpdedup", "diode", "postproc"):
        ref, mine = _make(R, kind), _make(P, kind)
        for lo in range(0, len(trace), 2_000):
            for pkg, eng in ((R, ref), (P, mine)):
                pkg.engine_ingest(eng, trace[lo:lo + 2_000], BATCH)
            assert P.gc_engine(mine, max_moves=50) == ref_gc_engine(ref, max_moves=50), kind
        assert _finish(P, mine, trace[:0]) == _finish(R, ref, trace[:0]), kind


def test_gc_never_resurrects_stale_cache_pair_on_reused_slot():
    """The resurrect-pin: compaction refills a freed slot with matching
    content; a cache pair still naming the slot must stay stale."""
    eng = P.HPDedup(cache_entries=64, adaptive_threshold=False, fixed_threshold=1, device="cpu")
    eng.write(0, 0, 0xAA)
    eng.write(0, 1, 0xBB)
    eng.write(0, 0, 0xCC)  # pba 0 freed; cache pair (0xAA -> 0) now stale
    eng.inline.flush()
    assert eng.run_gc()["moved"] == 1
    before = eng.inline.metrics.inline_dups
    eng.write(0, 5, 0xAA)
    eng.inline.flush()
    assert eng.inline.metrics.inline_dups == before
    eng.store.check_consistency()
    assert eng.store.fp_of_pba[eng.store.read(0, 5)] == 0xAA


def test_epoch_pin_parks_free_in_limbo_until_drain():
    store = P.BlockStore(device="cpu")
    store.deferred_reclaim = True
    events = []
    store.on_free = lambda pba: events.append((pba, store.freed_blocks))
    p1 = store.write_new_block(0, 1, 0xF1)
    tag = store.pin_epoch()
    store.unmap(0, 1)
    assert store.live_blocks == 0 and not store.has_fp(0xF1)
    assert store.freed_blocks == 0 and events == [] and store._limbo == [(0, p1)]
    store.advance_epoch()
    assert store.collect_limbo() == 0
    store.unpin_epoch(tag)
    assert store.collect_limbo() == 1
    assert events == [(p1, 1)] and store._free_pbas == [p1]
    assert store.collect_limbo(force=True) == 0
    store.check_consistency()


def test_compact_closes_holes_like_reference():
    stores = [P.BlockStore(device="cpu"), R.BlockStore()]
    out = []
    for store in stores:
        for i in range(8):
            store.write_new_block(0, i, 0xA0 + (i % 3))
        for lba in (1, 3, 7):
            store.unmap(0, lba)
        moves = []
        store.on_relocate = lambda old, new, moves=moves: moves.append((old, new))
        out.append((store.compact(max_moves=1), store.compact(), moves, store._next_pba,
                    json.dumps(store.snapshot())))
        store.check_consistency()
    assert out[0] == out[1]


def test_snapshot_mid_pending_run_state():
    engine = P.HPDedup(cache_entries=512, adaptive_threshold=False, fixed_threshold=4,
                       device="cpu")
    engine.write(0, 0, 42)
    engine.write(0, 1, 43)
    engine.write(1, 0, 42)  # cache hit -> pending run on stream 1
    tree = P.snapshot_engine(engine)
    assert tree["state"]["inline"]["pending"]
    restored = P.restore_engine(json.loads(json.dumps(tree)), device="cpu")
    assert restored.inline._pending.keys() == engine.inline._pending.keys()
    assert restored.finish() == engine.finish()


def test_load_engine_state_keeps_identity_and_hooks(trace):
    ref = R.HPDedup(cache_entries=128)
    R.engine_ingest(ref, trace[:BATCH * 4], BATCH)
    tree = json.loads(json.dumps(R.snapshot_engine(ref)))
    target = P.HPDedup(cache_entries=128, device="cpu")
    freed = []
    target.store.on_free = freed.append
    store_id, cache_id = id(target.store), id(target.inline.cache)
    P.load_engine_state(target, tree)
    assert id(target.store) == store_id and id(target.inline.cache) == cache_id
    assert target.store.on_free is not None
    assert _finish(P, target, trace[BATCH * 4:]) == _finish(R, ref, trace[BATCH * 4:])


def test_envelope_guards():
    engine = P.HPDedup(cache_entries=16, device="cpu")
    tree = P.snapshot_engine(engine)
    assert (tree["format"], tree["version"]) == (R.SNAPSHOT_FORMAT, R.SNAPSHOT_VERSION)
    for version in (tree["version"] + 1, 1):
        with pytest.raises(ValueError, match="version"):
            P.restore_engine(dict(tree, version=version), device="cpu")
    with pytest.raises(ValueError, match="not a"):
        P.restore_engine({"bogus": True}, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        P.load_engine_state(P.PurePostProcessing(device="cpu"), tree)
    with pytest.raises(TypeError, match="no snapshot support"):
        P.snapshot_engine(object())
    big = json.loads(json.dumps(P.snapshot_engine(P.HPDedup(cache_entries=8192, device="cpu"))))
    with pytest.raises(ValueError, match="config"):
        P.check_engine_compatible(P.HPDedup(cache_entries=1024, device="cpu"), big)


def test_cluster_load_snapshot_rejects_without_mutating(trace):
    donor = P.ShardedCluster(num_shards=2, cache_entries=32, device="cpu")
    donor.ingest_batched(trace[:BATCH * 4], BATCH)
    tree = json.loads(json.dumps(P.snapshot_engine(donor)))
    target = P.ShardedCluster(num_shards=2, cache_entries=16, device="cpu")
    target.ingest_batched(trace[BATCH * 4:BATCH * 8], BATCH)
    before = json.dumps(P.snapshot_engine(target))
    with pytest.raises(ValueError, match="config"):
        P.load_engine_state(target, tree)
    assert json.dumps(P.snapshot_engine(target)) == before
    with pytest.raises(ValueError, match="shards"):
        P.load_engine_state(P.ShardedCluster(num_shards=4, cache_entries=32, device="cpu"), tree)
    with pytest.raises(ValueError, match="pba_stride"):
        P.load_engine_state(
            P.ShardedCluster(num_shards=2, cache_entries=32, pba_stride=1 << 20, device="cpu"),
            tree)
    truncated = json.loads(json.dumps(tree))
    truncated["state"]["shards"] = truncated["state"]["shards"][:1]
    with pytest.raises(ValueError, match="corrupt"):
        P.restore_engine(truncated, device="cpu")


def test_tree_holds_plain_json_types_only(trace):
    """No device, tensor or numpy scalar reaches a tree: ``json.dumps``
    takes it as is and gives the reference's text."""
    mine = P.ShardedCluster(num_shards=2, cache_entries=64, device=torch.device("cpu"),
                            replication_factor=2)
    ref = R.ShardedCluster(num_shards=2, cache_entries=64, replication_factor=2)
    mine.ingest_batched(trace[:2_000], BATCH)
    ref.ingest_batched(trace[:2_000], BATCH)

    def walk(node):
        if isinstance(node, dict):
            assert all(type(k) in (str, int) for k in node)  # json.dumps writes int keys
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            assert node is None or type(node) in (bool, int, float, str), type(node)

    tree = P.snapshot_engine(mine)
    walk(tree)
    assert "device" not in tree["state"]["config"]["engine_kwargs"]
    assert json.dumps(tree) == json.dumps(R.snapshot_engine(ref))


def test_restore_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tree = P.snapshot_engine(P.HPDedup(cache_entries=16, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        P.restore_engine(tree)
