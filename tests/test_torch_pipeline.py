"""The port's ingest pipeline (``repro_torch.data.pipeline``) against the
reference's, on the CPU (``device="cpu"``) at small sizes.

Which cases are bit for bit and which carry a tolerance:

* ``TenantStream`` blocks and ``ops.fingerprint_ints`` equal the
  reference's bit for bit (the reference's Pallas kernel in interpret mode).
* With a cache large enough that nothing is evicted, the estimator decides
  nothing, so batches, ``PipelineMetrics`` and the ``block_content`` keys
  equal the reference's bit for bit, and ``state_dict()`` trees are equal
  except the estimator's float fields, which the port's float32 torch
  solver (``use_jax_estimator=True``) gives within 1e-3 relative of the JAX
  solver's, and the ``pools`` key only the port writes.
* Under a contended cache the estimator decides evictions: the dedup
  saving (inline ratio) is held within 0.02 of the reference's.
* The reference's own pipeline tests (state round trip, cluster-backed
  ingest, crash restore, periodic snapshots) run on the port; sharded ingest
  with and without shard worker threads, and crash-restore continuations,
  are held to the port's uninterrupted serial run bit for bit.
* The reference's checkpoint leaves out the overlap groups' shared content
  pools, so a restored tenant of a group leaves the uninterrupted stream
  (ROADMAP §3).  The port saves them: pinned below with the training
  launcher's tenant mix.
"""

from __future__ import annotations

import json

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
import numpy as np
import pytest
import torch

import repro.data.pipeline as RP
import repro.kernels.ops as ref_ops
from repro_torch.core import ShardedCluster
from repro_torch.data import DedupIngestPipeline, PipelineMetrics, TenantSpec, TenantStream
from repro_torch.kernels import ops

# ``launch/train.py``'s ``default_tenants()``: mail-, ftp- and web-like
# tenants, two of them in one overlap group
DEFAULT_TENANTS = [
    dict(tenant_id=0, rate=3.0, dup_ratio=0.8, locality="good", overlap_group="g"),
    dict(tenant_id=1, rate=2.0, dup_ratio=0.15, locality="weak", overlap_group="g"),
    dict(tenant_id=2, rate=1.0, dup_ratio=0.5, locality="good"),
    dict(tenant_id=3, rate=0.5, dup_ratio=0.3, locality="good"),
]
LDSS_RTOL = 1e-3
RATIO_TOL = 0.02


def _pipes(tenants, **kw):
    """The port's and the reference's pipeline on the same tenants."""
    mine = DedupIngestPipeline([TenantSpec(**t) for t in tenants], device="cpu", **kw)
    ref = RP.DedupIngestPipeline([RP.TenantSpec(**t) for t in tenants], **kw)
    return mine, ref


def _equal_batches(a, b):
    for key in ("inputs", "targets", "mask"):
        np.testing.assert_array_equal(a[key], b[key])


def _close_trees(a, b, path="", float_rtol=0.0):
    """Equal JSON trees, floats within ``float_rtol`` relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _close_trees(a[k], b[k], f"{path}/{k}", float_rtol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_trees(x, y, f"{path}[{i}]", float_rtol)
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= float_rtol * max(abs(a), abs(b)), (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# -- the reference's pipeline tests, on the port ------------------------------------


def test_pipeline_dedups_and_shapes():
    pipe = DedupIngestPipeline(
        [TenantSpec(0, dup_ratio=0.7, locality="good"), TenantSpec(1, dup_ratio=0.1, locality="weak")],
        block_tokens=32, vocab=1000, cache_entries=512, fingerprint_batch=16, device="cpu",
    )
    b = next(pipe.batches(batch_size=2, seq_len=64))
    assert b["inputs"].shape == (2, 64) and b["targets"].shape == (2, 64)
    for _ in range(20):
        next(pipe.batches(batch_size=2, seq_len=64))
    assert pipe.metrics.blocks_deduped_inline > 0
    assert pipe.metrics.dedup_saving > 0.15


def test_pipeline_state_roundtrip_reproduces_batches():
    def mk():
        return DedupIngestPipeline(
            [TenantSpec(0, dup_ratio=0.5), TenantSpec(1, dup_ratio=0.2)],
            block_tokens=16, vocab=500, cache_entries=128, fingerprint_batch=8, seed=3,
            device="cpu",
        )

    p1 = mk()
    it1 = p1.batches(2, 32)
    for _ in range(5):
        next(it1)
    state = p1.state_dict()
    a = next(it1)

    p2 = mk()
    it2 = p2.batches(2, 32)
    for _ in range(5):
        next(it2)
    p2.load_state(state)
    b = next(p2.batches(2, 32))
    np.testing.assert_array_equal(a["inputs"], b["inputs"])


def test_pipeline_cluster_backed_ingest():
    def mk():
        return DedupIngestPipeline(
            [TenantSpec(0, dup_ratio=0.7), TenantSpec(1, dup_ratio=0.3)],
            block_tokens=16, vocab=500, cache_entries=512, fingerprint_batch=16,
            num_shards=4, seed=3, device="cpu",
        )

    p1 = mk()
    assert isinstance(p1.engine, ShardedCluster)
    assert all(e.device == "cpu" for e in p1.engine.shards)
    it1 = p1.batches(2, 32)
    for _ in range(8):
        next(it1)
    assert p1.metrics.blocks_deduped_inline > 0
    state = p1.state_dict()
    assert len(state["estimator"]) == 4
    a = next(it1)

    p2 = mk()
    it2 = p2.batches(2, 32)
    for _ in range(8):
        next(it2)
    p2.load_state(state)
    b = next(p2.batches(2, 32))
    np.testing.assert_array_equal(a["inputs"], b["inputs"])


@pytest.mark.parametrize("num_shards", [1, 4])
def test_pipeline_crash_restore_continues_bit_exact(num_shards):
    """A fresh pipeline restored from a JSON-round-tripped state dict
    continues the uninterrupted run's batch stream bit for bit."""

    def mk():
        return DedupIngestPipeline(
            [TenantSpec(0, dup_ratio=0.6), TenantSpec(1, dup_ratio=0.2)],
            block_tokens=16, vocab=500, cache_entries=256, fingerprint_batch=8,
            num_shards=num_shards, seed=5, device="cpu",
        )

    ref = mk()
    it_ref = ref.batches(2, 32)
    for _ in range(5):
        next(it_ref)
    expected = [next(it_ref) for _ in range(3)]  # uninterrupted batches 6-8

    live = mk()
    it_live = live.batches(2, 32)
    for _ in range(5):
        next(it_live)
    payload = json.dumps(live.state_dict())  # checkpoints are serializable
    del live, it_live  # the crash

    cold = mk()
    cold.load_state(json.loads(payload))
    it_cold = cold.batches(2, 32)
    for exp in expected:
        _equal_batches(exp, next(it_cold))
    assert cold.metrics == ref.metrics


def test_pipeline_periodic_snapshots_flow():
    def mk():
        return DedupIngestPipeline(
            [TenantSpec(0, dup_ratio=0.5)], block_tokens=16, vocab=300, cache_entries=128,
            fingerprint_batch=8, snapshot_every_blocks=16, seed=2, device="cpu",
        )

    pipe = mk()
    it = pipe.batches(2, 32)
    while pipe.last_snapshot is None:
        next(it)
    first_at = pipe.last_snapshot["metrics"]["blocks_in"]
    for _ in range(6):
        next(it)
    assert pipe.last_snapshot["metrics"]["blocks_in"] > first_at  # refreshed
    cold = mk()
    cold.load_state(pipe.last_snapshot)
    next(cold.batches(2, 32))  # resumes without error
    assert cold.metrics.blocks_in > first_at


# -- bit for bit against the reference --------------------------------------------


@pytest.mark.parametrize("skew,vocab,width", [(1.2, 700, 32), (0.0, 700, 32), (1.2, 32000, 256)],
                         ids=["zipf-tokens", "uniform-tokens", "zipf-tokens-ingest-size"])
def test_tenant_stream_blocks_equal_reference(skew, vocab, width):
    """Every locality, an overlap group, both token distributions (and the
    ingest phase's 32,000-token vocabulary and 256-token blocks): the same
    seed gives the reference's blocks, and the same state trees."""
    probs = None
    if skew:
        probs = 1.0 / np.arange(1, vocab + 1) ** skew
        probs /= probs.sum()
    specs = [dict(tenant_id=0, dup_ratio=0.6, locality="good", overlap_group="g"),
             dict(tenant_id=1, dup_ratio=0.4, locality="weak", overlap_group="g",
                  overlap_prob=0.5),
             dict(tenant_id=2, dup_ratio=0.3, locality="weak")]
    mine_pools, ref_pools = {}, {}
    mine = [TenantStream(TenantSpec(**s), width, vocab, 9 + i, mine_pools, probs)
            for i, s in enumerate(specs)]
    ref = [RP.TenantStream(RP.TenantSpec(**s), width, vocab, 9 + i, ref_pools, probs)
           for i, s in enumerate(specs)]
    order = np.random.default_rng(4).integers(0, len(specs), size=900)
    for i in order:
        a, b = mine[i].next_block(), ref[i].next_block()
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mine, ref):
        assert json.dumps(a.state_dict()) == json.dumps(b.state_dict())


@pytest.mark.parametrize("block_tokens", [16, 32, 256])
def test_fingerprint_ints_equal_reference(block_tokens):
    rng = np.random.default_rng(block_tokens)
    blocks = rng.integers(0, 32000, size=(64, block_tokens), dtype=np.int32)
    blocks[0] = 0
    blocks[1] = 31999
    blocks[2] = blocks[3]  # equal content, equal fingerprint
    got = ops.fingerprint_ints(blocks, device="cpu")
    want = np.asarray(ref_ops.fingerprint_ints(blocks))
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert got[2] == got[3] and np.unique(got).size == 63


def test_whole_pipeline_equals_reference_when_nothing_is_evicted():
    """Bit for bit where the estimator decides nothing (the cache holds
    every fingerprint): batches, metrics, ``block_content`` keys; the state
    trees up to the estimator's floats (1e-3 relative) and ``pools``."""
    mine, ref = _pipes(DEFAULT_TENANTS, block_tokens=16, vocab=500, cache_entries=1 << 16,
                       fingerprint_batch=16, postprocess_every_blocks=256, seed=4)
    for _ in range(60):
        _equal_batches(mine.next_batch(2, 64), ref.next_batch(2, 64))
    assert mine.metrics == PipelineMetrics(**vars(ref.metrics))
    assert mine.metrics.blocks_deduped_inline > 0
    assert sorted(mine.block_content) == sorted(ref.block_content)
    for fp, block in ref.block_content.items():
        np.testing.assert_array_equal(mine.block_content[fp], block)
    tree = json.loads(json.dumps(mine.state_dict()))
    want = json.loads(json.dumps(ref.state_dict()))
    assert sorted(tree.pop("pools")) == ["g"]
    assert tree["engine"]["state"]["config"] == want["engine"]["state"]["config"]
    _close_trees(tree, want, float_rtol=LDSS_RTOL)


def test_pipeline_under_contended_cache_within_ratio_tolerance():
    """A 64-entry cache over four tenants: the estimator's float32 LDSS
    decides evictions, so admitted blocks may differ; the dedup saving stays
    within 0.02 of the reference's."""
    mine, ref = _pipes(DEFAULT_TENANTS, block_tokens=16, vocab=500, cache_entries=64,
                       fingerprint_batch=16, postprocess_every_blocks=256, seed=6)
    for _ in range(120):
        mine.next_batch(2, 64)
        ref.next_batch(2, 64)
    assert mine.metrics.blocks_in > 1500
    assert abs(mine.metrics.dedup_saving - ref.metrics.dedup_saving) < RATIO_TOL


# -- the port's own invariants ----------------------------------------------------


def _run(pipe, n, batch=(2, 64)):
    return [pipe.next_batch(*batch) for _ in range(n)]


def test_sharded_ingest_with_and_without_worker_threads():
    """Four shards with the shard worker threads (fanned out on every batch)
    and without them: the same batches, metrics and engine trees."""
    kw = dict(block_tokens=16, vocab=500, cache_entries=256, fingerprint_batch=16,
              num_shards=4, seed=8, device="cpu")
    tenants = [TenantSpec(**t) for t in DEFAULT_TENANTS]
    serial = DedupIngestPipeline(tenants, **kw)
    workers = DedupIngestPipeline(tenants, parallel_shards=True, **kw)
    workers.engine.min_parallel_batch = 0  # fan out even the 16-block batches
    try:
        for a, b in zip(_run(serial, 40), _run(workers, 40)):
            _equal_batches(a, b)
        assert serial.metrics == workers.metrics
        assert json.dumps(serial.state_dict()) == json.dumps(workers.state_dict())
    finally:
        workers.engine.stop_executor()


@pytest.mark.parametrize("num_shards", [1, 4])
def test_crash_restore_with_overlap_groups_continues_bit_exact(num_shards):
    """The training launcher's tenant mix (two tenants share a content
    pool): the port's restored pipeline continues the uninterrupted run bit
    for bit; the reference's leaves it (its checkpoint has no pools)."""
    kw = dict(block_tokens=16, vocab=500, cache_entries=256, fingerprint_batch=8,
              num_shards=num_shards, seed=5)
    mine, ref = _pipes(DEFAULT_TENANTS, **kw)
    mine_live, ref_live = _pipes(DEFAULT_TENANTS, **kw)
    _run(mine, 5), _run(ref, 5), _run(mine_live, 5), _run(ref_live, 5)
    want_mine, want_ref = _run(mine, 8), _run(ref, 8)
    mine_cold, ref_cold = _pipes(DEFAULT_TENANTS, **kw)
    mine_cold.load_state(json.loads(json.dumps(mine_live.state_dict())))
    ref_cold.load_state(json.loads(json.dumps(ref_live.state_dict())))
    for a, b in zip(want_mine, _run(mine_cold, 8)):
        _equal_batches(a, b)
    assert mine_cold.metrics == mine.metrics
    diverged = [not all(np.array_equal(a[k], b[k]) for k in a)
                for a, b in zip(want_ref, _run(ref_cold, 8))]
    assert any(diverged)


def test_reference_checkpoint_loads_into_the_port():
    """A tree the reference wrote (no ``pools``) loads into the port, which
    then continues as the reference's restored pipeline does, bit for bit,
    with a cache that evicts nothing."""
    kw = dict(block_tokens=16, vocab=500, cache_entries=1 << 16, fingerprint_batch=8, seed=3)
    tenants = [dict(tenant_id=0, dup_ratio=0.5), dict(tenant_id=1, dup_ratio=0.2)]
    _, ref = _pipes(tenants, **kw)
    _run(ref, 6)
    payload = json.dumps(ref.state_dict())
    mine_cold, ref_cold = _pipes(tenants, **kw)
    mine_cold.load_state(json.loads(payload))
    ref_cold.load_state(json.loads(payload))
    for a, b in zip(_run(mine_cold, 4), _run(ref_cold, 4)):
        _equal_batches(a, b)
    assert mine_cold.metrics == PipelineMetrics(**vars(ref_cold.metrics))


@pytest.mark.parametrize("num_shards", [1, 4])
def test_legacy_estimator_only_checkpoint(num_shards):
    """The pre-snapshot checkpoint form (estimator state only) loads; a
    checkpoint with another shard count is refused."""
    kw = dict(block_tokens=16, vocab=500, cache_entries=128, fingerprint_batch=8, seed=1,
              device="cpu")
    tenants = [TenantSpec(0, dup_ratio=0.5), TenantSpec(1, dup_ratio=0.2)]
    src = DedupIngestPipeline(tenants, num_shards=num_shards, **kw)
    _run(src, 6)
    legacy = json.loads(json.dumps(src.state_dict()))
    del legacy["engine"], legacy["pools"]
    if num_shards == 1:
        legacy["estimator"] = legacy["estimator"][0]  # the single-engine form
    dst = DedupIngestPipeline(tenants, num_shards=num_shards, **kw)
    dst.load_state(legacy)
    assert dst.metrics == src.metrics
    assert [e.state_dict() for e in dst._estimators()] == \
        [e.state_dict() for e in src._estimators()]
    other = DedupIngestPipeline(tenants, num_shards=2 if num_shards == 1 else 1, **kw)
    with pytest.raises(ValueError, match="same num_shards"):
        other.load_state(legacy)


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        DedupIngestPipeline([TenantSpec(0)], block_tokens=16, vocab=100)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        ops.fingerprint_ints(np.zeros((2, 16), dtype=np.int32))
