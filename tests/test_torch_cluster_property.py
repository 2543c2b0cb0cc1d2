"""Hypothesis differential harness: the port's ``ShardedCluster`` against
oracles only — the port's own scalar ``HPDedup``, its scalar cluster path
and a Python set of each key's last write — never against the reference,
whose batched cluster has a known fault on some of these traces (ROADMAP
§3: ``add_many`` after a staged removal).  The shortest traces where the
reference fails are pinned as examples.

Random traces (overwrites, reads, tiny fingerprint spaces, 1-8 shards):

* batched and scalar cluster paths agree, report and per-shard reports;
* ground-truth totals, final blocks and unique fingerprints equal the
  single engine's, and one shard equals it bit for bit;
* live content is the trace's last write per key;
* every shard's store and index pass their consistency checks.
"""

from conftest import require_hypothesis

require_hypothesis()
from hypothesis import example, given, strategies as st  # noqa: E402

import repro_torch.core as P  # noqa: E402
from test_torch_cluster import FAULT_CASES, SHARD_COUNTS, _cluster, _trace_of  # noqa: E402

ops_strategy = st.lists(
    st.tuples(
        st.integers(0, 3),   # stream
        st.integers(0, 1),   # op: write/read
        st.integers(0, 23),  # lba (small space -> overwrites)
        st.integers(1, 40),  # fingerprint (small space -> many dups)
    ),
    min_size=1,
    max_size=300,
)


@given(ops_strategy, st.sampled_from(SHARD_COUNTS), st.sampled_from([1, 16, 64]))
@example(FAULT_CASES[0][2], 1, 1)
@example(FAULT_CASES[1][2], 8, 1)
def test_property_cluster_against_oracles(ops, num_shards, batch_size):
    trace = _trace_of(ops)
    oracle = P.HPDedup(cache_entries=16, device="cpu")
    oracle.replay(trace)
    want = oracle.finish()
    scalar = _cluster(P, num_shards, cache_entries=16)
    scalar.replay(trace)
    scalar_rep = scalar.finish()
    batched = _cluster(P, num_shards, cache_entries=16)
    batched.replay_batched(trace, batch_size=batch_size)
    assert batched.finish() == scalar_rep
    assert batched.shard_reports == scalar.shard_reports
    assert (scalar_rep.total_writes, scalar_rep.total_dup_writes, scalar_rep.final_disk_blocks,
            scalar_rep.unique_fingerprints) == (want.total_writes, want.total_dup_writes,
                                                want.final_disk_blocks, want.unique_fingerprints)
    # live content is the trace's last write per key, as a Python set says
    last = {}
    for stream, op, lba, fp in ops:
        if op == 0:
            last[(stream, lba)] = fp
    for cluster in (scalar, batched):
        assert set().union(*(set(e.store.fp_table) for e in cluster.shards)) == set(last.values())
        cluster.check_consistency()
    if num_shards == 1:
        assert scalar_rep == want
