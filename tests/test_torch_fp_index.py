"""The port's fingerprint index against the reference.

* The layout helpers and the home-slot hash equal the reference's.
* The plain probe/insert/remove equal the reference's Pallas kernels (in
  interpret mode) bit for bit: tables and statuses.
* Random op sequences give the same membership, ``len`` and spill as
  ``repro.core.fp_index.FingerprintIndex`` on both port backends, on the CPU.
* On every table the plain insert and the numpy backend build, no key and
  no tombstone lies past an EMPTY slot of its window, so the early-stop
  probes equal the whole-window plain probe (sentinel keys included).
* Membership equals a plain set's on both backends (hypothesis), including
  ``discard`` then ``add_many`` of a key still in the table, where the
  reference answers "absent", and ``add``, ``add_many`` then ``discard`` of
  one key, where it answers "present" (ROADMAP, faults found against the
  reference); then ``add`` of that key again after an ``add_many`` of
  another.

The CUDA kernels are held against these plain versions in
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fp_index import FingerprintIndex as RefIndex
from repro.kernels import fp_index as ref_k
from repro.kernels import ops as ref_ops
from repro_torch.core.fp_index import EMPTY_KEY, TOMB_KEY, FingerprintIndex
from repro_torch.kernels import fp_index as k

from conftest import require_hypothesis

require_hypothesis()
from hypothesis import example, given  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


def _keys(rng, n):
    return rng.integers(1, 2**64 - 1, size=n, dtype=np.uint64)


def _t(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64))


def test_layout_helpers_match_reference():
    rng = np.random.default_rng(0)
    lo = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
    hi = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
    np.testing.assert_array_equal(k.slot_hash_host(lo, hi), ref_k.slot_hash_host(lo, hi))
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    for cap in (16, 1024, 1 << 15, 1 << 17):
        assert k.tile_shape(cap) == ref_k.tile_shape(cap)
        assert k.table_phys_len(cap) == ref_k.table_phys_len(cap)
        home = rng.integers(0, cap, size=512)
        np.testing.assert_array_equal(k.phys_slots(home, cap), ref_k.phys_slots(home, cap))
        # the torch hash and the host hash pick the same physical homes
        want = ref_k.phys_slots((ref_k.slot_hash_host(lo, hi) & np.uint32(cap - 1))
                                .astype(np.int64), cap)
        np.testing.assert_array_equal(k._windows(_t(keys), cap)[0].numpy(), want)
        np.testing.assert_array_equal(k.phys_homes_host(keys, cap), want)
    with pytest.raises(ValueError):
        k.tile_shape(100)


class _PallasTable:
    """The reference kernels (interpret mode) over their tiled lane arrays."""

    def __init__(self, cap):
        t, _, tile_phys = ref_k.tile_shape(cap)
        self.lo = jnp.zeros((t, tile_phys), jnp.uint32)
        self.hi = jnp.zeros((t, tile_phys), jnp.uint32)

    @staticmethod
    def _split(keys):
        return ((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (keys >> np.uint64(32)).astype(np.uint32))

    def insert(self, keys):
        self.lo, self.hi, st = ref_ops.fp_index_insert(*self._split(keys), self.lo, self.hi,
                                                       interpret=True)
        return st

    def remove(self, keys):
        self.lo, self.hi, st = ref_ops.fp_index_remove(*self._split(keys), self.lo, self.hi,
                                                       interpret=True)
        return st

    def probe(self, keys):
        return ref_ops.fp_index_probe(*self._split(keys), self.lo, self.hi, interpret=True)

    def t64(self):
        lo = np.asarray(self.lo).astype(np.uint64).reshape(-1)
        hi = np.asarray(self.hi).astype(np.uint64).reshape(-1)
        return (hi << np.uint64(32)) | lo


@pytest.mark.parametrize("cap,n", [(64, 80), (1024, 300), (1 << 16, 300)])
def test_plain_kernels_match_pallas_bit_for_bit(cap, n):
    """One-tile tables (64 forces window overflow) and a two-tile table:
    inserts with in-batch duplicates, removals, tombstone reuse, probes."""
    rng = np.random.default_rng(cap)
    ref = _PallasTable(cap)
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64)

    def same_table():
        np.testing.assert_array_equal(table.numpy().view(np.uint64), ref.t64())

    a = _keys(rng, n)
    a = np.concatenate([a, a[: n // 8]])  # later copies of earlier keys
    np.testing.assert_array_equal(k.fp_insert_torch(_t(a), table, cap).numpy(), ref.insert(a))
    same_table()
    gone = a[: n // 3]
    np.testing.assert_array_equal(k.fp_remove_torch(_t(gone), table, cap).numpy(),
                                  ref.remove(gone))
    same_table()
    b = np.concatenate([_keys(rng, n // 2), a[n // 3: n // 2], gone[: n // 6]])
    st = k.fp_insert_torch(_t(b), table, cap).numpy()
    np.testing.assert_array_equal(st, ref.insert(b))
    assert (st == k.PLACED_TOMB).any()  # tombstones were reused
    same_table()
    probe = np.concatenate([a, b, _keys(rng, n)])
    np.testing.assert_array_equal(k.fp_probe_torch(_t(probe), table, cap).numpy(),
                                  ref.probe(probe))


def _ops_sequence(indexes, steps, seed):
    """Drive every index through the same random op sequence and hold the
    port's against the first (the reference's) after every step."""
    rng = np.random.default_rng(seed)
    ref = indexes[0]
    for step in range(steps):
        op = int(rng.integers(0, 6))
        if op <= 1:
            ks = _keys(rng, int(rng.integers(1, 200)))
            if step % 5 == 0:  # the sentinel keys spill on every path
                ks[0] = EMPTY_KEY if step % 2 else TOMB_KEY
            for idx in indexes:
                if step % 3 == 0:
                    idx.add_many(ks)
                else:
                    for key in ks.tolist():
                        idx.add(key)
        elif op == 2 and len(ref):
            pool = np.fromiter(ref, dtype=np.uint64, count=len(ref))
            ks = rng.choice(pool, size=min(40, pool.size), replace=False)
            for idx in indexes:
                if step % 2:
                    idx.remove_many(ks)
                else:
                    for key in ks.tolist():
                        idx.discard(key)
        elif op == 3:
            uniq = np.unique(np.concatenate(
                [_keys(rng, 64), np.fromiter(ref, dtype=np.uint64, count=len(ref))[:32]]))
            flags = [idx.probe_and_add(uniq) for idx in indexes]
            for f in flags[1:]:
                np.testing.assert_array_equal(f, flags[0])
        else:
            probe = _keys(rng, 128)
            if len(ref):
                pool = np.fromiter(ref, dtype=np.uint64, count=len(ref))
                probe[:32] = rng.choice(pool, size=min(32, pool.size))
            probe[32] = EMPTY_KEY
            probe[33] = TOMB_KEY
            want = ref.contains_many(probe)
            for idx in indexes[1:]:
                np.testing.assert_array_equal(idx.contains_many(probe), want)
        for idx in indexes[1:]:
            assert len(idx) == len(ref)
            assert set(idx) == set(ref)
            assert idx.spilled() == ref.spilled()
        if step % 20 == 0:
            for idx in indexes:
                idx.check_consistency()
    for idx in indexes:
        idx.check_consistency()
    for idx in indexes[1:]:
        assert idx._spill == ref._spill


def test_numpy_backend_matches_reference_numpy():
    """Tiny capacity: growth, tombstone rebuilds and window overflow all
    trigger; the verbatim numpy path spills exactly the reference's keys."""
    _ops_sequence([RefIndex(capacity=128, small_batch=0, backend="numpy"),
                   FingerprintIndex(capacity=128, small_batch=0, backend="numpy",
                                    device="cpu")], steps=250, seed=7)


def test_torch_backend_matches_reference_pallas():
    """The torch backend on the CPU runs the plain kernels, whose layout is
    the reference kernels': membership, ``len`` and spill all agree."""
    _ops_sequence([RefIndex(capacity=128, small_batch=0, backend="pallas"),
                   FingerprintIndex(capacity=128, small_batch=0, backend="torch",
                                    device="cpu")], steps=40, seed=11)


def _same_home_keys(cap, count, seed=0):
    """``count`` keys that all hash to one home slot at capacity ``cap``."""
    rng = np.random.default_rng(seed)
    cand = _keys(rng, cap * (count + 8))
    home = k.phys_homes_host(cand, cap)
    target = np.bincount(home).argmax()
    picked = cand[home == target][:count]
    assert picked.size == count
    return picked


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_forced_window_overflow_spills(backend):
    keys = _same_home_keys(4096, k.WINDOW + 4)
    idx = FingerprintIndex(small_batch=0, backend=backend, device="cpu")
    idx.add_many(keys)
    assert idx.contains_many(keys).all()
    assert idx.spilled() == 4  # the window holds 16, the rest spill
    idx.check_consistency()
    idx.remove_many(keys[-6:])
    assert not idx.contains_many(keys[-6:]).any()
    assert idx.contains_many(keys[:-6]).all()
    idx.check_consistency()


def test_probe_routes_count_host_and_table_probes():
    from repro_torch.core import fp_index as core_fp_index

    idx = FingerprintIndex(np.arange(1, 100, dtype=np.uint64).tolist(), small_batch=8,
                           device="cpu")
    core_fp_index.reset_probe_routes()
    assert idx.contains_many(np.arange(1, 9, dtype=np.uint64)).all()  # 8 keys: host set
    assert idx.contains_many(np.arange(90, 110, dtype=np.uint64)).sum() == 10  # table
    idx.contains_many(np.zeros(0, dtype=np.uint64))  # empty: neither
    assert core_fp_index.PROBE_ROUTES == {
        "host_calls": 1, "host_keys": 8, "table_calls": 1, "table_keys": 20,
    }
    core_fp_index.reset_probe_routes()
    assert set(core_fp_index.PROBE_ROUTES.values()) == {0}
    # the host-set threshold is the host path's crossover on the CPU
    assert FingerprintIndex(device="cpu").small_batch == core_fp_index.SMALL_BATCH


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FingerprintIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        FingerprintIndex(backend="numpy", device="cuda")


def test_wrappers_reject_bad_tables():
    keys = _t(np.arange(1, 5, dtype=np.uint64))
    with pytest.raises(ValueError):
        k.fp_probe(keys, torch.zeros(100, dtype=torch.int64), 64)
    with pytest.raises(TypeError):
        k.fp_insert(keys.to(torch.int32), torch.zeros(k.table_phys_len(64), dtype=torch.int64),
                    64)


def _track_tombstones(before, after, tomb_homes, cap):
    """Record the home of the key each new tombstone replaced; forget
    tombstones that a key took again."""
    changed = np.nonzero(before != after)[0]
    tomb = np.uint64(TOMB_KEY)
    for s in changed.tolist():
        if after[s] == tomb:
            tomb_homes[s] = int(k.phys_homes_host(before[s:s + 1], cap)[0])
        else:
            tomb_homes.pop(s, None)


def _assert_nothing_past_empty(t64, tomb_homes, cap):
    """No key, and no tombstone, lies past a slot of its window that is EMPTY."""
    empties = np.concatenate([[0], np.cumsum(t64 == 0)])
    occupied = np.nonzero((t64 != 0) & (t64 != np.uint64(TOMB_KEY)))[0]
    slots = np.concatenate([occupied, np.fromiter(tomb_homes, dtype=np.int64)])
    homes = np.concatenate([k.phys_homes_host(t64[occupied], cap),
                            np.fromiter(tomb_homes.values(), dtype=np.int64)])
    assert ((slots >= homes) & (slots < homes + k.WINDOW)).all()
    assert (empties[slots] - empties[homes] == 0).all()


def _probe_batch(rng, t64):
    """Every resident key, absent keys, and both sentinels."""
    resident = t64[(t64 != 0) & (t64 != np.uint64(TOMB_KEY))]
    sentinels = np.array([EMPTY_KEY, TOMB_KEY], dtype=np.uint64)
    return np.concatenate([resident, _keys(rng, 300), sentinels])


@pytest.mark.parametrize("built_by", ["plain", "numpy"])
@pytest.mark.parametrize("cap,seed", [(64, 0), (1024, 1), (1 << 16, 2)])
def test_early_stop_invariant_on_built_tables(built_by, cap, seed):
    """The invariant the early-stop probes (``probe_host`` and the CUDA probe
    and remove) rest on, over seeded random inserts and removes on tables
    built by the plain ``fp_insert_torch`` and by the numpy backend's
    ``_table_insert``: no key and no tombstone lies past an EMPTY slot of its
    window.  On every such table the early-stop probe equals the
    whole-window ``fp_probe_torch``, sentinel keys included."""
    rng = np.random.default_rng(seed)
    tomb_homes: dict = {}
    if built_by == "plain":
        table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64)
    else:
        idx = FingerprintIndex(capacity=cap, small_batch=0, backend="numpy", device="cpu")
    for step in range(24):
        if built_by == "plain":
            t_cap, before = cap, table.numpy().view(np.uint64).copy()
            resident = before[(before != 0) & (before != np.uint64(TOMB_KEY))]
            if step % 3 == 2 and resident.size:
                gone = rng.choice(resident, size=max(1, resident.size // 3), replace=False)
                k.fp_remove_torch(_t(np.concatenate([gone, _keys(rng, 8)])), table, cap)
            else:
                fresh = _keys(rng, int(rng.integers(1, cap // 3 + 2)))
                k.fp_insert_torch(_t(np.concatenate([fresh, fresh[:3], resident[:5]])), table, cap)
            after = table.numpy().view(np.uint64)
        else:
            t_cap, before = idx._cap, idx._t64.copy()
            if step % 3 == 2 and len(idx):
                pool = np.fromiter(idx, dtype=np.uint64, count=len(idx))
                idx.remove_many(rng.choice(pool, size=max(1, pool.size // 3), replace=False))
            else:
                idx.add_many(_keys(rng, int(rng.integers(1, cap // 3 + 2))))
            idx._flush()
            if idx._cap != t_cap:  # the index grew: a fresh table, no tombstones
                tomb_homes.clear()
                t_cap, before = idx._cap, np.zeros_like(idx._t64)
            after = idx._t64
        _track_tombstones(before, after, tomb_homes, t_cap)
        _assert_nothing_past_empty(after, tomb_homes, t_cap)
        probe = _probe_batch(rng, after)
        want = k.fp_probe_torch(_t(probe), torch.from_numpy(after.view(np.int64)), t_cap).numpy()
        np.testing.assert_array_equal(k.probe_host(after, probe, t_cap), want)


def test_tombstone_key_is_not_decided_by_an_empty_slot():
    """A tombstone left by a key whose home lies past an EMPTY slot of the
    TOMBSTONE key's window: the whole-window probe finds it, so the early-stop
    probe may not stop the TOMBSTONE key at that EMPTY slot."""
    cap = 64
    tomb_home = int(k.phys_homes_host(np.array([TOMB_KEY], dtype=np.uint64), cap)[0])
    assert tomb_home + 1 < cap
    cand = _keys(np.random.default_rng(0), 4096)
    later = cand[k.phys_homes_host(cand, cap) == tomb_home + 1][:1]
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64)
    k.fp_insert_torch(_t(later), table, cap)
    assert k.fp_remove_torch(_t(later), table, cap).all()
    t64 = table.numpy().view(np.uint64)
    assert t64[tomb_home] == 0 and t64[tomb_home + 1] == np.uint64(TOMB_KEY)
    probe = np.array([TOMB_KEY, EMPTY_KEY], dtype=np.uint64)
    want = k.fp_probe_torch(_t(probe), table, cap).numpy()
    assert want.tolist() == [True, True]
    np.testing.assert_array_equal(k.probe_host(t64, probe, cap), want)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_add_many_cancels_a_staged_removal(backend):
    """The shortest sequence on which the reference loses key 1: ``discard``
    stages a removal of a key still in the table, ``add_many`` journals it
    again, and the flush must not tombstone it."""
    idx = FingerprintIndex(capacity=32, small_batch=0, backend=backend, device="cpu")
    for key in [0] * 9 + [25, 1, 32]:
        idx.add(key)
    idx.contains_many(np.asarray([10], dtype=np.uint64))
    idx.discard(1)
    idx.add_many(np.asarray([1], dtype=np.uint64))
    got = idx.contains_many(np.asarray([0, 1, 25, 32], dtype=np.uint64))
    np.testing.assert_array_equal(got, [True, True, True, True])
    idx.check_consistency()
    # the order contract stays: add_many then discard ends with the key absent
    idx.add_many(np.asarray([7], dtype=np.uint64))
    idx.discard(7)
    assert not idx.contains_many(np.asarray([7, 1], dtype=np.uint64))[0]
    idx.check_consistency()


_key_st = st.one_of(
    st.integers(min_value=0, max_value=(1 << 64) - 1),
    st.integers(min_value=0, max_value=31),  # collisions: every duplicate path
    st.sampled_from([EMPTY_KEY, TOMB_KEY, 1, (1 << 64) - 2]),
)
_op_st = st.tuples(
    st.sampled_from(["add", "add_many", "remove", "remove_many", "probe"]),
    st.lists(_key_st, min_size=1, max_size=60),
)


@given(st.lists(_op_st, min_size=1, max_size=30))
@example([("add", [0] * 9 + [25, 1, 32]), ("probe", [10]), ("remove", [1]), ("add_many", [1]),
          ("probe", [0, 1, 25, 32])])
@example([("add", [1]), ("add_many", [1]), ("remove", [1]), ("probe", [1])])
@example([("add", [1]), ("add_many", [2]), ("remove", [1]), ("add", [1]), ("probe", [1])])
def test_property_matches_a_set_on_both_backends(ops):
    """Scalar and batched mutators mixed, at capacity 32 (window overflow and
    growth routine): every membership answer equals a plain set's."""
    oracle = set()
    indexes = [FingerprintIndex(capacity=32, small_batch=0, backend=b, device="cpu")
               for b in ("numpy", "torch")]
    for op, keys in ops:
        arr = np.asarray(keys, dtype=np.uint64)
        for idx in indexes:
            if op == "add":
                for key in keys:
                    idx.add(key)
            elif op == "add_many":
                idx.add_many(arr)
            elif op == "remove":
                for key in keys:
                    idx.discard(key)
            elif op == "remove_many":
                idx.remove_many(arr)
            else:
                want = np.fromiter((key in oracle for key in keys), dtype=bool, count=len(keys))
                np.testing.assert_array_equal(idx.contains_many(arr), want)
        if op in ("add", "add_many"):
            oracle.update(keys)
        elif op in ("remove", "remove_many"):
            oracle.difference_update(keys)
    for idx in indexes:
        assert set(idx) == oracle
        everything = np.fromiter(oracle, dtype=np.uint64, count=len(oracle))
        assert idx.contains_many(everything).all()
        idx.check_consistency()
