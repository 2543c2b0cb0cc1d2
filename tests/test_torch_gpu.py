"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the reference package, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The plain versions themselves are held against the reference package on the
CPU in ``test_torch_fingerprint.py``, ``test_torch_fp_index.py``,
``test_torch_engine.py``, ``test_torch_cdc.py``, ``test_torch_ffh.py``,
``test_torch_paged_attention.py`` and ``test_torch_serving.py``; the cluster, the
snapshot envelope and online GC in ``test_torch_cluster.py``,
``test_torch_cluster_ops.py`` and ``test_torch_snapshot_gc.py``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import (
    ContentDefinedChunker,
    HPDedup,
    ShardedCluster,
    generate_workload,
    restore_engine,
    snapshot_engine,
)
from repro_torch.core.fp_index import SMALL_BATCH_CARD, TOMB_KEY, FingerprintIndex
from repro_torch.core.unseen import ldss_batch
from repro_torch.kernels import cdc
from repro_torch.kernels import fp_index as k
from repro_torch.kernels import ops
from repro_torch.kernels._build import LAUNCHES
from repro_torch.kernels.fingerprint import fingerprint, fingerprint_torch
from repro_torch.kernels.histogram import ffh, ffh_torch
from repro_torch.kernels.paged_attention import (
    bf16_err_ratio,
    paged_attention,
    paged_attention_torch,
    split_pages,
)
from repro_torch.kernels.ref import cdc_golden_buffer, chunk_edge_cases, fingerprint_golden_numpy

pytestmark = pytest.mark.gpu

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "fingerprint_digests.json")
CDC_GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "cdc_digests.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(rng, n):
    return rng.integers(1, 2**64 - 1, size=n, dtype=np.uint64)


def _t(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64))


@pytest.mark.parametrize("b,w", [(1, 128), (257, 1024), (64, 2048), (1000, 1024)])
def test_fingerprint_kernel_matches_plain(cuda, b, w):
    x = np.random.default_rng(b * w).integers(0, 2**32, size=(b, w), dtype=np.uint32)
    x[0, :] = 0xFFFFFFFF
    t = torch.from_numpy(x.view(np.int32))
    before = LAUNCHES["fingerprint"]
    got = fingerprint(t.to(cuda))
    torch.cuda.synchronize()
    assert LAUNCHES["fingerprint"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), fingerprint_torch(t).numpy())
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), fingerprint_golden_numpy(x))


def test_fingerprint_kernel_golden_and_uint8(cuda):
    with open(GOLDEN_PATH) as f:
        cases = json.load(f)["cases"]
    for case in cases:
        if case["kind"] != "zeros":
            continue
        x = np.zeros((case["b"], case["w"]), dtype=np.uint32)
        assert [f"{int(v):016x}" for v in ops.fingerprint_ints(x, device=cuda)] == case["fp64_hex"]
    x8 = np.random.default_rng(1).integers(0, 256, size=(5, 4095), dtype=np.uint8)
    np.testing.assert_array_equal(
        ops.fingerprint_ints(x8, device=cuda), ops.fingerprint_ints(x8, device="cpu")
    )


@pytest.mark.parametrize("cap,n", [(1024, 400), (1 << 17, 40_000)])
def test_index_kernels_match_plain(cuda, cap, n):
    rng = np.random.default_rng(n)
    keys = np.unique(_keys(rng, n))
    keys = np.concatenate([keys, keys[:100]])
    plain = torch.zeros(k.table_phys_len(cap), dtype=torch.int64)
    dev = plain.to(cuda)
    before = dict(LAUNCHES)
    st_plain = k.fp_insert(_t(keys), plain, cap).numpy()
    st_dev = k.fp_insert(_t(keys).to(cuda), dev, cap).cpu().numpy()
    # statuses: PRESENT exactly; PLACED + PLACED_TOMB + OVERFLOW in total
    assert (st_dev == k.PRESENT).sum() == (st_plain == k.PRESENT).sum()
    t64 = dev.cpu().numpy().view(np.uint64)
    occupied = t64[(t64 != 0) & (t64 != np.uint64(TOMB_KEY))]
    assert occupied.size == np.unique(occupied).size  # no key placed twice
    placed = keys[np.isin(st_dev, (k.PLACED, k.PLACED_TOMB))]
    assert set(occupied.tolist()) == set(placed.tolist())
    # the kernel probe equals the plain probe and the host early-stop probe
    probe = np.concatenate([keys, _keys(rng, n)])
    got = k.fp_probe(_t(probe).to(cuda), dev, cap).cpu().numpy()
    np.testing.assert_array_equal(got, k.fp_probe_torch(_t(probe), dev.cpu(), cap).numpy())
    np.testing.assert_array_equal(got, k.probe_host(t64, probe, cap))
    np.testing.assert_array_equal(got[: keys.size], st_dev != k.OVERFLOW)
    gone = placed[::3]
    removed = k.fp_remove(_t(gone).to(cuda), dev, cap).cpu().numpy()
    assert removed.all()
    assert not k.fp_probe(_t(gone).to(cuda), dev, cap).cpu().numpy().any()
    # tombstones are reused, and told apart from EMPTY slots
    st2 = k.fp_insert(_t(gone).to(cuda), dev, cap).cpu().numpy()
    assert (st2 == k.PLACED_TOMB).any()
    torch.cuda.synchronize()
    for name in ("fp_probe", "fp_insert", "fp_remove"):
        assert LAUNCHES[name] > before[name]


def _keys_at(cap, home, count, seed):
    """``count`` keys whose logical home slot at capacity ``cap`` is ``home``."""
    rng = np.random.default_rng(seed)
    found = []
    while sum(f.size for f in found) < count:
        cand = _keys(rng, cap * 16)
        lo = (cand & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (cand >> np.uint64(32)).astype(np.uint32)
        found.append(cand[(k.slot_hash_host(lo, hi) & np.uint32(cap - 1)) == home])
    return np.concatenate(found)[:count]


def _walk_case(case):
    """(cap, table built by the plain insert on the host, probe keys, remove
    keys) for one shape of the probe and remove walks."""
    rng = np.random.default_rng(len(case))
    if case == "odd_and_even_homes":
        cap = 1024
        at = [_keys_at(cap, h, 10, h) for h in (100, 201, 302, 403)]
        placed = np.concatenate([a[:7] for a in at])
        absent = np.concatenate([a[7:] for a in at])
        gone = placed[::2]
    elif case == "last_home_of_a_tile":
        # windows from the last home of each of two tiles run into TILE_PAD
        cap = 1 << 16
        at = [_keys_at(cap, h, 20, h) for h in (k.TILE_SLOTS - 1, 2 * k.TILE_SLOTS - 1)]
        placed = np.concatenate([a[:16] for a in at])
        absent = np.concatenate([a[16:] for a in at])
        gone = placed[5::6]
    elif case == "full_window":
        # no EMPTY slot in the window: an absent key walks every step
        cap = 1024
        at = [_keys_at(cap, h, 20, h) for h in (500, 601)]
        placed = np.concatenate([a[:16] for a in at])
        absent = np.concatenate([a[16:] for a in at])
        gone = placed[-3:]
    elif case == "tombstones_first":
        cap = 1024
        at = _keys_at(cap, 300, 14, 3)
        placed, absent, gone = at[:12], at[12:], at[6:12]
    elif case == "repeated_removes":
        cap = 1 << 14
        placed = np.unique(_keys(rng, 3000))
        absent = _keys(rng, 200)
        gone = np.concatenate([placed[:1000]] * 3)
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64)
    k.fp_insert_torch(_t(np.concatenate([placed, _keys(rng, cap // 4)])), table, cap)
    if case == "tombstones_first":  # tombstones in the window's first slots
        assert k.fp_remove_torch(_t(placed[:6]), table, cap).all()
    probe = np.concatenate([placed, absent, _keys(rng, 64)])
    remove = np.concatenate([gone, absent])
    return cap, table, probe, remove


def _hold_walks(cuda, cap, table, probe, remove):
    """Probe and remove on the card against the plain versions."""
    np.testing.assert_array_equal(
        k.fp_probe(_t(probe).to(cuda), table.to(cuda), cap).cpu().numpy(),
        k.fp_probe_torch(_t(probe), table, cap).numpy())
    got_t, want_t = table.to(cuda), table.clone()
    got = k.fp_remove(_t(remove).to(cuda), got_t, cap).cpu().numpy()
    want = k.fp_remove_torch(_t(remove), want_t, cap).numpy()
    # one flag per removed key; the same keys; the same slots tombstoned
    assert got.sum() == want.sum()
    np.testing.assert_array_equal(np.sort(remove[got]), np.sort(remove[want]))
    assert torch.equal(got_t.cpu(), want_t)


@pytest.mark.parametrize("case", ["odd_and_even_homes", "last_home_of_a_tile", "full_window",
                                  "tombstones_first", "repeated_removes"])
def test_walk_kernels_match_plain(cuda, case):
    """The probe and remove walks at the shapes that test their edges."""
    cap, table, probe, remove = _walk_case(case)
    _hold_walks(cuda, cap, table, probe, remove)


def test_probe_kernel_sentinel_keys(cuda):
    """Keys 0 and TOMBSTONE in a probe batch, on a table where a tombstone
    lies past an EMPTY slot of TOMBSTONE's window: equal to the plain
    whole-window probe."""
    cap = 64
    tomb_home = int(k.phys_homes_host(np.array([TOMB_KEY], dtype=np.uint64), cap)[0])
    later = _keys_at(cap, tomb_home + 1, 2, 5)
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64)
    k.fp_insert_torch(_t(later), table, cap)
    k.fp_remove_torch(_t(later[:1]), table, cap)
    sentinels = np.array([0, TOMB_KEY], dtype=np.uint64)
    want = k.fp_probe_torch(_t(sentinels), table, cap).numpy()
    assert want.tolist() == [True, True]
    fuller = table.clone()
    k.fp_insert_torch(_t(_keys(np.random.default_rng(6), 40)), fuller, cap)
    for tbl in (table, fuller):
        probe = np.concatenate([sentinels, later, sentinels])
        _hold_walks(cuda, cap, tbl, probe, np.array([0], dtype=np.uint64))


def test_walk_kernels_replay_batch_and_one_key(cuda):
    """8,192 keys, half resident, as a replay batch probes them, and a
    launch of one key, on a table at load 0.3."""
    cap = 1 << 16
    rng = np.random.default_rng(12)
    placed = np.unique(_keys(rng, int(0.3 * cap)))
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64)
    k.fp_insert_torch(_t(placed), table, cap)
    probe = np.concatenate([placed[:4096], _keys(rng, 4096)])
    rng.shuffle(probe)
    _hold_walks(cuda, cap, table, probe, placed[:8192])
    for one in (placed[:1], _keys(rng, 1)):
        _hold_walks(cuda, cap, table, one, one)


def test_index_on_card_matches_host_index(cuda):
    rng = np.random.default_rng(5)
    host = FingerprintIndex(capacity=128, small_batch=0, device="cpu")
    card = FingerprintIndex(capacity=128, small_batch=0, device=cuda)
    assert card.table_stats()["backend"] == "torch"
    for step in range(120):
        op = step % 4
        if op == 0:
            ks = _keys(rng, 150)
            host.add_many(ks)
            card.add_many(ks)
        elif op == 1 and len(host):
            pool = np.fromiter(host, dtype=np.uint64, count=len(host))
            ks = rng.choice(pool, size=min(40, pool.size), replace=False)
            host.remove_many(ks)
            card.remove_many(ks)
        elif op == 2:
            uniq = np.unique(_keys(rng, 64))
            np.testing.assert_array_equal(card.probe_and_add(uniq), host.probe_and_add(uniq))
        else:
            probe = _keys(rng, 128)
            pool = np.fromiter(host, dtype=np.uint64, count=len(host))
            probe[:32] = rng.choice(pool, size=32)
            np.testing.assert_array_equal(card.contains_many(probe), host.contains_many(probe))
        assert set(card) == set(host)
    card.check_consistency()
    host.check_consistency()


def test_batched_solver_on_card_matches_host(cuda):
    """The float32 LDSS solve on the card against the same solve on the CPU:
    matrix products sum in another order, so the estimates agree to a
    relative 1e-3, as the CPU solve agrees with the reference's."""
    rng = np.random.default_rng(3)
    counts = [np.bincount(rng.integers(0, m, size=1500))[1:] for m in (200, 1000, 5000)]
    counts = [c[c > 0] for c in counts]
    n = np.array([10_000.0, 10_000.0, 10_000.0])
    np.testing.assert_allclose(
        ldss_batch(counts, n, device=cuda), ldss_batch(counts, n, device="cpu"),
        rtol=1e-3, atol=1.0,
    )
    engine = HPDedup(cache_entries=256, use_jax_estimator=True, device=cuda)
    assert engine.inline.estimator.device == cuda


def test_engine_on_card_matches_host(cuda):
    # an estimation interval of 4096 writes: sub-batches pass SMALL_BATCH_CARD
    trace = generate_workload("A", total_requests=40_000, seed=1)[0]
    before = dict(LAUNCHES)
    engine = HPDedup(cache_entries=8192, device=cuda)
    assert engine._seen_fps.small_batch == SMALL_BATCH_CARD
    card = engine.replay_batched(trace, 8192).finish()
    host = HPDedup(cache_entries=8192, device="cpu").replay_batched(trace, 8192).finish()
    assert dataclasses.asdict(card) == dataclasses.asdict(host)
    assert LAUNCHES["fp_probe"] > before["fp_probe"]
    assert LAUNCHES["fp_insert"] > before["fp_insert"]


def _haloed(r, seed):
    x = np.random.default_rng(seed).integers(0, 2**32, size=(r, 520), dtype=np.uint32)
    x[0, :] = 0
    x[1, :] = 0xFFFFFFFF
    return torch.from_numpy(x.view(np.int32))


@pytest.mark.parametrize("avg_size", [256, 1024, 4096])
def test_cdc_candidates_kernel_matches_plain(cuda, avg_size):
    t = _haloed(256, avg_size)
    before = LAUNCHES["cdc_candidates"]
    got = cdc.cdc_candidates(t.to(cuda), avg_size)
    torch.cuda.synchronize()
    assert LAUNCHES["cdc_candidates"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), cdc.cdc_candidates_torch(t, avg_size).numpy())


def _chunk_cases(r: int, w_pad: int, rng, n_random: int):
    """Random chunks and every edge family of ``ref.chunk_edge_cases``."""
    max_size = 4 * w_pad
    total = r * cdc.SEG_BYTES
    lens = rng.integers(1, max_size + 1, size=n_random)
    starts = rng.integers(0, total - max_size, size=n_random)
    edges = chunk_edge_cases(r, max_size, ops.CHUNK_FP_BATCH).values()
    starts = np.concatenate([starts, *(s for s, _ in edges)]).astype(np.int64)
    lens = np.concatenate([lens, *(n for _, n in edges)]).astype(np.int32)
    return torch.from_numpy(starts), torch.from_numpy(lens)


@pytest.mark.parametrize("w_pad", [128, 1024, 4096])
def test_chunk_fingerprint_kernel_matches_plain(cuda, w_pad):
    """Random chunks and the edges: every start phase, lengths about 1, 512,
    a batch of groups and max_size, chunks across 1 to 8 row halos, at the
    payload's last byte, before byte 0 and past the payload; rows of zero
    bytes and of 0xFF bytes."""
    r = 64
    t = _haloed(r, w_pad)
    s, n = _chunk_cases(r, w_pad, np.random.default_rng(w_pad), 500)
    for rows in (t, torch.zeros_like(t), torch.full_like(t, -1)):
        before = LAUNCHES["chunk_fingerprint"]
        got = ops.chunk_fingerprint(rows.to(cuda), s.to(cuda), n.to(cuda), w_pad)
        torch.cuda.synchronize()
        assert LAUNCHES["chunk_fingerprint"] == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      ops.chunk_fingerprint_torch(rows, s, n, w_pad).numpy())


def test_chunk_fingerprint_kernel_on_many_uneven_chunks(cuda):
    """More chunks than the persistent grid has warps, of very uneven
    lengths (1 byte to max_size, long ones clustered), so that warps walk
    many chunks and finish at different times; two calls give equal bits."""
    r, w_pad = 2048, 4096
    t = _haloed(r, 5).to(cuda)
    rng = np.random.default_rng(5)
    c = 60_000
    lens = np.minimum(4 * w_pad, 1 + rng.geometric(1 / 3000, size=c))
    lens[rng.random(c) < 0.05] = 4 * w_pad
    lens[20_000:21_000] = 4 * w_pad  # a run of long chunks for a few warps
    starts = rng.integers(0, r * cdc.SEG_BYTES - 4 * w_pad, size=c)
    s = torch.from_numpy(starts.astype(np.int64)).to(cuda)
    n = torch.from_numpy(lens.astype(np.int32)).to(cuda)
    got = ops.chunk_fingerprint(t, s, n, w_pad)
    again = ops.chunk_fingerprint(t, s, n, w_pad)
    want = ops.chunk_fingerprint_torch(t, s, n, w_pad)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


def test_chunk_fingerprint_kernel_rejects_unaligned_rows(cuda):
    flat = torch.zeros(64 * 520 + 1, dtype=torch.int32, device=cuda)
    rows = flat[1:].view(64, 520)
    one = torch.zeros(1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ops.chunk_fingerprint(rows, one, one.to(torch.int32) + 5, 128)


def test_candidate_positions_on_card_match_unpack(cuda):
    rng = np.random.default_rng(9)
    bufs = [rng.integers(0, 256, size=n, dtype=np.uint8) for n in (0, 100, 2049, 70_000, 0)]
    rows, spans = cdc.pack_haloed(bufs)
    flags = ops.cdc_candidate_flags(rows, 256, device=cuda)
    host = flags.cpu().numpy().view(np.uint32)
    for got, span in zip(ops.candidate_positions(flags, spans), spans):
        np.testing.assert_array_equal(got, cdc.unpack_candidates(host, span))


def test_chunker_on_card_matches_golden_and_host(cuda):
    with open(CDC_GOLDEN_PATH) as f:
        golden = json.load(f)
    card = ContentDefinedChunker(*golden["cfg"], device=cuda)
    for case in golden["cases"]:
        ends, fps = card.chunk_fingerprints(
            cdc_golden_buffer(case["name"], case["n"], case["salt"]))
        assert ends.tolist() == case["ends"]
        assert [f"{int(v):016x}" for v in fps] == case["fp64_hex"]
    rng = np.random.default_rng(4)
    bufs = [rng.integers(0, 256, size=n, dtype=np.uint8) for n in (0, 5000, 300_000, 77)]
    host = ContentDefinedChunker(device="cpu")
    before = dict(LAUNCHES)
    got = ContentDefinedChunker(device=cuda).chunk_fingerprints_many(bufs)
    for (e1, f1), (e2, f2) in zip(got, host.chunk_fingerprints_many(bufs)):
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(f1, f2)
    assert LAUNCHES["cdc_candidates"] == before["cdc_candidates"] + 1
    assert LAUNCHES["chunk_fingerprint"] == before["chunk_fingerprint"] + 1


@pytest.mark.parametrize("n", [1, 7, 4096, 1_000_003])
@pytest.mark.parametrize("nbins", [1, 2, 40, 128, 1024])
def test_ffh_kernel_matches_plain(cuda, n, nbins):
    """Heavy-tailed counts (the hot bins 1 and 2), zeros, negatives and
    counts above the last bin; lengths off the 16-byte groups."""
    rng = np.random.default_rng(n + nbins)
    c = rng.geometric(0.5, size=n).astype(np.int32)
    c[rng.random(n) < 0.1] = 0
    c[rng.random(n) < 0.05] = -3
    c[rng.random(n) < 0.02] = nbins + 17
    c[0] = np.iinfo(np.int32).min
    t = torch.from_numpy(c)
    before = LAUNCHES["ffh"]
    got = ffh(t.to(cuda), nbins)
    torch.cuda.synchronize()
    assert LAUNCHES["ffh"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), ffh_torch(t, nbins).numpy())
    np.testing.assert_array_equal(ops.ffh_counts(c, nbins, device=cuda).cpu().numpy(),
                                  ffh_torch(t, nbins).numpy())


def test_ffh_kernel_all_in_one_bin(cuda):
    for value, nbins in ((1, 40), (2, 40), (5, 40), (500, 40), (1, 1)):
        got = ffh(torch.full((1 << 20,), value, dtype=torch.int32, device=cuda), nbins)
        want = np.zeros(nbins, np.int32)
        want[min(value, nbins) - 1] = 1 << 20
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def _paged_inputs(rng, b, h, kvh, d, ps, pps, dtype, device):
    npages = pps * b // 2 + 3
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((npages, ps, kvh, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((npages, ps, kvh, d)).astype(np.float32))
    table = rng.integers(0, npages, (b, pps)).astype(np.int32)
    table[:, : pps // 2] = np.arange(pps // 2)  # a shared prefix of pages in every row
    table[-1, -1] = table[-1, 0]  # an id repeated inside one row
    lengths = rng.integers(0, ps * pps + 1, (b,)).astype(np.int32)
    lengths[0], lengths[-1] = 0, ps * pps  # a row of length 0 and a full row
    if b > 2:
        lengths[1] = ps * (pps // 2) + 1  # one token into a page
    return [x.to(device) for x in (q.to(dtype), kp.to(dtype), vp.to(dtype),
                                   torch.from_numpy(table), torch.from_numpy(lengths))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,d,ps,pps", [
    (8, 32, 4, 64, 16, 8),     # TinyLlama's heads
    (3, 8, 8, 64, 32, 3),
    (4, 16, 4, 128, 16, 5),
    (2, 32, 1, 128, 32, 4),    # 32 query heads on one KV head
    (4, 32, 2, 64, 16, 20),    # bf16: 16 query heads per KV head, the tensor cores' last
    (3, 32, 2, 128, 32, 11),
    (4, 24, 2, 64, 32, 9),     # 12 per KV head: rows 8-11 of the 16-row tiles
    (3, 24, 2, 128, 16, 18),
])
def test_paged_attention_kernel_matches_plain(cuda, dtype, b, h, kvh, d, ps, pps):
    args = _paged_inputs(np.random.default_rng(b * h + d), b, h, kvh, d, ps, pps, dtype, cuda)
    before = LAUNCHES["paged_attention"]
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (b, h, d)
    want = paged_attention_torch(*args)
    _assert_paged_close(got, want)
    tol = dict(atol=3e-5, rtol=0) if dtype == torch.float32 else dict(atol=0.05, rtol=0.05)
    # the length-0 row is the mean of V over its slots, as the plain version gives
    v0 = args[2][args[3][0].long()].float().reshape(-1, kvh, d).mean(dim=0)
    torch.testing.assert_close(got[0].float(), v0.repeat_interleave(h // kvh, dim=0), **tol)


def _assert_paged_close(got, want):
    """float32 within atol 3e-5; bf16 within 0.05 and within the limit
    scaled to the outputs (``bf16_err_ratio``), which 0.05 is not."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=3e-5, rtol=0)
        return
    torch.testing.assert_close(got.float(), want.float(), atol=0.05, rtol=0.05)
    assert bf16_err_ratio(got, want) <= 1


def test_paged_attention_kernel_shared_rows_identical(cuda):
    rng = np.random.default_rng(7)
    q, kp, vp, table, lengths = _paged_inputs(rng, 4, 32, 4, 64, 16, 6, torch.bfloat16, cuda)
    q[1], table[1], lengths[1] = q[2], table[2], lengths[2]
    got = paged_attention(q, kp, vp, table, lengths)
    assert torch.equal(got[1], got[2])


def _split_edge_rows(rng, h, kvh, d, ps, pps, split, dtype, device):
    """Rows of length 0, 1, one page, exactly one split, one split + 1, a
    token short of the table and the whole table, over a table of ``pps``
    pages, which is not a multiple of ``split``; a shared prefix page."""
    lengths = np.asarray([0, 1, ps, split * ps, split * ps + 1, pps * ps - 1, pps * ps],
                         np.int32)
    b = lengths.size
    npages = pps * b + 2
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((npages, ps, kvh, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((npages, ps, kvh, d)).astype(np.float32))
    table = rng.permutation(npages)[: b * pps].reshape(b, pps).astype(np.int32)
    table[:, 0] = npages - 1
    return [x.to(device) for x in (q.to(dtype), kp.to(dtype), vp.to(dtype),
                                   torch.from_numpy(table), torch.from_numpy(lengths))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,ps", [(64, 16), (64, 32), (128, 16), (128, 32)])
@pytest.mark.parametrize("extra", [1, 3])  # pages past the last whole split
# bf16: tensor cores up to 16 query heads per KV head (8, 16 and 12 here)
@pytest.mark.parametrize("h,kvh", [(32, 4), (32, 1), (32, 2), (24, 2)])
def test_paged_attention_kernel_split_edges(cuda, dtype, d, ps, extra, h, kvh):
    """The kernel at its split edges against the plain version, over a table
    of two splits and ``extra`` pages; the merge regroups the softmax's
    sums, which moves a float32 result by a few rounding steps, inside atol
    3e-5."""
    split = split_pages(1 << 20, ps)
    pps = 2 * split + extra
    assert split_pages(pps, ps) == split and pps % split
    rng = np.random.default_rng(d + ps + pps)
    args = _split_edge_rows(rng, h, kvh, d, ps, pps, split, dtype, cuda)
    before = LAUNCHES["paged_attention"]
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_attention"] == before + 1
    _assert_paged_close(got, paged_attention_torch(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pps", [7, 40])  # one split; three splits and a part
def test_paged_attention_kernel_equal_bits(cuda, dtype, pps):
    """No float atomics and a fixed merge order: two calls give equal bits."""
    args = _paged_inputs(np.random.default_rng(3), 16, 32, 4, 64, 16, pps, dtype, cuda)
    assert torch.equal(paged_attention(*args), paged_attention(*args))


def test_fp_insert_kernel_copies_of_few_keys(cuda):
    """8,192 copies of 16 keys: exactly 16 land, the rest PRESENT."""
    cap = 1 << 16
    keys = np.tile(_keys(np.random.default_rng(8), 16), 512)
    np.random.default_rng(9).shuffle(keys)
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64, device=cuda)
    st = k.fp_insert(_t(keys).to(cuda), table, cap).cpu().numpy()
    assert (st == k.PLACED).sum() == 16 and (st == k.PRESENT).sum() == keys.size - 16
    t64 = table.cpu().numpy().view(np.uint64)
    assert sorted(t64[t64 != 0].tolist()) == sorted(np.unique(keys).tolist())


def test_fp_insert_kernel_overflows_one_window(cuda):
    """More keys than WINDOW slots on one home: 16 land, the rest OVERFLOW,
    and the table holds no key twice (each key repeated in the batch)."""
    cap = 1024
    rng = np.random.default_rng(10)
    cand = _keys(rng, 200_000)
    home = k.phys_homes_host(cand, cap)
    same = cand[home == np.bincount(home).argmax()][:40]
    assert same.size > k.WINDOW
    keys = np.concatenate([same, same[::-1]])
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64, device=cuda)
    st = k.fp_insert(_t(keys).to(cuda), table, cap).cpu().numpy()
    st_plain = k.fp_insert_torch(_t(keys), torch.zeros(k.table_phys_len(cap), dtype=torch.int64),
                                 cap).numpy()
    assert (st == k.PLACED).sum() == k.WINDOW
    assert (st == k.PRESENT).sum() == (st_plain == k.PRESENT).sum()
    assert (st == k.OVERFLOW).sum() == (st_plain == k.OVERFLOW).sum()
    t64 = table.cpu().numpy().view(np.uint64)
    occupied = t64[t64 != 0]
    assert occupied.size == k.WINDOW == np.unique(occupied).size
    placed = keys[st == k.PLACED]
    assert set(occupied.tolist()) == set(placed.tolist())
    np.testing.assert_array_equal(k.fp_probe(_t(same).to(cuda), table, cap).cpu().numpy(),
                                  np.isin(same, placed))


def test_fp_insert_kernel_reuses_tombstones(cuda):
    """After removes, new keys on the same homes take the tombstones
    (PLACED_TOMB), never past a slot that was EMPTY: the host probe agrees."""
    cap = 1024
    rng = np.random.default_rng(11)
    keys = np.unique(_keys(rng, 600))
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64, device=cuda)
    st = k.fp_insert(_t(keys).to(cuda), table, cap).cpu().numpy()
    placed = keys[st == k.PLACED]
    gone = placed[::2]
    assert k.fp_remove(_t(gone).to(cuda), table, cap).cpu().numpy().all()
    fresh = np.unique(_keys(rng, 400))
    st2 = k.fp_insert(_t(fresh).to(cuda), table, cap).cpu().numpy()
    assert (st2 == k.PLACED_TOMB).sum() > 0
    t64 = table.cpu().numpy().view(np.uint64)
    assert (t64 == np.uint64(TOMB_KEY)).sum() == gone.size - (st2 == k.PLACED_TOMB).sum()
    probe = np.concatenate([keys, fresh])
    want = np.isin(probe, np.concatenate([np.setdiff1d(placed, gone),
                                          fresh[np.isin(st2, (k.PLACED, k.PLACED_TOMB))]]))
    np.testing.assert_array_equal(k.probe_host(t64, probe, cap), want)
    np.testing.assert_array_equal(k.fp_probe(_t(probe).to(cuda), table, cap).cpu().numpy(), want)


def test_server_on_card_matches_host(cuda):
    """The smoke TinyLlama served on the card: the same metrics as on the
    host, and page reuse exact against a server that caches nothing."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.dedup_kv import DedupKVServer

    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 48)
    reqs = [np.concatenate([prompt, rng.integers(0, cfg.vocab_size, 8)]) for _ in range(4)]
    metrics, caches = [], []
    for device, entries in ((cuda, 128), ("cpu", 128), (cuda, 0)):
        srv = DedupKVServer(build_model(cfg), params, page_tokens=16, max_slots=128,
                            cache_entries=entries, device=device)
        for toks in reqs:
            cache, pos, _ = srv.prefill_request(0, toks)
        metrics.append(dataclasses.asdict(srv.metrics))
        caches.append((srv, cache, pos))
    assert metrics[0] == metrics[1] and metrics[0]["blocks_prefill_skipped"] == 9
    (srv, c1, p1), _, (nodedup, c2, p2) = caches
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)
    assert srv.decode(c1, p1, steps=4)[0] == nodedup.decode(c2, p2, steps=4)[0]


# -- the sharded cluster on the card -------------------------------------------------


def _cluster_run(device, trace, parallel, batch=2048):
    c = ShardedCluster(num_shards=4, cache_entries=8192, device=device)
    c.min_parallel_batch = 0
    c.replay_batched(trace, batch_size=batch, parallel=parallel)
    return c, c.finish()


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "workers"])
def test_cluster_on_card_matches_host(cuda, parallel):
    """Four shards, each with its own index tables on the card, serially and
    from one worker thread per shard: the host's reports, per-shard reports
    and tree; the index kernels launched from the shards."""
    trace = generate_workload("A", total_requests=60_000, seed=1)[0]
    before = dict(LAUNCHES)
    card, rep = _cluster_run(cuda, trace, parallel)
    launched = {n: LAUNCHES[n] - before[n] for n in ("fp_probe", "fp_insert", "fp_remove")}
    host, want = _cluster_run("cpu", trace, False)
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)
    assert [dataclasses.asdict(r) for r in card.shard_reports] == \
        [dataclasses.asdict(r) for r in host.shard_reports]
    assert json.dumps(snapshot_engine(card)) == json.dumps(snapshot_engine(host))
    assert launched["fp_probe"] > 0 and launched["fp_insert"] > 0
    for e in card.shards:
        assert e._seen_fps.table_stats()["backend"] == "torch"
        e._seen_fps.check_consistency()
    card.check_consistency()


def test_cluster_operations_on_card_match_host(cuda):
    """GC, a snapshot restored onto the card, resize, and a shard failed and
    recovered, on the card and on the host: equal reports and ``moved_fps``."""
    trace = generate_workload("A", total_requests=40_000, seed=2)[0]

    def run(device):
        c = ShardedCluster(num_shards=4, replication_factor=2, cache_entries=8192,
                           device=device)
        n = len(trace)
        c.ingest_batched(trace[:n // 2], batch_size=2048)
        gc1 = c.run_gc(max_moves_per_shard=512)
        c = restore_engine(json.loads(json.dumps(snapshot_engine(c))), device=device)
        c.ingest_batched(trace[n // 2:3 * n // 4], batch_size=2048)
        moved = c.resize(8)["moved_fps"]
        gc2 = c.run_gc(max_moves_per_shard=512)
        c.fail_shard(1)
        c.ingest_batched(trace[3 * n // 4:], batch_size=2048)
        c.recover_shard(1)
        rep = c.finish()
        c.check_consistency()
        return dataclasses.asdict(rep), moved, gc1, gc2, json.dumps(snapshot_engine(c))

    card, host = run(cuda), run("cpu")
    assert card == host
    assert card[1] > 0 and card[3]["moved"] > 0


def test_cluster_server_on_card_matches_host(cuda):
    """``DedupKVServer(num_shards=4)`` on the smoke TinyLlama: the card and
    the host give equal metrics and engine trees, pages lie on several
    shards, a snapshot round trip and a GC step leave the next request as
    it was."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.dedup_kv import DedupKVServer

    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 48)
    reqs = [np.concatenate([prompt, rng.integers(0, cfg.vocab_size, 8)]) for _ in range(5)]
    out = []
    for device in (cuda, "cpu"):
        srv = DedupKVServer(build_model(cfg), params, page_tokens=16, max_slots=128,
                            cache_entries=128, num_shards=4, device=device)
        for toks in reqs[:4]:
            srv.prefill_request(0, toks)
        snap = srv.snapshot()
        srv.load_state(snap)
        srv.run_gc()
        cache, pos, info = srv.prefill_request(0, reqs[4])
        out.append((dataclasses.asdict(srv.metrics), json.dumps(snapshot_engine(srv.dedup)),
                    info, srv.decode(cache, pos, steps=3)[0]))
        assert len({pba >> 48 for pba in srv.pages}) > 1
    assert out[0][:3] == out[1][:3] and out[0][2]["hit_blocks"] == 3
