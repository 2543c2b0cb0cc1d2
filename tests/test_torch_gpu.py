"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the reference package, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The training path (one train step, the trainer's pipeline, a checkpoint) is
held here against the same code on the host; the port against the reference
on the CPU in ``test_torch_models.py``, ``test_torch_train.py`` and
``test_torch_checkpoint.py``.  The plain versions themselves are held against
the reference package on the CPU in ``test_torch_fingerprint.py``,
``test_torch_fp_index.py``,
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


# -- the ingest pipeline and the async front end on the card ------------------------

INGEST_TENANTS = [
    dict(tenant_id=0, rate=3.0, dup_ratio=0.8, locality="good", overlap_group="g"),
    dict(tenant_id=1, rate=2.0, dup_ratio=0.15, locality="weak", overlap_group="g"),
    dict(tenant_id=2, rate=1.0, dup_ratio=0.5, locality="good"),
    dict(tenant_id=3, rate=0.5, dup_ratio=0.3, locality="good"),
]


def _pipeline(device, **kw):
    from repro_torch.data import DedupIngestPipeline, TenantSpec

    kw = {"block_tokens": 64, "vocab": 1000, "fingerprint_batch": 64, "seed": 3, **kw}
    return DedupIngestPipeline([TenantSpec(**t) for t in INGEST_TENANTS], device=device, **kw)


def _batches(pipe, n):
    return [pipe.next_batch(4, 256) for _ in range(n)]


def test_pipeline_on_card_matches_host(cuda):
    """A cache that evicts nothing: the card's batches, metrics and block
    store equal the host's bit for bit; the fingerprint kernel hashes each
    batch of 64 blocks in one launch."""
    card, host = _pipeline(cuda, cache_entries=1 << 16), _pipeline("cpu", cache_entries=1 << 16)
    before = LAUNCHES["fingerprint"]
    got, want = _batches(card, 40), _batches(host, 40)
    refills = card.metrics.blocks_in // 64
    assert LAUNCHES["fingerprint"] == before + refills
    for a, b in zip(got, want):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert card.metrics == host.metrics and card.metrics.blocks_deduped_inline > 0
    assert sorted(card.block_content) == sorted(host.block_content)
    assert card.engine._seen_fps.table_stats()["backend"] == "torch"


def test_sharded_pipeline_on_card_restores_bit_exact(cuda):
    """Four shards on the card, with and without worker threads, equal; a
    JSON checkpoint loaded into a fresh pipeline on the card continues the
    uninterrupted run bit for bit."""
    serial = _pipeline(cuda, cache_entries=512, num_shards=4)
    workers = _pipeline(cuda, cache_entries=512, num_shards=4, parallel_shards=True)
    workers.engine.min_parallel_batch = 0
    try:
        head = _batches(serial, 10)
        for a, b in zip(head, _batches(workers, 10)):
            np.testing.assert_array_equal(a["inputs"], b["inputs"])
        payload = json.dumps(serial.state_dict())
        want = _batches(serial, 6)
        assert json.dumps(workers.state_dict()) == payload
    finally:
        workers.engine.stop_executor()
    cold = _pipeline(cuda, cache_entries=512, num_shards=4)
    cold.load_state(json.loads(payload))
    for a, b in zip(want, _batches(cold, 6)):
        np.testing.assert_array_equal(a["inputs"], b["inputs"])
        np.testing.assert_array_equal(a["targets"], b["targets"])
    assert cold.metrics == serial.metrics


def test_frontend_on_card_replays_on_host(cuda):
    """256 connections through the async front end into a 4-shard cluster
    on the card: the executed trace replayed on the card and on the host
    gives the served report.  The front end's batches probe a few keys a
    shard, which the host set answers; the replay's one batch of 20,000
    writes probes through the tables on the card."""
    import asyncio

    from repro_torch.serving.frontend import AsyncDedupFrontend

    trace = generate_workload("A", total_requests=20_000, seed=5)[0]
    tenants = {int(t): (trace["lba"][trace["stream"] == t].astype(np.int64),
                        trace["fp"][trace["stream"] == t]) for t in np.unique(trace["stream"])}

    def cluster(device):
        # the front-end benchmark's 8,192 entries: the estimation interval
        # (4,096 writes) lets the replay's sub-batches pass the 512-key
        # host-set threshold
        return ShardedCluster(num_shards=4, cache_entries=8192, device=device)

    async def run(engine):
        fe = AsyncDedupFrontend(engine, max_batch=256, max_delay=0.001, record_trace=True)

        async def conn(t, lbas, fps):
            for lba, fp in zip(lbas.tolist(), fps.tolist()):
                await fe.write(t, fp, lba=lba)

        await asyncio.gather(*(conn(t, l[c::8], f[c::8]) for t, (l, f) in tenants.items()
                               for c in range(8)))
        await fe.close()
        return fe

    engine = cluster(cuda)
    fe = asyncio.run(run(engine))
    rep = engine.finish()
    assert fe.stats()["completed"] == trace.size
    for device in (cuda, "cpu"):
        before = LAUNCHES["fp_probe"] + LAUNCHES["fp_insert"]
        oracle = cluster(device)
        oracle.write_batch(*fe.executed_trace())
        assert oracle.finish() == rep
        assert (LAUNCHES["fp_probe"] + LAUNCHES["fp_insert"] > before) == (device is cuda)
    engine.check_consistency()


def _smoke_model(device, compute_dtype="bfloat16"):
    """TinyLlama's smoke config and its float32 weights, drawn on the host
    and moved to ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.pytree import tree_map

    cfg = get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=compute_dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return model, tree_map(lambda t: t.to(device), params)


def _digest(batch) -> str:
    import hashlib

    return hashlib.blake2b(b"".join(np.ascontiguousarray(batch[k]).tobytes()
                                    for k in ("inputs", "targets", "mask"))).hexdigest()


def test_train_step_on_card_matches_host(cuda):
    """One ``make_train_step`` step at smoke size in float32 from equal
    weights and batch, on the card and on the host: the loss within 1e-5,
    every weight within 2.5 x lr and at least 99.9% of them within 1e-5 (the
    train-step tolerance of ``test_torch_train.py``: at step 1 an element
    whose gradient is rounding noise may step the other way)."""
    from repro_torch.pytree import leaves
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step, trainable

    lr = 1e-3
    toks = np.random.default_rng(0).integers(0, 512, (4, 65)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": np.ones((4, 64), np.float32)}
    opt = AdamW(learning_rate=lr, warmup_steps=1, schedule="constant")
    out = {}
    for device in ("cpu", cuda):
        model, params = _smoke_model(device, "float32")
        p = trainable(params)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        p, state, loss, _ = make_train_step(model, opt)(p, opt.init(p), b)
        assert int(state.step) == 1 and state.mu["embed"].device.type == torch.device(device).type
        out[str(device)] = (float(loss), torch.cat([t.detach().cpu().flatten() for t in leaves(p)]))
    (host_loss, host), (card_loss, card) = out["cpu"], out[str(cuda)]
    assert abs(card_loss - host_loss) <= 1e-5
    diffs = (card - host).abs()
    assert float(diffs.max()) <= 2.5 * lr
    assert float((diffs <= 1e-5).float().mean()) >= 0.999


def test_trainer_pipeline_on_card_launches_fingerprint(cuda):
    """The trainer's producer thread runs the pipeline on the card: each
    refill hashes its blocks in one fingerprint launch, and the batches the
    trainer consumes equal the same pipeline's on the host (a cache that
    evicts nothing)."""
    from repro_torch.data import DedupIngestPipeline
    from repro_torch.launch.train import default_tenants
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model, params = _smoke_model(cuda)
    kw = dict(block_tokens=64, vocab=model.cfg.vocab_size, cache_entries=1 << 16)
    card = DedupIngestPipeline(default_tenants(), device=cuda, **kw)
    host = DedupIngestPipeline(default_tenants(), device="cpu", **kw)
    tr = Trainer(model, AdamW(learning_rate=1e-3, warmup_steps=2), params,
                 card.batches(4, 128), TrainerConfig(steps=4, log_every=0))
    consumed, to_device = [], tr._device_batch
    tr._device_batch = lambda b: (consumed.append(_digest(b)), to_device(b))[1]
    before = LAUNCHES["fingerprint"]
    out = tr.run()
    assert out["restarts"] == 0 and out["final_step"] == 4 and np.all(np.isfinite(out["losses"]))
    assert LAUNCHES["fingerprint"] - before == card.metrics.blocks_in // 64 > 0
    assert consumed == [_digest(host.next_batch(4, 128)) for _ in range(4)]


def test_checkpoint_saved_on_card_restores_on_host(cuda, tmp_path):
    """Weights and an optimizer state with bf16 moments, saved from the card
    (asynchronously, then changed in place), restore on the host bit for
    bit, and back onto the card."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.train.optimizer import AdamW

    _, params = _smoke_model(cuda)
    state = AdamW(moment_dtype="bfloat16").init(params)
    state = state._replace(mu=tree_map(lambda t: torch.randn_like(t), state.mu))
    tree = {"params": params, "opt": state}
    want = tree_map(lambda t: t.cpu().clone(), tree)
    ckpt.save(str(tmp_path), 3, tree, async_save=True).join(60)
    tree_map(lambda t: t.add_(1), params)
    host = ckpt.restore(str(tmp_path), 3, tree, device="cpu")
    for got, exp in zip(leaves(host), leaves(want)):
        assert got.device.type == "cpu" and got.dtype == exp.dtype
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           exp.view(torch.int16) if exp.dtype == torch.bfloat16 else exp)
    back = ckpt.restore(str(tmp_path), 3, tree)
    assert all(t.device.type == "cuda" for t in leaves(back["params"]))
    assert back["opt"].step.device.type == "cpu"


# -- the other block kinds (MoE, windowed attention, M-RoPE, RG-LRU, RWKV6,
#    encoder-decoder): the card against the same code on the host ------------------

BLOCK_ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b", "qwen2-vl-7b", "recurrentgemma-2b",
               "rwkv6-1.6b"]


def _block_params(arch, **extra):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32", **extra)
    return cfg, build_model(cfg).init(torch.Generator().manual_seed(0))


def _to(tree, device):
    from repro_torch.pytree import tree_map

    return tree_map(lambda t: t.to(device), tree)


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_block_model_on_card_matches_host(cuda, arch):
    """Float32 ``train_loss`` and its gradients (at 64 tokens, past the smoke
    windows), ``prefill`` and a ``decode_step`` at position S, card against
    host: loss within 1e-5, gradients and logits within 1e-4."""
    from repro_torch.models import build_model
    from repro_torch.pytree import leaves

    cfg, params = _block_params(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 65))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": np.ones((2, 64), np.float32)}
    out = {}
    for device in ("cpu", cuda):
        p = _to(params, device)
        for t in leaves(p):
            t.requires_grad_(True)
        model = build_model(cfg)
        loss, _ = model.train_loss(p, {k: torch.from_numpy(v).to(device)
                                       for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves(p))
        x = torch.from_numpy(toks[:, :32]).to(device)
        logits, cache = model.prefill(p, {"inputs": x}, slots=33)
        step, _ = model.load(p).decode_step(cache, x[:, :1], 32)
        out[str(device)] = (float(loss), [g.cpu() for g in grads], logits.cpu(), step.cpu())
    (l0, g0, p0, s0), (l1, g1, p1, s1) = out["cpu"], out[str(cuda)]
    assert abs(l0 - l1) <= 1e-5
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-4
    assert float((p0 - p1).abs().max()) <= 1e-4 and float((s0 - s1).abs().max()) <= 1e-4


@pytest.mark.parametrize("e,k", [(4, 2), (8, 1), (8, 2)])
def test_moe_dispatch_on_card_matches_host(cuda, e, k):
    """Routing (experts, sorted order, kept assignments) equal, outputs
    within 1e-5, at a capacity that drops (0.5) and one that does not."""
    from repro_torch.models import moe
    from repro_torch.models.layers import ParamFactory

    p = moe.init_moe(ParamFactory(torch.Generator().manual_seed(e), torch.float32), 16, 32, e,
                     "swiglu")
    x = torch.randn(96, 16, generator=torch.Generator().manual_seed(1))
    for cf in (0.5, float(e) / k):
        host = moe.route(x, p["router"], k, cf)
        card = moe.route(x.to(cuda), p["router"].to(cuda), k, cf)
        for a, b in zip(host[1:6], card[1:6]):
            assert torch.equal(a, b.cpu()) if a.dtype != torch.float32 else \
                float((a - b.cpu()).abs().max()) <= 1e-6
        assert torch.equal(host.keep, card.keep.cpu())
        want, aux = moe.moe_apply(p, x.view(2, 48, 16), top_k=k, capacity_factor=cf)
        got, aux_c = moe.moe_apply(_to(p, cuda), x.view(2, 48, 16).to(cuda), top_k=k,
                                   capacity_factor=cf)
        assert float((got.cpu() - want).abs().max()) <= 1e-5
        assert abs(float(aux_c) - float(aux)) <= 1e-6


def test_recurrent_blocks_on_card_match_host(cuda):
    """RG-LRU and RWKV6 train paths, their final states, and 4 decode steps
    from them, card against host within 1e-5."""
    from repro_torch.models import rglru, rwkv6
    from repro_torch.models.layers import ParamFactory

    pf = ParamFactory(torch.Generator().manual_seed(0), torch.float32)
    rg, tm = rglru.init_rglru(pf, 16, 24, 4), rwkv6.init_rwkv_tm(pf, 16, 2, 8)
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(1))
    steps = torch.randn(4, 2, 1, 16, generator=torch.Generator().manual_seed(2))
    out = {}
    for device in ("cpu", cuda):
        prg, ptm, xd = _to(rg, device), _to(tm, device), x.to(device)
        y, st = rglru.rglru_train(prg, xd)
        z, wst = rwkv6.rwkv_tm_train(ptm, xd, 2, 8)
        seq = [y, z, st.h, wst.s]
        s, shift = wst.s, wst.shift_tm
        for t in steps.to(device):
            a, st = rglru.rglru_decode(prg, t, st)
            b, s, shift = rwkv6.rwkv_tm_decode(ptm, t, s, shift, 2, 8)
            seq += [a, b]
        out[str(device)] = [v.cpu() for v in seq]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert float((a - b).abs().max()) <= 1e-5


def test_encoder_decoder_on_card_matches_host(cuda):
    """Whisper-small's smoke model: ``train_loss``, ``encode_prefill`` and 4
    decode steps, card against host within 1e-4."""
    from repro_torch.models import build_model

    cfg, params = _block_params("whisper-small")
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    out = {}
    for device in ("cpu", cuda):
        p, model = _to(params, device), build_model(cfg)
        e = torch.from_numpy(emb).to(device)
        t = torch.from_numpy(toks).to(device)
        batch = {"encoder_embeds": e, "decoder_tokens": t[:, :-1], "targets": t[:, 1:],
                 "mask": torch.ones(2, 8, device=device)}
        loss, _ = model.train_loss(p, batch)
        enc, cache = model.prefill(p, {"encoder_embeds": e}, slots=8)
        model.load(p)
        seq = [loss.reshape(1), enc]
        for pos in range(4):
            logits, cache = model.decode_step(cache, t[:, pos:pos + 1], pos)
            seq.append(logits)
        out[str(device)] = [v.detach().cpu() for v in seq]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert float((a - b).abs().max()) <= 1e-4


def test_mixtral_server_on_card_matches_host(cuda):
    """The KV-page server on Mixtral's smoke model with its window at
    ``max_slots`` (128), float32: metrics, pages and decoded tokens equal on
    the card and the host; the fingerprint kernel launched."""
    from repro_torch.models import build_model
    from repro_torch.serving.dedup_kv import DedupKVServer

    cfg, params = _block_params("mixtral-8x7b", attn_window=128)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 512, 48)
    mix = [np.concatenate([prompt, rng.integers(0, 512, 8)]) for _ in range(4)]
    out = {}
    before = LAUNCHES["fingerprint"]
    for device in ("cpu", cuda):
        srv = DedupKVServer(build_model(cfg), _to(params, device), page_tokens=16,
                            max_slots=128, cache_entries=128, device=device)
        last = [srv.prefill_request(0, toks) for toks in mix][-1]
        out[str(device)] = (dataclasses.asdict(srv.metrics), sorted(srv.pages),
                            srv.decode(last[0], last[1], steps=4)[0])
    assert out["cpu"] == out[str(cuda)]
    assert out["cpu"][0]["blocks_prefill_skipped"] > 0
    assert LAUNCHES["fingerprint"] - before >= len(mix)


def test_launcher_trains_rwkv6_on_card(cuda):
    """``launch/train.py``'s ``build`` on RWKV6's smoke model on the card: 3
    steps, finite losses, the pipeline's fingerprint kernel launched."""
    from repro_torch.launch import train as launch

    args = launch.parse_args(["--arch", "rwkv6-1.6b", "--smoke", "--steps", "3", "--batch", "2",
                              "--seq", "64", "--device", "cuda"])
    before = LAUNCHES["fingerprint"]
    trainer, _ = launch.build(args)
    out = trainer.run()
    assert out["final_step"] == 3 and out["restarts"] == 0 and np.all(np.isfinite(out["losses"]))
    assert LAUNCHES["fingerprint"] > before


SCHEDULES = [("flash", 2048, dict(causal=True, window=0)),
             ("flash", 2048, dict(causal=False, window=0)),
             ("flash", 2048, dict(causal=True, window=512)),
             ("banded", 2048, dict(window=512)),
             ("banded", 4096, dict(window=1024))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("kind,s,kw", SCHEDULES,
                         ids=[f"{k}-{s}-{kw['window']}-{kw.get('causal', True)}"
                              for k, s, kw in SCHEDULES])
def test_attention_schedule_on_card_matches_plain(cuda, kind, s, kw, dtype):
    """``flash_attend`` and ``banded_attend`` against ``attend_plain`` (the
    whole Sq x Sk) on the card, 8 query heads over 2 KV heads of 64: the
    output and the gradients of ``sum(out * w)``; float32 within 3e-5
    (gradients 1e-4), bf16 within one bf16 step (2^-7 of the plain value)
    plus those, element by element."""
    from repro_torch.models import attention

    gen = torch.Generator(cuda).manual_seed(s + kw["window"])
    q = torch.randn(2, s, 8, 64, device=cuda, generator=gen).to(dtype)
    k = torch.randn(2, s, 2, 64, device=cuda, generator=gen).to(dtype)
    v = torch.randn(2, s, 2, 64, device=cuda, generator=gen).to(dtype)
    w = torch.randn(2, s, 8, 64, device=cuda, generator=gen)
    fn = attention.flash_attend if kind == "flash" else attention.banded_attend
    got = {}
    for name, f in (("schedule", lambda *a: fn(*a, **kw)),
                    ("plain", lambda *a: attention.attend_plain(
                        *a, causal=kw.get("causal", True), window=kw["window"]))):
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = f(*ins)
        assert out.dtype == dtype and out.shape == q.shape
        (out.float() * w).sum().backward()
        got[name] = [out.detach().float()] + [t.grad.float() for t in ins]
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for what, a, b in zip(("out", "dq", "dk", "dv"), got["schedule"], got["plain"]):
        atol = 3e-5 if what == "out" else 1e-4
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=lambda m, w=what: f"{w}: {m}")


# ---------------------------------------------------------------------------
# Sharding on the card: a one-process NCCL group and its 1 x 1 mesh.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_mesh():
    """The card's 1 x 1 ("data", "model") mesh over a one-process NCCL group
    (in-memory store, no port), for the tests below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_single_process, make_host_mesh

    init_single_process("cuda")
    try:
        yield make_host_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def test_sharded_train_step_on_card_matches_plain(cuda, card_mesh):
    """The smoke TinyLlama in float32: two sharded steps (every leaf a
    DTensor) equal two plain steps, losses and weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import (make_sharded_train_step, make_train_step,
                                              trainable)

    cfg = get_config("tinyllama-1.1b", smoke=True).replace(param_dtype="float32",
                                                           compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    gen = torch.Generator(cuda).manual_seed(1)
    batches = [{"inputs": torch.randint(0, cfg.vocab_size, (8, 64), device=cuda, generator=gen),
                "targets": torch.randint(0, cfg.vocab_size, (8, 64), device=cuda, generator=gen),
                "mask": torch.ones(8, 64, device=cuda)} for _ in range(2)]
    opt = AdamW(learning_rate=1e-3, warmup_steps=1, schedule="constant")
    sds, axes = model.abstract_params()
    specs = param_pspecs(sds, axes, card_mesh, mode="train", fsdp=True)
    bspecs = batch_pspecs(cfg, "train", 8, card_mesh)
    sharded = trainable(distribute_tree(tree_map(torch.clone, params), specs, card_mesh))
    plain = trainable(params)
    dstate, state = opt.init(sharded), opt.init(plain)
    sstep, step = make_sharded_train_step(model, opt, card_mesh), make_train_step(model, opt)
    for b in batches:
        plain, state, loss, _ = step(plain, state, b)
        sharded, dstate, dloss, _ = sstep(sharded, dstate, distribute_tree(b, bspecs, card_mesh))
        assert abs(float(dloss) - float(loss)) <= 1e-5 * abs(float(loss))
    with torch.no_grad():
        for a, b in zip(leaves(sharded), leaves(plain)):
            assert float((a.to_local() - b).abs().max()) <= 1e-6


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_sharded_remat_step_on_card_matches_plain(cuda, card_mesh, remat):
    """The smoke TinyLlama in float32 under remat "dots" and "full" (the local
    regions recomputed in backward): two sharded steps equal two plain steps
    with the same policy, losses and weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import (make_sharded_train_step, make_train_step,
                                              trainable)

    cfg = get_config("tinyllama-1.1b", smoke=True).replace(param_dtype="float32",
                                                           compute_dtype="float32")
    model = build_model(cfg, remat=remat)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    gen = torch.Generator(cuda).manual_seed(1)
    batches = [{"inputs": torch.randint(0, cfg.vocab_size, (8, 64), device=cuda, generator=gen),
                "targets": torch.randint(0, cfg.vocab_size, (8, 64), device=cuda, generator=gen),
                "mask": torch.ones(8, 64, device=cuda)} for _ in range(2)]
    opt = AdamW(learning_rate=1e-3, warmup_steps=1, schedule="constant")
    sds, axes = model.abstract_params()
    specs = param_pspecs(sds, axes, card_mesh, mode="train", fsdp=True)
    bspecs = batch_pspecs(cfg, "train", 8, card_mesh)
    sharded = trainable(distribute_tree(tree_map(torch.clone, params), specs, card_mesh))
    plain = trainable(params)
    dstate, state = opt.init(sharded), opt.init(plain)
    sstep, step = make_sharded_train_step(model, opt, card_mesh), make_train_step(model, opt)
    for b in batches:
        plain, state, loss, _ = step(plain, state, b)
        sharded, dstate, dloss, _ = sstep(sharded, dstate, distribute_tree(b, bspecs, card_mesh))
        assert abs(float(dloss) - float(loss)) <= 1e-5 * abs(float(loss))
    with torch.no_grad():
        for a, b in zip(leaves(sharded), leaves(plain)):
            assert float((a.to_local() - b).abs().max()) <= 1e-6


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_sharded_prefill_and_decode_on_card_match_plain(cuda, card_mesh, arch):
    """Sharded prefill into a cache placed by ``cache_pspecs`` and 4 sharded
    decode steps on the 1 x 1 mesh equal the plain ones (float32 logits
    within 1e-5 of their largest)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.train_step import (make_serve_step, make_sharded_prefill_step,
                                              make_sharded_serve_step)

    cfg = get_config(arch, smoke=True).replace(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(2))
    gen = torch.Generator(cuda).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), device=cuda, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (4, 4, 1), device=cuda, generator=gen)
    logits, cache = model.prefill(params, {"inputs": prompt}, 68)
    serve = make_serve_step(model)
    want = [logits] + [serve(params, cache, toks[i], 64 + i)[0] for i in range(4)]
    sds, axes = model.abstract_params()
    dparams = distribute_tree(params, param_pspecs(sds, axes, card_mesh, mode="serve",
                                                   fsdp=False), card_mesh)
    dlogits, dcache = make_sharded_prefill_step(model, card_mesh, 68)(
        dparams, distribute_tree({"inputs": prompt}, batch_pspecs(cfg, "prefill", 4, card_mesh),
                                 card_mesh))
    dserve = make_sharded_serve_step(model, card_mesh)
    got = [dlogits] + [dserve(dparams, dcache, distribute_tensor(toks[i], card_mesh,
                                                                 [Replicate(), Replicate()]),
                              64 + i)[0] for i in range(4)]
    for a, b in zip(got, want):
        assert float((a.full_tensor() - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_moe_mesh_branch_on_card_group_of_one(cuda, card_mesh):
    from repro_torch.act_sharding import activation_rules
    from repro_torch.models import moe
    from repro_torch.models.layers import ParamFactory

    p = moe.init_moe(ParamFactory(torch.Generator(cuda).manual_seed(0), torch.float32), 64, 128,
                     8, "swiglu")
    x = torch.randn(4, 32, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    want, want_aux = moe.moe_apply(p, x, top_k=2, capacity_factor=4.0)
    with activation_rules(card_mesh):
        got, aux = moe.moe_apply(p, x, top_k=2, capacity_factor=4.0)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))


def test_restore_onto_card_mesh(cuda, card_mesh, tmp_path):
    from repro_torch.ckpt import checkpoint as ckpt

    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.arange(6.0)}
    ckpt.save(str(tmp_path), 1, tree)
    like = {k: torch.empty(v.shape, device="meta") for k, v in tree.items()}
    back = ckpt.restore(str(tmp_path), 1, like, mesh=card_mesh,
                        specs={"w": ("data", "model"), "b": ()})
    for k, v in tree.items():
        assert back[k].device.type == "cuda"
        assert torch.equal(back[k].full_tensor().cpu(), v)


EXAMPLES = [
    ("torch_quickstart.py",),
    ("torch_serve_kv_dedup.py",),
    ("torch_train_e2e.py", "--steps", "6", "--d-model", "64", "--layers", "2", "--batch", "2",
     "--seq", "64", "--ckpt-every", "3"),
    ("torch_paper_comparison.py", "--requests", "20000"),
]


@pytest.mark.parametrize("argv", EXAMPLES, ids=[a[0] for a in EXAMPLES])
def test_example_on_card(cuda, argv, tmp_path):
    """Each port example with ``--device cuda`` at its smallest size."""
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    args = list(argv[1:]) + (["--ckpt-dir", str(tmp_path)] if "torch_train_e2e" in argv[0]
                             else [])
    out = subprocess.run([sys.executable, os.path.join(root, "examples", argv[0]), *args,
                          "--device", "cuda"], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")), cwd=root)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec
