"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor the reference package, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The plain versions themselves are held against the reference package on the
CPU in ``test_torch_fingerprint.py``, ``test_torch_fp_index.py``,
``test_torch_engine.py`` and ``test_torch_cdc.py``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import ContentDefinedChunker, HPDedup, generate_workload
from repro_torch.core.fp_index import SMALL_BATCH_CARD, TOMB_KEY, FingerprintIndex
from repro_torch.core.unseen import ldss_batch
from repro_torch.kernels import cdc
from repro_torch.kernels import fp_index as k
from repro_torch.kernels import ops
from repro_torch.kernels._build import LAUNCHES
from repro_torch.kernels.fingerprint import fingerprint, fingerprint_torch
from repro_torch.kernels.ref import cdc_golden_buffer, fingerprint_golden_numpy

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


@pytest.mark.parametrize("w_pad", [128, 1024, 4096])
def test_chunk_fingerprint_kernel_matches_plain(cuda, w_pad):
    r, max_size = 64, 4 * w_pad
    t = _haloed(r, w_pad)
    total = r * cdc.SEG_BYTES
    rng = np.random.default_rng(w_pad)
    lens = rng.integers(1, max_size + 1, size=500)
    lens[:11] = [1, max_size, 2, 3, 4, 5, max_size, 5, 7, max_size, max_size]
    starts = rng.integers(0, total - max_size, size=500)
    # bytes before offset 0 and past the payload read as zero
    starts[:11] = [0, 1, 2, 3, 2046, 2047, total - max_size, total - 5, -3, -2049,
                   total - 1001]
    s, n = torch.from_numpy(starts.astype(np.int64)), torch.from_numpy(lens.astype(np.int32))
    before = LAUNCHES["chunk_fingerprint"]
    got = ops.chunk_fingerprint(t.to(cuda), s.to(cuda), n.to(cuda), w_pad)
    torch.cuda.synchronize()
    assert LAUNCHES["chunk_fingerprint"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ops.chunk_fingerprint_torch(t, s, n, w_pad).numpy())


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
