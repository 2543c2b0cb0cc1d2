"""The port's content-defined chunking front end against the reference.

The same seeded numpy bytes go through ``repro`` (the Pallas kernels in
interpret mode, and the numpy backend) and ``repro_torch`` (the plain
PyTorch versions on the CPU; ``tests/test_torch_gpu.py`` holds the CUDA
kernels against them on the card).  Candidate flags, chunk ends, chunk
fingerprints, ``ReplayBatch`` columns, trace summaries and replay reports
must be identical, bit for bit.
"""

import dataclasses
import json
import os

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.data.byte_workloads as RW
import repro.kernels.cdc as RK
import repro.kernels.ops as ROPS
import repro_torch.core as P
import repro_torch.data.byte_workloads as PW
import repro_torch.kernels.cdc as PK
import repro_torch.kernels.ops as POPS
from repro.core.cdc import ContentDefinedChunker as RefChunker
from repro.core.cdc import _candidates_numpy as ref_candidates_numpy
from repro_torch.core.cdc import CDCConfig, ContentDefinedChunker
from repro_torch.kernels.ref import cdc_golden_buffer
from test_kernels_golden import _cdc_buffer  # the golden fixtures' buffers

CFG = (256, 1024, 4096)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "cdc_digests.json")


def _bufs(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8) for n in sizes]


def _rows(r, seed):
    """(r, 520) random haloed rows, as numpy uint32 and as a CPU int32 tensor."""
    x = np.random.default_rng(seed).integers(0, 2**32, size=(r, 520), dtype=np.uint32)
    x[0, :] = 0            # zero bytes: GEAR[0] is not 0
    x[1, :] = 0xFFFFFFFF   # every byte 0xFF
    return x, torch.from_numpy(x.view(np.int32))


def _golden_cases():
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert tuple(golden["cfg"]) == CFG
    return golden["cases"]


# -- kernels/cdc.py host helpers ---------------------------------------------------


def test_gear_table_and_constants_match_reference():
    np.testing.assert_array_equal(PK.gear_table(), RK.gear_table())
    for name in ("SEG_BYTES", "SEG_WORDS", "HALO_BYTES", "HALO_WORDS", "TILE_R", "WINDOW",
                 "GEAR_SEED"):
        assert getattr(PK, name) == getattr(RK, name), name


@pytest.mark.parametrize("sizes", [[], [0], [1, 2047, 2048, 2049], [5000, 0, 70_000, 33]])
def test_pack_and_unpack_match_reference(sizes):
    bufs = _bufs(sizes, seed=len(sizes))
    rows, spans = PK.pack_haloed(bufs)
    ref_rows, ref_spans = RK.pack_haloed(bufs)
    assert rows.dtype == ref_rows.dtype
    np.testing.assert_array_equal(rows, ref_rows)
    assert spans == ref_spans
    flags = np.random.default_rng(7).integers(0, 16, size=(rows.shape[0], 512), dtype=np.uint32)
    for span in spans:
        np.testing.assert_array_equal(PK.unpack_candidates(flags, span),
                                      RK.unpack_candidates(flags, span))


# -- the two kernels' plain versions against the Pallas kernels ----------------


@pytest.mark.parametrize("avg_size", [256, 1024, 4096])
@pytest.mark.parametrize("r", [32, 64])
def test_candidates_match_pallas(avg_size, r):
    x, t = _rows(r, seed=avg_size + r)
    want = np.asarray(RK.cdc_candidates_pallas(jnp.asarray(x), avg_size, interpret=True))
    got = PK.cdc_candidates(t, avg_size)
    assert got.dtype == torch.int32 and got.shape == (r, 512)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(PK.cdc_candidates_torch(t, avg_size).numpy(), got.numpy())


def test_candidates_reject_what_the_reference_rejects():
    _, t = _rows(32, seed=1)
    with pytest.raises(ValueError):
        PK.cdc_candidates(t[:31], 1024)  # not a TILE_R multiple
    with pytest.raises(ValueError):
        PK.cdc_candidates(t[:, :519], 1024)  # wrong row width
    with pytest.raises(ValueError):
        PK.cdc_candidates(t, 1000)  # not a power of two
    with pytest.raises(TypeError):
        PK.cdc_candidates(t.to(torch.int64), 1024)


def _chunks(r, max_size, seed):
    """Starts and lengths over r rows: every start phase mod 4, length 1 and
    max_size, chunks crossing rows, and the payload's last byte."""
    rng = np.random.default_rng(seed)
    total = r * PK.SEG_BYTES
    fixed = [(0, 1), (3, max_size), (2046, max_size), (2045, 2), (total - 3, 3), (4093, 4),
             (1, 2047), (total - max_size, max_size), (total - 1, 1), (2047, 2049)]
    lens = rng.integers(1, max_size + 1, size=24)
    starts = rng.integers(0, total - max_size, size=24)
    starts[:4] += np.arange(4) - starts[:4] % 4  # phases 0..3
    starts = np.concatenate([[s for s, _ in fixed], starts]).astype(np.int64)
    lens = np.concatenate([[n for _, n in fixed], lens]).astype(np.int32)
    return starts, lens


@pytest.mark.parametrize("r", [32, 64])
def test_chunk_fingerprint_matches_pallas(r):
    max_size = 4096
    x, t = _rows(r, seed=r)
    starts, lens = _chunks(r, max_size, seed=r)
    assert (starts + lens <= r * PK.SEG_BYTES).all()
    pad = (-starts.size) % 256  # the reference's fingerprint tile
    s_pad = np.concatenate([starts, np.zeros(pad, dtype=np.int64)]).astype(np.int32)
    l_pad = np.concatenate([lens, np.zeros(pad, dtype=np.int32)])
    want = np.asarray(ROPS._chunk_fp_jit(jnp.asarray(x), jnp.asarray(s_pad), jnp.asarray(l_pad),
                                         max_size // 4, True))[: starts.size]
    got = POPS.chunk_fingerprint(t, torch.from_numpy(starts), torch.from_numpy(lens),
                                 max_size // 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        POPS.cdc_chunk_fingerprints(t, starts, lens, max_size),
        ROPS.cdc_chunk_fingerprints(x, starts, lens, max_size, interpret=True))


def test_chunk_fingerprints_reject_chunks_outside_the_payload():
    _, t = _rows(32, seed=2)
    total = 32 * PK.SEG_BYTES
    for starts, lens in (([total - 10], [11]), ([-1], [5]), ([0], [4097])):
        with pytest.raises(ValueError):
            POPS.cdc_chunk_fingerprints(t, starts, lens, 4096)
    with pytest.raises(TypeError):
        POPS.chunk_fingerprint(t, torch.zeros(1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32), 1024)


@pytest.mark.parametrize("sizes", [[0, 100, 2048, 2049, 40_000], [70_000], [0]])
def test_candidate_positions_match_unpack(sizes):
    bufs = _bufs(sizes, seed=sum(sizes))
    rows, spans = PK.pack_haloed(bufs)
    flags = POPS.cdc_candidate_flags(rows, 256, device="cpu")
    host = flags.numpy().view(np.uint32)
    got = POPS.candidate_positions(flags, spans)
    for g, span, buf in zip(got, spans, bufs):
        np.testing.assert_array_equal(g, RK.unpack_candidates(host, span))
        np.testing.assert_array_equal(g, ref_candidates_numpy(buf, 256))


# -- core/cdc.py: the chunker ----------------------------------------------------


def _port(backend):
    return ContentDefinedChunker(*CFG, backend=backend, device="cpu")


@pytest.mark.parametrize("backend", ["device", "numpy", "scalar"])
@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: f"{c['name']}_{c['n']}")
def test_golden_digests(case, backend):
    ends, fps = _port(backend).chunk_fingerprints(
        _cdc_buffer(case["name"], case["n"], case["salt"]))
    assert ends.tolist() == case["ends"]
    assert [f"{int(v):016x}" for v in fps] == case["fp64_hex"]


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: f"{c['name']}_{c['n']}")
def test_port_golden_buffer_matches_reference(case):
    """The port's maker of the golden buffers, used on the card, makes the
    reference test's bytes."""
    args = case["name"], case["n"], case["salt"]
    got = cdc_golden_buffer(*args)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cdc_buffer(*args))


EDGE_SIZES = [0, 100, 255, 1000, 2048, 2049, 4095, 5000, 40_000]


@pytest.mark.parametrize("ref_backend", ["pallas", "numpy"])
def test_backends_match_reference_on_many_buffers(ref_backend):
    bufs = _bufs(EDGE_SIZES, seed=3)
    want = RefChunker(*CFG, backend=ref_backend).chunk_fingerprints_many(bufs)
    for backend in ("device", "numpy", "scalar"):
        got = _port(backend).chunk_fingerprints_many(bufs)
        assert len(got) == len(want)
        for (e1, f1), (e2, f2), n in zip(want, got, EDGE_SIZES):
            np.testing.assert_array_equal(e1, e2, err_msg=f"{backend} ends n={n}")
            np.testing.assert_array_equal(f1, f2, err_msg=f"{backend} fps n={n}")
        ends = _port(backend).chunk_many(bufs)
        for (e1, _), e2 in zip(want, ends):
            np.testing.assert_array_equal(e1, e2)


@pytest.mark.parametrize("cfg", [(256, 1024, 4096), (2048, 4096, 16384), (64, 128, 512)])
def test_device_backend_matches_reference_across_configs(cfg):
    bufs = _bufs([3000, 70_000, 12_345], seed=sum(cfg))
    want = RefChunker(*cfg, backend="numpy").chunk_fingerprints_many(bufs)
    ck = ContentDefinedChunker(*cfg, device="cpu")
    assert ck.backend == "device"
    got = ck.chunk_fingerprints_many(bufs)
    for (e1, f1), (e2, f2) in zip(want, got):
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(f1, f2)
    assert set(ck.stage_seconds) == {"pack", "upload", "candidates", "select", "chunk_fp"}


def test_batch_from_buffers_matches_reference_with_carried_lbas():
    bufs = _bufs([5000, 40_000, 0, 9000, 12_000], seed=8)
    sids = [3, 1, 3, 1, 7]
    ref, port = RefChunker(*CFG, backend="numpy"), _port("device")
    ref_next, port_next = {1: 10}, {1: 10}
    for half in (slice(0, 3), slice(3, 5)):
        rb, rl = ref.batch_from_buffers(sids[half], bufs[half], lba_next=ref_next)
        pb, pl = port.batch_from_buffers(sids[half], bufs[half], lba_next=port_next)
        for col in ("stream", "lba", "fp"):
            a, b = getattr(rb, col), getattr(pb, col)
            assert a.dtype == b.dtype, col
            np.testing.assert_array_equal(a, b, err_msg=col)
        np.testing.assert_array_equal(rl, pl)
        assert rl.dtype == pl.dtype
        assert ref_next == port_next
    with pytest.raises(ValueError):
        port.batch_from_buffers([1], bufs[:2])


def test_config_validation_and_backends():
    CDCConfig(256, 1024, 4096)
    for bad in ((32, 1024, 4096), (256, 1000, 4096), (2048, 1024, 4096), (256, 1024, 1000),
                (256, 1024, 32768)):
        with pytest.raises(ValueError):
            CDCConfig(*bad)
    with pytest.raises(ValueError):
        ContentDefinedChunker(backend="pallas", device="cpu")  # the port's is "device"
    assert P.CDCConfig is CDCConfig and P.ContentDefinedChunker is ContentDefinedChunker


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in (None, "numpy", "scalar"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ContentDefinedChunker(*CFG, backend=backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContentDefinedChunker(*CFG, device="cuda")


# -- data/byte_workloads.py, traces and replays ----------------------------------

WORKLOADS = {
    "vm_image": dict(num_streams=2, base_size=64 * 1024, versions=2, edits_per_version=3,
                     seed=0),
    "log_append": dict(num_streams=2, snapshots=3, append_size=16 * 1024, seed=1),
}


def _make(pkg, name):
    fn = pkg.vm_image_workload if name == "vm_image" else pkg.log_append_workload
    return fn(**WORKLOADS[name])


@pytest.fixture(scope="module", params=sorted(WORKLOADS))
def traces(request):
    name = request.param
    ref_w, port_w = _make(RW, name), _make(PW, name)
    ref_trace, ref_lens = RW.byte_trace(RefChunker(*CFG, backend="numpy"), ref_w)
    port_trace, port_lens = PW.byte_trace(_port("device"), port_w)
    return name, ref_w, port_w, ref_trace, ref_lens, port_trace, port_lens


def test_workloads_match_reference(traces):
    name, ref_w, port_w, *_ = traces
    assert port_w.name == ref_w.name == name
    assert port_w.stream_ids == ref_w.stream_ids
    assert len(port_w.buffers) == len(ref_w.buffers)
    for a, b in zip(ref_w.buffers, port_w.buffers):
        np.testing.assert_array_equal(a, b)
    assert (port_w.fresh_bytes, port_w.boundary_events, port_w.total_bytes) == \
        (ref_w.fresh_bytes, ref_w.boundary_events, ref_w.total_bytes)
    for max_size in (4096, 16384):
        assert PW.analytic_bounds(port_w, max_size) == RW.analytic_bounds(ref_w, max_size)


def test_byte_trace_and_stats_match_reference(traces):
    _, ref_w, _, ref_trace, ref_lens, port_trace, port_lens = traces
    assert port_trace.dtype == ref_trace.dtype
    np.testing.assert_array_equal(port_trace, ref_trace)
    np.testing.assert_array_equal(port_lens, ref_lens)
    st = P.trace_stats(port_trace, chunk_bytes=port_lens)
    assert st == R.trace_stats(ref_trace, chunk_bytes=ref_lens)
    assert P.trace_stats(port_trace) == R.trace_stats(ref_trace)
    lower, upper = RW.analytic_bounds(ref_w, CFG[2])
    assert lower <= st["byte_dup_ratio"] <= upper
    with pytest.raises(ValueError):
        P.trace_stats(port_trace, chunk_bytes=port_lens[:-1])


def test_round_by_round_ingest_matches_byte_trace(traces):
    """One ``batch_from_buffers`` call per snapshot round, ``lba_next``
    carried and joined by ``batches_trace``, gives ``byte_trace``'s trace."""
    _, _, port_w, _, _, port_trace, port_lens = traces
    chunker, lba_next = _port("device"), {}
    per_round = len(set(port_w.stream_ids))
    batches, lens = [], []
    for a in range(0, len(port_w.buffers), per_round):
        batch, ln = chunker.batch_from_buffers(port_w.stream_ids[a:a + per_round],
                                               port_w.buffers[a:a + per_round],
                                               lba_next=lba_next)
        batches.append(batch)
        lens.append(ln)
    np.testing.assert_array_equal(PW.batches_trace(batches), port_trace)
    np.testing.assert_array_equal(np.concatenate(lens), port_lens)
    assert PW.batches_trace([]).size == 0


@pytest.mark.parametrize("engine", ["HPDedup", "PurePostProcessing"])
def test_replay_reports_match_reference(traces, engine):
    _, _, _, ref_trace, _, port_trace, _ = traces
    kw = {"cache_entries": 512} if engine == "HPDedup" else {}
    ref_eng = getattr(R, engine)(**kw)
    R.run_replay(ref_eng, ref_trace)
    port_eng = getattr(P, engine)(device="cpu", **kw)
    P.run_replay(port_eng, port_trace)
    want, got = ref_eng.finish(), port_eng.finish()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    batched = getattr(P, engine)(device="cpu", **kw).replay_batched(port_trace, 1024).finish()
    assert dataclasses.asdict(batched) == dataclasses.asdict(want)
