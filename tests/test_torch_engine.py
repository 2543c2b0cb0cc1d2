"""The port's write path as a whole against the reference package.

Same traces, same engine parameters, ``device="cpu"``: every ``HybridReport``
field and every snapshot tree must equal the reference's.  The engines run
both index backends of the port (numpy, and the plain kernels of the torch
backend).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
import numpy as np
import pytest
import torch  # noqa: F401

import repro.core as R
import repro_torch.core as P
import repro_torch.core.fp_index as port_fp_index
from repro.core.unseen import ldss_batch as ref_ldss_batch
from repro.core.unseen import unseen_estimate_from_counts as ref_unseen
from repro.kernels.ops import fingerprint_ints as ref_fingerprint_ints
from repro_torch.core.ffh import occurrence_counts
from repro_torch.core.unseen import ldss_batch
from repro_torch.kernels.ops import fingerprint_ints

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(params=["numpy", "torch"])
def backend(request, monkeypatch):
    """Run the port's engines on one index backend, with every batched probe
    going through the table (no small-batch host-set shortcut)."""
    monkeypatch.setattr(port_fp_index, "_auto_backend", lambda device: request.param)
    monkeypatch.setattr(port_fp_index, "SMALL_BATCH", 0)
    return request.param


def _engines(pkg, device=None):
    kw = {} if device is None else {"device": device}
    return {
        "hpdedup": lambda: pkg.HPDedup(cache_entries=512, **kw),
        "idedup": lambda: pkg.make_idedup(cache_entries=512, **kw),
        "diode": lambda: pkg.DIODE(cache_entries=512, **kw),
        "postproc": lambda: pkg.PurePostProcessing(**kw),
    }


def _tree(report) -> dict:
    return {
        "inline": report.inline.snapshot(),
        "post": report.post.snapshot(),
        "peak_disk_blocks": report.peak_disk_blocks,
        "final_disk_blocks": report.final_disk_blocks,
        "unique_fingerprints": report.unique_fingerprints,
        "total_writes": report.total_writes,
        "total_dup_writes": report.total_dup_writes,
    }


def _from_tree(tree: dict):
    from repro_torch.core.inline_engine import InlineMetrics
    from repro_torch.core.postprocess import PostProcessMetrics

    return P.HybridReport(
        inline=InlineMetrics.from_snapshot(tree["inline"]),
        post=PostProcessMetrics.from_snapshot(tree["post"]),
        **{key: int(v) for key, v in tree.items() if key not in ("inline", "post")},
    )


def _json(tree):
    return json.loads(json.dumps(tree))


def _overwrite_trace(total=3_000, seed=13, workload="A"):
    """Second half overwrites the first half's keys with new content."""
    base = P.generate_workload(workload, total_requests=total, seed=seed)[0]
    over = base.copy()
    over["ts"] = over["ts"] + int(base["ts"].max()) + 1
    over["fp"] = over["fp"] ^ np.uint64(0x9E3779B97F4A7C15)
    both = np.concatenate([base, over])
    both.sort(order="ts", kind="stable")
    return both


def test_generated_traces_equal_reference():
    for w in ("A", "B", "C"):
        mine, streams = P.generate_workload(w, total_requests=4_000, seed=3)
        ref, ref_streams = R.generate_workload(w, total_requests=4_000, seed=3)
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)
        assert streams == ref_streams
        assert P.trace_stats(mine) == {key: v for key, v in R.trace_stats(ref).items()}


@pytest.mark.parametrize("name", ["hpdedup", "idedup", "diode", "postproc"])
def test_golden_report_fixtures(name, backend):
    with open(os.path.join(GOLDEN_DIR, f"report_{name}.json")) as f:
        golden = json.load(f)
    trace = P.generate_workload("B", total_requests=4_000, seed=23)[0]
    scalar = _engines(P, "cpu")[name]()
    scalar.replay(trace)
    scalar_rep = scalar.finish()
    # field for field, in the fixture's own tree form...
    assert _json(_tree(scalar_rep)) == golden
    assert scalar_rep == _from_tree(golden)
    # ...and the batched path equals it (per-stream dicts compare unordered)
    batched = _engines(P, "cpu")[name]()
    batched.replay_batched(trace, batch_size=512)
    assert dataclasses.asdict(batched.finish()) == dataclasses.asdict(scalar_rep)


@pytest.mark.parametrize("workload", ["A", "B", "C"])
def test_reports_equal_reference(workload, backend):
    trace = P.generate_workload(workload, total_requests=4_000, seed=9)[0]
    for name in ("hpdedup", "diode"):
        want = dataclasses.asdict(_engines(R)[name]().replay_batched(trace, 1024).finish())
        for bs in (257, 2048):
            got = _engines(P, "cpu")[name]().replay_batched(trace, bs).finish()
            assert dataclasses.asdict(got) == want, (name, bs)


def test_overwrite_heavy_reports_equal_reference(backend):
    trace = _overwrite_trace()
    for name, mk in _engines(P, "cpu").items():
        ref = _engines(R)[name]().replay_batched(trace, 1024)
        mine = mk().replay_batched(trace, 1024)
        assert dataclasses.asdict(mine.finish()) == dataclasses.asdict(ref.finish()), name
        # and the finished state trees too
        assert _json(mine.snapshot()) == _json(ref.snapshot()), name


def test_diode_overwrite_flood_store_state_equals_reference():
    """DIODE on an overwrite flood (64 LBAs): the port's store ends in the
    reference's state, ``live_blocks`` and consistency verdict included.

    The reference once drifted ``live_blocks`` on such floods; the port keeps
    whatever the reference does, drift or not, rather than fixing it."""
    trace, streams = P.generate_workload("A", total_requests=12_000, seed=2)
    trace["lba"] = trace["lba"] % 64

    def run(engine):
        engine.replay_batched(trace, 2048)
        report = dataclasses.asdict(engine.finish())
        try:
            engine.store.check_consistency()
            verdict = "consistent"
        except AssertionError as e:
            verdict = str(e)
        return report, engine.store.live_blocks, verdict, _json(engine.store.snapshot())

    ref = run(R.DIODE(cache_entries=128, stream_templates=streams))
    mine = run(P.DIODE(cache_entries=128, stream_templates=streams, device="cpu"))
    assert mine == ref


def test_blocks_to_reports_chain_equals_reference():
    """Block content -> fingerprint -> engine, through each package."""
    rng = np.random.default_rng(0)
    trace = P.generate_workload("A", total_requests=3_000, seed=2)[0]
    w = trace[trace["op"] == P.OP_WRITE]
    uniq, inv = np.unique(w["fp"], return_inverse=True)
    content = rng.integers(0, 256, size=(uniq.size, 1024), dtype=np.uint8)[inv]
    fps = fingerprint_ints(content, device="cpu")
    np.testing.assert_array_equal(fps, ref_fingerprint_ints(content))
    streams, lbas = w["stream"].astype(np.int64), w["lba"].astype(np.int64)
    mine = P.HPDedup(cache_entries=256, device="cpu")
    mine.write_batch(streams, lbas, fps)
    ref = R.HPDedup(cache_entries=256)
    ref.write_batch(streams, lbas, ref_fingerprint_ints(content))
    assert dataclasses.asdict(mine.finish()) == dataclasses.asdict(ref.finish())


@pytest.mark.parametrize("name", ["hpdedup", "idedup", "diode", "postproc"])
def test_reference_snapshot_restores_into_port(name, backend):
    """Reference snapshot mid-trace -> JSON -> port ``restore``; both finish
    the trace: equal reports and equal final snapshot trees."""
    trace = P.generate_workload("A", total_requests=4_000, seed=31)[0]
    cut = 2_111
    ref = _engines(R)[name]()
    R.engine_ingest(ref, trace[:cut], 512)
    tree = _json(ref.snapshot())
    mine = type(_engines(P, "cpu")[name]()).restore(tree, device="cpu")
    assert _json(mine.snapshot()) == tree
    for eng, pkg in ((ref, R), (mine, P)):
        pkg.engine_ingest(eng, trace[cut:], 512)
        pkg.engine_finish_replay(eng)
    assert dataclasses.asdict(mine.finish()) == dataclasses.asdict(ref.finish())
    assert _json(mine.snapshot()) == _json(ref.snapshot())


def test_index_rebuilds_from_reference_key_set():
    keys = np.random.default_rng(1).integers(1, 2**64 - 1, size=5_000, dtype=np.uint64)
    ref = R.FingerprintIndex(keys.tolist(), small_batch=0)
    mine = P.FingerprintIndex(ref, small_batch=0, device="cpu", backend="torch")
    assert set(mine) == set(ref)
    probe = np.concatenate([keys[:100], keys[:100] ^ np.uint64(1)])
    np.testing.assert_array_equal(mine.contains_many(probe), ref.contains_many(probe))
    mine.check_consistency()


def _sample(pop, rate, rng):
    k = max(50, int(rate * pop.size))
    return occurrence_counts(rng.choice(pop, size=k, replace=False))


def test_batched_ldss_solver_close_to_reference():
    """The torch float32 solver against the reference's JAX float32 solver.

    Same algorithm, both in float32, but the matrix products sum in another
    order, and 300 multiplicative updates carry the rounding forward: the
    estimates agree to a relative 1e-3, well inside the 25% the reference
    allows its float32 solver against the scipy oracle (tests/test_unseen.py).
    """
    rng = np.random.default_rng(1)
    pops = [
        np.repeat(np.arange(2000), 5),
        np.concatenate([np.arange(8000), np.arange(1000), np.arange(1000)]),
        np.repeat(np.arange(1000), 10),
        np.arange(10000),
    ]
    counts = [_sample(p, 0.15, rng) for p in pops]
    n = np.array([p.size for p in pops], dtype=np.float64)
    mine = ldss_batch(counts, n, device="cpu")
    ref = ref_ldss_batch(counts, n)
    np.testing.assert_allclose(mine, ref, rtol=1e-3, atol=1.0)
    for c, p, v in zip(counts, pops, mine):
        oracle = p.size - ref_unseen(c, p.size)
        assert abs(v - oracle) <= 0.25 * max(p.size - oracle, len(np.unique(p)))


def test_batched_solver_defaults_to_the_card():
    """Like every entry point of the port, the solver runs on the card unless
    the caller names another device; without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    counts = [np.array([3, 1, 1, 2])]
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        ldss_batch(counts, np.array([40.0]))
    est = P.StreamLocalityEstimator(256, batched_solver=True)
    assert est.device == "cuda"


def test_jax_estimator_flag_runs_torch_solver():
    """``use_jax_estimator=True`` keeps the reference's config key and runs
    the batched float32 solver; reports stay close to the reference's."""
    trace = P.generate_workload("A", total_requests=12_000, seed=4)[0]
    mine = P.HPDedup(cache_entries=256, use_jax_estimator=True, device="cpu")
    ref = R.HPDedup(cache_entries=256, use_jax_estimator=True)
    assert mine.inline.estimator.device == "cpu"  # the solve runs where the engine does
    a = mine.replay_batched(trace, 4096).finish()
    b = ref.replay_batched(trace, 4096).finish()
    assert mine.snapshot()["config"] == ref.snapshot()["config"]
    assert a.total_writes == b.total_writes and a.total_dup_writes == b.total_dup_writes
    assert abs(a.inline_dedup_ratio - b.inline_dedup_ratio) < 0.02


def test_package_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
