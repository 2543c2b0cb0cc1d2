"""The port's examples (``examples/torch_*.py``) on the CPU at their
smallest size, each as a subprocess with a timeout, against what the
reference's example computes at the same size.

Run: PYTHONPATH=src python -m pytest -q tests/test_torch_examples.py

* ``torch_quickstart``: the batches the trainer took (SHA-256) and the
  pipeline's metrics after the batches it made equal the reference
  pipeline's; the LDSS predictions within 1e-3 relative (the port's torch
  solver, ROADMAP section 3); the loss falls.
* ``torch_serve_kv_dedup``: the prefill and HBM metrics equal the ones the
  reference example prints (the decoded tokens differ: the weights come
  from a ``torch.Generator``).
* ``torch_train_e2e`` at 2 layers of width 64, 6 steps of 2 x 64, a
  checkpoint every 3: batches and metrics as for the quickstart.
* ``torch_paper_comparison`` at 20,000 requests: the three reports' inline
  ratios and peak blocks equal the reference engines' bit for bit.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 240


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), *args],
                         capture_output=True, text=True, env=env, timeout=TIMEOUT_S, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout, json.loads(out.stdout.strip().splitlines()[-1])


def _ref_batches(tenants, batch, seq, made, steps, **kw):
    """The reference pipeline after ``made`` batches: (SHA-256 of the first
    ``steps``, its metrics, the pipeline)."""
    from repro.data.pipeline import DedupIngestPipeline

    pipe = DedupIngestPipeline(tenants, **kw)
    sha = hashlib.sha256()
    it = pipe.batches(batch, seq)
    for i in range(made):
        b = next(it)
        if i < steps:
            for k in sorted(b):
                sha.update(k.encode() + b[k].tobytes())
    return sha.hexdigest(), pipe.metrics, pipe


def test_quickstart(tmp_path):
    from repro.data.pipeline import TenantSpec

    text, rec = _run("torch_quickstart.py", "--device", "cpu")
    assert "loss:" in text and "ingested blocks:" in text and "predicted LDSS" in text
    tenants = [
        TenantSpec(0, rate=2.0, dup_ratio=0.75, locality="good", overlap_group="shared"),
        TenantSpec(1, rate=1.0, dup_ratio=0.10, locality="weak", overlap_group="shared"),
    ]
    sha, m, pipe = _ref_batches(tenants, 4, 64, rec["batches_made"], 30, block_tokens=32,
                                vocab=512, cache_entries=512)
    assert rec["steps"] == 30 and rec["batches_made"] >= 30
    assert rec["batches_sha256"] == sha
    assert (rec["blocks_in"], rec["deduped_inline"]) == (m.blocks_in, m.blocks_deduped_inline)
    assert rec["dedup_saving"] == m.dedup_saving
    ref_ldss = pipe.engine.inline.estimator.predicted
    assert set(rec["ldss"]) == {str(k) for k in ref_ldss}
    for k, v in ref_ldss.items():
        assert abs(rec["ldss"][str(k)] - v) <= 1e-3 * max(abs(v), 1.0), (k, v)
    assert rec["final_loss"] < rec["first_loss"]


def test_serve_kv_dedup():
    text, rec = _run("torch_serve_kv_dedup.py", "--device", "cpu")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "serve_kv_dedup.py")],
                         capture_output=True, text=True, env=env, timeout=TIMEOUT_S, cwd=ROOT)
    assert ref.returncode == 0, ref.stderr[-4000:]
    blocks = re.search(r"prefill blocks: (\d+), skipped via dedup: (\d+)", ref.stdout)
    saved = re.search(r"prefill compute saved: ([\d.]+)%; KV HBM saved: ([\d.]+)%", ref.stdout)
    assert (rec["blocks_total"], rec["blocks_prefill_skipped"]) == \
        (int(blocks.group(1)), int(blocks.group(2)))
    assert (f"{rec['prefill_saving']:.1%}", f"{rec['hbm_saving']:.1%}") == \
        (saved.group(1) + "%", saved.group(2) + "%")
    # the port prints the reference's lines
    for line in ref.stdout.splitlines()[1:]:
        assert line in text
    assert len(rec["decoded"]) == 8


def test_train_e2e(tmp_path):
    from repro.data.pipeline import TenantSpec

    ckpt = tmp_path / "ckpt"
    text, rec = _run("torch_train_e2e.py", "--steps", "6", "--d-model", "64", "--layers", "2",
                     "--batch", "2", "--seq", "64", "--ckpt-every", "3",
                     "--ckpt-dir", str(ckpt), "--device", "cpu")
    assert "model:" in text and "dedup saved" in text
    assert rec["steps"] == 6 and rec["restarts"] == 0
    assert sorted(os.listdir(ckpt)) == ["step_3", "step_6"]
    tenants = [
        TenantSpec(0, rate=3.0, dup_ratio=0.8, locality="good", overlap_group="g"),
        TenantSpec(1, rate=2.0, dup_ratio=0.1, locality="weak", overlap_group="g"),
        TenantSpec(2, rate=1.0, dup_ratio=0.5, locality="good"),
    ]
    sha, m, _ = _ref_batches(tenants, 2, 64, rec["batches_made"], 6, block_tokens=64,
                             vocab=32000, cache_entries=8192)
    assert rec["batches_sha256"] == sha
    assert (rec["blocks_in"], rec["deduped_inline"], rec["dedup_saving"]) == \
        (m.blocks_in, m.blocks_deduped_inline, m.dedup_saving)


def test_paper_comparison():
    from repro.core import HPDedup, PurePostProcessing, generate_workload, make_idedup

    text, rec = _run("torch_paper_comparison.py", "--requests", "20000", "--device", "cpu")
    assert "HPDedup inline-ratio improvement over iDedup" in text
    trace, _ = generate_workload("C", total_requests=20_000, seed=0)
    ide = make_idedup(cache_entries=2048)
    ide.replay(trace)
    hp = HPDedup(cache_entries=2048, adaptive_threshold=False, fixed_threshold=4)
    hp.replay(trace)
    reports = {"idedup": ide.finish(run_post_to_exact=False), "hpdedup": hp.finish(),
               "post": PurePostProcessing().replay(trace).finish()}
    for name, r in reports.items():
        assert rec[name]["peak_disk_blocks"] == r.peak_disk_blocks, name
        if name != "post":
            assert rec[name]["inline_dedup_ratio"] == r.inline_dedup_ratio, name


@pytest.mark.parametrize("script", ["torch_quickstart.py", "torch_serve_kv_dedup.py",
                                    "torch_train_e2e.py", "torch_paper_comparison.py"])
def test_examples_import_only_the_port(script):
    with open(os.path.join(ROOT, "examples", script)) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", src, re.M), script
    assert '"--device", default="cuda"' in src
