"""The port's launchers (``repro_torch.launch.{analytic,dryrun,mesh}``)
against the reference's, on the CPU.

Run: PYTHONPATH=src python -m pytest -q tests/test_torch_launch.py

* ``analytic_terms`` equal the reference's with ``==`` for every id x shape
  x production mesh x remat policy (and the FSDP, serve-FSDP, bf16-moment
  and compression knobs).
* ``skip_reason`` and the 40 cells equal the reference's; ``input_specs``
  gives the reference's shapes and dtypes, on ``meta``.
* Each cell's parameter bytes per device equal a sum over the reference's
  own spec trees and shapes (``AbstractMesh``), its AdamW state and batch
  bytes likewise; ``main`` writes its records.
* The production mesh shapes, and a one-process gloo mesh (in a
  subprocess).

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host devices)
when imported; it is imported here after JAX has started, and the variable
is put back, so nothing else in the process sees it.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.launch.analytic as RAN
import repro.sharding as RS
from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.launch import analytic, dryrun
from repro_torch.launch.mesh import init_single_process, make_production_mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(scope="module")
def ref_dryrun():
    jax.devices()  # the platform starts first, at the device count it has
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as module
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return module


def _terms_equal(a, b):
    assert (a.flops, a.hbm_bytes, a.wire_bytes) == (b.flops, b.hbm_bytes, b.wire_bytes)
    assert a.detail == b.detail


# ---------------------------------------------------------------------------
# analytic_terms.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_terms_equal(arch, mesh_name):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    for shape in SHAPES.values():
        args = (shape.kind, shape.seq_len, shape.global_batch, dict(mesh))
        for remat in analytic.REMAT_MULT:
            _terms_equal(analytic.analytic_terms(cfg, *args, remat=remat),
                         RAN.analytic_terms(ref_cfg, *args, remat=remat))
        knobs = dict(fsdp=False, moment_dtype="bfloat16", serve_fsdp=True, grad_compress=True,
                     kv_dedup_factor=0.5, act_rules={"seq": None})
        _terms_equal(analytic.analytic_terms(cfg, *args, **knobs),
                     RAN.analytic_terms(ref_cfg, *args, **knobs))


def test_analytic_constants_equal():
    assert analytic.REMAT_MULT == RAN.REMAT_MULT
    assert analytic.ACT_RW_PASSES == RAN.ACT_RW_PASSES
    assert (analytic.BF16, analytic.F32) == (RAN.BF16, RAN.F32)


# ---------------------------------------------------------------------------
# The dry run's cells.
# ---------------------------------------------------------------------------


def test_skip_rules_and_cells_equal(ref_dryrun):
    assert dryrun.LONG_CONTEXT_ARCHS == ref_dryrun.LONG_CONTEXT_ARCHS
    cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    assert len(cells) == 40
    for arch, shape in cells:
        assert dryrun.skip_reason(arch, SHAPES[shape]) == \
            ref_dryrun.skip_reason(arch, SHAPES[shape]), (arch, shape)
    runnable = [c for c in cells if dryrun.skip_reason(c[0], SHAPES[c[1]]) is None]
    assert len(runnable) == 33


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal(arch, ref_dryrun):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    for shape in SHAPES.values():
        got = dryrun.input_specs(cfg, shape)
        want = ref_dryrun.input_specs(ref_cfg, shape)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_bytes_equal_reference_specs(arch, mesh_name, ref_dryrun):
    from jax.sharding import PartitionSpec as P

    multi = MESHES[mesh_name]
    shape = make_production_mesh(multi_pod=multi)
    mesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    for name, spec in SHAPES.items():
        rec = dryrun.run_cell(arch, name, multi_pod=multi, verbose=False, trace=False)
        if rec["status"] == "skipped":
            continue
        cfg = ref_config(arch)
        if spec.kind != "train":
            cfg = cfg.replace(param_dtype="bfloat16")
        sds, axes = ref_build(cfg).abstract_params()
        mode = "train" if spec.kind == "train" else "serve"
        pspecs = RS.param_pspecs(sds, axes, mesh, mode=mode, fsdp=spec.kind == "train")
        leaves = lambda t: jax.tree.leaves(t, is_leaf=lambda x: isinstance(x, P))

        def nbytes(tree, specs, dtype=None):
            total = 0
            for sds_, spec_ in zip(jax.tree.leaves(tree), leaves(specs)):
                parts = 1
                for entry in spec_:
                    for axis in (() if entry is None else (entry,) if isinstance(entry, str)
                                 else entry):
                        parts *= mesh.shape[axis]
                total += int(np.prod(sds_.shape)) * np.dtype(dtype or sds_.dtype).itemsize // parts
            return total

        got = rec["bytes_per_device"]
        assert got["params"] == nbytes(sds, pspecs), name
        if spec.kind != "decode":
            bspecs = RS.batch_pspecs(cfg, spec.kind, spec.global_batch, mesh)
            batch = ref_dryrun.input_specs(cfg, spec)
            assert got["batch"] == nbytes({k: batch[k] for k in bspecs},
                                          {k: bspecs[k] for k in bspecs}), name
        if spec.kind == "train":
            assert got["opt_state"] == 2 * nbytes(sds, pspecs, np.float32) + 4
        if spec.kind == "decode":
            enc = spec.seq_len if cfg.is_encdec else 0
            slots = min(cfg.decoder_slots, 448) if cfg.is_encdec else spec.seq_len
            cache = jax.eval_shape(lambda: ref_build(cfg).init_cache(spec.global_batch, slots,
                                                                     enc))
            assert got["cache"] == nbytes(cache, RS.cache_pspecs(cfg, mesh, spec.global_batch,
                                                                 slots, enc)), name
        assert got["args"] == sum(v for k, v in got.items() if k != "args")


def test_run_all_records_and_main(tmp_path, monkeypatch):
    # the accounting; the traced steps are held in test_torch_dryrun_trace.py
    cells = dryrun.run_all(verbose=False, trace=False)
    assert len(cells) == 80
    assert sum(c["status"] == "ok" for c in cells) == 66
    ok = [c for c in cells if c["status"] == "ok"]
    for key in ("bytes_per_device", "fits_hbm", "flops_per_device", "bytes_accessed_per_device",
                "collective_wire_bytes_per_device", "analytic_detail", "model_flops_global",
                "useful_flops_ratio", "chips", "total_params", "active_params", "device"):
        assert all(key in c for c in ok), key
    assert {c["device"] for c in ok} == {dryrun.H100_80GB_HBM3}
    out = tmp_path / "dry.json"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "tinyllama-1.1b", "--shape",
                                      "train_4k", "--mesh", "both", "--no-trace", "--out",
                                      str(out)])
    dryrun.main()
    records = json.loads(out.read_text())
    assert [r["mesh"] for r in records] == ["16x16", "2x16x16"]
    assert records[0]["bytes_per_device"] == cells[12]["bytes_per_device"]


# ---------------------------------------------------------------------------
# Meshes.
# ---------------------------------------------------------------------------


def test_production_mesh_shapes():
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert list(make_production_mesh(multi_pod=True).items()) == [("pod", 2), ("data", 16),
                                                                 ("model", 16)]


def test_single_process_group_needs_its_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a card"):
        init_single_process("cuda")


def test_host_mesh_on_one_process():
    """A gloo group of one (in-memory store, no port) and its 1 x 1 mesh,
    in a subprocess of its own."""
    code = (
        "import torch, torch.distributed as dist\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.launch.mesh import init_single_process, make_host_mesh\n"
        "from repro_torch.act_sharding import mesh_shape\n"
        "init_single_process('cpu')\n"
        "print(mesh_shape(make_host_mesh(device='cpu')), dist.get_backend())\n"
        "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "{'data': 1, 'model': 1} gloo"
