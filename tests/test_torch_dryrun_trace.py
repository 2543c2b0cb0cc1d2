"""The traced dry run (``repro_torch.launch.{step_trace,dryrun}``) on the
CPU.

Run: PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun_trace.py

* The wire model (``step_trace.summarize``) equals the reference's
  ``collective_bytes`` on HLO lines made from the same (kind, shape, dtype)
  list.
* On a fake 4 x 4 mesh, ``StepTrace`` counts known redistributions exactly
  (an all-gather, an all-reduce, a reduce-scatter; a move between split
  dimensions as one all-to-all of the rank's result, and the split token
  shift as one collective-permute), a storage shared by views once (and
  names it at the peak: ``keep_peak``), and a sharded product's FLOPs per
  device.
* On a fake 4 x 4 mesh, a smoke config whose heads do not split "model":
  the last rank (15) attends its query rows against their whole causal
  key range, rank 0 its own shorter one (``FLASH_PASSES_DOTS`` products a
  key chunk, under remat "dots" and "full": the local region's graph
  rebuild makes none), the rest of their work equal; the record traces
  both and reports the heavier; where the heads split, it traces rank 0
  alone.
* At smoke widths, the straight-line extrapolation from one and two periods
  of ``block_pattern`` (and the remainder) equals a trace at the full
  depth: collective counts and bytes and FLOPs exactly, the peak within
  ``PEAK_RTOL``.
* The CLI on smoke configs on both production meshes: every cell "ok",
  ``args`` the accounting that ``test_torch_launch.py`` holds to the
  reference's spec trees, ``peak >= args``; a cell that raises is recorded
  as failed and the CLI exits 1.
* Against the reference's own dry run (``repro.launch.dryrun.run_cell``,
  512 forced host devices, its layers unrolled so the compiled module
  holds the whole step): on TinyLlama's and Mixtral's smoke prefill and
  decode cells and Whisper's smoke prefill on both meshes, the traced
  FLOPs per device equal the matrix-product FLOPs of the reference's
  compiled SPMD module (``tools/reference_buffers.py``'s ``hlo_dots``: 2 x
  result elements x contracted size over its ``dot`` instructions, what
  ``FlopCounterMode`` counts; XLA's ``cost_analysis`` adds every
  elementwise operation), but where ``FLOPS_APART`` pins them; every
  collective kind the reference's module issues, the trace issues, but
  those ``KINDS_APART`` pins.
* The train cells (TinyLlama's, Mixtral's and RWKV6's), at a smoke batch
  that splits over the batch axes (32 rows: ``TRAIN_SMOKE``), against the
  reference's compiled module with its loss head chunked under
  ``jax.checkpoint`` as it runs (its unrolled cost mode takes the head
  whole and without recompute): the loss head's FLOPs a device (the port's
  ``loss_head/`` products, the reference's dots with an operand as wide as
  the vocabulary) are equal; the totals part where ``FLOPS_APART`` pins
  them; every collective kind of the reference's is in the trace but
  exactly those ``SMOKE_KINDS_APART`` pins (RWKV6's collective-permute is
  in it).
* Full size: the port's traced peak of TinyLlama's, Phi-3-medium's,
  RWKV6's, Whisper's and RecurrentGemma's ``train_4k`` on both meshes at
  most ``PEAK_OVER_REFERENCE`` times the reference's compiled peak
  (``memory_analysis``: compiled here, or ``REFERENCE_PEAKS``), and their
  heaviest rank's FLOPs at most ``FLOPS_OVER_REFERENCE`` times the
  reference's compiled matrix products (``REFERENCE_DOT_FLOPS``);
  TinyLlama's and RWKV6's moves between splits are all-to-alls (RWKV6's
  token shift a collective-permute); TinyLlama's loss head traces
  ``TINYLLAMA_LOSS_HEAD_FLOPS`` a device (the vocabulary split over 16
  "model" ranks) and its step at most ``TINYLLAMA_MAX_FLOPS``.
* Full size: Whisper-small's ``prefill_32k`` on both meshes, its encoder
  on the sequence split: the traced FLOPs a device at most
  ``FLOPS_OVER_REFERENCE`` times the reference's compiled matrix products
  (``REFERENCE_PREFILL_DOT_FLOPS``), its peak at most
  ``PEAK_OVER_REFERENCE`` times the reference's, the reference's
  collective kinds in the trace.
* ``act_rules`` reaches the traced step as it reaches ``analytic_terms``.

A process has one default process group, so every part that makes the fake
group runs in a subprocess of its own; the slower ones start together
(``children``).
"""

import json
import math
import os
import subprocess
import sys

import jax
import pytest

from repro_torch.launch import dryrun, step_trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
# The peak is not a straight line in depth: a transient of the first layer
# or of the loss head may decide it at one depth and not at another.
PEAK_RTOL = 0.02


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


def _run(code: str, timeout: float = 120) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=ENV,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


class _Child:
    """A subprocess started now and read once, when a test asks."""

    def __init__(self, args, timeout: float):
        self.proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, env=ENV, cwd=ROOT)
        self.timeout, self.done = timeout, None

    def result(self):
        if self.done is None:
            out, err = self.proc.communicate(timeout=self.timeout)
            self.done = subprocess.CompletedProcess(self.proc.args, self.proc.returncode, out, err)
        return self.done

    def json(self):
        run = self.result()
        assert run.returncode == 0, run.stderr[-3000:]
        return json.loads(run.stdout.strip().splitlines()[-1])


# The cells held against the reference's compiled module: REF_ARCHS x
# REF_SHAPES, and REF_EXTRA's (arch, shape) pairs.
REF_ARCHS = ("tinyllama-1.1b", "mixtral-8x7b")
REF_SHAPES = ("prefill_32k", "decode_32k")
REF_EXTRA = (("whisper-small", "prefill_32k"),)

# The reference's side: ``tools/reference_buffers.py``'s counter of the
# compiled module's matrix products (``hlo_dots``), run from the repo's root.
_HLO = r"""
import json, sys
sys.path.insert(0, "tools")
import repro.launch.dryrun as R  # first: it fakes 512 host devices
from reference_buffers import capture_modules, compiled_dots, hlo_dot_flops
from repro.configs import SMOKE_SHAPES, ShapeSpec, get_config
from repro.models import scan_mode
texts = capture_modules(R)
"""

_REF_CELLS = _HLO + r"""
R.SHAPES = SMOKE_SHAPES
R.get_config = lambda arch: get_config(arch, smoke=True)
out = []
for multi_pod in (False, True):
    for arch, shape in [(a, s) for a in ARCHS for s in SHAPES] + EXTRA:
        with scan_mode.unrolled():
            rec = R.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
        out.append(dict(arch=arch, shape=shape, mesh=rec["mesh"],
                        dot_flops=hlo_dot_flops(texts[-1]), cost_flops=rec["hlo_body_flops"],
                        loops=texts[-1].count(" while("), counts=rec["collectives"]["counts"]))
print(json.dumps(out))
"""

_PORT_CELLS = r"""
import json
from repro_torch.launch import dryrun
cells = dryrun.run_all((False, True), ARCHS, SHAPES, verbose=False, smoke=True)
for arch, shape in EXTRA:
    cells += dryrun.run_all((False, True), [arch], [shape], verbose=False, smoke=True)
print(json.dumps(cells))
"""

# The train cells held against the reference's compiled module: the smoke
# configs at a batch of 32 rows, which split over 16 "data" or 2 x 16
# ("pod", "data") ranks (the smoke shape's 4 rows do not); RWKV6's too (its
# token shift on the split sequence).
TRAIN_SMOKE = ("train_4k", "train", 128, 32)
TRAIN_ARCHS = REF_ARCHS + ("rwkv6-1.6b",)
# The full-size train cells whose peaks are held to the reference's, on both
# meshes; the reference compiles the first two on 16 x 16 here (each
# full-size compile takes a minute or more of a child's 240 s) and the
# others' peaks are pinned: its ``memory_analysis`` by
# ``PYTHONPATH=src python tools/reference_buffers.py --arch all --mesh both``
# (jax 0.9.0, XLA:CPU, 512 forced host devices).
PEAK_ARCHS = ("tinyllama-1.1b", "phi3-medium-14b", "rwkv6-1.6b", "whisper-small",
              "recurrentgemma-2b")
LIVE_PEAK_ARCHS = ("tinyllama-1.1b", "phi3-medium-14b")
REFERENCE_PEAKS = {("recurrentgemma-2b", "16x16"): 32_744_027_096,
                   ("recurrentgemma-2b", "2x16x16"): 20_861_818_928,
                   ("tinyllama-1.1b", "2x16x16"): 5_387_409_328,
                   ("phi3-medium-14b", "2x16x16"): 32_431_071_952,
                   ("rwkv6-1.6b", "16x16"): 15_633_660_072,
                   ("rwkv6-1.6b", "2x16x16"): 9_056_553_800,
                   ("whisper-small", "16x16"): 1_797_998_032,
                   ("whisper-small", "2x16x16"): 1_071_332_000}

_REF_TRAIN = _HLO + r"""
import repro.configs as RC
R.SHAPES = dict(SMOKE_SHAPES, train_4k=ShapeSpec(*TRAIN_SMOKE))
R.get_config = lambda arch: get_config(arch, smoke=True)
smoke = []
for multi_pod in (False, True):
    for arch in ARCHS:
        # the loss head in checkpointed chunks, as the step runs it
        rec, dots, loops = compiled_dots(R, texts, arch, "train_4k", multi_pod)
        vocab = get_config(arch, smoke=True).vocab_size
        smoke.append(dict(arch=arch, shape="train_4k", mesh=rec["mesh"],
                          dot_flops=sum(f for _, f in dots), cost_flops=rec["hlo_body_flops"],
                          vocab_flops=sum(f for d, f in dots if vocab in d),
                          loops=loops, counts=rec["collectives"]["counts"]))
R.SHAPES, R.get_config = RC.SHAPES, RC.get_config
peaks = {arch: R.run_cell(arch, "train_4k", verbose=False)["bytes_per_device"]["peak"]
         for arch in LIVE_PEAK_ARCHS}
print(json.dumps(dict(smoke=smoke, peaks=peaks)))
"""

_PORT_TRAIN = r"""
import json
from repro_torch.configs import SMOKE_SHAPES, ShapeSpec
from repro_torch.launch import dryrun
dryrun.SMOKE_SHAPES = dict(SMOKE_SHAPES, train_4k=ShapeSpec(*TRAIN_SMOKE))
smoke = dryrun.run_all((False, True), ARCHS, ["train_4k"], verbose=False, smoke=True)
print(json.dumps(dict(smoke=smoke)))
"""

# one full-size cell (ARCH's SHAPE, on 2 x 16 x 16 if MULTI_POD)
_PORT_FULL = r"""
import json
from repro_torch.launch import dryrun
rec = dryrun.run_cell(ARCH, SHAPE, multi_pod=MULTI_POD, verbose=False)
dryrun.close_fake_mesh()
print(json.dumps(dict(peak=rec["bytes_per_device"]["peak"], flops=rec["traced_flops_per_device"],
                      by_op=rec["traced_flops_by_op"], counts=rec["collectives"]["counts"])))
"""
MESHES = ("16x16", "2x16x16")

# Heads that do not split "model": a smoke config of 6 query and 2 KV
# heads, one layer, at 2,048 tokens (4 blocks of 512 query rows, each one
# key chunk) on a fake 4 x 4 mesh, traced as rank 0 and as the last rank
# (15), and its record; and the smoke config itself (4 heads, which split),
# whose ranks do the same work.
RANKS_MESH = {"data": 4, "model": 4}
RANKS_SHAPE = ("train_4k", "train", 2048, 4)
RANKS_HEADS = (6, 2)
_RANKS = r"""
import json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
smoke = get_config("tinyllama-1.1b", smoke=True)
configs = {"apart": smoke.replace(num_heads=HEADS[0], num_kv_heads=HEADS[1], num_layers=1),
           "split": smoke.replace(num_layers=1)}
shape = ShapeSpec(*SHAPE)
out = {}
for name, cfg in configs.items():
    for rank in (0, 15):
        r = dryrun.trace_step(cfg, shape, dryrun.fake_mesh(MESH, rank))
        out[f"{name}_{rank}"] = dict(
            flops=r["flops"], offsets=r["rank_offsets"],
            attention=sum(n for k, n in r["flops_by_op"].items() if k.startswith("attention/")))
    dryrun.get_config = lambda arch, smoke=False, cfg=cfg: cfg
    dryrun.SMOKE_SHAPES = dict(dryrun.SMOKE_SHAPES, train_4k=shape)
    dryrun.make_production_mesh = lambda multi_pod=False: dict(MESH)
    rec = dryrun.run_cell(cfg.name, "train_4k", smoke=True, verbose=False)
    out[f"{name}_record"] = {k: rec[k] for k in (
        "traced_flops_per_device", "traced_flops_rank0", "traced_flops_last_rank",
        "last_rank_traced", "peak_rank", "bytes_per_device")}
# flash's products by call in rank 0's trace under "dots" and "full", those
# made while a local region rebuilds its graph apart
from repro_torch import act_sharding
from repro_torch.models import attention
originals = {n: getattr(attention, n) for n in ("_logits", "_pv", "_tp")}
def counted(calls, f):
    def call(*a, **kw):
        calls["rebuild" if act_sharding.rebuilding_graph() else "products"] += 1
        return f(*a, **kw)
    return call
for remat in ("dots", "full"):
    calls = {"products": 0, "rebuild": 0}
    for n, f in originals.items():
        setattr(attention, n, counted(calls, f))
    try:
        r = dryrun.trace_step(configs["apart"], shape, dryrun.fake_mesh(MESH, 0), remat=remat)
    finally:
        for n, f in originals.items():
            setattr(attention, n, f)
    out[f"calls_{remat}"] = dict(calls, attention=sum(
        n for k, n in r["flops_by_op"].items() if k.startswith("attention/")))
dryrun.close_fake_mesh()
print(json.dumps(out))
"""

_ACT_RULES = r"""
import json
from repro_torch.launch import dryrun
out = {}
for name, rules in (("default", None), ("seq_off", {"seq": None})):
    rec = dryrun.run_cell("tinyllama-1.1b", "prefill_32k", verbose=False, smoke=True,
                          act_rules=rules)
    out[name] = dict(collectives=rec["collectives"], wire=rec["collective_wire_bytes_per_device"])
dryrun.close_fake_mesh()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The file's slower subprocesses, started together: the CLI on
    TinyLlama's smoke cells on both meshes, the port's and the reference's
    prefill and decode cells of REF_ARCHS (and REF_EXTRA's), their train
    cells and full-size peaks (one child a cell), the full-size prefill
    cells of REFERENCE_PREFILL_DOT_FLOPS, and the ``act_rules`` pair."""
    cli_out = tmp_path_factory.mktemp("cli") / "dry.json"
    consts = f"ARCHS = {list(REF_ARCHS)!r}\nSHAPES = {list(REF_SHAPES)!r}\n" \
             f"EXTRA = {[list(c) for c in REF_EXTRA]!r}\n"
    train = f"ARCHS = {list(TRAIN_ARCHS)!r}\nTRAIN_SMOKE = {TRAIN_SMOKE!r}\n" \
            f"LIVE_PEAK_ARCHS = {list(LIVE_PEAK_ARCHS)!r}\n"
    kids = {
        "cli": _Child([sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke", "--arch",
                       "tinyllama-1.1b", "--mesh", "both", "--out", str(cli_out)], 240),
        "ref": _Child([sys.executable, "-c", consts + _REF_CELLS], 240),
        "port": _Child([sys.executable, "-c", consts + _PORT_CELLS], 240),
        "act_rules": _Child([sys.executable, "-c", _ACT_RULES], 240),
        "ranks": _Child([sys.executable, "-c", f"MESH = {RANKS_MESH!r}\nSHAPE = {RANKS_SHAPE!r}\n"
                         f"HEADS = {RANKS_HEADS!r}\n" + _RANKS], 240),
        "ref_train": _Child([sys.executable, "-c", train + _REF_TRAIN], 240),
        "port_train": _Child([sys.executable, "-c", train + _PORT_TRAIN], 240),
        **{f"full_{arch}_{mesh}": _Child([sys.executable, "-c", f"ARCH = {arch!r}\nMULTI_POD = "
                                          f"{mesh != MESHES[0]}\nSHAPE = 'train_4k'\n"
                                          + _PORT_FULL], 240)
           for arch in PEAK_ARCHS for mesh in MESHES},
        **{f"full_prefill_{arch}_{mesh}": _Child(
            [sys.executable, "-c", f"ARCH = {arch!r}\nMULTI_POD = {mesh != MESHES[0]}\n"
             f"SHAPE = 'prefill_32k'\n" + _PORT_FULL], 240)
           for arch, mesh in REFERENCE_PREFILL_DOT_FLOPS},
    }
    kids["cli_out"] = cli_out
    yield kids
    for kid in kids.values():
        if isinstance(kid, _Child) and kid.proc.poll() is None:
            kid.proc.kill()
            kid.proc.wait()


# ---------------------------------------------------------------------------
# The wire model.
# ---------------------------------------------------------------------------

_HLO_DTYPES = {"f32": 4, "bf16": 2, "s32": 4, "u8": 1, "pred": 1}
_OPS = [("all-reduce", (1024,), "f32"), ("all-gather", (16, 128), "bf16"),
        ("reduce-scatter", (2, 3, 5), "f32"), ("all-to-all", (8, 64), "bf16"),
        ("collective-permute", (7,), "s32"), ("all-reduce", (3, 3), "bf16"),
        ("all-gather", (4096,), "u8")]


def test_wire_model_equals_reference_collective_bytes(ref_dryrun):
    lines = []
    for i, (kind, shape, dt) in enumerate(_OPS):
        ty = f"{dt}[{','.join(map(str, shape))}]"
        lines.append(f"  %{kind}.{i} = {ty}{{0}} {kind}({ty} %p{i}), replica_groups={{}}")
    ours = step_trace.summarize((kind, _HLO_DTYPES[dt] * math.prod(shape))
                                for kind, shape, dt in _OPS)
    assert ours == ref_dryrun.collective_bytes("\n".join(lines))
    assert step_trace.KINDS == tuple(ref_dryrun.collective_bytes("")["bytes"])


# ---------------------------------------------------------------------------
# Known redistributions, views and products on a fake 4 x 4 mesh.
# ---------------------------------------------------------------------------

_KNOWN = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.act_sharding import shift_tokens
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.step_trace import StepTrace
mesh = make_fake_mesh({"data": 4, "model": 4})
out = {}
with FakeTensorMode(allow_non_fake_inputs=True):
    a = DTensor.from_local(torch.empty(4, 8), mesh, [Shard(0), Replicate()], run_check=False)
    b = DTensor.from_local(torch.empty(8, 8), mesh, [Replicate(), Partial()], run_check=False)
    c = DTensor.from_local(torch.empty(8, 8), mesh, [Replicate(), Partial()], run_check=False)
    w = DTensor.from_local(torch.empty(8, 16), mesh, [Replicate(), Replicate()], run_check=False)
    with StepTrace() as tr:
        a.redistribute(mesh, [Replicate(), Replicate()])   # all-gather over "data"
        b.redistribute(mesh, [Replicate(), Replicate()])   # all-reduce over "model"
        c.redistribute(mesh, [Replicate(), Shard(0)])      # reduce-scatter over "model"
        out["collectives"] = tr.collectives()
    with StepTrace() as tr:
        y = a @ w                                           # (4, 8) @ (8, 16) on each rank
        out["flops"] = tr.flops
    s = DTensor.from_local(torch.empty(4, 8, 16), mesh, [Replicate(), Shard(1)], run_check=False)
    with StepTrace() as tr:
        moved = s.redistribute(mesh, [Replicate(), Shard(2)])  # all-to-all over "model"
        out["alltoall"] = tr.collectives()
        out["alltoall_shape"] = list(moved.to_local().shape)
    x = DTensor.from_local(torch.empty(2, 4, 8), mesh, [Shard(0), Shard(1)], run_check=False)
    with StepTrace() as tr:
        shift_tokens(x, "model")                             # collective-permute over "model"
        out["permute"] = tr.collectives()
    with StepTrace(keep_peak=True) as tr:
        base = torch.empty(1024)
        views = [base[:10], base.view(32, 32), base[512:]]
        out["live_views"] = tr.live_bytes
        del base
        out["live_after_base"] = tr.live_bytes
        del views
        out["live_after_views"] = tr.live_bytes
        out["peak"] = tr.peak
        out["peak_live"] = tr.peak_live()
print(json.dumps(out))
"""


def test_known_redistributions_views_and_products(children):
    got = _run(_KNOWN)  # (``children`` starts the slower subprocesses meanwhile)
    coll = got["collectives"]
    assert coll["counts"] == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
                              "all-to-all": 0, "collective-permute": 0}
    # all-gather: the (16, 8) float32 result; all-reduce: 2 x (8, 8) float32;
    # reduce-scatter: the (2, 8) float32 shard
    assert coll["bytes"] == {"all-reduce": 2 * 256, "all-gather": 512, "reduce-scatter": 64,
                             "all-to-all": 0, "collective-permute": 0}
    assert coll["total_bytes"] == 1088
    assert got["flops"] == 2 * 4 * 8 * 16
    # a move between split dimensions on the fake group: one all-to-all of
    # the rank's (4, 32, 4) float32 result (its middle dimension gathered,
    # its last split), not an all-gather of the whole (4, 32, 16)
    assert got["alltoall_shape"] == [4, 32, 4]
    assert got["alltoall"]["counts"] == {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0,
                                         "all-to-all": 1, "collective-permute": 0}
    assert got["alltoall"]["total_bytes"] == 4 * 32 * 4 * 4
    # the split token shift: one collective-permute of the (2, 8) last tokens
    assert got["permute"]["counts"]["collective-permute"] == 1
    assert got["permute"]["total_bytes"] == 2 * 8 * 4
    assert got["live_views"] == got["live_after_base"] == got["peak"] == 4096
    assert got["live_after_views"] == 0
    assert got["peak_live"] == {"empty -> (1024,) float32": 4096}


# ---------------------------------------------------------------------------
# Depth: the straight line against a full-depth trace.
# ---------------------------------------------------------------------------

_DEPTH = r"""
import json
from repro_torch.configs import SMOKE_SHAPES, get_config
from repro_torch.launch import dryrun
mesh = {"data": 16, "model": 16}
out = []
for arch, shape, layers, remat in CASES:
    cfg = get_config(arch, smoke=True)
    cfg = dryrun.depth_cut(cfg, layers or cfg.num_layers)
    if shape != "train_4k":
        cfg = cfg.replace(param_dtype="bfloat16")
    spec = SMOKE_SHAPES[shape]
    line = dryrun.trace_cell(cfg, spec, mesh, remat=remat)
    whole = dryrun.trace_step(cfg, spec, dryrun.fake_mesh(mesh), remat=remat)
    out.append(dict(arch=arch, shape=shape, layers=cfg.num_layers, depths=line["depths"],
                    line={k: line[k] for k in ("collectives", "flops", "peak")},
                    whole={k: whole[k] for k in ("collectives", "flops", "peak")}))
dryrun.close_fake_mesh()
print(json.dumps(out))
"""

# (arch, shape, layers (0: the smoke config's), remat): cuts deeper than the
# smoke configs (whose 2 layers a trace at 1 and 2 meets trivially), the
# remainder of RecurrentGemma's 3-layer pattern included (7 = 2 x 3 + 1),
# and DeepSeek's smoke depth (3)
DEPTH_CASES = [("tinyllama-1.1b", "train_4k", 4, "dots"),
               ("recurrentgemma-2b", "prefill_32k", 7, "none"),
               ("mixtral-8x7b", "prefill_32k", 4, "none"),
               ("deepseek-67b", "decode_32k", 0, "none")]


def test_extrapolation_equals_full_depth_trace():
    got = _run(f"CASES = {json.dumps(DEPTH_CASES)}\n" + _DEPTH, timeout=300)
    assert len(got) == len(DEPTH_CASES)
    for case in got:
        line, whole = case["line"], case["whole"]
        assert line["collectives"] == whole["collectives"], case
        assert line["flops"] == whole["flops"], case
        assert abs(line["peak"] - whole["peak"]) <= PEAK_RTOL * whole["peak"], case
    rg = next(c for c in got if c["arch"] == "recurrentgemma-2b")
    assert rg["depths"] == [3, 6, 4] and rg["layers"] == 7


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


def _cli(*args, timeout=240):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          capture_output=True, text=True, env=ENV, timeout=timeout, cwd=ROOT)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b"])
def test_cli_smoke_cells_on_both_meshes(children, arch):
    out = children["cli_out"]
    run = children["cli"].result()
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    cells = json.loads(out.read_text())
    assert [c["mesh"] for c in cells] == ["16x16"] * 4 + ["2x16x16"] * 4
    ok = [c for c in cells if c["status"] == "ok"]
    assert all(c["status"] in ("ok", "skipped") for c in cells)
    assert {c["kind"] for c in ok} == {"train", "prefill", "decode"}
    for c in ok:
        account = dryrun.run_cell(arch, c["shape"], multi_pod=c["mesh"] == "2x16x16",
                                  verbose=False, trace=False, smoke=True)
        assert c["bytes_per_device"]["args"] == account["bytes_per_device"]["args"]
        assert c["bytes_per_device"]["peak"] >= c["bytes_per_device"]["args"]
        assert c["fits_hbm"] == (c["bytes_per_device"]["peak"] <= c["device_memory_bytes"])
        assert set(c["collectives"]) == {"bytes", "counts", "total_bytes"}
        assert c["collectives"]["total_bytes"] > 0
        assert c["traced_flops_per_device"] > 0 and c["trace_s"] > 0
        assert sum(c["traced_flops_by_op"].values()) == c["traced_flops_rank0"]
        assert c["traced_flops_per_device"] == max(c["traced_flops_rank0"],
                                                   c["traced_flops_last_rank"])
        assert c["traced_depths"][:2] == [1, 2]
    assert f"{len(ok)} ok / {len(cells) - len(ok)} skipped / 0 failed" in run.stdout


def test_cli_records_a_failing_cell_and_exits_1(tmp_path):
    """4 rows do not split into 3 microbatches: the cell is recorded as
    failed with its error, and the CLI goes on and exits 1."""
    out = tmp_path / "dry.json"
    run = _cli("--smoke", "--arch", "tinyllama-1.1b", "--shape", "train_4k", "--microbatches",
               "3", "--out", str(out))
    assert run.returncode == 1
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "failed"
    assert "does not split into 3 microbatches" in cell["error"]
    assert "0 ok / 0 skipped / 1 failed" in run.stdout


# ---------------------------------------------------------------------------
# Against the reference's compiled module.
# ---------------------------------------------------------------------------

# (arch, shape, mesh): (the port's FLOPs a device, the reference's matrix-
# product FLOPs a device) where they part.  The smoke train cells
# (TRAIN_SMOKE): at these widths
# GSPMD splits every product and the attention by sequence over "model"
# (8 or 16 query rows a rank, the weights gathered), where the port's
# rules split the MLP's width over "model": TinyLlama's 4 heads do not
# divide 16, so each rank attends its block of query rows at its offset
# (``flash_attend(q_offset=)``; at 128 tokens every rank's rows see the one
# key chunk, so the last rank's work is rank 0's); Mixtral's 4 heads take
# the banded schedule, whole on each rank, with its recompute; RWKV6's 4
# heads run their recurrence whole on each rank (the products on each
# rank's sequence block); the loss heads' FLOPs are equal.  Mixtral's smoke
# prefill: the banded schedule makes no product against the chunk before
# position 0 (window 32, 4 chunks of 32 tokens: 7 of the reference's 8
# chunk pairs), which the reference's compiled module multiplies as zeros.
# Whisper's smoke prefill: see KINDS_APART.
FLOPS_APART = {("tinyllama-1.1b", "train_4k", "16x16"): (15_990_784, 15_466_496),
               ("tinyllama-1.1b", "train_4k", "2x16x16"): (7_995_392, 7_733_248),
               ("mixtral-8x7b", "train_4k", "16x16"): (52_953_088, 31_457_280),
               ("mixtral-8x7b", "train_4k", "2x16x16"): (26_476_544, 15_728_640),
               ("mixtral-8x7b", "prefill_32k", "16x16"): (24_125_440, 25_174_016),
               ("mixtral-8x7b", "prefill_32k", "2x16x16"): (14_159_872, 14_684_160),
               ("rwkv6-1.6b", "train_4k", "16x16"): (48_234_496, 14_438_400),
               ("rwkv6-1.6b", "train_4k", "2x16x16"): (24_117_248, 7_225_344),
               ("whisper-small", "prefill_32k", "16x16"): (3_670_016, 2_686_976),
               ("whisper-small", "prefill_32k", "2x16x16"): (1_835_008, 1_343_488)}
# Whisper's smoke prefill (4 heads, 128 frames, 2 rows): both encode on the
# sequence split over "model", and their projections and QK^T agree; GSPMD
# also splits the PV product over the keys and the MLP's output product over
# its width, each rank multiplying its share and the partial sums
# all-reduced, and moves sequence blocks between ranks with
# collective-permutes, where the port multiplies each rank's query rows
# against every value and reduce-scatters the MLP's output.  The reference's
# collective kinds that such a cell lacks, by (arch, shape); at full size
# the reference issues all-gathers alone there (REFERENCE_PREFILL_KINDS).
KINDS_APART = {("whisper-small", "prefill_32k"): {"all-reduce", "collective-permute"}}
# The full-size train cells: the port's traced peak at most this many times
# the reference's compiled peak; TinyLlama's loss head (4 products, the
# forward, its recompute and two backward, over 16 x 512-token chunks a
# rank: 4 x 2 x 16 x 4,096 x 2,048 x 32,000 / 16) and its step's FLOPs a
# device.
PEAK_OVER_REFERENCE = 1.3
TINYLLAMA_LOSS_HEAD_FLOPS = 2_147_483_648_000
TINYLLAMA_MAX_FLOPS = 45.0e12
# The reference's compiled step a device, every full-size train_4k cell
# under remat "dots": the FLOPs of its matrix products (``hlo_dots``), its
# layers unrolled and its loss head in checkpointed chunks as the step
# runs it, by ``PYTHONPATH=src python tools/reference_buffers.py --arch all
# --mesh both --measure flops`` (jax 0.9.0, XLA:CPU, 512 forced host
# devices; a compile takes from a minute to about twenty, so they are
# pinned).  The heaviest rank of each PEAK_ARCHS cell traces at most
# FLOPS_OVER_REFERENCE times its figure.
REFERENCE_DOT_FLOPS = {
    ("tinyllama-1.1b", "16x16"): 38_053_410_242_560,
    ("tinyllama-1.1b", "2x16x16"): 19_026_705_121_280,
    ("mixtral-8x7b", "16x16"): 534_671_888_744_448,
    ("mixtral-8x7b", "2x16x16"): 267_335_944_372_224,
    ("deepseek-67b", "16x16"): 1_852_161_696_727_040,
    ("deepseek-67b", "2x16x16"): 926_080_848_363_520,
    ("llama4-maverick-400b-a17b", "16x16"): 378_182_607_831_040,
    ("llama4-maverick-400b-a17b", "2x16x16"): 189_091_303_915_520,
    ("qwen2-vl-7b", "16x16"): 205_161_997_795_328,
    ("qwen2-vl-7b", "2x16x16"): 102_580_998_897_664,
    ("phi3-medium-14b", "16x16"): 406_819_302_277_120,
    ("phi3-medium-14b", "2x16x16"): 203_409_651_138_560,
    ("yi-34b", "16x16"): 953_053_242_982_400,
    ("yi-34b", "2x16x16"): 476_526_621_491_200,
    ("recurrentgemma-2b", "16x16"): 91_418_378_895_360,
    ("recurrentgemma-2b", "2x16x16"): 45_709_189_447_680,
    ("whisper-small", "16x16"): 6_225_988_386_816,
    ("whisper-small", "2x16x16"): 3_112_994_193_408,
    ("rwkv6-1.6b", "16x16"): 37_023_826_051_072,
    ("rwkv6-1.6b", "2x16x16"): 18_511_913_025_536,
}
FLOPS_OVER_REFERENCE = 1.3
# The reference's compiled prefill a device, Whisper-small's prefill_32k
# (its encoder on the sequence split): the FLOPs of its matrix products,
# as REFERENCE_DOT_FLOPS (``tools/reference_buffers.py --arch whisper-small
# --shape prefill_32k --mesh both --measure flops``), its peak
# (``memory_analysis``, ``--measure peak``) and the collective kinds it
# issues (``PYTHONPATH=src python -m repro.launch.dryrun --arch
# whisper-small --shape prefill_32k --mesh both``: 7 all-gathers).
REFERENCE_PREFILL_DOT_FLOPS = {("whisper-small", "16x16"): 5_759_551_143_936,
                               ("whisper-small", "2x16x16"): 2_879_775_571_968}
REFERENCE_PREFILL_PEAKS = {("whisper-small", "16x16"): 1_732_229_192,
                           ("whisper-small", "2x16x16"): 1_279_146_056}
REFERENCE_PREFILL_KINDS = {"whisper-small": {"all-gather"}}


def test_flops_and_collective_kinds_against_reference_compiled_module(children):
    ref = children["ref"].json()
    port = {(c["arch"], c["shape"], c["mesh"]): c for c in children["port"].json()}
    assert len(ref) == len(port) == 2 * (len(REF_ARCHS) * len(REF_SHAPES) + len(REF_EXTRA))
    for r in ref:
        key = (r["arch"], r["shape"], r["mesh"])
        c = port[key]
        assert c["status"] == "ok", c
        # the whole step is in the module (no loop counted once), and the
        # parser reads a part of XLA's own count
        assert r["loops"] == 0 and 0 < r["dot_flops"] <= r["cost_flops"], r
        want = FLOPS_APART.get(key, (r["dot_flops"], r["dot_flops"]))
        assert (c["traced_flops_per_device"], r["dot_flops"]) == want, key
        kinds = lambda counts: {k for k, n in counts.items() if n}
        apart = KINDS_APART.get(key[:2], set())
        assert kinds(r["counts"]) - kinds(c["collectives"]["counts"]) == apart, \
            (key, r["counts"])
        assert not kinds(c["collectives"]["counts"]) & {"all-to-all", "collective-permute"}


# flash attention's products a key chunk under remat "dots" on a mesh:
# the forward's two (QK^T, PV) in the local region and again in the unit's
# rerun, and the backward's five (the probabilities, dV, dP, dQ, dK); where
# the region makes its graph again in the backward pass, flash takes its
# output from the rerun and makes none.  The reference's
# Mixtral-8x7B step makes 8 a block of query rows, each over its whole key
# range: its forward's two, their recompute under ``jax.checkpoint`` and
# its backward's four, which read the recomputed probabilities
# (``tools/reference_buffers.py --arch mixtral-8x7b --dots 30``).
FLASH_PASSES_DOTS = 9


def test_last_rank_attends_its_whole_causal_key_range(children):
    """Heads that do not split "model": rank r attends its block of R query
    rows at offset r R, against key chunks 0 to r, so the last rank's
    attention FLOPs are a whole causal key range over its rows (R x 4 R
    keys), rank 0's its own R x R; the rest of the step is the same work.
    The record traces both ranks and reports the heavier.  Where the heads
    split, no block is placed at a rank's offset and the record traces rank
    0 alone."""
    got = children["ranks"].json()
    _, _, s, b = RANKS_SHAPE
    rows = s // RANKS_MESH["model"]
    unit = 2 * (b // RANKS_MESH["data"]) * RANKS_HEADS[0] * 16 * rows  # head_dim 16
    first, last = got["apart_0"], got["apart_15"]
    assert first["offsets"] > 0 and last["offsets"] > 0
    assert first["attention"] == FLASH_PASSES_DOTS * unit * rows
    assert last["attention"] == FLASH_PASSES_DOTS * unit * s
    assert last["flops"] - first["flops"] == last["attention"] - first["attention"] > 0
    rec = got["apart_record"]
    assert rec["last_rank_traced"] is True
    assert (rec["traced_flops_rank0"], rec["traced_flops_last_rank"]) == (first["flops"],
                                                                          last["flops"])
    assert rec["traced_flops_per_device"] == last["flops"]
    assert rec["bytes_per_device"]["peak"] >= rec["bytes_per_device"]["args"]
    split = got["split_record"]
    assert got["split_0"]["offsets"] == got["split_15"]["offsets"] == 0
    assert got["split_0"]["flops"] == got["split_15"]["flops"]
    assert split["last_rank_traced"] is False and split["peak_rank"] == 0
    assert split["traced_flops_per_device"] == split["traced_flops_rank0"] == \
        split["traced_flops_last_rank"] == got["split_0"]["flops"]


def test_flash_graph_rebuild_in_the_trace_makes_no_products(children):
    """Rank 0's trace of the config whose heads do not split "model", under
    remat "dots" and "full": flash's local region rebuilds its graph in the
    backward pass without a product (it takes its output from the unit's
    rerun), so both make FLASH_PASSES_DOTS products a key chunk."""
    got = children["ranks"].json()
    _, _, s, b = RANKS_SHAPE
    rows = s // RANKS_MESH["model"]
    unit = 2 * (b // RANKS_MESH["data"]) * RANKS_HEADS[0] * 16 * rows
    for remat in ("dots", "full"):
        calls = got[f"calls_{remat}"]
        assert calls["rebuild"] == 0 and calls["products"] > 0, (remat, calls)
        assert calls["attention"] == FLASH_PASSES_DOTS * unit * rows, (remat, calls)


def test_act_rules_reach_the_traced_step(children):
    """``run_cell(act_rules={"seq": None})`` (no sequence-parallel residual)
    drops the gathers of the sequence before each norm from the trace, as
    it drops them from ``analytic_terms``."""
    got = children["act_rules"].json()
    base, off = got["default"], got["seq_off"]
    assert off["collectives"]["counts"]["all-gather"] < base["collectives"]["counts"]["all-gather"]
    assert off["collectives"]["total_bytes"] < base["collectives"]["total_bytes"]
    assert off["wire"] < base["wire"]


def _loss_head_flops(by_op: dict) -> int:
    return sum(n for key, n in by_op.items() if key.startswith("loss_head/"))


# The fake mesh records every kind (``launch.mesh`` routes DTensor's moves
# between split dimensions to its all-to-all; RWKV6's token shift is a
# collective-permute), so what a smoke train cell lacks of the reference's
# kinds is where the strategies part at smoke widths (FLOPS_APART), by the
# reference's HLO op names: XLA partitions the lookup's gather and its
# scatter-add into an all-to-all and a collective-permute (the port's
# vocabulary-parallel lookup reduce-scatters), and moves the sequence- and
# chunk-split pieces of Mixtral's and RWKV6's blocks between splits with
# all-to-alls (the port moves nothing shard to shard there: 4 heads do not
# split 16 ranks).  Each set is exactly what the cell lacks.
SMOKE_KINDS_APART = {"tinyllama-1.1b": {"all-to-all", "collective-permute"},
                     "mixtral-8x7b": {"all-to-all", "collective-permute"},
                     "rwkv6-1.6b": {"all-to-all"}}


def test_train_cells_against_reference_compiled_module(children):
    """The smoke train cells at a batch that splits: the loss head's FLOPs
    a device equal the reference's (its dots with an operand as wide as the
    vocabulary), the totals as ``FLOPS_APART`` pins them, and the
    reference's collective kinds in the trace but exactly those
    ``SMOKE_KINDS_APART`` lists (RWKV6's collective-permute included)."""
    ref = children["ref_train"].json()["smoke"]
    port = {(c["arch"], c["shape"], c["mesh"]): c for c in children["port_train"].json()["smoke"]}
    assert len(ref) == len(port) == 2 * len(TRAIN_ARCHS)
    for r in ref:
        key = (r["arch"], r["shape"], r["mesh"])
        c = port[key]
        assert c["status"] == "ok", c
        assert r["loops"] == 0 and 0 < r["dot_flops"] <= r["cost_flops"], r
        assert _loss_head_flops(c["traced_flops_by_op"]) == r["vocab_flops"] > 0, key
        want = FLOPS_APART.get(key, (r["dot_flops"], r["dot_flops"]))
        assert (c["traced_flops_per_device"], r["dot_flops"]) == want, key
        kinds = lambda counts: {k for k, n in counts.items() if n}
        assert kinds(r["counts"]) - kinds(c["collectives"]["counts"]) == \
            SMOKE_KINDS_APART[r["arch"]], key
    assert "collective-permute" in {k for c in port.values() if c["arch"] == "rwkv6-1.6b"
                                    for k, n in c["collectives"]["counts"].items() if n}


@pytest.mark.parametrize("arch", PEAK_ARCHS)
def test_train_peak_against_reference_compiled_peak(children, arch):
    """Full-size ``train_4k`` on 16 x 16 and 2 x 16 x 16 under remat
    "dots": the port's traced peak per device at most PEAK_OVER_REFERENCE
    times the reference's compiled peak (its ``memory_analysis``; compiled
    here for LIVE_PEAK_ARCHS on 16 x 16, else REFERENCE_PEAKS)."""
    live = children["ref_train"].json()["peaks"]
    for mesh in MESHES:
        ref = live[arch] if mesh == MESHES[0] and arch in live else REFERENCE_PEAKS[(arch, mesh)]
        peak = children[f"full_{arch}_{mesh}"].json()["peak"]
        assert 0 < peak <= PEAK_OVER_REFERENCE * ref, (arch, mesh, peak, ref)


@pytest.mark.parametrize("arch", PEAK_ARCHS)
def test_train_flops_against_reference_compiled_dots(children, arch):
    """Full-size ``train_4k`` on 16 x 16 and 2 x 16 x 16 under remat
    "dots": the heaviest rank's traced FLOPs a device at most
    FLOPS_OVER_REFERENCE times the reference's compiled matrix products
    (REFERENCE_DOT_FLOPS).  RecurrentGemma-2B's band makes 7 products a
    query chunk over its keys from position 0 on (the reference's step 8,
    over half of its zero-padded band a device)."""
    for mesh in MESHES:
        flops = children[f"full_{arch}_{mesh}"].json()["flops"]
        ref = REFERENCE_DOT_FLOPS[(arch, mesh)]
        assert 0 < flops <= FLOPS_OVER_REFERENCE * ref, (arch, mesh, flops, ref, flops / ref)


@pytest.mark.parametrize("arch,mesh", list(REFERENCE_PREFILL_DOT_FLOPS))
def test_prefill_against_reference_compiled_step(children, arch, mesh):
    """Full-size ``prefill_32k`` of an encoder-decoder model: its encoder
    runs on the sequence split, each rank's query rows against every frame
    and every projection on each rank's block, as the reference's GSPMD
    splits it, so the traced FLOPs a device are at most
    FLOPS_OVER_REFERENCE times the reference's compiled matrix products,
    its peak at most PEAK_OVER_REFERENCE times the reference's, and it
    issues every collective kind the reference's step issues."""
    rec = children[f"full_prefill_{arch}_{mesh}"].json()
    ref = REFERENCE_PREFILL_DOT_FLOPS[(arch, mesh)]
    assert 0 < rec["flops"] <= FLOPS_OVER_REFERENCE * ref, (rec["flops"], ref, rec["flops"] / ref)
    peak = REFERENCE_PREFILL_PEAKS[(arch, mesh)]
    assert 0 < rec["peak"] <= PEAK_OVER_REFERENCE * peak, (rec["peak"], peak)
    assert REFERENCE_PREFILL_KINDS[arch] <= {k for k, n in rec["counts"].items() if n}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b"])
def test_full_size_moves_between_splits_are_all_to_alls(children, arch):
    """At full size the heads split over "model", so K and V (TinyLlama) and
    r, k, v, g and the decays (RWKV6) move from the sequence split to the
    heads split: the fake mesh records all-to-alls there, and RWKV6's
    token shift collective-permutes, on both meshes."""
    for mesh in MESHES:
        rec = children[f"full_{arch}_{mesh}"].json()
        assert rec["counts"]["all-to-all"] > 0, (mesh, rec["counts"])
        assert (rec["counts"]["collective-permute"] > 0) == (arch == "rwkv6-1.6b"), mesh


def test_tinyllama_loss_head_split_over_the_vocabulary(children):
    """TinyLlama ``train_4k`` on 16 x 16: each rank multiplies its rows by
    its 2,000 of the 32,000 columns, so the loss head traces 1 / 16 of the
    whole head's FLOPs a device, and the step at most
    TINYLLAMA_MAX_FLOPS."""
    full = children["full_tinyllama-1.1b_16x16"].json()
    assert _loss_head_flops(full["by_op"]) == TINYLLAMA_LOSS_HEAD_FLOPS
    assert all("32000" not in key for key in full["by_op"])
    assert full["flops"] <= TINYLLAMA_MAX_FLOPS
