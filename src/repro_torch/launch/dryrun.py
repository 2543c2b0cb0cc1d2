"""Multi-pod dry run: every (architecture x shape x mesh) cell's step, traced
on fake tensors over a fake process group of the production mesh's size.

The port's counterpart of the reference's ``launch/dryrun.py``, over the same
40 cells (10 ids x 4 shapes) and both production meshes (16 x 16 and
2 x 16 x 16).  The reference lowers and compiles each cell's step under 512
faked XLA devices and reads XLA's memory and cost analyses and the HLO's
collectives.  Here each cell's step runs as the reference runs it: the
sharded train step (remat "dots" by default, ``microbatches``), the prefill
into a cache placed by ``cache_pspecs``, or one decode step against such a
cache, on DTensors of ``FakeTensorMode`` tensors placed by the partition
rules on a fake ``DeviceMesh`` (``mesh.make_fake_mesh``: 256 or 512 ranks in
one process, collectives that move nothing).  ``step_trace.StepTrace``
reads one rank's view of it: rank 0's, and the last rank's where a step
places a block at an offset that depends on the rank (causal attention on
each rank's block of query rows, ``act_sharding.rank_offsets``), since
there the last rank, which holds the last block on every axis, visits the
most key chunks:

  * ``collectives``: ``{"bytes", "counts", "total_bytes"}`` over the
    reference's five kinds and its wire model, per device (rank 0's);
  * ``bytes_per_device["peak"]``: the most bytes of live storages on a
    rank over the step (the counterpart of args + out + temp - alias), of
    the rank with the larger (``peak_rank``), which decides ``fits_hbm``
    against one card's memory (``torch.cuda.get_device_properties(0)``
    when a card is present, else ``H100_80GB_HBM3_BYTES``);
  * ``traced_flops_per_device``: the step's FLOPs on the heavier rank,
    ``traced_flops_rank0`` and ``traced_flops_last_rank`` each rank's
    (``last_rank_traced`` false: the step placed nothing at a
    rank-dependent offset, so every rank's local work is rank 0's, and the
    last rank's figures are rank 0's).

Each cell is traced at one and two periods of its ``block_pattern`` (and one
plus the remainder layers where the depth leaves some), and every count,
byte and FLOP is extrapolated in a straight line to the config's depth
(``traced_depths``, ``extrapolate``): the counterpart of the reference's
unrolled lowering.  The record keeps the reference's keys where they mean
the same, the accounting of the step's arguments (``bytes_per_device``'s
parameters, AdamW state, batch, cache and ``args``, a lower bound of
``peak``) and ``analytic_terms``.  A cell that raises is recorded as failed
with its error, and ``main`` exits 1.  The fake group needs a process of its
own (``make_fake_mesh`` refuses if one is up): ``trace=False`` gives the
accounting alone.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun.json
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..act_sharding import axes_size, entry_axes
from ..configs import ARCH_IDS, SHAPES, SMOKE_SHAPES, ShapeSpec, get_config
from ..models import config as C
from ..models import encdec, transformer
from ..models.model import build_model
from ..pytree import tree_map
from ..sharding import batch_pspecs, param_pspecs, cache_pspecs
from .analytic import analytic_terms
from .mesh import close_fake_mesh as destroy_fake_mesh
from .mesh import make_fake_mesh, make_production_mesh

# long_500k runs only for bounded-state decoders (DESIGN.md §4).
LONG_CONTEXT_ARCHS = {"mixtral-8x7b", "recurrentgemma-2b", "rwkv6-1.6b"}

# One NVIDIA H100 80GB HBM3's memory, as torch.cuda.get_device_properties(0)
# .total_memory reads it: the limit when no card is present.
H100_80GB_HBM3 = "NVIDIA H100 80GB HBM3"
H100_80GB_HBM3_BYTES = 85_017_493_504
# ``--peak-live``: how many of the kinds of storage alive at the peak a
# record keeps, largest first
PEAK_LIVE_SHOWN = 24


def skip_reason(arch: str, shape: ShapeSpec) -> Optional[str]:
    cfg = get_config(arch)
    if shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return "full-attention arch: 500k decode state unbounded (DESIGN.md §4)"
    if cfg.is_encdec and shape.name == "long_500k":
        return "enc-dec: quadratic encoder at 500k frames (DESIGN.md §4)"
    return None


def device_memory() -> Tuple[str, int]:
    """(name, bytes) of the card the cells are held against."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.name, int(props.total_memory)
    return H100_80GB_HBM3, H100_80GB_HBM3_BYTES


# ---------------------------------------------------------------------------
# Input specs (``meta`` tensors; no allocation).
# ---------------------------------------------------------------------------


def input_specs(cfg: C.ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    meta = functools.partial(torch.empty, device="meta")
    if cfg.is_encdec:
        sd = min(cfg.decoder_slots, 448)
        return {
            "encoder_embeds": meta((b, s, cfg.d_model), dtype=cdt),
            "decoder_tokens": meta((b, sd), dtype=torch.int32),
            "targets": meta((b, sd), dtype=torch.int32),
            "mask": meta((b, sd), dtype=torch.float32),
        }
    specs: Dict[str, torch.Tensor] = {
        "targets": meta((b, s), dtype=torch.int32),
        "mask": meta((b, s), dtype=torch.float32),
    }
    if cfg.family == "vlm" or not cfg.embed_inputs:
        specs["embeds"] = meta((b, s, cfg.d_model), dtype=cdt)
    else:
        specs["inputs"] = meta((b, s), dtype=torch.int32)
    if shape.kind == "prefill":
        specs.pop("targets"), specs.pop("mask")
    return specs


# ---------------------------------------------------------------------------
# Bytes per device.
# ---------------------------------------------------------------------------


def shard_bytes(t: torch.Tensor, spec, mesh: Dict[str, int], dtype=None) -> int:
    """Bytes of one device's shard of ``t`` (in ``dtype``, default its own)
    under ``spec``: the rules split only dimensions the mesh axes divide."""
    parts = axes_size(mesh, [a for entry in spec for a in entry_axes(entry)])
    return t.numel() * (dtype or t.dtype).itemsize // parts


def tree_bytes(tree, specs, mesh: Dict[str, int], dtype=None) -> int:
    total = [0]

    def add(t, spec):
        total[0] += shard_bytes(t, spec, mesh, dtype)

    tree_map(add, tree, specs)
    return total[0]


@functools.lru_cache(maxsize=None)
def _abstract(arch: str, param_dtype: str, smoke: bool = False):
    cfg = get_config(arch, smoke=smoke).replace(param_dtype=param_dtype)
    return build_model(cfg).abstract_params()


def _meta_cache(cfg: C.ModelConfig, batch: int, slots: int, enc_slots: int):
    if cfg.is_encdec:
        return encdec.init_dec_cache(cfg, batch, slots, enc_slots, device="meta")
    return transformer.init_cache(cfg, batch, slots, device="meta")


# ---------------------------------------------------------------------------
# The traced step: each cell's sharded step on fake tensors over a fake mesh.
# ---------------------------------------------------------------------------

_FAKE = {"mesh": None, "rank": 0}


def fake_mesh(shape: Dict[str, int], rank: int = 0):
    """The fake ``DeviceMesh`` of ``shape`` (``mesh.make_fake_mesh``) with
    this process playing ``rank``, kept for the cells that follow; a mesh of
    another shape or rank replaces it (its process group destroyed first)."""
    from ..act_sharding import mesh_shape

    mesh = _FAKE["mesh"]
    if mesh is not None and mesh_shape(mesh) == dict(shape) and _FAKE["rank"] == rank:
        return mesh
    close_fake_mesh()
    _FAKE["mesh"], _FAKE["rank"] = make_fake_mesh(dict(shape), rank), rank
    return _FAKE["mesh"]


def close_fake_mesh() -> None:
    if _FAKE["mesh"] is not None:
        _FAKE["mesh"] = None
        destroy_fake_mesh()


def depth_cut(cfg: C.ModelConfig, layers: int) -> C.ModelConfig:
    """``cfg`` at ``layers`` layers (an encoder-decoder model: as many in
    its encoder)."""
    if cfg.is_encdec:
        return cfg.replace(num_layers=layers, encoder_layers=layers)
    return cfg.replace(num_layers=layers)


def traced_depths(cfg: C.ModelConfig) -> Tuple[int, ...]:
    """The depths a cell is traced at: one and two periods of its
    ``block_pattern``, and one period plus the remainder layers where the
    depth leaves some (RecurrentGemma: 26 = 8 x 3 + 2)."""
    if cfg.is_encdec:
        if cfg.encoder_layers != cfg.num_layers:
            raise ValueError("the traced dry run takes an encoder as deep as its decoder")
        return (1, 2)
    p = cfg.pattern_period
    rem = cfg.num_layers % p
    return (p, 2 * p) + ((p + rem,) if rem else ())


def extrapolate(cfg: C.ModelConfig, traced: Dict[int, int]) -> int:
    """A count at the config's depth from the traces at ``traced_depths``:
    one period's value, plus each further period's (the second trace less
    the first), plus the remainder's (the third less the first)."""
    depths = traced_depths(cfg)
    v1, v2 = traced[depths[0]], traced[depths[1]]
    groups = cfg.num_layers // (1 if cfg.is_encdec else cfg.pattern_period)
    out = v1 + (groups - 1) * (v2 - v1)
    if len(depths) == 3:
        out += traced[depths[2]] - v1
    return out


def _fake_placed(tree, specs, mesh):
    from ..sharding import empty_placed

    return empty_placed(tree, specs, mesh, device="cpu", zero=False)


def trace_step(cfg: C.ModelConfig, shape: ShapeSpec, mesh, *, remat: str = "dots",
               fsdp: bool = True, serve_fsdp: bool = False, moment_dtype: str = "float32",
               microbatches: int = 1, act_rules=None, keep_peak: bool = False
               ) -> Dict[str, Any]:
    """One rank's trace of the cell's step at ``cfg``'s depth, on fake
    tensors (``FakeTensorMode``) placed on ``mesh``: the train step (AdamW,
    ``remat``, ``microbatches``), the prefill into a placed cache, or one
    decode step against a placed cache, under ``activation_rules(mesh,
    act_rules)``, as the reference's ``run_cell`` lowers them.  Returns
    ``{"collectives", "peak", "flops", "flops_by_op", "args_live",
    "rank_offsets"}`` (``args_live``: the bytes alive when the step
    starts; ``rank_offsets``: the blocks the step placed at a
    rank-dependent offset, ``act_sharding.rank_offsets``), and with
    ``keep_peak`` ``"peak_live"``: the bytes alive at the peak by the
    operation and shape that made them (``StepTrace.peak_live``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..act_sharding import rank_offsets
    from ..sharding import batch_pspecs, cache_pspecs
    from ..train import train_step as TS
    from ..train.optimizer import AdamW
    from .step_trace import StepTrace

    model = build_model(cfg, remat=remat if shape.kind == "train" else "none")
    sds, axes = model.abstract_params()
    b = shape.global_batch
    # the mesh's own rank tensor is a real one
    with FakeTensorMode(allow_non_fake_inputs=True), StepTrace(keep_peak) as tr:
        if shape.kind == "train":
            pspecs = param_pspecs(sds, axes, mesh, mode="train", fsdp=fsdp)
            params = TS.trainable(_fake_placed(sds, pspecs, mesh))
            opt = AdamW(moment_dtype=moment_dtype)
            state = opt.init(params)
            batch = _fake_placed(input_specs(cfg, shape),
                                 batch_pspecs(cfg, "train", b, mesh), mesh)
            step = TS.make_sharded_train_step(model, opt, mesh, microbatches, act_rules)
            args = (params, state, batch)
        else:
            mode = "train" if serve_fsdp else "serve"
            params = _fake_placed(sds, param_pspecs(sds, axes, mesh, mode=mode, fsdp=serve_fsdp),
                                  mesh)
            if shape.kind == "prefill":
                batch = _fake_placed(input_specs(cfg, shape),
                                     batch_pspecs(cfg, "prefill", b, mesh), mesh)
                step = TS.make_sharded_prefill_step(model, mesh, rules=act_rules)
                args = (params, batch)
            else:
                enc_slots = shape.seq_len if cfg.is_encdec else 0
                slots = min(cfg.decoder_slots, 448) if cfg.is_encdec else shape.seq_len
                cache = _fake_placed(_meta_cache(cfg, b, slots, enc_slots),
                                     cache_pspecs(cfg, mesh, b, slots, enc_slots), mesh)
                tokens = _fake_placed(torch.empty((b, 1), dtype=torch.int32, device="meta"),
                                      (None, None), mesh)
                step = TS.make_sharded_serve_step(model, mesh, act_rules)
                args = (params, cache, tokens, shape.seq_len - 1)
        tr.reset_peak()
        args_live, offsets = tr.live_bytes, rank_offsets()
        out = step(*args)
        del out, args
    out = {"collectives": tr.collectives(), "peak": tr.peak, "flops": tr.flops,
           "flops_by_op": tr.flops_by_op, "args_live": args_live,
           "rank_offsets": rank_offsets() - offsets}
    if keep_peak:
        out["peak_live"] = tr.peak_live()
    return out


def trace_cell(cfg: C.ModelConfig, shape: ShapeSpec, mesh_dims: Dict[str, int],
               **kw) -> Dict[str, Any]:
    """``trace_step`` at each of ``traced_depths(cfg)`` on the fake mesh of
    ``mesh_dims`` as rank 0, extrapolated to the config's depth
    (``extrapolate``): the collective record, ``peak``, ``flops`` and
    ``flops_by_op`` (each operation's, by ``StepTrace``'s key, largest
    first) per device, and the seconds the traces took.  Where a trace
    placed a block at a rank-dependent offset, the last rank's step is
    traced too: ``flops_last_rank`` and ``peak_last_rank`` (else rank 0's
    figures, ``last_rank_traced`` false)."""
    t0 = time.perf_counter()
    mesh = fake_mesh(mesh_dims)
    runs = {n: trace_step(depth_cut(cfg, n), shape, mesh, **kw) for n in traced_depths(cfg)}
    at = lambda fn, runs=runs: extrapolate(cfg, {n: fn(r) for n, r in runs.items()})
    from .step_trace import KINDS

    coll = {
        "bytes": {k: at(lambda r, k=k: r["collectives"]["bytes"][k]) for k in KINDS},
        "counts": {k: at(lambda r, k=k: r["collectives"]["counts"][k]) for k in KINDS},
    }
    coll["total_bytes"] = sum(coll["bytes"].values())
    keys = {k for r in runs.values() for k in r["flops_by_op"]}
    by_op = {k: at(lambda r, k=k: r["flops_by_op"].get(k, 0)) for k in keys}
    out = {"collectives": coll, "peak": at(lambda r: r["peak"]),
           "flops_by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
           "flops": at(lambda r: r["flops"]), "args_live": at(lambda r: r["args_live"]),
           "depths": list(runs),
           "per_depth": {n: {"peak": r["peak"], "flops": r["flops"],
                             "total_bytes": r["collectives"]["total_bytes"]}
                         for n, r in runs.items()}}
    out["last_rank_traced"] = any(r["rank_offsets"] for r in runs.values())
    out["flops_last_rank"], out["peak_last_rank"] = out["flops"], out["peak"]
    if out["last_rank_traced"]:
        last = fake_mesh(mesh_dims, axes_size(mesh_dims, mesh_dims) - 1)
        lasts = {n: trace_step(depth_cut(cfg, n), shape, last, **kw) for n in runs}
        out["flops_last_rank"] = at(lambda r: r["flops"], lasts)
        out["peak_last_rank"] = at(lambda r: r["peak"], lasts)
    out["trace_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Cell runner.
# ---------------------------------------------------------------------------


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    remat: str = "dots",
    fsdp: bool = True,
    serve_fsdp: bool = False,
    moment_dtype: str = "float32",
    microbatches: int = 1,
    grad_compress: bool = False,
    kv_dedup_factor: float = 1.0,
    act_rules: Optional[Dict[str, Any]] = None,
    verbose: bool = True,
    trace: bool = True,
    smoke: bool = False,
    peak_live: bool = False,
) -> Dict[str, Any]:
    """One cell's record: the accounting of its step's arguments and, with
    ``trace``, its step traced on the fake production mesh (``trace_cell``)
    under ``act_rules``: the collectives, the peak bytes (which decide
    ``fits_hbm``; None without ``trace``) and the FLOPs per device of the
    heavier of rank 0 and the last rank (each rank's, and rank 0's by
    operation, ``traced_flops_by_op``).  ``smoke``: the smoke configs
    and shapes.  ``peak_live``: also trace the step once at full depth
    and record the bytes alive at its peak by the operation and shape that
    made them (``peak_live``, the largest ``PEAK_LIVE_SHOWN``)."""
    shape = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
        "remat": remat,
        "fsdp": fsdp,
        "microbatches": microbatches,
    }
    reason = skip_reason(arch, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    t0 = time.perf_counter()
    cfg = get_config(arch, smoke=smoke)
    if shape.kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16")  # serving runs bf16 weights
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = axes_size(mesh, mesh)
    params, axes = _abstract(arch, cfg.param_dtype, smoke)
    b = shape.global_batch
    parts: Dict[str, int] = {}
    if shape.kind == "train":
        pspecs = param_pspecs(params, axes, mesh, mode="train", fsdp=fsdp)
        parts["params"] = tree_bytes(params, pspecs, mesh)
        mdt = getattr(torch, moment_dtype)
        parts["opt_state"] = 2 * tree_bytes(params, pspecs, mesh, mdt) + 4  # mu, nu, step
        parts["batch"] = tree_bytes(input_specs(cfg, shape), batch_pspecs(cfg, "train", b, mesh),
                                    mesh)
    else:
        pspecs = param_pspecs(params, axes, mesh, mode="train" if serve_fsdp else "serve",
                              fsdp=serve_fsdp)
        parts["params"] = tree_bytes(params, pspecs, mesh)
        if shape.kind == "prefill":
            parts["batch"] = tree_bytes(input_specs(cfg, shape),
                                        batch_pspecs(cfg, "prefill", b, mesh), mesh)
        else:
            enc_slots = shape.seq_len if cfg.is_encdec else 0
            slots = min(cfg.decoder_slots, 448) if cfg.is_encdec else shape.seq_len
            parts["cache"] = tree_bytes(_meta_cache(cfg, b, slots, enc_slots),
                                        cache_pspecs(cfg, mesh, b, slots, enc_slots), mesh)
            parts["batch"] = b * 4 + 4  # tokens (B, 1) int32 replicated, pos
    rec["account_s"] = round(time.perf_counter() - t0, 3)
    args = sum(parts.values())
    bytes_per_device = {**parts, "args": args}
    traced: Dict[str, Any] = {}
    if trace:
        traced = trace_cell(cfg, shape, mesh, remat=remat, fsdp=fsdp, serve_fsdp=serve_fsdp,
                            moment_dtype=moment_dtype, microbatches=microbatches,
                            act_rules=act_rules)
        if traced["peak"] < args:  # the arguments are alive through the step
            raise RuntimeError(f"traced peak {traced['peak']} below the arguments' {args} bytes")
        bytes_per_device["peak"] = max(traced["peak"], traced["peak_last_rank"])

    terms = analytic_terms(
        cfg, shape.kind, shape.seq_len, shape.global_batch, dict(mesh), remat=remat, fsdp=fsdp,
        moment_dtype=moment_dtype, serve_fsdp=serve_fsdp, grad_compress=grad_compress,
        kv_dedup_factor=kv_dedup_factor, act_rules=act_rules,
    )
    if shape.kind == "train":
        tokens = b * (min(cfg.decoder_slots, 448) if cfg.is_encdec else shape.seq_len)
    elif shape.kind == "prefill":
        tokens = b * shape.seq_len
    else:
        tokens = b
    n_active = cfg.active_params_per_token_matmul()
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    device, memory = device_memory()
    rec.update(
        status="ok",
        bytes_per_device=bytes_per_device,
        device=device,
        device_memory_bytes=memory,
        # only the traced peak decides it: ``args`` is a lower bound
        fits_hbm=bool(bytes_per_device["peak"] <= memory) if trace else None,
        flops_per_device=terms.flops,
        bytes_accessed_per_device=terms.hbm_bytes,
        collective_wire_bytes_per_device=terms.wire_bytes,
        analytic_detail={k: float(v) for k, v in terms.detail.items()},
        model_flops_global=model_flops,
        useful_flops_ratio=(model_flops / chips) / terms.flops if terms.flops else 0.0,
        chips=chips,
        total_params=cfg.total_params(),
        active_params=n_active,
    )
    if trace and peak_live:
        whole = trace_step(cfg, shape, fake_mesh(mesh), remat=remat, fsdp=fsdp,
                           serve_fsdp=serve_fsdp, moment_dtype=moment_dtype,
                           microbatches=microbatches, act_rules=act_rules, keep_peak=True)
        rec["peak_live"] = {"peak": whole["peak"],
                            "by_origin": dict(list(whole["peak_live"].items())[:PEAK_LIVE_SHOWN])}
    if trace:
        heavier = traced["peak_last_rank"] > traced["peak"]
        rec.update(collectives=traced["collectives"],
                   traced_flops_per_device=max(traced["flops"], traced["flops_last_rank"]),
                   traced_flops_rank0=traced["flops"],
                   traced_flops_last_rank=traced["flops_last_rank"],
                   last_rank_traced=traced["last_rank_traced"],
                   peak_rank=chips - 1 if heavier else 0,
                   trace_s=round(traced["trace_s"], 2), traced_depths=traced["depths"],
                   traced_per_depth=traced["per_depth"], args_live=traced["args_live"],
                   traced_flops_by_op=traced["flops_by_op"])
    if verbose:
        extra = (f" peak/dev={bytes_per_device['peak'] / 2**30:8.2f}GiB"
                 f" coll/dev={traced['collectives']['total_bytes']:.3e}"
                 f" traced_flops/dev={rec['traced_flops_per_device']:.3e}"
                 f" (rank 0 {traced['flops']:.3e}) trace={traced['trace_s']:6.1f}s"
                 if trace else "")
        print(f"[{rec['mesh']}] {arch:28s} {shape_name:12s} args/dev={args / 2**30:8.2f}GiB"
              f"{extra} fits={rec['fits_hbm']} ({device}) analytic_flops/dev={terms.flops:.3e}",
              flush=True)
        for origin, n in rec.get("peak_live", {}).get("by_origin", {}).items():
            print(f"    {n:>16,d}  {origin}", flush=True)
    return rec


def failed_record(arch: str, shape_name: str, multi_pod: bool, err: BaseException) -> Dict:
    """The reference's record of a cell that raised."""
    return {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
            "status": "failed", "error": f"{type(err).__name__}: {err}"[:2000]}


def run_all(meshes=(False, True), archs=None, shapes=None, verbose: bool = True, **kw):
    """Every cell on each mesh (``multi_pod`` values), in the reference's
    order; a cell that raises is recorded as failed (``failed_record``) and
    the run goes on, as the reference's ``main`` does."""
    cells = []
    try:
        for mp in meshes:
            for arch in archs or ARCH_IDS:
                for shape in shapes or list(SHAPES):
                    try:
                        cells.append(run_cell(arch, shape, multi_pod=mp, verbose=verbose, **kw))
                    except Exception as e:  # a failing cell is a bug: record + continue
                        if verbose:
                            print(f"FAILED {arch} {shape} multi_pod={mp}: {e}", flush=True)
                        cells.append(failed_record(arch, shape, mp, e))
    finally:
        close_fake_mesh()
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES.keys()))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch x shape) cell")
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", help="the smoke configs and shapes")
    ap.add_argument("--no-trace", action="store_true",
                    help="the argument accounting alone: no step is traced")
    ap.add_argument("--peak-live", action="store_true",
                    help="also trace each step at full depth and record what is alive at its "
                         "peak, by the operation and shape that made it")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES.keys()) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = run_all(meshes, archs, shapes, remat=args.remat, fsdp=not args.no_fsdp,
                    moment_dtype=args.moment_dtype, microbatches=args.microbatches,
                    trace=not args.no_trace, smoke=args.smoke, peak_live=args.peak_live)
    ok = sum(1 for c in cells if c.get("status") == "ok")
    sk = sum(1 for c in cells if c.get("status") == "skipped")
    fail = sum(1 for c in cells if c.get("status") == "failed")
    print(f"\n{ok} ok / {sk} skipped / {fail} failed")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
        print(f"wrote {args.out}")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
