"""Multi-pod dry run on the ``meta`` device: every (architecture x shape x
mesh) cell's bytes per device, with nothing allocated.

The port's counterpart of the reference's ``launch/dryrun.py``, over the same
40 cells (10 ids x 4 shapes) and both production meshes (16 x 16 and
2 x 16 x 16).  The reference lowers and compiles each cell's step under 512
faked XLA devices and reads XLA's memory and cost analyses; the port has no
XLA artifact, so a cell here is the accounting of what its step takes as
arguments, from the partition rules:

  * parameters: ``Model.abstract_params()`` (``meta`` tensors and logical
    axes) split by ``param_pspecs``;
  * the AdamW state (train): two moments in ``moment_dtype``, split as the
    parameters are, and the step count;
  * the batch: ``input_specs`` split by ``batch_pspecs``;
  * the decode cache (decode): ``init_cache``'s shapes on ``meta``, split by
    ``cache_pspecs``;
  * ``analytic_terms`` (FLOPs, HBM and wire bytes per device per step).

The arguments are a lower bound on a step's peak (activations and
temporaries come on top), held against one card's memory:
``torch.cuda.get_device_properties(0)`` when a card is present, else
``H100_80GB_HBM3_BYTES``.  The record keeps the reference's keys where they
mean the same here; XLA's ``memory_analysis``/``cost_analysis`` and the HLO
collective schedule (``collective_bytes``) have no counterpart (README.md).

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
from ..configs import ARCH_IDS, SHAPES, ShapeSpec, get_config
from ..models import config as C
from ..models import encdec, transformer
from ..models.model import build_model
from ..pytree import tree_map
from ..sharding import batch_pspecs, param_pspecs, cache_pspecs
from .analytic import analytic_terms
from .mesh import make_production_mesh

# long_500k runs only for bounded-state decoders (DESIGN.md §4).
LONG_CONTEXT_ARCHS = {"mixtral-8x7b", "recurrentgemma-2b", "rwkv6-1.6b"}

# One NVIDIA H100 80GB HBM3's memory, as torch.cuda.get_device_properties(0)
# .total_memory reads it: the limit when no card is present.
H100_80GB_HBM3 = "NVIDIA H100 80GB HBM3"
H100_80GB_HBM3_BYTES = 85_017_493_504


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
def _abstract(arch: str, param_dtype: str):
    cfg = get_config(arch).replace(param_dtype=param_dtype)
    return build_model(cfg).abstract_params()


def _meta_cache(cfg: C.ModelConfig, batch: int, slots: int, enc_slots: int):
    if cfg.is_encdec:
        return encdec.init_dec_cache(cfg, batch, slots, enc_slots, device="meta")
    return transformer.init_cache(cfg, batch, slots, device="meta")


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
    grad_compress: bool = False,
    kv_dedup_factor: float = 1.0,
    act_rules: Optional[Dict[str, Any]] = None,
    verbose: bool = True,
) -> Dict[str, Any]:
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
        "remat": remat,
        "fsdp": fsdp,
    }
    reason = skip_reason(arch, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if shape.kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16")  # serving runs bf16 weights
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = axes_size(mesh, mesh)
    params, axes = _abstract(arch, cfg.param_dtype)
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
    args = sum(parts.values())
    rec.update(
        status="ok",
        bytes_per_device={**parts, "args": args},
        device=device,
        device_memory_bytes=memory,
        fits_hbm=bool(args <= memory),
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
    if verbose:
        print(f"[{rec['mesh']}] {arch:28s} {shape_name:12s} args/dev={args / 2**30:8.2f}GiB "
              f"fits={rec['fits_hbm']} ({device}) flops/dev={terms.flops:.3e} "
              f"hbm/dev={terms.hbm_bytes:.3e} wire/dev={terms.wire_bytes:.3e}")
    return rec


def run_all(meshes=(False, True), archs=None, shapes=None, **kw):
    """Every cell on each mesh (``multi_pod`` values), in the reference's
    order."""
    cells = []
    for mp in meshes:
        for arch in archs or ARCH_IDS:
            for shape in shapes or list(SHAPES):
                cells.append(run_cell(arch, shape, multi_pod=mp, **kw))
    return cells


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES.keys()))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch x shape) cell")
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES.keys()) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = run_all(meshes, archs, shapes, remat=args.remat, fsdp=not args.no_fsdp,
                    moment_dtype=args.moment_dtype)
    ok = sum(1 for c in cells if c.get("status") == "ok")
    sk = sum(1 for c in cells if c.get("status") == "skipped")
    print(f"\n{ok} ok / {sk} skipped / 0 failed")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
