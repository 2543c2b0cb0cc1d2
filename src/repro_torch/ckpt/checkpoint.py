"""Atomic, async-capable checkpointing of tensor trees: the port's
counterpart of the reference's ``ckpt/checkpoint.py``, with its layout.

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per tree leaf (its key path
joined by ``__``) plus ``manifest.json`` (``step``, ``leaves`` with each
leaf's name, shape and dtype, and ``extra``: the trainer's losses and the data
pipeline's dedup state).  Writes go to ``step_<N>.tmp`` and rename
atomically; ``latest_step`` looks only at directories with a manifest, so a
crash mid-save never corrupts the restore point.

numpy has no bfloat16: a bf16 leaf is stored as its ``uint16`` bits, with
``"bfloat16"`` as its manifest dtype.  ``save`` copies every leaf to host
memory before it returns, also with ``async_save``, so a tensor changed in
place afterwards (an optimizer step) cannot race the writer thread.
``restore`` places leaves on ``device``, by default where the matching leaf
of ``like`` lies.

Elastic restore (the reference's ``shardings``): ``save`` writes a DTensor
leaf as its full tensor (every rank gathers it, rank 0 writes), and
``restore(..., mesh=, specs=)`` places each leaf as a DTensor by its spec
on the current mesh, whatever the mesh was at save time.

Earlier versions of the port kept the dense decoder's layers under one
``layers`` dictionary (``layers__wq``, ...) where the reference's layout,
which the port takes now, has ``scan__pos0__mixer__wq``: the same arrays,
stacked the same way.  ``restore`` reads such a checkpoint's leaf for a
``scan__pos0`` attention, MLP or norm leaf that the checkpoint lacks.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..act_sharding import is_dtensor, placements
from ..pytree import flatten_with_path, leaves, tree_map, unflatten_like

BF16 = "bfloat16"


def _key_name(path) -> str:
    return "__".join(path) or "root"


_DENSE_LAYER = re.compile(
    r"scan__pos0__(?:mixer__|mlp__)?(?=(?:ln1|ln2|wq|wk|wv|wo|w_in|w_gate|w_out)$)")


def _earlier_name(name: str) -> str:
    """The leaf's name in the earlier ``layers`` layout (itself if none)."""
    return _DENSE_LAYER.sub("layers__", name)


def _to_host(leaf):
    """(numpy copy of the leaf, manifest dtype); a DTensor's full tensor."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16), BF16
        arr = t.to("cpu", copy=True).numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(
    directory: str,
    step: int,
    tree: Any,
    extra: Optional[Dict[str, Any]] = None,
    async_save: bool = False,
) -> Optional[threading.Thread]:
    """Save a tree of tensors (or numpy arrays); with ``async_save`` the files
    are written by a thread, which is returned (the host copies are made
    before that).  A tree with DTensor leaves is saved by every rank of
    their group together: each gathers the full tensors, rank 0 writes, and
    a synchronous save returns on every rank once the files are in place."""
    host_leaves = [(_key_name(path), *_to_host(leaf)) for path, leaf in flatten_with_path(tree)]
    sharded = any(is_dtensor(leaf) for leaf in leaves(tree))
    if sharded:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            if not async_save:
                dist.barrier()
            return None

    def _write():
        tmp = os.path.join(directory, f"step_{step}.tmp")
        final = os.path.join(directory, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        names = []
        for name, arr, dtype in host_leaves:
            names.append({"name": name, "shape": list(arr.shape), "dtype": dtype})
            np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest = {"step": step, "leaves": names, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # atomic publish

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if sharded:
        dist.barrier()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(directory: str, step: int, like: Any, device=None, mesh=None,
            specs: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, possibly on
    the ``meta`` device).  Each leaf goes to ``device`` if given, else where
    ``like``'s leaf lies (a ``meta`` or non-tensor leaf: the host).  With a
    ``DeviceMesh`` and ``specs`` (a spec tree of ``like``'s structure,
    ``sharding.param_pspecs``), each leaf is placed on the mesh's device as
    a DTensor by its spec instead (elastic restore)."""
    if (mesh is None) != (specs is None):
        raise ValueError("restore takes mesh and specs together")
    spec_leaves = None
    if mesh is not None:
        spec_leaves = []   # in flatten_with_path's order, as tree_map visits
        tree_map(lambda _, spec: spec_leaves.append(tuple(spec)), like, specs)
    base = os.path.join(directory, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    saved = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    out = []
    for path, leaf in flatten_with_path(like):
        name = _key_name(path)
        if name not in saved and _earlier_name(name) in saved:
            name = _earlier_name(name)
        if name not in saved:
            raise KeyError(f"checkpoint missing leaf {name}")
        if tuple(saved[name]["shape"]) != tuple(leaf.shape):
            raise ValueError(f"leaf {name}: saved shape {saved[name]['shape']}, "
                             f"want {list(leaf.shape)}")
        t = _from_host(np.load(os.path.join(base, name + ".npy")), saved[name]["dtype"])
        if spec_leaves is not None:
            from torch.distributed.tensor import distribute_tensor

            spec = spec_leaves[len(out)]
            out.append(distribute_tensor(t.to(mesh.device_type), mesh, placements(spec, mesh)))
            continue
        target = device
        if target is None:
            on = getattr(leaf, "device", None)
            target = on if isinstance(on, torch.device) and on.type != "meta" else "cpu"
        out.append(t.to(target))
    return unflatten_like(like, out)


def restore_extra(directory: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["extra"]
