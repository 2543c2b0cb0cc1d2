"""Logical-axis -> mesh partitioning rules (MaxText-style, divisibility-aware).

The port's counterpart of the reference's ``sharding/partition.py``, over a
mesh's axis names and sizes (``act_sharding.mesh_shape``: a ``DeviceMesh``
or an ordered ``{axis: size}``), returning spec tuples (``act_sharding``):

* **TP** — "heads"/"kv_heads"/"ff"/"vocab"/"rnn"/"heads_flat" map to the
  "model" axis.
* **EP** — "experts" maps to "model" when divisible (llama4's 128 experts on
  a 16-way axis); otherwise experts stay replicated and their inner "ff"
  axis takes "model" (mixtral's 8 experts).
* **FSDP** — "embed" maps to "data", sharding params, grads and optimizer
  state across the data axis.
* **DP/pod** — the batch dimension of activations maps to ("pod", "data").

A mesh axis is used at most once per tensor, and a mapping only applies when
the dimension size is divisible by the mesh axis size.  ``distribute_tree``
places a tree of tensors by a spec tree as DTensors, the counterpart of the
reference's ``shardings_of`` + ``device_put``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ..act_sharding import Spec, axes_size, mesh_shape, placements
from ..act_sharding import batch_mesh_axes as batch_axes  # mesh axes of the batch dimension
from ..pytree import tree_map

# priority-ordered candidate mesh axes per logical axis
TRAIN_RULES: Dict[str, Tuple[str, ...]] = {
    "experts": ("model",),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "heads_flat": ("model",),
    "rnn": ("model",),
    "rnn_out": (),
    "vocab": ("model",),
    "embed": ("data",),          # FSDP (dropped when fsdp=False)
    "embed_out": (),
    "head_dim": (),
    "layers": (),
    "conv": (),
    "lora": (),
}

SERVE_RULES: Dict[str, Tuple[str, ...]] = {**TRAIN_RULES, "embed": ()}


def spec_for_axes(shape: Sequence[int], axes: Sequence[str], mesh,
                  rules: Dict[str, Tuple[str, ...]]) -> Spec:
    """The spec of one tensor: rules applied left to right, each mesh axis
    at most once, divisibility required; trailing ``None``s dropped."""
    sizes = mesh_shape(mesh)
    used = set()
    out = []
    for dim, logical in zip(shape, axes):
        chosen: Optional[str] = None
        for cand in rules.get(logical, ()):  # unknown logical axes replicate
            if cand in used or cand not in sizes:
                continue
            if dim % sizes[cand] == 0 and dim > 0:
                chosen = cand
                used.add(cand)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_pspecs(params, axes_tree, mesh, *, mode: str = "train", fsdp: bool = True):
    """The spec tree of a parameter tree (tensors, ``meta`` ones included)
    and its axes tree (``Model.abstract_params()``)."""
    rules = dict(TRAIN_RULES if mode == "train" else SERVE_RULES)
    if not fsdp:
        rules["embed"] = ()
    return tree_map(lambda p, axes: spec_for_axes(p.shape, axes, mesh, rules), params, axes_tree)


def batch_dim_spec(mesh, batch_size: int):
    """The batch dimension's mesh axes: ("pod", "data") when their product
    divides the batch, else "data" or "pod" alone, else ``None``."""
    sizes = mesh_shape(mesh)
    axes = batch_axes(sizes)
    if axes and batch_size % axes_size(sizes, axes) == 0:
        return axes
    for sub in (("data",), ("pod",)):
        if all(a in sizes for a in sub) and batch_size % axes_size(sizes, sub) == 0:
            return sub
    return None


def local_shape(shape: Sequence[int], plc, mesh) -> Tuple[int, ...]:
    """The shape of this rank's shard of a tensor of ``shape`` under the
    DTensor placements ``plc``: each ``Shard(dim)`` split as ``torch.chunk``
    splits it (chunks of ``ceil(n / ranks)``, the last ones short or empty),
    in mesh-dimension order."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = list(shape)
    for i, p in enumerate(plc):
        if isinstance(p, Shard):
            size, chunk = out[p.dim], -(-out[p.dim] // mesh.size(i))
            out[p.dim] = max(0, min(size, chunk * (coord[i] + 1)) - chunk * coord[i])
    return tuple(out)


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def empty_placed(tree, spec_tree, mesh, device=None, zero: bool = True):
    """DTensors of ``tree``'s shapes and dtypes (tensors on any device,
    ``meta`` ones included) placed by ``spec_tree``, each rank allocating
    only its shard (``local_shape``), zeroed unless ``zero`` is false: the
    placed counterpart of ``torch.zeros``, with no full tensor made."""
    import torch
    from torch.distributed.tensor import DTensor

    def make(t, spec):
        plc = placements(spec, mesh)
        make_local = torch.zeros if zero else torch.empty
        local = make_local(local_shape(t.shape, plc, mesh), dtype=t.dtype,
                           device=device or mesh.device_type)
        return DTensor.from_local(local, mesh, plc, run_check=False, shape=t.shape,
                                  stride=contiguous_stride(t.shape))

    return tree_map(make, tree, spec_tree)


def distribute_tree(tree, spec_tree, mesh):
    """Each tensor of ``tree`` placed on the ``DeviceMesh`` as a DTensor by
    its spec (every rank passes the same full tensor and keeps its shard)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, spec: distribute_tensor(t, mesh, placements(spec, mesh)),
                    tree, spec_tree)
