"""Meshes: the production mesh shapes, and a mesh over the processes present.

The port's counterpart of the reference's ``launch/mesh.py``.  The
production meshes are shapes only (ordered ``{axis: size}``), which is all
the partition rules and the dry run read: no process group is made.
``make_host_mesh`` builds a ``DeviceMesh`` over the processes of the current
``torch.distributed`` group (one card: 1 x 1), and ``init_single_process``
starts that group for one process without opening a port.
``make_fake_mesh`` builds a production-sized ``DeviceMesh`` inside one
process over ``torch.distributed``'s "fake" backend, whose collectives move
nothing: the dry run traces each rank's step on it (``launch/dryrun.py``),
and ``close_fake_mesh`` ends it.
"""

from __future__ import annotations

import datetime
from typing import Dict

import torch

# Seconds a process group waits for its ranks before it fails.
GROUP_TIMEOUT_S = 120.0


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """16 x 16 single pod (256 chips) or 2 x 16 x 16 two-pod (512 chips).

    Axes: "pod" (cross-pod, data parallel only), "data" (in-pod DP/FSDP),
    "model" (TP/EP)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(model_axis: int = 1, device: str = "cuda"):
    """A ("data", "model") ``DeviceMesh`` over the processes of the current
    group: ``world // model_axis`` x ``model_axis``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_single_process() or "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} processes do not split into a model axis of {model_axis}")
    return init_device_mesh(torch.device(device).type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def init_single_process(device: str = "cuda") -> None:
    """The process group of this one process: NCCL for ``cuda``, gloo for
    ``cpu``, rank 0 of 1, over an in-memory ``HashStore`` (no port is
    opened).  Raises if the backend cannot start; never takes the other."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_single_process(device='cuda') needs a card")
    backend = {"cuda": "nccl", "cpu": "gloo"}[kind]
    if kind == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def make_fake_mesh(shape: Dict[str, int], rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` (ordered ``{axis: size}``, e.g.
    ``make_production_mesh()``) on CPU over a "fake" process group of that
    many ranks, this process playing ``rank`` (its coordinates on the mesh,
    major axis first; the last rank holds the last block on every axis):
    collectives return tensors of the right shapes and move nothing.  A
    process has one default group, so this raises if one is already up:
    the dry run owns its process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        raise RuntimeError("make_fake_mesh: a process group is already up; the fake mesh "
                           "needs a process of its own")
    # registers the "fake" backend (torch ships it with its distributed tests)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    chips = 1
    for size in shape.values():
        chips *= size
    if not 0 <= rank < chips:
        raise ValueError(f"make_fake_mesh: rank {rank} is not on a mesh of {chips} ranks")
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank, world_size=chips)
    _install_fake_alltoall()
    return init_device_mesh("cpu", tuple(shape.values()), mesh_dim_names=tuple(shape))


def close_fake_mesh() -> None:
    """Destroy the fake group of ``make_fake_mesh``, put DTensor's own
    shard-to-shard move back and empty DTensor's caches: a ``DeviceMesh``
    equals any other of its layout whatever rank it was made for, so a
    plan cached for a mesh that is gone would name its process groups."""
    import torch.distributed as dist

    _uninstall_fake_alltoall()
    if dist.is_initialized():
        dist.destroy_process_group()
    _clear_dtensor_caches()


def _clear_dtensor_caches() -> None:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _collective_utils, _redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:  # the dispatch's own cache in C++
        native()
    for fn in (getattr(prop, "propagate_op_sharding", None),
               getattr(prop, "_propagate_tensor_meta_cached", None),
               getattr(_redistribute, "_gen_transform_infos", None),
               getattr(getattr(_collective_utils, "MeshTopoInfo", None), "build_from_mesh", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


# DTensor moves a tensor from one split dimension to another (``Shard(a)`` to
# ``Shard(b)`` on one mesh dimension) with ``shard_dim_alltoall``, which on a
# mesh of device type "cpu" takes a fallback for gloo, which has no
# all-to-all: it all-gathers the whole tensor and keeps this rank's chunk.
# The fake mesh is a "cpu" mesh, so a trace on it would count that move as
# an all-gather of the whole result (group-size times the bytes) and hold a
# whole-size transient that no card allocates, where NCCL on a card group
# makes it one all-to-all.  While a fake mesh is up, this module's
# replacement sends a move on a "fake" group to DTensor's all-to-all
# operation itself (``torch.ops._dtensor.shard_dim_alltoall``, whose fake
# implementation gives the rank's result shape); a move on any other group
# (gloo, NCCL) takes DTensor's own function.
_MODULES = ("torch.distributed.tensor._collective_utils",
            "torch.distributed.tensor.placement_types")
_ORIGINAL: Dict[str, object] = {}


def _fake_alltoall(original):
    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        import torch.distributed as dist

        group = mesh.get_group(mesh_dim)
        if dist.get_backend(group) != "fake":
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     group.group_name)

    return shard_dim_alltoall


def _install_fake_alltoall() -> None:
    import importlib

    for name in _MODULES:
        module = importlib.import_module(name)
        fn = getattr(module, "shard_dim_alltoall", None)
        if fn is not None and name not in _ORIGINAL:
            _ORIGINAL[name] = fn
            module.shard_dim_alltoall = _fake_alltoall(fn)
    if not _ORIGINAL:
        raise RuntimeError("make_fake_mesh: DTensor has no shard_dim_alltoall to route")


def _uninstall_fake_alltoall() -> None:
    import importlib

    for name, fn in list(_ORIGINAL.items()):
        importlib.import_module(name).shard_dim_alltoall = fn
        del _ORIGINAL[name]
