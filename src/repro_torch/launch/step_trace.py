"""One rank's view of a step run on fake tensors: its collectives, its live
bytes and its FLOPs.

The port's counterpart of what the reference reads from a compiled XLA
module (``launch/dryrun.py``: ``collective_bytes`` over the HLO text,
``memory_analysis`` and ``cost_analysis``).  ``StepTrace`` is a
``TorchDispatchMode`` that sees the operations on plain (fake) tensors: under
a ``DeviceMesh`` those are each rank's local shards, since it hands an
operation on DTensors back to DTensor's dispatch (``NotImplemented``), which
then runs the local operations and collectives beneath it.  So every number
it keeps is per device:

* ``collectives``: each ``c10d_functional`` collective the step makes, by
  the reference's five kinds, its bytes under the reference's wire model
  (all-reduce 2 x the result's bytes, the others the result's bytes);
* ``peak``: the most bytes of distinct storages alive at once (a storage
  shared by views counts once; it is freed when its last tensor goes);
* ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) over the local shapes; ``flops_by_op`` splits
  them by operation and operand shapes (``"mm(8192, 2048)x(2048, 32000)"``).
"""

from __future__ import annotations

import sys
import weakref
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# The reference's collective kinds (``collective_bytes``), in its order.
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# Functional collectives by name (``torch.ops._c10d_functional``, and
# DTensor's own all-to-all), each to its kind; ``wait_tensor`` moves nothing.
_KIND_OF = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def wire_bytes(kind: str, result_bytes: int) -> int:
    """The reference's ring model of one collective's bytes on the wire per
    device: an all-reduce twice its result, the others their result."""
    return 2 * result_bytes if kind == "all-reduce" else result_bytes


def summarize(ops: Iterable[Tuple[str, int]]) -> Dict:
    """``{"bytes", "counts", "total_bytes"}`` over (kind, result bytes) pairs,
    the reference's ``collective_bytes`` record."""
    totals = dict.fromkeys(KINDS, 0)
    counts = dict.fromkeys(KINDS, 0)
    for kind, nbytes in ops:
        totals[kind] += wire_bytes(kind, nbytes)
        counts[kind] += 1
    return {"bytes": totals, "counts": counts, "total_bytes": sum(totals.values())}


def _propagating() -> bool:
    """Whether DTensor's sharding propagation is running: it runs each new
    operation once on fake tensors of the global shapes to learn its output's
    shape (then caches it), which is not a rank's work."""
    frame = sys._getframe(2)
    while frame is not None:
        if "sharding_prop" in frame.f_code.co_filename:
            return True
        frame = frame.f_back
    return False


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class StepTrace(TorchDispatchMode):
    """Counts a step's collectives, live storage bytes and FLOPs on the
    plain tensors it sees (module docstring).  ``reset_peak()`` starts the
    peak at the bytes alive now (``torch.cuda.reset_peak_memory_stats``);
    ``track(tree)`` adds tensors made before the mode was entered."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.ops: List[Tuple[str, int]] = []

    # -- storages --------------------------------------------------------------
    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            if hasattr(t, "_local_tensor"):  # a DTensor: its shard on this rank
                t = t._local_tensor
            if t.device.type == "meta":  # shapes only, never allocated
                continue
            try:
                storage = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = storage._cdata
            if key in self._live:
                continue
            self._live[key] = storage.nbytes()
            self.live_bytes += storage.nbytes()
            self.peak = max(self.peak, self.live_bytes)
            weakref.finalize(storage, self._freed, key)

    def reset_peak(self) -> None:
        self.peak = self.live_bytes

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor's dispatch runs the local operations
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _propagating():
            return out
        packet = func._overloadpacket
        if func.namespace in _NAMESPACES and packet.__name__ in _KIND_OF:
            self.ops.append((_KIND_OF[packet.__name__],
                             sum(t.numel() * t.element_size() for t in _tensors(out))))
        elif "c10d" in func.namespace and not packet.__name__.startswith("wait_tensor"):
            raise NotImplementedError(f"step trace: no wire model for collective {func}")
        fn = self._flop_registry.get(packet)
        if fn is not None:
            n = int(fn(*args, **kwargs, out_val=out))
            key = packet.__name__ + "x".join(str(tuple(t.shape)) for t in _tensors(args))
            self.flops += n
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        self.track(out)
        return out

    def collectives(self) -> Dict:
        return summarize(self.ops)
