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

* ``collectives``: each ``c10d_functional`` collective the step makes,
  DTensor's all-to-all (``launch.mesh`` routes a move between split
  dimensions on the fake group to it) and the port's collective-permute
  (``act_sharding.shift_ranks``), by the reference's five kinds, its bytes
  under the reference's wire model (all-reduce 2 x the result's bytes,
  the others the result's bytes);
* ``peak``: the most bytes of distinct storages alive at once (a storage
  shared by views counts once; it is freed when its last tensor goes; a
  collective's ``wait_tensor`` returns its input's storage, as it does on
  a real group, where fake tensors give it a new one);
* ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) over the local shapes; ``flops_by_op`` splits
  them by operation and operand shapes (``"mm(8192, 2048)x(2048, 32000)"``),
  prefixed with the name of the enclosing ``act_sharding.work_label``
  (``"loss_head/mm(8192, 2048)x(2048, 2000)"``);
* ``peak_live()`` (with ``keep_peak``): the storages alive at the peak,
  summed by the operation and shape that made each
  (``"mm -> (8192, 2048) bfloat16"``), largest first.
"""

from __future__ import annotations

import sys
import weakref
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..act_sharding import current_label

# The reference's collective kinds (``collective_bytes``), in its order.
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# Functional collectives by name (``torch.ops._c10d_functional``, DTensor's
# own all-to-all, and the port's shift of a block to the next rank,
# ``act_sharding.shift_ranks``), each to its kind; ``wait_tensor`` moves
# nothing.
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
    "shift_ranks": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor", "repro_torch")


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
    ``track(tree)`` adds tensors made before the mode was entered;
    ``keep_peak`` keeps the live set at the peak (``peak_live``)."""

    def __init__(self, keep_peak: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self._live: Dict[int, int] = {}
        self._origin: Dict[int, str] = {}
        self._keep_peak = keep_peak
        self._peak_set: Dict[int, Tuple[str, int]] = {}
        self.live_bytes = 0
        self.peak = 0
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.ops: List[Tuple[str, int]] = []

    # -- storages --------------------------------------------------------------
    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._origin.pop(key, None)

    def _new_peak(self) -> None:
        self.peak = self.live_bytes
        if self._keep_peak:
            self._peak_set = {k: (self._origin.get(k, "before"), n) for k, n in self._live.items()}

    def peak_live(self) -> Dict[str, int]:
        """Bytes alive at the peak by origin, largest first (``keep_peak``);
        storages tracked before the mode saw an operation are "before"."""
        out: Dict[str, int] = {}
        for origin, n in self._peak_set.values():
            out[origin] = out.get(origin, 0) + n
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def track(self, tree, origin: str = "before") -> None:
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
            if self._keep_peak:
                self._origin[key] = f"{origin} -> {tuple(t.shape)} {str(t.dtype)[6:]}"
            self.live_bytes += storage.nbytes()
            if self.live_bytes > self.peak:
                self._new_peak()
            weakref.finalize(storage, self._freed, key)

    def _hand_over(self, t: torch.Tensor) -> None:
        """The bytes of t's storage move to the next storage tracked (the
        waited result, the same memory on a real group)."""
        key = t.untyped_storage()._cdata
        self.live_bytes -= self._live.get(key, 0)
        if key in self._live:
            self._live[key] = 0

    def reset_peak(self) -> None:
        self._new_peak()

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
        if packet.__name__ == "wait_tensor":
            self._hand_over(args[0])
        if func.namespace in _NAMESPACES and packet.__name__ in _KIND_OF:
            self.ops.append((_KIND_OF[packet.__name__],
                             sum(t.numel() * t.element_size() for t in _tensors(out))))
        elif "c10d" in func.namespace and not packet.__name__.startswith("wait_tensor"):
            raise NotImplementedError(f"step trace: no wire model for collective {func}")
        fn = self._flop_registry.get(packet)
        if fn is not None:
            n = int(fn(*args, **kwargs, out_val=out))
            key = packet.__name__ + "x".join(str(tuple(t.shape)) for t in _tensors(args))
            label = current_label()
            key = f"{label}/{key}" if label else key
            self.flops += n
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        self.track(out, packet.__name__)
        return out

    def collectives(self) -> Dict:
        return summarize(self.ops)
