"""Activation sharding by logical dimension names, and the mesh helpers the
sharding rules share.

The port's counterpart of the reference's ``act_sharding.py``.  Model code
names the dimensions of key activations (the residual stream, attention's
queries and outputs, recurrent states) with ``shard_act(x, names)``; a
launcher activates a rule table for a mesh with ``activation_rules(mesh)``.
Outside that context, or on a plain tensor, ``shard_act`` returns ``x``
itself, so the model code stays mesh-agnostic and a one-card run never
touches ``torch.distributed``.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions; the rules read only its axis names and sizes (``mesh_shape``),
so they also run over a plain ordered ``{axis: size}`` dictionary.  A spec
is a tuple with one entry per tensor dimension: a mesh-axis name, a tuple of
names, or ``None`` (the reference's ``PartitionSpec``, whose one-name tuples
read as the name).  ``placements`` turns a spec into DTensor placements.

Under a ``DeviceMesh``, ``activation_rules`` also lets plain tensors meet
DTensors in one operation, taken as replicated (``implicit_replication``),
for the constants that the model makes from shapes (positions, masks, zero
accumulators): they are the same on every rank, as they are replicated
under GSPMD.  That holds only when every input of the step is placed, so
``train_step.make_sharded_train_step`` refuses a parameter, moment or batch
leaf that is not a DTensor.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

AxisSpec = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisSpec, ...]

# Baseline rule table (the reference's; perf variants override entries).
DEFAULT_ACT_RULES: Dict[str, AxisSpec] = {
    "batch": ("pod", "data"),
    "seq": "model",             # sequence-parallel residual stream (None = off)
    "attn_seq": None,           # seq dim *inside* mixers (heads take "model")
    "heads": "model",
    "kv_heads": "model",
    "embed_act": None,
    "ff_act": "model",
    "vocab_act": "model",
    "experts_act": "model",
    "moe_cap": ("data", "model"),
    "rnn_act": "model",
    "kv_seq": None,
}

_state = threading.local()


def mesh_shape(mesh) -> Dict[str, int]:
    """The ordered ``{axis: size}`` of a ``DeviceMesh`` (its dimension names)
    or of a dictionary."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions have no names")
    return dict(zip(names, mesh.mesh.shape))


def spec_entry(axes: Sequence[str]) -> AxisSpec:
    """One spec entry for the mesh axes of a dimension, as ``PartitionSpec``
    normalises it: ``None`` for none, the name for one, else the tuple."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def entry_axes(entry: AxisSpec) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> List:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(dim)`` on
    every mesh dimension that a tensor dimension names, ``Replicate()`` on
    the others.  A tensor dimension split over several mesh axes is split
    in their mesh order, major first, as a ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for axis in entry_axes(entry):
            out[names.index(axis)] = Shard(dim)
    return out


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@contextlib.contextmanager
def activation_rules(mesh, rules: Optional[Dict[str, AxisSpec]] = None):
    """Activate ``DEFAULT_ACT_RULES`` (updated by ``rules``) for ``mesh``;
    under a ``DeviceMesh`` plain tensors join DTensor operations as
    replicated (module docstring)."""
    merged = dict(DEFAULT_ACT_RULES)
    if rules:
        merged.update(rules)
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, merged)
    try:
        if isinstance(mesh, dict):
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _state.ctx = prev


def active_mesh():
    """The mesh of the enclosing ``activation_rules`` context (None outside)."""
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def batch_mesh_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def axes_size(mesh, axes: Sequence[str]) -> int:
    """The number of ranks along ``axes`` of a mesh (or mesh shape)."""
    shape = mesh_shape(mesh)
    total = 1
    for a in axes:
        total *= shape[a]
    return total


def _axes_fit(dim: int, axes: Tuple[str, ...], shape: Dict[str, int]) -> bool:
    return dim % axes_size(shape, axes) == 0 and dim > 0


def act_spec(dims: Sequence[int], names: Sequence[Optional[str]], mesh,
             rules: Dict[str, AxisSpec]) -> Spec:
    """The spec that ``shard_act`` gives a tensor of shape ``dims`` named
    ``names``: each name's mesh axes, left to right, each mesh axis at most
    once, all of them if their product divides the dimension, else the first
    one alone that divides it, else none."""
    shape = mesh_shape(mesh)
    if len(dims) != len(names):
        raise ValueError(f"rank mismatch: {tuple(dims)} vs names {tuple(names)}")
    used = set()
    out = []
    for dim, name in zip(dims, names):
        axes = tuple(a for a in entry_axes(rules.get(name) if name else None)
                     if a in shape and a not in used)
        if axes and not _axes_fit(dim, axes, shape):
            axes = next(((a,) for a in axes if _axes_fit(dim, (a,), shape)), ())
        used.update(axes)
        out.append(spec_entry(axes))
    return tuple(out)


def shard_act(x, names: Sequence[Optional[str]]):
    """Constrain ``x``'s sharding by logical dimension names: a DTensor is
    redistributed to the placements the active rules give; anything else,
    or anything outside ``activation_rules``, is returned as it is."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    return x.redistribute(mesh, placements(act_spec(x.shape, names, mesh, rules), mesh))


def fsdp_gather(x):
    """Under ``activation_rules``, a weight DTensor made whole over the
    batch axes ("pod", "data": where FSDP splits it), its "model" split
    kept: the all-gather GSPMD makes before a layer uses an FSDP-split
    weight (its gradient comes back reduce-scattered).  Taken per layer,
    inside the layer's remat unit, so the gathered weights of one layer
    are alive at a time.  Anything else is returned as it is."""
    if getattr(_state, "ctx", None) is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    names, fsdp = list(mesh_shape(x.device_mesh)), batch_mesh_axes(x.device_mesh)
    plc = [Replicate() if names[i] in fsdp else p for i, p in enumerate(x.placements)]
    return x if plc == list(x.placements) else x.redistribute(x.device_mesh, plc)


def unflatten(x, dim: int, sizes: Sequence[int]):
    """x with dimension ``dim`` viewed as ``sizes``.  On a DTensor whose
    ``dim`` is split over more ranks than divide ``sizes[0]``, the split is
    undone first: DTensor cannot unflatten it (GSPMD splits the inner
    dimension too, e.g. 4 heads of 16 over 16 ranks)."""
    dim = dim % x.ndim
    if sizes[0] % split_ranks(x, dim):
        from torch.distributed.tensor import Replicate, Shard

        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in x.placements])
    return x.view(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def view_heads(x, heads: int):
    """x (..., heads * hd) viewed as (..., heads, hd) (``unflatten``)."""
    return unflatten(x, -1, (heads, x.shape[-1] // heads))


def split_ranks(x, dim: int) -> int:
    """Over how many ranks dimension ``dim`` of ``x`` is split (1 for a
    plain tensor, or one split only over mesh dimensions of size 1)."""
    if not is_dtensor(x):
        return 1
    from torch.distributed.tensor import Shard

    total = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim % x.ndim:
            total *= x.device_mesh.size(i)
    return total


def flatten_heads(x):
    """x (..., heads, hd) -> (..., heads * hd).  On a DTensor the result is
    pinned to its placements (an identity ``redistribute``), so that its
    gradient comes back placed as it is, which ``unflatten`` can take: a
    product against a weight split on the flat dimension would otherwise
    hand back a gradient split where the heads are not."""
    y = x.reshape(*x.shape[:-2], -1)
    return y.redistribute(y.device_mesh, y.placements) if is_dtensor(y) else y


def active_spec(x, names: Sequence[Optional[str]]) -> Optional[Spec]:
    """The spec ``shard_act(x, names)`` gives ``x`` under the active rules
    (``None`` outside ``activation_rules``)."""
    ctx = getattr(_state, "ctx", None)
    return None if ctx is None else act_spec(x.shape, names, ctx[0], ctx[1])


def _grad_placements(dts: Sequence) -> List[list]:
    """Each DTensor's gradient placements for one local computation over
    all of them: partial (summed over the ranks) on the mesh dimensions
    where it is whole but another argument is split, since there each
    rank's gradient covers only its own part of the work (a replicated
    weight meeting batch-split tokens, replicated tokens meeting
    expert-split weights); its own placements elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    split = [any(isinstance(d.placements[i], Shard) for d in dts)
             for i in range(len(dts[0].placements))]
    return [[Partial() if split[i] and isinstance(p, Replicate) else p
             for i, p in enumerate(d.placements)] for d in dts]


class _Local(torch.autograd.Function):
    """``fn`` on the local shards of DTensors, forward and backward on plain
    tensors: the inputs' local tensors go in detached, and the backward pass
    hands ``fn``'s graph the outputs' local gradients and returns the
    inputs' as DTensors (``_grad_placements``).  ``fn``'s graph is kept from
    the forward pass; inside a remat unit (``remat_unit``) only the inputs
    are kept and the graph is made again in the backward pass, so that the
    unit's checkpoint never meets it from inside another backward pass
    (one there would recompute the whole unit a second time)."""

    @staticmethod
    def forward(ctx, fn, mesh, out_placements, recompute, *dts):
        from torch.distributed.tensor import DTensor

        ctx.fn, ctx.recompute = fn, recompute
        ctx.mesh, ctx.out_placements = mesh, out_placements
        ctx.set_materialize_grads(False)  # an unused output's gradient stays None
        ctx.grad_placements = _grad_placements(dts)
        if recompute:
            with torch.no_grad():
                outs = fn(*(d._local_tensor for d in dts))
            ctx.save_for_backward(*dts)
        else:
            ctx.graph = _local_graph(fn, dts)
            outs = ctx.graph[1]
        outs = outs if isinstance(outs, tuple) else (outs,)
        return tuple(DTensor.from_local(o.detach(), mesh, pl, run_check=False)
                     for o, pl in zip(outs, out_placements))

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        ins, outs = _local_graph(ctx.fn, ctx.saved_tensors) if ctx.recompute else ctx.graph
        # a partial output's gradient is whole on every rank (d sum / d part = 1)
        pairs = [(o, g.redistribute(ctx.mesh, [Replicate() if isinstance(p, Partial) else p
                                               for p in pl]).to_local())
                 for o, g, pl in zip(outs, grads, ctx.out_placements)
                 if g is not None and o.requires_grad]
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True) if pairs and wanted else ())
        out = []
        for t, pl in zip(ins, ctx.grad_placements):
            g = next(got) if t.requires_grad else None
            out.append(None if g is None else DTensor.from_local(g, ctx.mesh, pl, run_check=False))
        ctx.graph = None
        return (None, None, None, None, *out)


def _local_graph(fn: Callable, dts: Sequence) -> Tuple[list, tuple]:
    """(the local inputs, detached, tracking gradients where the DTensors
    do; ``fn``'s outputs on them, with their graph)."""
    ins = [d._local_tensor.detach().requires_grad_(d.requires_grad) for d in dts]
    with torch.enable_grad():
        outs = fn(*ins)
    return ins, outs if isinstance(outs, tuple) else (outs,)


def current_rules():
    """The active ``activation_rules`` (mesh, rules), or None: what a remat
    unit captures to run under again (``remat_unit``)."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def remat_unit(rules):
    """Inside a remat unit's checkpoint (``transformer.remat_call``): the
    rules captured when the unit first ran (``current_rules``), since its
    recompute runs in the autograd engine's thread for the device (a card's
    backward pass does), where this module's thread-local rules are absent
    (DTensor's implicit replication is process-wide and stays on); and local
    regions keep their inputs only and make their graph again in the
    backward pass (``_Local``)."""
    prev = getattr(_state, "ctx", None), getattr(_state, "recompute", False)
    _state.ctx, _state.recompute = rules, True
    try:
        yield
    finally:
        _state.ctx, _state.recompute = prev


def run_local(fn: Callable, dts: Sequence, out_placements: Sequence[list]) -> tuple:
    """``fn``'s outputs over the local shards of ``dts`` (DTensors on one
    mesh), each output a DTensor with its ``out_placements``: the port's
    ``shard_map``, differentiable (``_Local``)."""
    return _Local.apply(fn, dts[0].device_mesh, list(out_placements),
                        getattr(_state, "recompute", False), *dts)


def local_call(fn: Callable, *args: Tuple[torch.Tensor, Sequence[Optional[str]]],
               outs: Optional[Sequence[Sequence[Optional[str]]]] = None):
    """``fn`` over the local shards of DTensor arguments: each ``(tensor,
    names)`` is constrained by ``shard_act`` (a plain tensor is taken as
    replicated), and ``fn``'s one output comes back as a DTensor split as
    the first argument is, on dimensions it shares with it (``run_local``);
    with ``outs`` (one tuple of names per output), ``fn``'s outputs come back
    split as the arguments' dimensions of those names are.  For functions
    whose rows are independent along the split dimensions (attention or a
    recurrence over batch rows and heads, a lookup or a loss per token).
    Outside a ``DeviceMesh`` context, or with no DTensor among the
    arguments, ``fn`` runs on the tensors as they are."""
    ctx = getattr(_state, "ctx", None)
    tensors = [a for a, _ in args]
    if ctx is None or isinstance(ctx[0], dict) or not any(is_dtensor(a) for a in tensors):
        return fn(*tensors)
    mesh, rules = ctx
    placed = _placed(mesh, args)
    if outs is None:
        return run_local(fn, placed, [placed[0].placements])[0]
    axes: Dict[str, AxisSpec] = {}
    for (_, names), d in zip(args, placed):
        for name, entry in zip(names, act_spec(d.shape, names, mesh, rules)):
            if name:
                axes.setdefault(name, entry)
    return run_local(fn, placed, [placements(tuple(axes.get(n) if n else None for n in names),
                                             mesh) for names in outs])


def _placed(mesh, args) -> list:
    """Each ``(tensor, names)`` as a DTensor constrained by ``shard_act`` (a
    plain tensor taken as replicated first)."""
    from torch.distributed.tensor import DTensor

    out = []
    for a, names in args:
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, placements((), mesh), run_check=False)
        out.append(shard_act(a, names))
    return out


def local_sum(fn: Callable, *args: Tuple[torch.Tensor, Sequence[Optional[str]]]):
    """``fn``'s scalar over the local shards of DTensor arguments (each
    ``(tensor, names)`` constrained by ``shard_act``), summed over the ranks
    that split them: a DTensor partial there (``run_local``).  Outside a
    ``DeviceMesh`` context, or with no DTensor among the arguments, ``fn``
    runs on the tensors as they are."""
    ctx = getattr(_state, "ctx", None)
    tensors = [a for a, _ in args]
    if ctx is None or isinstance(ctx[0], dict) or not any(is_dtensor(a) for a in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Partial, Replicate, Shard

    placed = _placed(ctx[0], args)
    split = [any(isinstance(d.placements[i], Shard) for d in placed)
             for i in range(len(placed[0].placements))]
    return run_local(fn, placed, [[Partial() if s else Replicate() for s in split]])[0]
