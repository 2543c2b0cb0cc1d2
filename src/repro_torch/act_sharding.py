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

Where DTensor's own rules would keep more than GSPMD keeps, the step takes
explicit collectives on local shards instead: ``row_parallel`` (a block's
output product, reduce-scattered onto the residual stream's sequence
split) and the vocabulary-parallel lookup and loss head
(``models/vocab.py``), each an ``autograd.Function`` whose backward pass
pairs its forward collective (all-gather with reduce-scatter, all-reduce
with identity).  Each runs only where its split has more than one rank,
so on a 1 x 1 mesh the step is the plain one.

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


def block_start(x, names: Sequence[Optional[str]], dim: int) -> int:
    """The first index along dimension ``dim`` of this rank's block of x
    under ``shard_act(x, names)`` (0 outside ``activation_rules``): its
    coordinate over the mesh axes that split the dimension, major first,
    times the block's length."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or isinstance(ctx[0], dict):
        return 0
    mesh, rules = ctx
    axes = entry_axes(act_spec(x.shape, names, mesh, rules)[dim])
    if axes_size(mesh, axes) > 1:
        _RANK_OFFSETS[0] += 1
    index = 0
    for i, axis in enumerate(mesh_shape(mesh)):
        if axis in axes:
            index = index * mesh.size(i) + mesh.get_local_rank(axis)
    return index * (x.shape[dim] // axes_size(mesh, axes))


# How many blocks ``block_start`` placed at an offset that depends on the
# rank's coordinates (a split of more than one rank).  A step that places
# none does the same local work on every rank of its mesh
# (``launch.dryrun`` traces a second rank only where it places some).
_RANK_OFFSETS = [0]


def rank_offsets() -> int:
    """The blocks ``block_start`` has placed at a rank-dependent offset so
    far in this process."""
    return _RANK_OFFSETS[0]


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
    (one there would recompute the whole unit a second time).  That rerun
    is made under ``rebuilding_graph``: there a function whose output no
    operation of the region reads, and whose own backward pass needs only
    its inputs (the banded schedule, which ``attention._schedule`` runs
    alone in its region), may skip computing it; one whose backward pass
    needs what its forward made (flash attention's float32 output and
    log-sum-exp) takes it from the region's run in the unit's rerun, which
    the checkpoint makes just before, when this backward pass first reads
    the inputs (``hand_to_rebuild``, ``taken_from_rerun``).  The regions of
    a unit are told apart by their order in it, the same in each of its
    runs."""

    @staticmethod
    def forward(ctx, fn, mesh, out_placements, recompute, *dts):
        from torch.distributed.tensor import DTensor

        ctx.fn, ctx.recompute = fn, recompute
        ctx.mesh, ctx.out_placements = mesh, out_placements
        ctx.set_materialize_grads(False)  # an unused output's gradient stays None
        ctx.grad_placements = _grad_placements(dts)
        if recompute:
            run = getattr(_state, "unit_run", None)
            ctx.handed, ctx.region = (None, None) if run is None else (run.handed, run.next)
            handed = [] if run is not None and run.rerun else None
            if run is not None:
                run.next += 1
            prev, _state.to_rebuild = getattr(_state, "to_rebuild", None), handed
            try:
                with torch.no_grad():
                    outs = fn(*(d._local_tensor for d in dts))
            finally:
                _state.to_rebuild = prev
            if handed:
                run.handed[ctx.region] = handed
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

        if ctx.recompute:
            saved = ctx.saved_tensors  # the unit's rerun runs here, if nothing ran it yet
            handed = ctx.handed.pop(ctx.region, None) if ctx.handed is not None else None
            prev = getattr(_state, "graph_only", False), getattr(_state, "from_rerun", None)
            _state.graph_only, _state.from_rerun = True, handed
            try:
                ins, outs = _local_graph(ctx.fn, saved)
            finally:
                _state.graph_only, _state.from_rerun = prev
        else:
            ins, outs = ctx.graph
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
        ctx.graph = ctx.handed = None
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


class _UnitRun:
    """One run of a remat unit: ``handed``, shared by the unit's runs, maps
    a local region's place in the unit to what its run in the unit's rerun
    handed to its graph rebuild (``_Local``); ``next``, the place of the
    run's next region; ``rerun``, whether this is the backward pass's
    rerun."""

    def __init__(self, handed: dict, rerun: bool):
        self.handed, self.rerun, self.next = handed, rerun, 0


@contextlib.contextmanager
def remat_unit(rules, replay: bool = False, handed: Optional[dict] = None,
               rerun: bool = False):
    """Inside a remat unit's checkpoint (``transformer.remat_call``): the
    rules captured when the unit first ran (``current_rules``), since its
    recompute runs in the autograd engine's thread for the device (a card's
    backward pass does), where this module's thread-local rules are absent
    (DTensor's implicit replication is process-wide and stays on); and local
    regions keep their inputs only and make their graph again in the
    backward pass (``_Local``).  ``replay``: this is the backward pass's
    rerun of a remat "dots" unit (``replaying``).  ``handed``: one dictionary
    a unit, shared by its runs, through which a region's run in the rerun
    (``rerun``: this run is it, under any policy) hands tensors to its
    graph rebuild (``hand_to_rebuild``)."""
    prev = (getattr(_state, "ctx", None), getattr(_state, "recompute", False),
            getattr(_state, "replay", False), getattr(_state, "unit_run", None))
    _state.ctx, _state.recompute, _state.replay = rules, True, replay
    _state.unit_run = None if handed is None else _UnitRun(handed, rerun)
    try:
        yield
    finally:
        _state.ctx, _state.recompute, _state.replay, _state.unit_run = prev


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


# ---------------------------------------------------------------------------
# Explicit collectives on local shards, and the row-parallel block output.
# ---------------------------------------------------------------------------

# A block's residual stream: rows over the batch axes, its sequence split
# by the "seq" rule (sequence parallelism; None: whole).
RESIDUAL = ("batch", "seq", "embed_act")


def axis_group(mesh, axis: str) -> Tuple[str, int]:
    """(process group name, ranks) of one mesh axis."""
    return mesh.get_group(axis).group_name, mesh.size(list(mesh_shape(mesh)).index(axis))


def _c10d():
    return torch.ops._c10d_functional


def gather_rows(t: torch.Tensor, group: Tuple[str, int]) -> torch.Tensor:
    """Each rank's t (n, ...) concatenated in rank order: (ranks * n, ...)."""
    name, m = group
    return _c10d().wait_tensor(_c10d().all_gather_into_tensor(t.contiguous(), m, name))


def scatter_rows(t: torch.Tensor, group: Tuple[str, int]) -> torch.Tensor:
    """The sum of every rank's t (ranks * n, ...), rank r keeping rows r n
    to (r + 1) n."""
    name, m = group
    return _c10d().wait_tensor(_c10d().reduce_scatter_tensor(t.contiguous(), "sum", m, name))


def reduce_all(t: torch.Tensor, group: Tuple[str, int], op: str = "sum") -> torch.Tensor:
    """Every rank's t combined by ``op`` ("sum", "max"), on every rank."""
    return _c10d().wait_tensor(_c10d().all_reduce(t.contiguous(), op, group[0]))


def rows_split_only(x, axis: Optional[str] = None) -> bool:
    """Whether DTensor x is split along its rows (dimension 0) only, and
    not over ``axis``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(x.device_mesh))
    return all(p == Replicate() or (p == Shard(0) and names[i] != axis)
               for i, p in enumerate(x.placements))


@contextlib.contextmanager
def _keep_result():
    prev = getattr(_state, "keep", False)
    _state.keep = True
    try:
        yield
    finally:
        _state.keep = prev


def keeping_result() -> bool:
    """Inside ``keep``: the ``aten.alias`` there is what remat "dots" keeps
    (``row_parallel``'s scattered result, not its product; the banded
    schedule's output)."""
    return getattr(_state, "keep", False)


def replaying() -> bool:
    """Inside the backward pass's rerun of a remat "dots" unit."""
    return getattr(_state, "replay", False)


def rebuilding_graph() -> bool:
    """Inside ``_Local``'s backward pass, which runs its function again on
    the kept inputs only to make the graph that its gradients go through."""
    return getattr(_state, "graph_only", False)


def hand_to_rebuild(*tensors: torch.Tensor) -> None:
    """Inside a local region's run in a remat unit's rerun: ``tensors``
    handed to the region's graph rebuild, which the backward pass makes just
    after (``taken_from_rerun``) and which drops them; elsewhere nothing."""
    handed = getattr(_state, "to_rebuild", None)
    if handed is not None:
        handed.append(tensors)


def taken_from_rerun() -> Optional[tuple]:
    """Inside a local region's graph rebuild (``rebuilding_graph``): the
    next tensors that the region's run in the unit's rerun handed over
    (``hand_to_rebuild``), in the order it handed them; None where it
    handed none."""
    handed = getattr(_state, "from_rerun", None)
    return handed.pop(0) if handed else None


def keep(x: torch.Tensor) -> torch.Tensor:
    """x through ``aten.alias`` inside ``_keep_result``: a remat "dots"
    unit keeps it (``transformer._dots_policy``), and in the unit's rerun
    (``replaying``) ``keep`` of a tensor of its shape (``new_empty``) returns
    the kept one.  Elsewhere an alias of x."""
    with _keep_result():
        return torch.ops.aten.alias(x)


class _RowParallel(torch.autograd.Function):
    """h (B, S, K) @ w (K, d) with K split over mesh axis ``axis`` in both:
    each rank's product is a partial sum of the whole (B, S, d), which is
    reduce-scattered onto the sequence split over that axis (the residual
    stream's).  The product runs on (S, B) rows, so the collective's blocks
    are sequence blocks.  Backward all-gathers the output's gradient along
    the sequence and runs the two products locally.

    Under remat "dots" the unit keeps the scattered result, as GSPMD keeps
    the dot's output after its reduce-scatter: the result passes through
    ``aten.alias``, which the policy saves (``keep``), and in the
    backward pass's rerun of the unit (``replaying``) the product and its
    collective are skipped and the alias returns the kept tensor.  The
    product writes through ``out=`` (``aten.mm.out``), an overload no other
    operation of a unit uses, so skipping it shifts no other operation's
    place in the policy's record."""

    @staticmethod
    def forward(ctx, h, w, axis, out_plc, replay):
        from torch.distributed.tensor import DTensor

        mesh = h.device_mesh
        hl, wl = h._local_tensor, w._local_tensor
        b, s, k = hl.shape
        group = axis_group(mesh, axis)
        rows = s // group[1] * b
        if replay:
            out = keep(hl.new_empty((rows, wl.shape[1])))
        else:
            y = hl.new_empty((s * b, wl.shape[1]))
            torch.mm(hl.transpose(0, 1).reshape(s * b, k), wl, out=y)
            out = keep(scatter_rows(y, group))
        ctx.save_for_backward(hl, wl)
        ctx.group, ctx.mesh, ctx.out_plc = group, mesh, out_plc
        ctx.grad_plc = _grad_placements([h, w])
        local = out.view(s // group[1], b, -1).transpose(0, 1)
        return DTensor.from_local(local, mesh, out_plc, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        hl, wl = ctx.saved_tensors
        gl = g.redistribute(ctx.mesh, ctx.out_plc).to_local()
        b, sm, d = gl.shape
        gfull = gather_rows(gl.transpose(0, 1).reshape(sm * b, d), ctx.group)   # (S B, d)
        s = gfull.shape[0] // b
        dh = (gfull @ wl.T).view(s, b, -1).transpose(0, 1)
        dw = hl.transpose(0, 1).reshape(s * b, -1).T @ gfull
        dh_plc, dw_plc = ctx.grad_plc
        return (DTensor.from_local(dh, ctx.mesh, dh_plc, run_check=False),
                DTensor.from_local(dw, ctx.mesh, dw_plc, run_check=False), None, None, None)


class _SeqLocal(torch.autograd.Function):
    """h (B, S, K) @ w (K, N) with w whole on mesh axis ``axis`` and the
    output split over it along the sequence: each rank multiplies only its
    sequence block of h (h split there, or whole and cut), no collective.
    Backward is local; w's gradient is a partial sum over ``axis`` and the
    batch axes, and h's is placed on the sequence split (zero outside each
    rank's block)."""

    @staticmethod
    def forward(ctx, h, w, axis, out_plc):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = h.device_mesh
        names = list(mesh_shape(mesh))
        hl, wl = h._local_tensor, w._local_tensor
        if h.placements[names.index(axis)] != Shard(1):   # whole: this rank's block
            span = hl.shape[1] // mesh.size(names.index(axis))
            r = mesh.get_local_rank(axis)
            hl = hl[:, r * span:(r + 1) * span]
        b, s, k = hl.shape
        out = (hl.reshape(b * s, k) @ wl).view(b, s, -1)
        ctx.save_for_backward(hl, wl)
        ctx.mesh, ctx.out_plc = mesh, out_plc
        ctx.h_plc = [Shard(1) if n == axis else p for n, p in zip(names, h.placements)]
        ctx.w_plc = [Partial() if isinstance(hp, Shard) and wp == Replicate() else wp
                     for hp, wp in zip(ctx.h_plc, w.placements)]
        return DTensor.from_local(out, mesh, out_plc, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        hl, wl = ctx.saved_tensors
        gl = g.redistribute(ctx.mesh, ctx.out_plc).to_local()
        b, s, n = gl.shape
        g2 = gl.reshape(b * s, n)
        dh = (g2 @ wl.T).view(b, s, -1)
        dw = hl.reshape(b * s, -1).T @ g2
        return (DTensor.from_local(dh, ctx.mesh, ctx.h_plc, run_check=False),
                DTensor.from_local(dw, ctx.mesh, ctx.w_plc, run_check=False), None, None)


def seq_split_axis(x) -> Optional[str]:
    """On the sequence split under a mesh (``_training``), the one mesh
    axis, of more than one rank, that splits DTensor x (B, S, d) along its
    sequence as it splits the residual stream; None elsewhere (x whole
    there, or a plain tensor)."""
    from torch.distributed.tensor import Shard

    ctx = getattr(_state, "ctx", None)
    if not _training(ctx) or not is_dtensor(x) or x.ndim != 3:
        return None
    axis = _seq_axis(ctx[0], ctx[1], tuple(x.shape))
    if axis is None or x.placements[list(mesh_shape(ctx[0])).index(axis)] != Shard(1):
        return None
    return axis


def seq_matmul(x, w, axis: str):
    """x (B, S, K), split along its sequence over mesh axis ``axis``, @ w
    (K, N): w gathered whole over ``axis`` where it is split there, then
    each rank multiplies its own sequence block (``_SeqLocal``), the output
    split as x.  GSPMD's choice where the weight moves fewer bytes than
    the sequence would (RWKV6's products: 8 to 29 MB against 268 MB at
    train_4k); the gathered weight's gradient comes back reduce-scattered."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    plc = [Replicate() if n == axis else p for n, p in zip(mesh_shape(mesh), w.placements)]
    if plc != list(w.placements):
        w = w.redistribute(mesh, plc)
    return _SeqLocal.apply(x, w, axis, list(x.placements))


@torch.library.custom_op("repro_torch::shift_ranks", mutates_args=())
def shift_ranks(x: torch.Tensor, step: int, group_name: str) -> torch.Tensor:
    """Rank r's x sent to rank r + step of the process group named
    ``group_name``, one send and one receive a rank (the reference's
    collective-permute; gloo and NCCL carry them); a rank that nothing is
    sent to gets zeros.  A custom operation, so that a tracer sees it whole
    (``launch.step_trace`` counts it as a collective-permute)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = _resolve_process_group(group_name)
    rank, m = dist.get_rank(group), dist.get_world_size(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= rank + step < m:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, rank + step), group))
    if 0 <= rank - step < m:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, rank - step), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


@shift_ranks.register_fake
def _(x, step, group_name):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


class _ShiftTokens(torch.autograd.Function):
    """x (B, S, d), split along its sequence over mesh axis ``axis``,
    shifted one token later: the first token of each rank's block is the
    previous rank's last (one collective-permute of (B, d)), rank 0's is
    zeros.  Backward sends each block's first-row gradient back to the
    previous rank, where it adds to its last token's (the last rank gets
    zeros)."""

    @staticmethod
    def forward(ctx, x, axis):
        from torch.distributed.tensor import DTensor

        mesh, xl = x.device_mesh, x._local_tensor
        ctx.name, ctx.mesh, ctx.plc = axis_group(mesh, axis)[0], mesh, x.placements
        prev = shift_ranks(xl[:, -1], 1, ctx.name)
        return DTensor.from_local(torch.cat([prev[:, None], xl[:, :-1]], dim=1), mesh,
                                  x.placements, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        gl = g.redistribute(ctx.mesh, ctx.plc).to_local()
        nxt = shift_ranks(gl[:, 0], -1, ctx.name)
        dx = torch.cat([gl[:, 1:], nxt[:, None]], dim=1)
        return DTensor.from_local(dx, ctx.mesh, ctx.plc, run_check=False), None


def shift_tokens(x, axis: str):
    """x (B, S, d) split along its sequence over ``axis``, one token later
    with zeros first, each rank on its own block (``_ShiftTokens``)."""
    return _ShiftTokens.apply(x, axis)


def last_token(x, axis: str):
    """The last token (B, d) of x (B, S, d) split along its sequence over
    ``axis``: the last rank's, on every rank (an all-reduce of it and the
    other ranks' zeros), outside autograd."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    group = axis_group(mesh, axis)
    last = x._local_tensor[:, -1].detach()
    if mesh.get_local_rank(axis) != group[1] - 1:
        last = torch.zeros_like(last)
    plc = [Replicate() if n == axis else p for n, p in zip(mesh_shape(mesh), x.placements)]
    return DTensor.from_local(reduce_all(last, group), mesh, plc, run_check=False)


def _seq_axis(mesh, rules, dims) -> Optional[str]:
    """The one axis, of more than one rank, that splits the residual
    stream's sequence for an activation of ``dims`` (B, S, d)."""
    seq = entry_axes(act_spec(dims, RESIDUAL, mesh, rules)[1])
    return seq[0] if len(seq) == 1 and axes_size(mesh, seq) > 1 else None


def _product_plan(h, w, mesh, rules, out_dims):
    """("row", axis, placements) for ``_RowParallel``, ("seq", axis,
    placements) for ``_SeqLocal``, or None: the residual's sequence split
    over one axis A of more than one rank; h's rows split as the
    residual's (and on nothing else but A); w replicated but on A, where
    it is split on its rows (``_RowParallel``: h split on its last
    dimension there, its sequence whole) or whole (``_SeqLocal``: h's
    sequence split on A or whole)."""
    from torch.distributed.tensor import Replicate, Shard

    if h.ndim != 3 or w.ndim != 2:
        return None
    axis = _seq_axis(mesh, rules, out_dims)
    if axis is None:
        return None
    out_plc = placements(act_spec(out_dims, RESIDUAL, mesh, rules), mesh)
    names = list(mesh_shape(mesh))
    a = names.index(axis)
    for i, (hp, wp, op) in enumerate(zip(h.placements, w.placements, out_plc)):
        if i != a and (wp != Replicate() or hp != op):
            return None
    if w.placements[a] == Shard(0) and h.placements[a] == Shard(2):
        return "row", axis, out_plc
    if w.placements[a] == Replicate() and h.placements[a] in (Shard(1), Replicate()):
        return "seq", axis, out_plc
    return None


def _training(ctx) -> bool:
    """Whether the sequence-parallel products apply: under a ``DeviceMesh``
    with autograd recording (a train step), or inside ``split_sequence``
    (a sharded prefill's encoder).  Elsewhere (a decoder-only prefill,
    decode) the block's products take their sequence whole and its output
    is summed whole, as the reference's compiled prefill computes them."""
    return (ctx is not None and not isinstance(ctx[0], dict)
            and (torch.is_grad_enabled() or getattr(_state, "split_seq", False)))


def sequence_parallel() -> bool:
    """``_training`` under the active rules."""
    return _training(getattr(_state, "ctx", None))


@contextlib.contextmanager
def split_sequence():
    """Inside, the sequence-parallel products apply under a ``DeviceMesh``
    without autograd too (``_training``): ``encdec.encode`` and
    ``encode_prefill`` enter it, so that a sharded prefill encodes on the
    residual stream's sequence split, as the reference's GSPMD splits its
    encoder there (its residual constraint names "seq" in prefill too), and
    each decoder layer's cross K/V is projected on each rank's block."""
    prev = getattr(_state, "split_seq", False)
    _state.split_seq = True
    try:
        yield
    finally:
        _state.split_seq = prev


def row_parallel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for a block's output product (h (B, S, K) @ w (K, d), K the
    heads, the MLP's or a recurrence's width).  On the sequence split under
    a mesh (``_training``) the result is placed as the residual stream
    (``RESIDUAL``): where K is split over the axis that splits its
    sequence, the partial sums are reduce-scattered onto that split
    (``_RowParallel``); where K and w are whole on it, each rank multiplies
    its own sequence block (``_SeqLocal``); elsewhere DTensor's product is
    constrained to it (an all-reduce where "seq" is None, as the
    reference's non-sequence-parallel step sums).  Off the split it is
    summed with its sequence whole."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or not (is_dtensor(h) and is_dtensor(w)):
        return h @ w
    if not _training(ctx):
        return shard_act(h @ w, ("batch", "attn_seq", "embed_act"))
    plan = _product_plan(h, w, ctx[0], ctx[1], (h.shape[0], h.shape[1], w.shape[1]))
    if plan is None:
        return shard_act(h @ w, RESIDUAL)
    kind, axis, out_plc = plan
    if kind == "row":
        return _RowParallel.apply(h, w, axis, out_plc, replaying())
    return _SeqLocal.apply(h, w, axis, out_plc)


class BlockInput:
    """A block's input (B, S, d) under a mesh: the residual stream after its
    norm, its sequence split as the stream's.  ``x @ w`` for a product
    whose weight is whole on the sequence's axis runs on each rank's
    sequence block (``_SeqLocal``; GSPMD's choice for a dot whose operand
    is split and whose weight is not: TinyLlama's K and V, every
    projection of heads that do not divide "model"), its output split on
    the sequence; any other product takes the input with its sequence
    whole (``whole``, gathered once: the "attn_seq" rule), as DTensor's
    products fold (B, S) into rows, which they cannot do over a split
    sequence (torch 2.11)."""

    def __init__(self, x):
        self.x = x
        self._whole = None

    shape = property(lambda self: self.x.shape)
    dtype = property(lambda self: self.x.dtype)
    device = property(lambda self: self.x.device)

    def whole(self):
        if self._whole is None:
            self._whole = shard_act(self.x, ("batch", "attn_seq", "embed_act"))
        return self._whole

    def __matmul__(self, w):
        ctx = getattr(_state, "ctx", None)
        if ctx is not None and is_dtensor(w) and w.ndim == 2:
            plan = _product_plan(self.x, w, ctx[0], ctx[1], tuple(self.x.shape))
            if plan is not None and plan[0] == "seq":
                return _SeqLocal.apply(self.x, w, plan[1], plan[2])
        return self.whole() @ w


def block_input(x):
    """x itself outside a mesh (or off DTensors); on the sequence split
    under a mesh (``_training``) a ``BlockInput``; else x with its sequence
    whole."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x
    if not _training(ctx):
        return shard_act(x, ("batch", "attn_seq", "embed_act"))
    return BlockInput(x)


def whole_of(x):
    """A block input with its sequence whole: ``BlockInput.whole``, or x."""
    return x.whole() if isinstance(x, BlockInput) else x


@contextlib.contextmanager
def work_label(name: str):
    """Names the operations run inside for a tracer (``launch.step_trace``
    prefixes their FLOP keys with ``name``)."""
    prev = getattr(_state, "label", None)
    _state.label = name
    try:
        yield
    finally:
        _state.label = prev


def current_label() -> Optional[str]:
    return getattr(_state, "label", None)
