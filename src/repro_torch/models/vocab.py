"""The vocabulary-parallel embedding lookup and loss head under a mesh.

The reference's GSPMD step keeps the output table split over "model"
(``vocab_act``) and never makes it whole.  Here each runs as one
``autograd.Function`` on local shards, with explicit collectives
(``act_sharding.gather_rows``, ``scatter_rows``, ``reduce_all``):

* ``vocab_lookup``: each rank looks up the tokens that fall in its
  vocabulary shard and writes zeros for the others; the sum over the
  vocabulary's axis is left to the caller as a DTensor partial (the
  residual stream's constraint reduce-scatters it onto the sequence split,
  or all-reduces it where "seq" is None).  Backward adds each token's
  gradient into the rank's own shard only.
* ``vocab_ce_sum``: the masked sum of the reference's per-token loss (the
  1e-4 z-loss included) in chunks of ``transformer.LOSS_CHUNK`` tokens.
  Each rank multiplies the chunk's rows by its ``V / m`` columns; the row
  max, the sum of exponentials and the target's logit are combined over
  the vocabulary's axis as (rows, chunk) float32 values, never as logits.
  Backward makes each chunk's logits again (the reference's checkpointed
  chunk), and is local but for the sum of the gradient into x.  Where the
  residual stream's sequence is split over the same axis, chunk j gathers
  each rank's j-th ``c / m`` positions (an all-gather, whose backward pass
  is a reduce-scatter); a sequence whole on every rank is cut into
  contiguous chunks and its gradient all-reduced.

``plan_lookup`` and ``plan_ce`` say whether a tensor layout takes these
paths (a split of more than one rank, placed as the functions need); the
callers in ``transformer`` and ``encdec`` keep their plain code otherwise,
so a one-card run, or a 1 x 1 mesh, is unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..act_sharding import (_grad_placements, act_spec, axes_size, axis_group, current_rules,
                            gather_rows, is_dtensor, mesh_shape, reduce_all, rows_split_only,
                            scatter_rows, work_label)

# The reference's z-loss weight (``layers.token_losses``).
Z_LOSS = 1e-4


def _vocab_axis(table, dim: int) -> Optional[str]:
    """The one mesh axis, of more than one rank, that splits ``table``'s
    vocabulary dimension ``dim``, where nothing else splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(table.device_mesh))
    axes = [names[i] for i, p in enumerate(table.placements) if p == Shard(dim)]
    rest = [p for i, p in enumerate(table.placements) if names[i] not in axes]
    if len(axes) != 1 or axes_size(table.device_mesh, axes) == 1 or any(
            p != Replicate() for p in rest):
        return None
    return axes[0]


def plan_lookup(table, tokens) -> Optional[str]:
    """The vocabulary axis of a lookup of ``tokens`` (B, S) in ``table`` (V,
    d, its FSDP split undone), or None where ``vocab_lookup`` does not
    apply."""
    if current_rules() is None or not (is_dtensor(table) and is_dtensor(tokens)):
        return None
    axis = _vocab_axis(table, 0)
    return axis if axis is not None and rows_split_only(tokens, axis) else None


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, table, axis):
        from torch.distributed.tensor import DTensor, Partial

        mesh = table.device_mesh
        wl = table._local_tensor
        n = wl.shape[0]
        idx = tokens._local_tensor.long() - n * mesh.get_local_rank(axis)
        inside = (idx >= 0) & (idx < n)
        out = wl[idx.clamp(0, n - 1)]
        out.masked_fill_(~inside[..., None], 0)
        names = list(mesh_shape(mesh))
        ctx.out_plc = [Partial() if names[i] == axis else p for i, p in enumerate(tokens.placements)]
        ctx.mesh, ctx.n, ctx.grad_plc = mesh, n, _grad_placements([tokens, table])[1]
        ctx.save_for_backward(torch.where(inside, idx, n))  # n: the row past the shard
        return DTensor.from_local(out, mesh, ctx.out_plc, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        (idx,) = ctx.saved_tensors
        # a partial output's gradient is whole on every rank
        gl = g.redistribute(ctx.mesh, [Replicate() if isinstance(p, Partial) else p
                                       for p in ctx.out_plc]).to_local()
        d = gl.shape[-1]
        grad = gl.new_zeros((ctx.n + 1, d))
        grad.index_add_(0, idx.reshape(-1), gl.reshape(-1, d))
        return None, DTensor.from_local(grad[:ctx.n], ctx.mesh, ctx.grad_plc, run_check=False), None


def vocab_lookup(table, tokens, axis: str):
    """Rows of ``table`` (V, d; vocabulary split over ``axis``) at ``tokens``
    (B, S), as a DTensor partial over ``axis`` (``plan_lookup``)."""
    return _Lookup.apply(tokens, table, axis)


def plan_ce(table, x, targets, mask, tied: bool, chunk: int):
    """(vocabulary axis, chunk positions per rank, gathered) for
    ``vocab_ce_sum`` of x (B, S, d) against ``table`` (its FSDP split
    undone), or None where it does not apply: the table's vocabulary split
    over the one axis that the "vocab_act" rule gives the chunk's logits,
    of more than one rank; x, targets and mask split on their rows alike,
    x's sequence whole or split over that axis (then ``chunk`` divides over
    its ranks)."""
    ctx = current_rules()
    if ctx is None or not all(is_dtensor(t) for t in (table, x, targets, mask)):
        return None
    mesh, rules = ctx
    axis = _vocab_axis(table, 0 if tied else 1)
    if axis is None:
        return None
    b, s, _ = x.shape
    logits = act_spec((b, chunk, table.shape[0 if tied else 1]), ("batch", None, "vocab_act"),
                      mesh, rules)
    if logits[2] != axis or not (rows_split_only(targets, axis) and rows_split_only(mask, axis)):
        return None
    if targets.placements != mask.placements:
        return None
    from torch.distributed.tensor import Shard

    names = list(mesh_shape(mesh))
    gathered = False
    for i, (xp, tp) in enumerate(zip(x.placements, targets.placements)):
        if names[i] == axis and xp == Shard(1):
            gathered = True
        elif xp != tp:
            return None
    m = axes_size(mesh, (axis,))
    if gathered and chunk % m:
        return None
    return axis, chunk // m if gathered else chunk, gathered


def _chunk_rows(tl, ml, j: int, per: int, gathered: bool, span: int, m: int):
    """Chunk j's targets and mask as rows in the order its x rows take:
    gathered, (position, row) over each rank's j-th ``per`` positions in
    rank order (``span`` positions a rank); else (row, position) over
    positions ``j per`` to ``(j + 1) per``."""
    if not gathered:
        cols = slice(j * per, (j + 1) * per)
        return tl[:, cols].reshape(-1), ml[:, cols].reshape(-1)
    pos = (torch.arange(m, device=tl.device)[:, None] * span + j * per
           + torch.arange(per, device=tl.device)[None, :]).reshape(-1)
    return tl[:, pos].T.reshape(-1), ml[:, pos].T.reshape(-1)


def _chunk_x(xl, j: int, per: int, gathered: bool, group) -> torch.Tensor:
    """Chunk j's x as rows (see ``_chunk_rows``)."""
    piece = xl[:, j * per:(j + 1) * per]
    if not gathered:
        return piece.reshape(-1, xl.shape[-1])
    return gather_rows(piece.transpose(0, 1).reshape(-1, xl.shape[-1]), group)


def _logits(xr, w, tied: bool) -> torch.Tensor:
    """Rows (n, d) against the local table in their compute dtype, then in
    float32, as the plain loss head casts them."""
    wc = w.to(xr.dtype)
    return (xr @ (wc.T if tied else wc)).float()


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, targets, mask, axis, per, gathered, tied, keep_logits):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = table.device_mesh
        group = axis_group(mesh, axis)
        m = group[1]
        xl, wl = x._local_tensor, table._local_tensor
        tl, ml = targets._local_tensor.long(), mask._local_tensor
        n = wl.shape[0 if tied else 1]
        lo = n * mesh.get_local_rank(axis)
        span = xl.shape[1]
        chunks = span // per
        total = torch.zeros((), dtype=torch.float32, device=xl.device)
        logz, kept = [], []
        with work_label("loss_head"):
            for j in range(chunks):
                logits = _logits(_chunk_x(xl, j, per, gathered, group), wl, tied)
                t, mk = _chunk_rows(tl, ml, j, per, gathered, span, m)
                idx = t - lo
                inside = (idx >= 0) & (idx < n)
                top = reduce_all(logits.amax(dim=-1), group, "max")
                picked = logits.gather(1, idx.clamp(0, n - 1)[:, None])[:, 0] * inside
                local = torch.stack([torch.exp(logits - top[:, None]).sum(dim=-1), picked])
                sums = reduce_all(local, group)
                lz = top + torch.log(sums[0])
                total = total + ((-(sums[1] - lz) + Z_LOSS * lz.square()) * mk).sum()
                logz.append(lz)
                if keep_logits:
                    kept.append(logits)
        ctx.save_for_backward(xl, wl, tl, ml, torch.stack(logz), *kept)
        ctx.args = (mesh, group, per, gathered, tied, keep_logits, lo, n)
        ctx.plc = (x.placements, _grad_placements([x, table])[1])
        out_plc = [Partial() if isinstance(p, Shard) else Replicate() for p in targets.placements]
        return DTensor.from_local(total, mesh, out_plc, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate

        mesh, group, per, gathered, tied, keep_logits, lo, n = ctx.args
        xl, wl, tl, ml, logz, *kept = ctx.saved_tensors
        # the sum's gradient is whole on every rank
        gl = g.redistribute(mesh, [Replicate()] * len(g.placements)).to_local()
        m, span = group[1], xl.shape[1]
        dx = torch.zeros_like(xl)
        dw = torch.zeros_like(wl, dtype=torch.float32)
        with work_label("loss_head"):
            for j in range(span // per):
                xr = _chunk_x(xl, j, per, gathered, group)
                logits = kept[j] if keep_logits else _logits(xr, wl, tied)
                t, mk = _chunk_rows(tl, ml, j, per, gathered, span, m)
                idx = t - lo
                inside = (idx >= 0) & (idx < n)
                lz = logz[j]
                coef = mk * gl
                dl = torch.exp(logits - lz[:, None]).mul_((coef * (1 + 2 * Z_LOSS * lz))[:, None])
                dl.scatter_add_(1, idx.clamp(0, n - 1)[:, None], (-coef * inside)[:, None])
                dl = dl.to(xr.dtype)
                wc = wl.to(xr.dtype)
                dxr = dl @ (wc if tied else wc.T)                  # a partial sum over the axis
                dw += (dl.T @ xr if tied else xr.T @ dl).float()
                if gathered:
                    dx[:, j * per:(j + 1) * per] = scatter_rows(dxr, group).view(
                        per, -1, xl.shape[-1]).transpose(0, 1)
                else:
                    dx[:, j * per:(j + 1) * per] = reduce_all(dxr, group).view(
                        xl.shape[0], per, -1)
        x_plc, w_plc = ctx.plc
        return (DTensor.from_local(dx, mesh, x_plc, run_check=False),
                DTensor.from_local(dw.to(wl.dtype), mesh, w_plc, run_check=False),
                None, None, None, None, None, None, None)


def vocab_ce_sum(table, x, targets, mask, plan: Tuple[str, int, bool], tied: bool,
                 keep_logits: bool = False):
    """The masked sum over the tokens of x (B, S, d) of the reference's loss
    against ``table`` (its FSDP split undone; (V, d) when ``tied``, else
    (d, V)) as a DTensor scalar, partial over the batch axes
    (``plan_ce``'s plan).  ``keep_logits``: backward takes each chunk's
    logits as the forward pass made them, instead of making them again."""
    axis, per, gathered = plan
    return _CrossEntropy.apply(x, table, targets, mask, axis, per, gathered, tied, keep_logits)
