"""Mixture-of-Experts with sort-based dropping dispatch, on one card.

The port's counterpart of the reference's ``models/moe.py`` outside a mesh
(``moe_apply`` with no active mesh, which runs ``_moe_local`` on every
token).  The router runs in float32: softmax, ``top_k``, the gates
renormalised over the chosen experts, and the load-balance aux loss from the
first choice.  Each expert takes at most ``capacity = int(max(1, cf * t * k
/ E))`` of the ``t * k`` assignments: the assignments are sorted by expert
with a stable sort (``jnp.argsort`` is stable), so within an expert the
earlier token keeps its place and the later ones drop.  The kept tokens are
scattered into an (E, capacity, d) buffer, go through the experts' SwiGLU
(or GELU) MLP as batched matrix products, and are gathered back, weighted by
their gates, with a scatter-add over the tokens.

Under a ``DeviceMesh`` with a "model" axis of size m (``activation_rules``),
``moe_apply`` takes the reference's mesh branch, its ``shard_map`` written
over local shards: with ``E % m == 0`` each "model" rank holds E / m experts
(expert parallelism) and routes with ``expert_offset`` = its index x E / m;
otherwise every rank holds all experts with ``ff`` split over "model"
(tensor-parallel experts).  Tokens are split over the batch axes ("pod",
"data"), or replicated where the batch does not divide them.  One
all-reduce over "model" sums the partial outputs (the reference's ``psum``).
The aux loss is the reference's: each rank's over its own tokens, averaged
over "model", and the one of the first batch shard returned on every rank
(its ``out_specs=P()``), not the whole batch's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..act_sharding import (active_mesh, axes_size, batch_mesh_axes, is_dtensor, mesh_shape,
                            placements, run_local, spec_entry)
from .layers import ParamFactory, gelu, silu


def init_moe(pf: ParamFactory, d: int, ff: int, num_experts: int, act: str) -> dict:
    p = {
        "router": pf.normal((d, num_experts), ("embed", "experts"), stddev=0.02),
        "w_in": pf.normal((num_experts, d, ff), ("experts", "embed", "ff")),
        "w_out": pf.normal((num_experts, ff, d), ("experts", "ff", "embed")),
    }
    if act == "swiglu":
        p["w_gate"] = pf.normal((num_experts, d, ff), ("experts", "embed", "ff"))
    return p


class Routing(NamedTuple):
    """One call's dispatch over the ``t * k`` (token, choice) assignments,
    sorted by expert: ``expert``, ``token`` and ``gate`` of each, its place
    ``slot`` in its expert's buffer (0 where dropped) and ``keep``."""

    probs: torch.Tensor        # (t, E) float32 router probabilities
    expert_ids: torch.Tensor   # (t, k) chosen experts, best first
    expert: torch.Tensor       # (t * k,) sorted
    token: torch.Tensor
    gate: torch.Tensor         # float32 renormalised gate
    slot: torch.Tensor
    keep: torch.Tensor         # bool
    capacity: int


def _counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """How many of ``ids`` name each of the ``e`` experts (a scatter-add:
    ``bincount`` and ``one_hot`` read the ids back to the host on a card)."""
    return torch.zeros(e, dtype=ids.dtype, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def route(x: torch.Tensor, router: torch.Tensor, top_k: int,
          capacity_factor: float) -> Routing:
    """The reference's routing of tokens x (t, d) in float32 and its
    capacity-bounded, stable-sorted dispatch."""
    t = x.shape[0]
    e = router.shape[-1]
    tk = t * top_k
    logits = x.float() @ router.float()
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    capacity = int(max(1, capacity_factor * tk / e))

    flat_expert = expert_ids.reshape(tk)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(top_k)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    counts = _counts(se, e)
    run_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=x.device) - run_start[se]
    keep = pos < capacity
    return Routing(probs, expert_ids, se, flat_tok[order], gate_vals.reshape(tk)[order],
                   torch.where(keep, pos, 0), keep, capacity)


def aux_loss(r: Routing) -> torch.Tensor:
    """Load-balance loss ``E * sum(mean probs * share of first choices)``."""
    t, e = r.probs.shape
    me = r.probs.mean(dim=0)
    ce = _counts(r.expert_ids[:, 0], e).float() / t
    return e * (me * ce).sum()


def moe_local(x: torch.Tensor, router: torch.Tensor, w_in: torch.Tensor,
              w_gate: Optional[torch.Tensor], w_out: torch.Tensor, *, top_k: int,
              capacity_factor: float, act: str,
              expert_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-shape dropping dispatch of tokens x (t, d): (out (t, d), aux).
    ``w_in``, ``w_gate`` and ``w_out`` may hold a slice of the experts, from
    ``expert_offset`` on: assignments to the others add nothing."""
    t, d = x.shape
    e_loc = w_in.shape[0]
    r = route(x, router, top_k, capacity_factor)
    local_e = r.expert - expert_offset
    keep = r.keep & (local_e >= 0) & (local_e < e_loc)
    local_e = local_e.clamp(0, e_loc - 1)
    xtok = torch.where(keep[:, None], x[r.token], 0.0)
    buf = torch.zeros((e_loc, r.capacity, d), dtype=x.dtype, device=x.device)
    # dropped assignments add zeros at slot 0: the sum is the kept token's
    buf = buf.index_put((local_e, r.slot), xtok, accumulate=True)
    h = torch.bmm(buf, w_in)
    if act == "swiglu":
        h = silu(torch.bmm(buf, w_gate)) * h
    else:
        h = gelu(h)
    y = torch.bmm(h, w_out)
    vals = y[local_e, r.slot] * torch.where(keep, r.gate, 0.0)[:, None].to(y.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add(
        0, r.token, vals.to(x.dtype))
    return out, aux_loss(r)


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              act: str = "swiglu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(output (B, S, d), aux load-balance loss, a float32 scalar); under a
    mesh with a "model" axis, the mesh branch (module docstring)."""
    mesh = active_mesh()
    if mesh is not None and not isinstance(mesh, dict) and "model" in mesh_shape(mesh):
        return _moe_mesh(p, x, mesh, top_k=top_k, capacity_factor=capacity_factor, act=act)
    b, s, d = x.shape
    out, aux = moe_local(x.reshape(b * s, d), p["router"], p["w_in"], p.get("w_gate"),
                         p["w_out"], top_k=top_k, capacity_factor=capacity_factor, act=act)
    return out.reshape(b, s, d), aux


def _moe_mesh(p: dict, x, mesh, *, top_k: int, capacity_factor: float, act: str):
    """The reference's ``shard_map`` branch on the local shards of x and the
    weights (plain tensors, taken as replicated, or DTensors); returns what
    it was given: plain full tensors, or DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    sizes = mesh_shape(mesh)
    m = sizes["model"]
    b, s, d = x.shape
    e = p["w_in"].shape[0]
    baxes = batch_mesh_axes(mesh)
    if b % axes_size(mesh, baxes):
        baxes = ()  # decode with tiny batches: replicate tokens across DP
    ep = e % m == 0  # true expert parallelism vs tensor-parallel experts
    xspec = (spec_entry(baxes), None, None)
    wspec = ("model", None, None) if ep else (None, None, "model")
    wspec_out = ("model", None, None) if ep else (None, "model", None)

    def place(t, spec):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, placements((), mesh), run_check=False)
        return t.redistribute(mesh, placements(spec, mesh))

    specs = {"x": xspec, "router": (), "w_in": wspec, "w_out": wspec_out, "w_gate": wspec}
    keys = [k for k in specs if k == "x" or k in p]
    ep_offset = mesh.get_local_rank("model") * (e // m) if ep else 0

    def local(xl, router, w_in, w_out, w_gate=None):
        bl, sl, _ = xl.shape
        out, aux = moe_local(xl.reshape(bl * sl, d), router, w_in, w_gate, w_out, top_k=top_k,
                             capacity_factor=capacity_factor, act=act, expert_offset=ep_offset)
        # aux: equal on every "model" rank (the reference's pmean), its
        # gradient 1 / m there (pmean's), as the router's sums over "model"
        return out.reshape(bl, sl, d), (aux.detach() + (aux - aux.detach()) / m)[None]

    names = list(sizes)
    # the psum over "model": partial outputs, summed into the tokens' split;
    # aux: one value a batch shard
    part = [Partial() if n == "model" else Shard(0) if n in baxes else Replicate()
            for n in names]
    per = [Shard(0) if n in baxes else Replicate() for n in names]
    out, aux = run_local(local, [place(x if k == "x" else p[k], specs[k]) for k in keys],
                         [part, per])
    out = out.redistribute(mesh, placements(xspec, mesh))
    aux = aux.full_tensor()[0]  # the first batch shard's, on every rank
    if is_dtensor(x):
        return out, DTensor.from_local(aux, mesh, placements((), mesh), run_check=False)
    return out.full_tensor(), aux


def drop_share(p: dict, x: torch.Tensor, top_k: int, capacity_factor: float) -> float:
    """The share of (token, choice) assignments of x (B, S, d) that the
    capacity drops."""
    r = route(x.reshape(-1, x.shape[-1]), p["router"], top_k, capacity_factor)
    return float((~r.keep).float().mean())
