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

The mesh branch (``shard_map`` over the experts, one ``psum``) comes with
sharding (ROADMAP.md, queue 1, item 6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .layers import ParamFactory, gelu, silu


def init_moe(pf: ParamFactory, d: int, ff: int, num_experts: int, act: str) -> dict:
    p = {
        "router": pf.normal((d, num_experts), stddev=0.02),
        "w_in": pf.normal((num_experts, d, ff)),
        "w_out": pf.normal((num_experts, ff, d)),
    }
    if act == "swiglu":
        p["w_gate"] = pf.normal((num_experts, d, ff))
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
              capacity_factor: float, act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-shape dropping dispatch of tokens x (t, d): (out (t, d), aux)."""
    t, d = x.shape
    e = w_in.shape[0]
    r = route(x, router, top_k, capacity_factor)
    xtok = torch.where(r.keep[:, None], x[r.token], 0.0)
    buf = torch.zeros((e, r.capacity, d), dtype=x.dtype, device=x.device)
    # dropped assignments add zeros at slot 0: the sum is the kept token's
    buf = buf.index_put((r.expert, r.slot), xtok, accumulate=True)
    h = torch.bmm(buf, w_in)
    if act == "swiglu":
        h = silu(torch.bmm(buf, w_gate)) * h
    else:
        h = gelu(h)
    y = torch.bmm(h, w_out)
    vals = y[r.expert, r.slot] * torch.where(r.keep, r.gate, 0.0)[:, None].to(y.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add(
        0, r.token, vals.to(x.dtype))
    return out, aux_loss(r)


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              act: str = "swiglu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(output (B, S, d), aux load-balance loss, a float32 scalar)."""
    b, s, d = x.shape
    out, aux = moe_local(x.reshape(b * s, d), p["router"], p["w_in"], p.get("w_gate"),
                         p["w_out"], top_k=top_k, capacity_factor=capacity_factor, act=act)
    return out.reshape(b, s, d), aux


def drop_share(p: dict, x: torch.Tensor, top_k: int, capacity_factor: float) -> float:
    """The share of (token, choice) assignments of x (B, S, d) that the
    capacity drops."""
    r = route(x.reshape(-1, x.shape[-1]), p["router"], top_k, capacity_factor)
    return float((~r.keep).float().mean())
