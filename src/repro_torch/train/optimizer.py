"""AdamW with configurable moment dtypes: the port's counterpart of the
reference's ``train/optimizer.py``, over trees of tensors (``pytree``).

The arithmetic is the reference's, in float32: the global gradient-norm clip,
bias corrections ``1 - b**step``, the warmup + cosine (or constant) schedule,
and decoupled weight decay on every leaf with two or more dimensions.  The
model keeps its layers stacked on a leading axis, as the reference does for
its scan, so the per-layer norm scales (layers, d) decay and ``final_ln`` (d,)
does not, in both packages.  Moments are stored in ``moment_dtype``; the
step count is a 0-d int32 tensor on the host.

Parameters may be DTensors (a sharded train step): the moments take each
parameter's placements, the gradient norm sums every shard, and
``update_in_place`` works on each rank's local shards, the gradient first
placed as its parameter is (the data-parallel reduce-scatter).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from ..act_sharding import is_dtensor
from ..pytree import leaves, tree_map, unflatten_like


# ``AdamW.update_in_place`` works through a leaf in pieces of this many
# elements (64 Mi: 256 MB of float32 a temporary).
IN_PLACE_PIECE = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32, on the host
    mu: Any                 # first moment (param-tree shaped)
    nu: Any                 # second moment


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"       # float32 | bfloat16
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"            # cosine | constant

    # -- schedule ---------------------------------------------------------------
    def lr_at(self, step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        if self.schedule == "constant":
            return self.learning_rate * warm
        t = torch.clamp((step - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return self.learning_rate * warm * (0.1 + 0.9 * cos)

    # -- state -------------------------------------------------------------------
    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.moment_dtype)
        zeros = lambda p: (torch.zeros_like(p, dtype=dt) if is_dtensor(p)
                           else torch.zeros(p.shape, dtype=dt, device=p.device))
        return AdamWState(torch.zeros((), dtype=torch.int32), tree_map(zeros, params),
                          tree_map(zeros, params))

    # -- update ------------------------------------------------------------------
    def _consts(self, grads, state: AdamWState):
        """(step, clip scale, bias corrections, lr) of the next update."""
        step = state.step + 1
        gnorm = torch.stack([_square_sum(g) for g in leaves(grads)]).sum().sqrt()
        scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        return (step, scale, 1.0 - self.b1 ** step.float(), 1.0 - self.b2 ** step.float(),
                self.lr_at(step))

    def _leaf(self, g, m, v, p, consts, decay: bool):
        """One leaf's (update in p's dtype, new moments in the moment dtype)."""
        _, scale, bc1, bc2, lr = consts
        b1, b2 = self.b1, self.b2
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g.square()
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
        if decay:  # decoupled weight decay on matrices only
            delta = delta + self.weight_decay * p.float()
        mdt = getattr(torch, self.moment_dtype)
        return (-lr * delta).to(p.dtype), m32.to(mdt), v32.to(mdt)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params) -> Tuple[Any, AdamWState]:
        consts = self._consts(grads, state)
        out = [self._leaf(*x, consts, x[3].ndim >= 2)
               for x in zip(leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params))]
        updates, mu, nu = (unflatten_like(params, [o[i] for o in out]) for i in range(3))
        return updates, AdamWState(consts[0], mu, nu)

    @torch.no_grad()
    def update_in_place(self, grads, state: AdamWState, params) -> AdamWState:
        """``update`` then ``apply_updates``, element for element the same,
        with the moments and the parameters written in place, a leaf at a
        time in pieces of ``IN_PLACE_PIECE`` elements: no second copy of the
        moments and no update tree, so a step holds weights, gradients and
        moments once (plus one piece's float32 temporaries).  Returns the
        state (its moment tensors are ``state``'s)."""
        consts = self._consts(grads, state)
        for g, m, v, p in zip(leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params)):
            decay = p.ndim >= 2
            if is_dtensor(p):
                g = g.redistribute(p.device_mesh, p.placements).to_local()
                m, v, p = (t.to_local() for t in (m, v, p))
            pieces = [t.view(-1).split(IN_PLACE_PIECE) for t in (m, v, p)]
            for gs, ms, vs, ps in zip(g.reshape(-1).split(IN_PLACE_PIECE), *pieces):
                u, m_new, v_new = self._leaf(gs, ms, vs, ps, consts, decay)
                ms.copy_(m_new)
                vs.copy_(v_new)
                ps.add_(u)
        return AdamWState(consts[0], state.mu, state.nu)


def _square_sum(g) -> torch.Tensor:
    """sum(g^2) in float32; a DTensor's over all its shards."""
    out = g.float().square().sum()
    return out.full_tensor() if is_dtensor(out) else out


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` in place, so parameters that autograd tracks stay leaves;
    returns ``params`` (the reference returns new ones)."""
    for p, u in zip(leaves(params), leaves(updates)):
        p.add_(u.to(p.dtype))
    return params
