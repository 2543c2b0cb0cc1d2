"""Int8 gradient compression with error feedback for the data-parallel mean.

The port's counterpart of the reference's ``train/compression.py``, over a
``torch.distributed`` process group in place of a ``shard_map`` axis.
``compressed_psum_mean`` replaces a float32 all-reduce with:

  1. per-chunk symmetric int8 quantisation (256 values a chunk, scale =
     max|g| / 127 + 1e-12, rounded half to even, clipped to +-127),
  2. a reduce-scatter as an ``all_to_all`` of the int8 shards and their
     float32 scales, then a local float32 sum,
  3. requantisation of the reduced shard and an ``all_gather`` of it,
  4. dequantisation and division by the group's size,

in the reference's order of operations, so every rank's result equals an
oracle built from the reference's ``_quantize`` bit for bit (the local sum
adds the ranks' shards in rank order).  ``ErrorFeedback`` keeps each
quantisation's residual and adds it back at the next step (EF-SGD).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..pytree import tree_map

CHUNK = 256


def _quantize(x: torch.Tensor, chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 (chunks, chunk), float32 scales (chunks, 1)) of x, flattened and
    zero-padded to whole chunks."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % chunk))
    blocks = flat.reshape(-1, chunk)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def int8_payload_bytes(numel: int, n: int) -> int:
    """Bytes of int8 that one rank hands ``compressed_psum_mean``'s two
    collectives for ``numel`` values over ``n`` ranks (the scales, 4 bytes
    per 256 values, not counted); of these, a share of ``(n - 1) / n``
    leaves the rank."""
    padded = numel + (-numel) % (n * CHUNK)
    return padded + padded // n


def compressed_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (default: the whole
    world) with an int8 payload; every rank calls it with its own ``x`` of
    one shape and gets the same float32 mean."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    shape, size = x.shape, x.numel()
    flat = F.pad(x.float().reshape(-1), (0, (-size) % (n * CHUNK)))

    q, scale = _quantize(flat)                       # quantize the whole payload
    q = q.reshape(n, -1, CHUNK)                      # shard i goes to rank i
    scale = scale.reshape(n, -1, 1)

    # reduce-scatter: all_to_all the per-destination shards, sum locally
    q_t = torch.empty_like(q)
    s_t = torch.empty_like(scale)
    dist.all_to_all_single(q_t, q, group=group)
    dist.all_to_all_single(s_t, scale, group=group)
    local = q_t[0].float() * s_t[0]
    for j in range(1, n):
        local = local + q_t[j].float() * s_t[j]      # (chunks, 256)

    # quantize the reduced shard and all_gather it (int8 again)
    q2, s2 = _quantize(local)
    qg = [torch.empty_like(q2) for _ in range(n)]
    sg = [torch.empty_like(s2) for _ in range(n)]
    dist.all_gather(qg, q2, group=group)
    dist.all_gather(sg, s2, group=group)
    full = (torch.stack(qg).float() * torch.stack(sg)).reshape(-1)
    return full[:size].reshape(shape) / n


class ErrorFeedback:
    """Residual accumulator: g_eff = g + e;  e' = g_eff - Q(g_eff)."""

    @staticmethod
    def init(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                        grads)

    @staticmethod
    def apply(grads: Any, err: Any) -> Tuple[Any, Any]:
        """(the dequantised corrected gradients, the new residuals)."""
        def one(g, e):
            c = g.float() + e
            q, s = _quantize(c)
            deq = _dequantize(q, s, c.shape, c.numel())
            return deq, c - deq

        pairs = tree_map(one, grads, err)
        return _split(pairs, grads, 0), _split(pairs, grads, 1)


def _split(pairs: Any, like: Any, i: int) -> Any:
    """The ``i``-th element of each (deq, residual) pair, in ``like``'s
    structure."""
    return tree_map(lambda _, p: p[i], like, pairs)
