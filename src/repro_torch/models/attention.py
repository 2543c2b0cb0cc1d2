"""GQA attention: the training/prefill path and decoding against a dense KV
cache.

The port's counterpart of the reference's ``models/attention.py`` for full
causal attention (``window=0``).  Weight layouts are the
reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KVH, hd), ``wo`` (H, hd, d).
The attention itself stays plain matrix products, as the reference computes
it (einsums) outside any Pallas kernel; ``kernels.paged_attention`` is the
paged kernel.

The cache holds every layer: k and v of shape (layers, B, slots, KVH, hd).
``attention_decode`` writes the new token's K/V into its layer's slot in
place (the reference returns a new cache), which saves a copy of the cache
per layer and step.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .layers import ParamFactory, apply_rope, rotate

NEG_INF = -1e30
# The reference's flash schedule walks the keys in chunks of this many and
# asserts that a longer sequence is a multiple of it; the port refuses what
# the reference refuses.
KV_CHUNK = 512


def init_attention(pf: ParamFactory, d: int, heads: int, kv_heads: int, head_dim: int) -> dict:
    return {
        "wq": pf.normal((d, heads, head_dim)),
        "wk": pf.normal((d, kv_heads, head_dim)),
        "wv": pf.normal((d, kv_heads, head_dim)),
        "wo": pf.normal((heads, head_dim, d)),
    }


def attention_train(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                    rope_theta: float = 10_000.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over a whole sequence x (B, S, d) at positions
    (B, S): the reference's ``attention_train`` with ``window=0``.

    The reference computes it in ``_flash_attend``, an online softmax over
    512-key chunks in float32: q scaled in float32, logits and the
    accumulator in float32, the output cast to q's dtype.  Here the same
    float32 arithmetic runs as plain products over the whole S x S (equal to
    the flash schedule's single chunk for S <= 512, within float32 rounding
    beyond), the query heads of a KV head grouped against it as in
    ``attention_decode``.  So its memory grows with S^2: the float32 logits
    and probabilities are (B, H, S, S) each, and autograd keeps them for the
    backward pass, which is small at the launcher's 256 tokens (a chunked
    schedule for long sequences is ROADMAP.md's).  Lengths the reference's
    schedule rejects (over 512 and not a multiple of it) raise
    ``ValueError``.  Returns the output (B, S, d) and the rotated k and v
    (B, S, KVH, hd), which prefill stores in its cache."""
    b, s, d = x.shape
    heads, hd = p["wq"].shape[1], p["wq"].shape[2]
    kv_heads = p["wk"].shape[1]
    groups = heads // kv_heads
    if s > KV_CHUNK and s % KV_CHUNK:
        raise ValueError(f"sequence length {s} is not a multiple of {KV_CHUNK} "
                         f"(the reference's flash attention asserts it)")
    q = apply_rope((x @ p["wq"].reshape(d, heads * hd)).view(b, s, heads, hd), positions,
                   rope_theta)
    k = apply_rope((x @ p["wk"].reshape(d, kv_heads * hd)).view(b, s, kv_heads, hd), positions,
                   rope_theta)
    v = (x @ p["wv"].reshape(d, kv_heads * hd)).view(b, s, kv_heads, hd)
    qf = (q.float() * hd ** -0.5).view(b, s, kv_heads, groups, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 3, 1).unsqueeze(2)            # (B, KVH, 1, hd, S)
    vf = v.float().transpose(1, 2).unsqueeze(2)                # (B, KVH, 1, S, hd)
    logits = qf @ kf                                           # (B, KVH, G, S, S)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    logits = torch.where(causal, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (probs @ vf) / probs.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, heads * hd).to(q.dtype)
    return out @ p["wo"].reshape(heads * hd, d), k, v


class KVCache(NamedTuple):
    """Dense KV cache of every layer, ``k`` and ``v`` of (layers, B, slots,
    KVH, hd); the server's pages are slices of it, (layers, page, KVH, hd)."""

    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(batch: int, slots: int, kv_heads: int, head_dim: int, dtype, layers: int,
                  device=None) -> KVCache:
    """Zeroed cache for ``layers`` layers on a leading axis:
    (layers, batch, slots, kv_heads, head_dim) each for K and V."""
    shape = (layers, batch, slots, kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, rope: Tuple[torch.Tensor, torch.Tensor],
                     valid: torch.Tensor) -> torch.Tensor:
    """One token x (B, 1, d) at position ``pos`` against one layer's cache
    (B, slots, KVH, hd), which takes the token's K/V in place; returns the
    attention block's output (B, 1, d).

    ``rope`` is ``layers.rope_angles`` at ``pos`` and ``valid`` the (slots,)
    mask of the slots at or before ``pos``, both made once per step by the
    caller.  The reference's einsums run as matrix products, the query
    heads of a KV head grouped against it instead of repeating K and V.
    """
    b, _, d = x.shape
    heads, hd = p["wq"].shape[1], p["wq"].shape[2]
    slots, kv_heads = cache_k.shape[1], cache_k.shape[2]
    groups = heads // kv_heads
    q = rotate((x @ p["wq"].reshape(d, heads * hd)).view(b, 1, heads, hd), *rope)
    k_new = rotate((x @ p["wk"].reshape(d, kv_heads * hd)).view(b, 1, kv_heads, hd), *rope)
    v_new = (x @ p["wv"].reshape(d, kv_heads * hd)).view(b, 1, kv_heads, hd)
    slot = pos % slots
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]

    qg = q.view(b, kv_heads, groups, hd)                      # (B, KVH, G, hd)
    logits = (qg @ cache_k.permute(0, 2, 3, 1)) * hd ** -0.5  # (B, KVH, G, slots)
    logits = torch.where(valid, logits, NEG_INF)
    attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = attn @ cache_v.transpose(1, 2)                      # (B, KVH, G, hd)
    return out.reshape(b, 1, heads * hd) @ p["wo"].reshape(heads * hd, d)
