"""GQA attention: the training/prefill path (full, sliding-window, local and
cross attention) and decoding against a dense or ring-buffer KV cache.

The port's counterpart of the reference's ``models/attention.py``.  Weight
layouts are the reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KVH, hd),
``wo`` (H, hd, d).  The attention itself stays plain matrix products, as the
reference computes it (einsums) outside any Pallas kernel;
``kernels.paged_attention`` is the paged kernel.

A sliding-window or local layer keeps only ``min(window, slots)`` cache
slots and uses them as a ring: position ``pos`` goes to slot ``pos %
slots``.  ``attention_decode`` writes the new token's K/V into its layer's
cache in place (the reference returns a new cache), which saves a copy of
the cache per layer and step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

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


def _banded(s: int, window: int) -> bool:
    """Whether the reference takes its banded schedule (``_banded_attend``)
    for a sequence of ``s`` tokens: it computes the same function as the
    masked full form, which the port runs instead, and checks no length."""
    return (window > 0 and s > window and s % min(window, KV_CHUNK, s) == 0
            and window % min(window, KV_CHUNK) == 0)


def project_kv(p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unrotated K and V (B, S, KVH, hd) of x (B, S, d): a cross-attention
    layer's memory."""
    b, s, d = x.shape
    kv_heads, hd = p["wk"].shape[1], p["wk"].shape[2]
    k = (x @ p["wk"].reshape(d, kv_heads * hd)).view(b, s, kv_heads, hd)
    v = (x @ p["wv"].reshape(d, kv_heads * hd)).view(b, s, kv_heads, hd)
    return k, v


def attention_train(p: dict, x: torch.Tensor, positions: Optional[torch.Tensor], *,
                    causal: bool = True, window: int = 0, rope_theta: float = 10_000.0,
                    mrope_sections: Sequence[int] = (), use_rope: bool = True,
                    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention over a whole sequence x (B, S, d) at positions (B, S) (or
    (3, B, S) with ``mrope_sections``): the reference's ``attention_train``.

    ``window > 0`` keeps, for each query, the keys less than ``window``
    positions behind it (sliding-window and local attention).
    ``kv_override`` (k, v), each (B, Sk, KVH, hd), is cross-attention: the
    queries attend every key, with no rotation and no mask.

    The reference computes it in ``_flash_attend``, an online softmax over
    512-key chunks in float32 (or, for a window shorter than S, a banded
    chunk schedule, the same function): q scaled in float32, logits and the
    accumulator in float32, the output cast to q's dtype.  Here the same
    float32 arithmetic runs as plain products over the whole Sq x Sk, masked
    (equal to the flash schedule's single chunk for Sk <= 512, within
    float32 rounding beyond), the query heads of a KV head grouped against
    it as in ``attention_decode``.  So its memory grows with Sq x Sk: the
    float32 logits and probabilities are (B, H, Sq, Sk) each, and autograd
    keeps them for the backward pass, which is small at the launcher's 256
    tokens (a chunked schedule for long sequences is ROADMAP.md's).  Lengths
    the reference's flash schedule rejects (over 512 and not a multiple of
    it) raise ``ValueError``.  Returns the output (B, S, d) and the K and V
    attended (B, Sk, KVH, hd; rotated, for self-attention), which prefill
    stores in its cache."""
    b, s, d = x.shape
    heads, hd = p["wq"].shape[1], p["wq"].shape[2]
    q = (x @ p["wq"].reshape(d, heads * hd)).view(b, s, heads, hd)
    if kv_override is None:
        k, v = project_kv(p, x)
        if use_rope:
            q = apply_rope(q, positions, rope_theta, mrope_sections)
            k = apply_rope(k, positions, rope_theta, mrope_sections)
    else:
        k, v = kv_override
        causal, window = False, 0
    sk, kv_heads = k.shape[1], k.shape[2]
    if not _banded(s, window) and sk > KV_CHUNK and sk % KV_CHUNK:
        raise ValueError(f"sequence length {sk} is not a multiple of {KV_CHUNK} "
                         f"(the reference's flash attention asserts it)")
    groups = heads // kv_heads
    qf = (q.float() * hd ** -0.5).view(b, s, kv_heads, groups, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 3, 1).unsqueeze(2)            # (B, KVH, 1, hd, Sk)
    vf = v.float().transpose(1, 2).unsqueeze(2)                # (B, KVH, 1, Sk, hd)
    logits = qf @ kf                                           # (B, KVH, G, S, Sk)
    if causal or window:
        qi = torch.arange(s, device=x.device)[:, None]
        kj = torch.arange(sk, device=x.device)[None, :]
        ok = torch.ones(s, sk, dtype=torch.bool, device=x.device)
        if causal:
            ok &= kj <= qi
        if window:
            ok &= kj > qi - window
        logits = torch.where(ok, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (probs @ vf) / probs.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, heads * hd).to(q.dtype)
    return out @ p["wo"].reshape(heads * hd, d), k, v


class KVCache(NamedTuple):
    """Dense or ring-buffer KV cache: ``k`` and ``v`` of (B, slots, KVH, hd)
    for one layer, or (layers, B, slots, KVH, hd) for a model whose every
    layer attends over as many slots (the server's pages are slices of it,
    (layers, page, KVH, hd))."""

    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(batch: int, slots: int, kv_heads: int, head_dim: int, dtype,
                  layers: Optional[int] = None, device=None) -> KVCache:
    """Zeroed cache of (batch, slots, kv_heads, head_dim) each for K and V,
    with a leading axis of ``layers`` if given."""
    shape = (batch, slots, kv_heads, head_dim)
    if layers is not None:
        shape = (layers,) + shape
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def valid_slots(slots: int, pos: int, ring: bool, device=None) -> torch.Tensor:
    """(slots,) mask of the slots a query at ``pos`` attends after its own
    K/V went to slot ``pos % slots``.  A dense cache: slots 0 to ``pos``.  A
    ring (a windowed layer): the slots whose age ``(slot - i) % slots`` is at
    most ``min(pos, slots - 1)``, the reference's rule."""
    idx = torch.arange(slots, device=device)
    if not ring:
        return idx <= pos
    return (pos % slots - idx) % slots <= min(pos, slots - 1)


def _attend_one(p: dict, q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, 1, H, hd) against (B, slots, KVH, hd) K/V under the (slots,)
    mask ``valid`` (``None``: every slot): the reference's einsums as matrix
    products, the query heads of a KV head grouped against it instead of
    repeating K and V.  Returns (B, 1, d)."""
    b, _, heads, hd = q.shape
    kv_heads = cache_k.shape[2]
    qg = q.view(b, kv_heads, heads // kv_heads, hd)           # (B, KVH, G, hd)
    logits = (qg @ cache_k.permute(0, 2, 3, 1)) * hd ** -0.5  # (B, KVH, G, slots)
    if valid is not None:
        logits = torch.where(valid, logits, NEG_INF)
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = attn @ cache_v.transpose(1, 2)                      # (B, KVH, G, hd)
    return out.reshape(b, 1, heads * hd) @ p["wo"].reshape(heads * hd, -1)


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, rope: Tuple[torch.Tensor, torch.Tensor],
                     valid: torch.Tensor) -> torch.Tensor:
    """One token x (B, 1, d) at position ``pos`` against one layer's cache
    (B, slots, KVH, hd), which takes the token's K/V in place at slot
    ``pos % slots``; returns the attention block's output (B, 1, d).

    ``rope`` is ``layers.rope_angles`` at ``pos`` and ``valid`` is
    ``valid_slots`` for this cache, both made once per step by the caller.
    """
    b, _, d = x.shape
    heads, hd = p["wq"].shape[1], p["wq"].shape[2]
    kv_heads = cache_k.shape[2]
    q = rotate((x @ p["wq"].reshape(d, heads * hd)).view(b, 1, heads, hd), *rope)
    k_new = rotate((x @ p["wk"].reshape(d, kv_heads * hd)).view(b, 1, kv_heads, hd), *rope)
    v_new = (x @ p["wv"].reshape(d, kv_heads * hd)).view(b, 1, kv_heads, hd)
    slot = pos % cache_k.shape[1]
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    return _attend_one(p, q, cache_k, cache_v, valid)


def cross_attention_decode(p: dict, x: torch.Tensor, mem_k: torch.Tensor,
                           mem_v: torch.Tensor) -> torch.Tensor:
    """One token x (B, 1, d) against a cross-attention memory (B, Sk, KVH,
    hd), read only: no rotation, every key attended."""
    b, _, d = x.shape
    heads, hd = p["wq"].shape[1], p["wq"].shape[2]
    q = (x @ p["wq"].reshape(d, heads * hd)).view(b, 1, heads, hd)
    return _attend_one(p, q, mem_k, mem_v, None)
