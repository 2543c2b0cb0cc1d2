"""GQA attention: the training/prefill path (full, sliding-window, local and
cross attention) and decoding against a dense or ring-buffer KV cache.

The port's counterpart of the reference's ``models/attention.py``.  Weight
layouts are the reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KVH, hd),
``wo`` (H, hd, d).  The attention itself is plain PyTorch tensor arithmetic,
as the reference computes it (``jnp``) outside any Pallas kernel;
``kernels.paged_attention`` is the paged kernel.

Over a whole sequence, ``attention_train`` takes the reference's schedules:
``flash_attend`` (an online softmax over 512-key chunks) and, for a window
shorter than the sequence, ``banded_attend`` (each query chunk against the
key chunks of its window), both in float32 and both recomputing their
chunks in the backward pass, so that nothing of Sq x Sk is kept.  The query
heads of a KV head are grouped against it, never repeated.
``attend_plain`` is the same function over the whole Sq x Sk, masked (the
code ``attention_train`` ran before, sharing no helper with the schedules):
the plain version they are held against.

A sliding-window or local layer keeps only ``min(window, slots)`` cache
slots and uses them as a ring: position ``pos`` goes to slot ``pos %
slots``.  ``attention_decode`` writes the new token's K/V into its layer's
cache in place (the reference returns a new cache), which saves a copy of
the cache per layer and step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..act_sharding import (active_mesh, active_spec, block_start, flatten_heads,
                            hand_to_rebuild, is_dtensor, keep, local_call, mesh_shape,
                            rebuilding_graph, replaying, row_parallel, sequence_parallel,
                            split_ranks, taken_from_rerun, unflatten, view_heads, work_label)
from .layers import ParamFactory, apply_rope, rotate

NEG_INF = -1e30
# The flash schedule walks the keys in chunks of this many and refuses a
# longer sequence that is not a multiple of it, as the reference asserts;
# the banded schedule's chunk is at most this many tokens.
KV_CHUNK = 512


def init_attention(pf: ParamFactory, d: int, heads: int, kv_heads: int, head_dim: int) -> dict:
    return {
        "wq": pf.normal((d, heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": pf.normal((d, kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": pf.normal((d, kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": pf.normal((heads, head_dim, d), ("heads", "head_dim", "embed")),
    }


def _band_chunk(s: int, window: int) -> Optional[int]:
    """The banded schedule's chunk ``c = min(window, 512, S)`` for ``s``
    tokens under ``window``, or ``None`` where it does not divide both (the
    reference asserts that it does)."""
    if window <= 0:
        return None
    c = min(window, KV_CHUNK, s)
    return c if s % c == 0 and window % c == 0 else None


def _banded(s: int, window: int) -> bool:
    """Whether a sequence of ``s`` tokens under ``window`` takes the banded
    schedule: the reference's condition in ``attention_train``."""
    return s > window and _band_chunk(s, window) is not None


# ---------------------------------------------------------------------------
# Schedules over a whole sequence.  q (B, Sq, H, D), k and v (B, Sk, KVH, D)
# -> (B, Sq, H, D) in q's dtype.  Inside, the G = H / KVH query heads of a KV
# head are rows of one matrix: (B, KVH, Sq, G, D), head h = kvh * G + g, so
# that a run of query positions is a run of rows.
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, S, H, D) -> float32 (B, KVH, S, G, D), contiguous."""
    b, s, h, d = x.shape
    return x.float().view(b, s, kv_heads, h // kv_heads, d).transpose(1, 2).contiguous()


def _unrows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, KVH, S, G, D) -> (B, S, KVH * G, D) in ``dtype``."""
    b, kvh, s, g, d = x.shape
    return x.transpose(1, 2).reshape(b, s, kvh * g, d).to(dtype)


def _heads(x: torch.Tensor) -> torch.Tensor:
    """K or V (B, S, KVH, D) -> float32 (B, KVH, S, D), contiguous."""
    return x.float().transpose(1, 2).contiguous()


def _masked(qi: torch.Tensor, kj: torch.Tensor, causal: bool,
            window: int) -> Optional[torch.Tensor]:
    """(Sq, 1, Sk) mask of the (query, key) pairs at positions qi, kj that
    are not attended (``None``: every pair is): keys after the query when
    ``causal``, keys ``window`` or more positions behind it."""
    bad = None
    if causal:
        bad = kj[None, :] > qi[:, None]
    if window > 0:
        old = kj[None, :] <= qi[:, None] - window
        bad = old if bad is None else bad | old
    return None if bad is None else bad[:, None, :]


def _logits(qf: torch.Tensor, kc: torch.Tensor, bad: Optional[torch.Tensor]) -> torch.Tensor:
    """float32 logits (B, KVH, Sq, G, C) of scaled queries (B, KVH, Sq, G, D)
    against keys (B, KVH, C, D), masked entries at ``NEG_INF``."""
    b, kvh, sq, g, d = qf.shape
    logits = (qf.reshape(b, kvh, sq * g, d) @ kc.transpose(-1, -2)).view(b, kvh, sq, g, -1)
    if bad is not None:
        logits.masked_fill_(bad, NEG_INF)
    return logits


def _pv(p: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """Rows (B, KVH, Sq, G, C) times (B, KVH, C, D) -> (B, KVH, Sq, G, D)."""
    b, kvh, sq, g, c = p.shape
    return (p.reshape(b, kvh, sq * g, c) @ vc).view(b, kvh, sq, g, -1)


# ``_tp`` sums over at most this many rows (query position x head) in one
# product, then adds the products up.  One product over every row of a
# chunk (Sq x G: 32,768 at 4,096 tokens and 8 heads a KV head) rounds its
# float32 sum in a long chain: on an H100 it put dV 1.3e-4 from float64
# (values to 11), where the whole-S plain version, which sums Sq rows a
# head and then the heads, is 3e-5 from it; in blocks, 1.3e-5.
TP_ROWS = 512


def _tp(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a^T x over every row: a (B, KVH, Sq, G, C) and x (B, KVH, Sq, G, D) ->
    (B, KVH, C, D) (a chunk's dK or dV, summed over the query heads), the
    rows taken ``TP_ROWS`` at a time."""
    b, kvh, sq, g, c = a.shape
    d = x.shape[-1]
    per = max(1, TP_ROWS // g)        # query positions a product
    n = sq // per * per
    out = (a[:, :, :n].reshape(b, kvh, -1, per * g, c).transpose(-1, -2)
           @ x[:, :, :n].reshape(b, kvh, -1, per * g, d)).sum(dim=2)
    if n < sq:
        out += a[:, :, n:].reshape(b, kvh, -1, c).transpose(-1, -2) @ x[:, :, n:].reshape(b, kvh, -1, d)
    return out


def _check_flash(sk: int) -> int:
    ck = min(KV_CHUNK, sk)
    if sk % ck:
        raise ValueError(f"sequence length {sk} is not a multiple of {KV_CHUNK} "
                         f"(the reference's flash attention asserts it)")
    return ck


def _flash_chunks(sq: int, sk: int, ck: int, causal: bool, q_offset: int = 0):
    """(first row, first key) of each key chunk that queries at positions
    ``q_offset`` to ``q_offset + sq - 1`` attend.  Causal, the rows before a
    chunk's first key see none of it and attended a key in an earlier chunk
    (their own position's, which is inside any window), so the reference's
    update of them there is exactly the identity (``m`` unchanged,
    ``exp(NEG_INF - m) = 0``): the chunk starts at the first row that sees
    one of its keys, and a chunk wholly after the last query is skipped."""
    for j in range(0, sk, ck):
        r0 = min(max(j - q_offset, 0), sq) if causal else 0
        if r0 < sq:
            yield r0, j


class _Flash(torch.autograd.Function):
    """The reference's ``_flash_attend``: an online softmax over key chunks
    of ``min(512, Sk)``.  Forward keeps the float32 output and the
    log-sum-exp (B, KVH, Sq, G); backward walks the same chunks and
    recomputes each chunk's probabilities from it (the reference's
    ``jax.checkpoint`` of the scan body), with ``delta = rowsum(dO * O)``
    taken from the float32 output, as the reference's gradient of its
    float32 scan takes it, not from the output rounded to q's dtype.  K and
    V are taken to float32 one chunk at a time, and each chunk's dK and dV
    (visited once) are rounded to K's dtype in its iteration, so that no
    float32 copy of the whole K, V or their gradients is alive.

    Where ``act_sharding``'s local region makes its graph again in the
    backward pass (``rebuilding_graph``), the forward pass makes no
    product: it takes the output and the log-sum-exp from the region's run
    in the remat unit's rerun just before (``taken_from_rerun``; that run
    hands them over, ``hand_to_rebuild``), the same values from the same
    inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        ctx.args = (causal, window, q_offset)
        kept = taken_from_rerun() if rebuilding_graph() else None
        if kept is not None:
            o, lse = kept
            ctx.save_for_backward(q, k, v, o, lse)
            return _unrows(o, q.dtype)
        b, sq, h, d = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        ck = _check_flash(sk)
        qf = _rows(q.float() * d ** -0.5, kvh)
        qi = torch.arange(q_offset, q_offset + sq, device=q.device)
        m = torch.full(qf.shape[:-1], -float("inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        with work_label("attention"):
            for r0, j in _flash_chunks(sq, sk, ck, causal, q_offset):
                kj = torch.arange(j, j + ck, device=q.device)
                logits = _logits(qf[:, :, r0:], _heads(k[:, j:j + ck]),
                                 _masked(qi[r0:], kj, causal, window))
                m_old = m[:, :, r0:]
                m_new = torch.maximum(m_old, logits.amax(dim=-1))
                p = logits.sub_(m_new[..., None]).exp_()
                corr = torch.exp(m_old - m_new)
                l[:, :, r0:] = l[:, :, r0:] * corr + p.sum(dim=-1)
                acc[:, :, r0:] = acc[:, :, r0:] * corr[..., None] + _pv(p, _heads(v[:, j:j + ck]))
                m[:, :, r0:] = m_new
        o, lse = acc.div_(l.clamp(min=1e-30)[..., None]), m + torch.log(l)
        ctx.save_for_backward(q, k, v, o, lse)
        hand_to_rebuild(o, lse)
        return _unrows(o, q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.args
        b, sq, h, d = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        ck, scale = min(KV_CHUNK, sk), d ** -0.5
        qf = _rows(q.float() * scale, kvh)
        do = _rows(dout, kvh)
        delta = (do * o).sum(dim=-1, keepdim=True)
        qi = torch.arange(q_offset, q_offset + sq, device=q.device)
        # a chunk after the last query is skipped: its dK and dV stay zero
        dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(k), torch.zeros_like(v)
        with work_label("attention"):
            for r0, j in _flash_chunks(sq, sk, ck, causal, q_offset):
                kc, vc, doc = _heads(k[:, j:j + ck]), _heads(v[:, j:j + ck]), do[:, :, r0:]
                kj = torch.arange(j, j + ck, device=q.device)
                p = _logits(qf[:, :, r0:], kc, _masked(qi[r0:], kj, causal, window))
                p = p.sub_(lse[:, :, r0:, :, None]).exp_()
                dv[:, j:j + ck] = _tp(p, doc).transpose(1, 2)
                ds = _pv(doc, vc.transpose(-1, -2)).sub_(delta[:, :, r0:]).mul_(p)
                dq[:, :, r0:] += _pv(ds, kc)
                dk[:, j:j + ck] = _tp(ds, qf[:, :, r0:]).transpose(1, 2)
        return _unrows(dq * scale, q.dtype), dk, dv, None, None, None


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                 window: int, q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) at positions ``q_offset`` to ``q_offset
    + Sq - 1`` (for the causal and window masks) over k, v (B, Sk, KVH, D)
    at 0..Sk-1, the reference's ``_flash_attend``: q scaled in float32,
    512-key chunks (all of Sk if shorter) with the running max, sum and
    accumulator in float32, masked entries at ``NEG_INF`` (a row whose
    first chunks are all masked is wiped by the ``exp(m - m_new)``
    correction, as there), the output ``acc / max(l, 1e-30)`` in q's dtype.
    Causal, a chunk skips the rows that see none of its keys, and a chunk
    wholly after the last query is skipped (``_flash_chunks``).  Nothing of
    Sq x Sk is kept for the backward pass.  Raises ``ValueError`` where the
    reference asserts: Sk over 512 and not a multiple of it."""
    return _Flash.apply(q, k, v, causal, window, q_offset)


def _band(x: torch.Tensor, i: int, c: int, p: int) -> torch.Tensor:
    """Keys or values (B, KVH, S, D) of query chunk i's band: chunks
    ``max(i - p, 0)`` to i, oldest first -> (B, KVH, (min(i, p) + 1) c, D).
    The reference's band also holds the chunks before position 0, as zeros
    that its mask leaves out; they add nothing to the softmax or the
    output, and are not made here."""
    return x[:, :, max(i - p, 0) * c:(i + 1) * c]


def _check_banded(s: int, window: int) -> Tuple[int, int]:
    c = _band_chunk(s, window)
    if c is None:
        raise ValueError(f"the banded schedule needs S ({s}) and the window ({window}) to be "
                         f"multiples of its chunk min(window, {KV_CHUNK}, S) (the reference "
                         f"asserts it)")
    return c, window // c


def _band_probs(qc: torch.Tensor, kb: torch.Tensor, i: int, c: int, p: int,
                window: int) -> torch.Tensor:
    """Query chunk i's softmax (B, KVH, c, G, keys) over its band (``_band``):
    the reference's ``valid`` mask (causal, inside the window),
    ``exp(x - max) / sum`` as ``jax.nn.softmax``."""
    qi = torch.arange(i * c, (i + 1) * c, device=qc.device)
    kj = torch.arange(max(i - p, 0) * c, (i + 1) * c, device=qc.device)
    logits = _logits(qc, kb, _masked(qi, kj, True, window))
    probs = logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
    return probs.div_(probs.sum(dim=-1, keepdim=True))


class _Banded(torch.autograd.Function):
    """The reference's ``_banded_attend``: query chunk i (of ``c = min(window,
    512, S)`` tokens) against key chunks i - window/c to i, a softmax over
    the band; backward recomputes each query chunk's softmax from q, k and
    v alone.  So the forward pass runs its products once a step: in a
    remat "dots" unit its output is kept (``act_sharding.keep``) and the
    backward pass's rerun of the unit (``replaying``) takes it back without
    a product, and where ``act_sharding``'s local region makes its graph
    again (``rebuilding_graph``) the output's values are not needed."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        if rebuilding_graph():
            return torch.empty_like(q)
        if replaying():
            return keep(torch.empty_like(q))
        b, s, h, d = q.shape
        c, p = _check_banded(s, window)
        qf = _rows(q.float() * d ** -0.5, k.shape[2])
        kf, vf = _heads(k), _heads(v)
        out = torch.empty_like(qf)
        with work_label("attention"):
            for i in range(s // c):
                probs = _band_probs(qf[:, :, i * c:(i + 1) * c], _band(kf, i, c, p), i, c, p,
                                    window)
                out[:, :, i * c:(i + 1) * c] = _pv(probs, _band(vf, i, c, p))
        return keep(_unrows(out, q.dtype))

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        window = ctx.window
        b, s, h, d = q.shape
        c, p = _check_banded(s, window)
        scale = d ** -0.5
        qf = _rows(q.float() * scale, k.shape[2])
        kf, vf = _heads(k), _heads(v)
        do = _rows(dout, k.shape[2])
        dq, dk, dv = torch.empty_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
        with work_label("attention"):
            for i in range(s // c):
                rows, keys = slice(i * c, (i + 1) * c), slice(max(i - p, 0) * c, (i + 1) * c)
                qc, doc = qf[:, :, rows], do[:, :, rows]
                kb, vb = kf[:, :, keys], vf[:, :, keys]
                probs = _band_probs(qc, kb, i, c, p, window)
                dv[:, :, keys] += _tp(probs, doc)
                dp = _pv(doc, vb.transpose(-1, -2))
                ds = dp.sub_((dp * probs).sum(dim=-1, keepdim=True)).mul_(probs)
                dq[:, :, rows] = _pv(ds, kb) * scale
                dk[:, :, keys] += _tp(ds, qc)
        return (_unrows(dq, q.dtype), dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype), None)


def banded_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) over k, v (B, S, KVH, D) keeping
    the keys less than ``window`` positions behind each query, the
    reference's ``_banded_attend``: O(S x window) work in float32, chunks
    of ``c = min(window, 512, S)``, each query chunk against the ``window
    // c + 1`` key chunks that end with its own (fewer near position 0,
    where the reference's are zeros, masked), a softmax over the band, the
    output in q's dtype.  Raises ``ValueError`` unless
    ``c`` divides S and the window, as the reference asserts."""
    return _Banded.apply(q, k, v, window)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                 window: int) -> torch.Tensor:
    """The same function as ``flash_attend`` and ``banded_attend`` over the
    whole Sq x Sk at once, masked: float32 logits and probabilities (B, KVH,
    G, Sq, Sk; float64 for float64 inputs), which autograd keeps.  It is the
    whole-sequence code
    ``attention_train`` ran before the schedules, kept apart from their
    helpers (its own masks, layout and casts) so that the plain version the
    schedules are held against shares none of their code; no path of the
    port calls it."""
    b, s, heads, hd = q.shape
    sk, kv_heads = k.shape[1], k.shape[2]
    groups = heads // kv_heads
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = (q.to(acc) * hd ** -0.5).view(b, s, kv_heads, groups, hd).permute(0, 2, 3, 1, 4)
    kf = k.to(acc).permute(0, 2, 3, 1).unsqueeze(2)            # (B, KVH, 1, hd, Sk)
    vf = v.to(acc).transpose(1, 2).unsqueeze(2)                # (B, KVH, 1, Sk, hd)
    logits = qf @ kf                                           # (B, KVH, G, S, Sk)
    if causal or window:
        qi = torch.arange(s, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        ok = torch.ones(s, sk, dtype=torch.bool, device=q.device)
        if causal:
            ok &= kj <= qi
        if window:
            ok &= kj > qi - window
        logits = torch.where(ok, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (probs @ vf) / probs.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, heads, hd).to(q.dtype)


def project_kv(p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unrotated K and V (B, S, KVH, hd) of x (B, S, d): a cross-attention
    layer's memory."""
    d, kv_heads, hd = p["wk"].shape
    k = view_heads(x @ p["wk"].reshape(d, kv_heads * hd), kv_heads)
    v = view_heads(x @ p["wv"].reshape(d, kv_heads * hd), kv_heads)
    return k, v


def _project_q(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Unrotated Q (B, S, H, hd) of x (B, S, d)."""
    d, heads, hd = p["wq"].shape
    return view_heads(x @ p["wq"].reshape(d, heads * hd), heads)


def project_qkv(p: dict, x: torch.Tensor, positions: Optional[torch.Tensor], *,
                rope_theta: float = 10_000.0, mrope_sections: Sequence[int] = (),
                use_rope: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Q (B, S, H, hd), K and V (B, S, KVH, hd) of x (B, S, d), Q and K
    rotated at ``positions`` unless ``use_rope`` is false."""
    q = _project_q(p, x)
    k, v = project_kv(p, x)
    if use_rope:
        q = apply_rope(q, positions, rope_theta, mrope_sections)
        k = apply_rope(k, positions, rope_theta, mrope_sections)
    return q, k, v


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
    queries attend every key, with no rotation and no mask.  The schedule is
    the reference's: cross-attention goes to ``flash_attend`` unmasked, a
    window shorter than the sequence (with the chunk dividing both) to
    ``banded_attend``, the rest to ``flash_attend``; so lengths the
    reference rejects (over 512 and not a multiple of it, outside the
    banded schedule) raise ``ValueError``.
    Returns the output (B, S, d) and the K and V attended (B, Sk, KVH, hd;
    rotated, for self-attention), which prefill stores in its cache."""
    b, s, d = x.shape
    if kv_override is not None:
        q = _project_q(p, x)
        k, v = kv_override
        out = _schedule(flash_attend, q, k, v, causal=False, window=0)
    else:
        q, k, v = project_qkv(p, x, positions, rope_theta=rope_theta,
                              mrope_sections=mrope_sections, use_rope=use_rope)
        if _banded(s, window):
            out = _schedule(banded_attend, q, k, v, window=window)
        else:
            out = _schedule(flash_attend, q, k, v, causal=causal, window=window)
    return row_parallel(flatten_heads(out), p["wo"].reshape(-1, d)), k, v


def _schedule(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw) -> torch.Tensor:
    """``attend(q, k, v, **kw)``; under a mesh, on each rank's batch rows and
    heads (``act_sharding.local_call``): the schedules write their chunks
    in place, which DTensor cannot follow, and every (row, KV head) of them
    is independent.  Query heads split over "model" only together with
    their KV heads (the reference's sites: q ("batch", "attn_seq", "heads",
    None), its output the same).  Where the KV heads are fewer than the
    "model" ranks but the query heads split over them (TinyLlama's 4 and 32
    on 16), each KV head is repeated until they split too (``_repeat_kv``),
    so that each rank attends its own query heads, as GSPMD splits them.
    Where the heads do not split, flash attention on the residual stream's
    sequence split (``sequence_parallel``: a train step, or a sharded
    prefill's encoder; Whisper's 12 heads on 16 ranks) takes each rank's
    block of the query rows, at its offset in the sequence for the causal
    and window masks (``q_offset``; unmasked, the offset changes nothing
    and is not taken), against every key, as GSPMD splits it, instead of
    every query on every rank."""
    spec = active_spec(k, ("batch", "attn_seq", "kv_heads", None))
    if spec is not None and spec[2] is None and is_dtensor(k):
        k, v = _repeat_kv(q, k), _repeat_kv(q, v)
        spec = active_spec(k, ("batch", "attn_seq", "kv_heads", None))
    heads = "heads" if spec is not None and spec[2] is not None else None
    if (spec is not None and heads is None and is_dtensor(q) and attend is flash_attend
            and sequence_parallel()):
        rows = ("batch", "seq", None, None)
        masked = kw["causal"] or kw["window"]
        attend = functools.partial(attend, q_offset=block_start(q, rows, 1) if masked else 0,
                                   **kw)
        return local_call(attend, (q, rows), (k, ("batch", None, None, None)),
                          (v, ("batch", None, None, None)))
    return local_call(functools.partial(attend, **kw),
                      (q, ("batch", "attn_seq", heads, None)),
                      (k, ("batch", "attn_seq", heads and "kv_heads", None)),
                      (v, ("batch", "attn_seq", heads and "kv_heads", None)))


def _repeat_kv(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K or V (B, S, KVH, D) with each KV head repeated ``m / KVH`` times
    (m the "model" ranks) where that splits the heads over "model" and the
    query heads split there too, else as it is.  Query head h sees KV head
    ``h // (H / KVH)``, which is copy ``h // (H / m)`` of the repeated
    ones."""
    m = mesh_shape(active_mesh()).get("model", 1)
    b, s, kvh, d = x.shape
    if m % kvh or q.shape[2] % m or kvh == m:
        return x
    return x[:, :, :, None].expand(b, s, kvh, m // kvh, d).reshape(b, s, m, d)


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


def _attend_heads(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                  valid: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, 1, H, hd) against (B, slots, KVH, hd) K/V under the (slots,)
    mask ``valid`` (``None``: every slot): the reference's einsums as matrix
    products, the query heads of a KV head grouped against it instead of
    repeating K and V.  Returns (B, 1, H, hd)."""
    b, _, heads, hd = q.shape
    kv_heads = cache_k.shape[2]
    qg = unflatten(q[:, 0], 1, (kv_heads, heads // kv_heads))  # (B, KVH, G, hd)
    logits = (qg @ cache_k.permute(0, 2, 3, 1)) * hd ** -0.5  # (B, KVH, G, slots)
    if valid is not None:
        logits = torch.where(valid, logits, NEG_INF)
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = attn @ cache_v.transpose(1, 2)                      # (B, KVH, G, hd)
    return out.reshape(b, 1, heads, hd)


def _attend_one(p: dict, q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """``_attend_heads`` then the output projection: (B, 1, d).  On a cache
    whose slots are not split (``split_ranks``), under a mesh the heads run
    on each rank's batch rows and KV heads (``local_call``): DTensor cannot
    fold a split KV-head dimension into the products' batch (torch 2.11);
    a cache split over its slots (sequence-parallel decode) takes DTensor's
    products, which reduce the softmax across the slots.  The output
    product is summed whole under a mesh (``row_parallel``), as GSPMD sums
    it before the residual add: a partial residual would reach the MLP's
    column-split weights as a partial input, which DTensor meets by
    gathering those weights whole."""
    b, _, heads, hd = q.shape
    if is_dtensor(cache_k) and split_ranks(cache_k, 1) == 1:
        kvh = "kv_heads" if split_ranks(cache_k, 2) > 1 else None
        attend = functools.partial(_attend_heads, valid=valid)
        out = local_call(attend, (q, ("batch", None, kvh and "heads", None)),
                         (cache_k, ("batch", None, kvh, None)),
                         (cache_v, ("batch", None, kvh, None)))
    else:
        out = _attend_heads(q, cache_k, cache_v, valid)
    return row_parallel(out.reshape(b, 1, heads * hd), p["wo"].reshape(heads * hd, -1))


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, rope: Tuple[torch.Tensor, torch.Tensor],
                     valid: torch.Tensor) -> torch.Tensor:
    """One token x (B, 1, d) at position ``pos`` against one layer's cache
    (B, slots, KVH, hd), which takes the token's K/V in place at slot
    ``pos % slots``; returns the attention block's output (B, 1, d).

    ``rope`` is ``layers.rope_angles`` at ``pos`` and ``valid`` is
    ``valid_slots`` for this cache, both made once per step by the caller.
    """
    q = rotate(_project_q(p, x), *rope)
    k_new, v_new = project_kv(p, x)
    k_new = rotate(k_new, *rope)
    slot = pos % cache_k.shape[1]
    write_slot(cache_k, slot, k_new[:, 0])
    write_slot(cache_v, slot, v_new[:, 0])
    return _attend_one(p, q, cache_k, cache_v, valid)


def write_slot(cache: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """``cache[:, slot] = value`` for a cache (B, slots, ...) and a value
    (B, ...).  On a DTensor cache, each rank writes into its own shard, and
    only the rank whose slots hold ``slot`` writes (the slots may be split,
    ``sharding.cache_pspecs``): the value placed as the cache is on its
    other dimensions."""
    if not is_dtensor(cache):
        cache[:, slot] = value
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, plc = cache.device_mesh, cache.placements
    coord = mesh.get_coordinate()
    lo, size = 0, cache.shape[1]
    for i, p in enumerate(plc):
        if isinstance(p, Shard) and p.dim == 1:  # this rank's slots: [lo, lo + size)
            chunk = -(-size // mesh.size(i))
            lo, size = lo + chunk * coord[i], max(0, min(size, chunk * (coord[i] + 1))
                                                     - chunk * coord[i])
    vplc = [Replicate() if isinstance(p, Shard) and p.dim == 1
            else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p for p in plc]
    local = value.redistribute(mesh, vplc).to_local()
    if lo <= slot < lo + size:
        cache.to_local()[:, slot - lo] = local


def cross_attention_decode(p: dict, x: torch.Tensor, mem_k: torch.Tensor,
                           mem_v: torch.Tensor) -> torch.Tensor:
    """One token x (B, 1, d) against a cross-attention memory (B, Sk, KVH,
    hd), read only: no rotation, every key attended."""
    return _attend_one(p, _project_q(p, x), mem_k, mem_v, None)
