"""RWKV6 "Finch" time-mix and channel-mix (arXiv:2404.05892).

The port's counterpart of the reference's ``models/rwkv6.py``.  Per head
the state S (K x V) evolves as ``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` with
a data-dependent decay ``w_t``, and ``o_t = r_t (S_{t-1} + diag(u) k_t^T
v_t)``.  Training and prefill use the reference's chunked form: within a
chunk of 32 tokens the pairwise decay products telescope through cumulative
log-decays, so the intra-chunk work is two matrix products per head, and
the state recurs only across chunks (a loop here, ``jax.lax.scan`` there).
Decode is the one-step recurrence.  The log-decays are clamped to [-2.5,
-1e-4] per step, so the factored ``exp`` terms stay in float32 range over a
chunk.  The reference's cost-measurement branch (``scan_unroll``, an
associative scan over the chunks) computes the same function and is not
ported.

As in the reference, the token-shift mixing coefficients are static
parameters and the decay keeps its data-dependent low-rank form.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..act_sharding import (BlockInput, flatten_heads, last_token, local_call, row_parallel,
                            seq_matmul, seq_split_axis, shard_act, shift_tokens, view_heads,
                            whole_of)
from .layers import ParamFactory, sigmoid, silu

CHUNK = 32
_LOGW_MIN, _LOGW_MAX = -2.5, -1e-4
_DECAY_RANK = 64
_E, _HD = ("embed",), ("heads", "head_dim")   # axes of the mixing and per-head leaves


def init_rwkv_tm(pf: ParamFactory, d: int, heads: int, head_dim: int) -> dict:
    hk = heads * head_dim
    half = np.full((d,), 0.5)
    return {
        "mu_r": pf.constant(half, _E), "mu_k": pf.constant(half, _E),
        "mu_v": pf.constant(half, _E), "mu_g": pf.constant(half, _E), "mu_w": pf.constant(half, _E),
        "w_r": pf.normal((d, hk), ("embed", "heads_flat")),
        "w_k": pf.normal((d, hk), ("embed", "heads_flat")),
        "w_v": pf.normal((d, hk), ("embed", "heads_flat")),
        "w_g": pf.normal((d, hk), ("embed", "heads_flat")),
        "w_o": pf.normal((hk, d), ("heads_flat", "embed")),
        "decay_base": pf.constant(np.linspace(-1.5, -0.5, hk).reshape(heads, head_dim), _HD),
        "decay_lora_a": pf.normal((d, _DECAY_RANK), ("embed", "lora")),
        "decay_lora_b": pf.normal((_DECAY_RANK, hk), ("lora", "heads_flat"), stddev=0.01),
        "bonus_u": pf.constant(np.full((heads, head_dim), 0.5), _HD),
        "ln_scale": pf.ones((heads, head_dim), _HD),
    }


def init_rwkv_cm(pf: ParamFactory, d: int, ff: int) -> dict:
    half = np.full((d,), 0.5)
    return {
        "mu_r": pf.constant(half, _E),
        "mu_k": pf.constant(half, _E),
        "w_r": pf.normal((d, d), ("embed", "embed_out")),
        "w_k": pf.normal((d, ff), ("embed", "ff")),
        "w_v": pf.normal((ff, d), ("ff", "embed")),
    }


class RWKVState(NamedTuple):
    s: torch.Tensor         # (B, H, K, V) float32 wkv state
    shift_tm: torch.Tensor  # (B, d) previous token (time-mix)
    shift_cm: torch.Tensor  # (B, d) previous token (channel-mix)


def init_rwkv_state(batch: int, heads: int, head_dim: int, d: int, dtype,
                    device=None) -> RWKVState:
    return RWKVState(
        torch.zeros((batch, heads, head_dim, head_dim), dtype=torch.float32, device=device),
        torch.zeros((batch, d), dtype=dtype, device=device),
        torch.zeros((batch, d), dtype=dtype, device=device))


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t - 1]; shifted[0] = prev."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _sequence(x) -> Tuple[torch.Tensor, Optional[str]]:
    """(x, the mesh axis splitting its sequence): a block input
    (``act_sharding.BlockInput``) of a train step whose sequence is split
    keeps the split, so that the token shift, the mixes and the products
    run on each rank's block (``seq_split_axis``); anything else is taken
    with its sequence whole (``whole_of``, axis None)."""
    if isinstance(x, BlockInput):
        axis = seq_split_axis(x.x)
        if axis is not None:
            return x.x, axis
    return whole_of(x), None


def _shifted(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """x one token later, zeros first: on a split sequence each rank's block
    takes the previous rank's last token (``act_sharding.shift_tokens``)."""
    if axis is not None:
        return shift_tokens(x, axis)
    return _token_shift(x, torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype, device=x.device))


def _matmul(axis: Optional[str]):
    """The products' function: on a split sequence, each rank's block
    against the weight gathered whole (``act_sharding.seq_matmul``)."""
    return torch.matmul if axis is None else functools.partial(seq_matmul, axis=axis)


def _mix(x, xs, mu):
    return x * mu + xs * (1.0 - mu)


def _projections(p: dict, x: torch.Tensor, xs: torch.Tensor, heads: int,
                 axis: Optional[str] = None):
    """r, k, v, g (B, S, H, hd) and the clamped float32 log decays.  On a
    split sequence the products run on each rank's block and each result
    moves to the heads split (``_SEQ_HEADS``: an all-to-all)."""
    mm = _matmul(axis)

    def head(t):
        t = view_heads(t, heads)
        return t if axis is None else shard_act(t, _SEQ_HEADS)

    r = head(mm(_mix(x, xs, p["mu_r"]), p["w_r"]))
    k = head(mm(_mix(x, xs, p["mu_k"]), p["w_k"]))
    v = head(mm(_mix(x, xs, p["mu_v"]), p["w_v"]))
    g = head(mm(_mix(x, xs, p["mu_g"]), p["w_g"]))
    dec = head(mm(mm(_mix(x, xs, p["mu_w"]), p["decay_lora_a"]), p["decay_lora_b"]))
    logw = -torch.exp(p["decay_base"].float() + dec.float())
    return r, k, v, g, torch.clamp(logw, _LOGW_MIN, _LOGW_MAX)   # logw (b, s, h, k)


def _head_norm(p: dict, o: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm in float32 (the reference's stand-in for RWKV's
    GroupNorm)."""
    of = o.float()
    var = of.square().mean(dim=-1, keepdim=True)
    return (of * torch.rsqrt(var + 1e-6) * p["ln_scale"]).to(o.dtype)


def _output(p: dict, o: torch.Tensor, g: torch.Tensor, dtype) -> torch.Tensor:
    """o (B, S, H, V) float32 -> (B, S, d): head norm, SiLU gate, w_o."""
    o = _head_norm(p, o) * silu(g.float()).to(o.dtype)
    return row_parallel(flatten_heads(o.to(dtype)), p["w_o"])


def _wkv_chunked(r, k, v, logw, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked recurrence over (B, S, H, hd) r, k, v and float32 log
    decays, u (H, hd): the output (B, S, H, V) float32 and the state (B, H,
    K, V) after the sequence.  Each (row, head) is independent."""
    b, s, heads, hd = r.shape
    u = u.float()
    nc = s // CHUNK

    def chunked(t):  # (b, h, nc, C, k), float32 for the recurrence
        return t.reshape(b, nc, CHUNK, heads, hd).permute(0, 3, 1, 2, 4).float()

    rc, kc, vc, lw = chunked(r), chunked(k), chunked(v), chunked(logw)
    lp = torch.cumsum(lw, dim=3)                     # inclusive log-decay products
    lp_last = lp[:, :, :, -1:, :]
    q_s = rc * torch.exp(lp - lw)                    # exclusive: lp_{t-1} <= 0
    k_in = kc * torch.exp(-lp)                       # bounded by the clamp x chunk
    k_st = kc * torch.exp(lp_last - lp)              # <= 1

    mask = torch.ones(CHUNK, CHUNK, device=r.device).tril(-1)
    att = (q_s @ k_in.transpose(-1, -2)) * mask
    diag = (rc * u[:, None, None, :] * kc).sum(dim=-1)
    o = att @ vc + diag[..., None] * vc

    state = torch.zeros((b, heads, hd, hd), dtype=torch.float32, device=r.device)
    inter = []
    for c in range(nc):
        inter.append(q_s[:, :, c] @ state)
        state = (torch.exp(lp_last[:, :, c, 0])[..., None] * state
                 + k_st[:, :, c].transpose(-1, -2) @ vc[:, :, c])
    o = o + torch.stack(inter, dim=2)                # (b, h, nc, C, v)
    return o.permute(0, 2, 3, 1, 4).reshape(b, s, heads, hd), state


_SEQ_HEADS = ("batch", "attn_seq", "heads", None)
_STATE = ("batch", "heads", None, None)


def rwkv_tm_train(p: dict, x, heads: int, hd: int) -> Tuple[torch.Tensor, RWKVState]:
    """(B, S, d) -> (B, S, d), S a multiple of 32 (``ValueError`` else, where
    the reference asserts), and the state after the sequence (prefill's
    cache, with both shifts at the last input token: the reference
    recomputes it in ``_rwkv_tail_state``).  Under a mesh the recurrence
    runs on each rank's rows and heads (``local_call``; the reference's
    state sites are ("batch", "heads", None, None)).  In a train step whose
    block input (``BlockInput``) is split along the sequence, the token
    shift, the five mixes and their products run on each rank's sequence
    block (``_sequence``), as GSPMD runs them, and the state's shifts are
    the last rank's last token."""
    x, axis = _sequence(x)
    b, s, d = x.shape
    if s % CHUNK:
        raise ValueError(f"seq {s} not a multiple of {CHUNK}")
    r, k, v, g, logw = _projections(p, x, _shifted(x, axis), heads, axis)
    o, state = local_call(_wkv_chunked, (r, _SEQ_HEADS), (k, _SEQ_HEADS), (v, _SEQ_HEADS),
                          (logw, _SEQ_HEADS), (p["bonus_u"], ("heads", None)),
                          outs=(_SEQ_HEADS, _STATE))
    last = x[:, -1, :] if axis is None else last_token(x, axis)
    return _output(p, o, g, x.dtype), RWKVState(state, last, last)


def _wkv_step(r, k, v, logw, u, state_s) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's recurrence: r, k, v, logw (B, 1, H, hd), u (H, hd), state
    (B, H, K, V) float32 -> (output (B, 1, H, V) float32, new state)."""
    u = u.float()
    rf, kf, vf = (t[:, 0].float() for t in (r, k, v))          # (b, h, k)
    o = (rf[..., None, :] @ state_s)[..., 0, :]
    o = o + (rf * (u * kf)).sum(dim=-1, keepdim=True) * vf
    s_new = torch.exp(logw[:, 0])[..., None] * state_s + kf[..., :, None] * vf[..., None, :]
    return o[:, None], s_new


def rwkv_tm_decode(p: dict, x: torch.Tensor, state_s: torch.Tensor, shift: torch.Tensor,
                   heads: int, hd: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token: x (B, 1, d), state_s (B, H, K, V) float32, shift (B, d) the
    previous token; returns (out (B, 1, d), new state, new shift).  Under a
    mesh the step runs on each rank's rows and heads, as in training."""
    r, k, v, g, logw = _projections(p, x, shift[:, None, :], heads)
    o, s_new = local_call(_wkv_step, (r, _SEQ_HEADS), (k, _SEQ_HEADS), (v, _SEQ_HEADS),
                          (logw, _SEQ_HEADS), (p["bonus_u"], ("heads", None)),
                          (state_s, _STATE), outs=(_SEQ_HEADS, _STATE))
    return _output(p, o, g, x.dtype), s_new, x[:, 0, :]


def _channel_mix(p: dict, x: torch.Tensor, xs: torch.Tensor,
                 axis: Optional[str] = None) -> torch.Tensor:
    mm = _matmul(axis)
    r = sigmoid(mm(_mix(x, xs, p["mu_r"]), p["w_r"]))
    k = torch.relu(mm(_mix(x, xs, p["mu_k"]), p["w_k"])).square()
    return r * mm(k, p["w_v"])


def rwkv_cm_train(p: dict, x) -> torch.Tensor:
    """(B, S, d) -> (B, S, d); a split block input runs on each rank's
    sequence block, as ``rwkv_tm_train``."""
    x, axis = _sequence(x)
    return _channel_mix(p, x, _shifted(x, axis), axis)


def rwkv_cm_decode(p: dict, x: torch.Tensor,
                   shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _channel_mix(p, x, shift[:, None, :]), x[:, 0, :]
