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

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..act_sharding import flatten_heads, local_call, row_parallel, view_heads
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


def _mix(x, xs, mu):
    return x * mu + xs * (1.0 - mu)


def _projections(p: dict, x: torch.Tensor, xs: torch.Tensor, heads: int):
    r = view_heads(_mix(x, xs, p["mu_r"]) @ p["w_r"], heads)
    k = view_heads(_mix(x, xs, p["mu_k"]) @ p["w_k"], heads)
    v = view_heads(_mix(x, xs, p["mu_v"]) @ p["w_v"], heads)
    g = view_heads(_mix(x, xs, p["mu_g"]) @ p["w_g"], heads)
    dec = view_heads((_mix(x, xs, p["mu_w"]) @ p["decay_lora_a"]) @ p["decay_lora_b"], heads)
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


def rwkv_tm_train(p: dict, x: torch.Tensor, heads: int,
                  hd: int) -> Tuple[torch.Tensor, RWKVState]:
    """(B, S, d) -> (B, S, d), S a multiple of 32 (``ValueError`` else, where
    the reference asserts), and the state after the sequence (prefill's
    cache, with both shifts at the last input token: the reference
    recomputes it in ``_rwkv_tail_state``).  Under a mesh the recurrence
    runs on each rank's rows and heads (``local_call``; the reference's
    state sites are ("batch", "heads", None, None))."""
    b, s, d = x.shape
    if s % CHUNK:
        raise ValueError(f"seq {s} not a multiple of {CHUNK}")
    xs = _token_shift(x, torch.zeros((b, d), dtype=x.dtype, device=x.device))
    r, k, v, g, logw = _projections(p, x, xs, heads)
    o, state = local_call(_wkv_chunked, (r, _SEQ_HEADS), (k, _SEQ_HEADS), (v, _SEQ_HEADS),
                          (logw, _SEQ_HEADS), (p["bonus_u"], ("heads", None)),
                          outs=(_SEQ_HEADS, _STATE))
    last = x[:, -1, :]
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


def _channel_mix(p: dict, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    r = sigmoid(_mix(x, xs, p["mu_r"]) @ p["w_r"])
    k = torch.relu(_mix(x, xs, p["mu_k"]) @ p["w_k"]).square()
    return r * (k @ p["w_v"])


def rwkv_cm_train(p: dict, x: torch.Tensor) -> torch.Tensor:
    return _channel_mix(p, x, _token_shift(x, torch.zeros_like(x[:, 0])))


def rwkv_cm_decode(p: dict, x: torch.Tensor,
                   shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _channel_mix(p, x, shift[:, None, :]), x[:, 0, :]
