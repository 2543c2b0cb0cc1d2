"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port's counterpart of the reference's ``models/rglru.py``.  The
recurrence is diagonal-linear: ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) *
(i_t * u_t)``, with the gated decay ``a_t = exp(-8 * softplus(lam) *
sigmoid(u_t W_a))``.  Training and prefill evaluate it with a log-depth
(Hillis-Steele) scan in float32, where the reference uses
``jax.lax.associative_scan``: the same products in another order, so the
two agree to float32 rounding, not bit for bit.  Decode is the one-step
update.  The surrounding block is Griffin's: a causal depthwise conv and the
RG-LRU on one branch, a GELU gate on the other, multiplied and projected
out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..act_sharding import local_call, row_parallel, shard_act
from .layers import ParamFactory, dtype_const, gelu, sigmoid, softplus

_C = 8.0  # Griffin's decay temperature


def init_rglru(pf: ParamFactory, d: int, rnn_dim: int, conv_width: int) -> dict:
    return {
        "w_x": pf.normal((d, rnn_dim), ("embed", "rnn")),
        "w_gate_branch": pf.normal((d, rnn_dim), ("embed", "rnn")),
        "w_out": pf.normal((rnn_dim, d), ("rnn", "embed")),
        "conv_w": pf.normal((conv_width, rnn_dim), ("conv", "rnn"), stddev=0.1),
        "conv_b": pf.zeros((rnn_dim,), ("rnn",)),
        "w_input_gate": pf.normal((rnn_dim, rnn_dim), ("rnn", "rnn_out")),
        "w_a_gate": pf.normal((rnn_dim, rnn_dim), ("rnn", "rnn_out")),
        "lam": pf.constant(np.linspace(0.5, 4.0, rnn_dim), ("rnn",)),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, rnn) float32
    conv: torch.Tensor       # (B, conv_width - 1, rnn): the conv's last inputs


def init_rglru_state(batch: int, rnn_dim: int, conv_width: int, dtype,
                     device=None) -> RGLRUState:
    return RGLRUState(torch.zeros((batch, rnn_dim), dtype=torch.float32, device=device),
                      torch.zeros((batch, conv_width - 1, rnn_dim), dtype=dtype, device=device))


def _decay(p: dict, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step decay a_t and input gate i_t from the branch activations;
    under a mesh each gate's product (summed over the "rnn" split) is
    placed as u, on the rows and the channels."""
    names = ("batch", "attn_seq", "rnn_act")[-u.ndim:]
    gate_a = sigmoid(shard_act(u @ p["w_a_gate"], names))
    a = torch.exp(-_C * softplus(p["lam"]) * gate_a)
    return a, sigmoid(shard_act(u @ p["w_input_gate"], names))


def _conv1d(p: dict, u: torch.Tensor,
            state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise temporal conv of u (B, S, rnn), width W, summed tap
    by tap in the reference's order; ``state`` (B, W - 1, rnn) holds the
    inputs before u (zeros if ``None``).  Returns (out, the last W - 1
    inputs)."""
    w = p["conv_w"]
    width = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], width - 1, u.shape[-1]), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)
    out = sum(ext[:, i:i + u.shape[1]] * w[i] for i in range(width))
    return out + p["conv_b"], ext[:, ext.shape[1] - (width - 1):]


def _gated(a: torch.Tensor, i: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(1.0 - a.square(), min=dtype_const(1e-12, a))) * i * u


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` (h_{-1} = 0) over
    axis 1 in log2(S) doubling steps, out of place so autograd follows."""
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


_SEQ_RNN = ("batch", "attn_seq", "rnn_act")


def _conv_local(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    return _conv1d({"conv_w": w, "conv_b": b}, u)


def rglru_train(p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, RGLRUState]:
    """(B, S, d) -> (B, S, d), and the state after the sequence (prefill's
    cache: the reference recomputes it in ``_rglru_tail_state``).  Under a
    mesh the conv and the scan, independent per (row, channel), run on each
    rank's rows and channels (``local_call``; the reference's site is h
    ("batch", "attn_seq", "rnn_act"))."""
    u_in = x @ p["w_x"]
    u, conv_state = local_call(_conv_local, (u_in, _SEQ_RNN), (p["conv_w"], (None, "rnn_act")),
                               (p["conv_b"], ("rnn_act",)),
                               outs=(_SEQ_RNN, ("batch", None, "rnn_act")))
    a, i = _decay(p, u)
    h = local_call(_scan, (a.float(), _SEQ_RNN), (_gated(a, i, u).float(), _SEQ_RNN))
    branch = gelu(x @ p["w_gate_branch"])
    return row_parallel(h.to(x.dtype) * branch, p["w_out"]), RGLRUState(h[:, -1], conv_state)


def rglru_decode(p: dict, x: torch.Tensor,
                 state: RGLRUState) -> Tuple[torch.Tensor, RGLRUState]:
    """One-token step: x (B, 1, d) -> (B, 1, d) and the new state."""
    u, conv_state = _conv1d(p, x @ p["w_x"], state.conv)
    a, i = _decay(p, u)
    h = a[:, 0].float() * state.h + _gated(a, i, u)[:, 0].float()
    branch = gelu(x @ p["w_gate_branch"])
    out = row_parallel(h[:, None].to(x.dtype) * branch, p["w_out"])
    return out, RGLRUState(h, conv_state)
