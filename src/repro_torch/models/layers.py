"""Shared model layers: the initialiser, RMS norm, SwiGLU MLP, RoPE and the
cross-entropy loss.

The port's counterpart of the reference's ``models/layers.py`` for the dense
decoder: the same initialiser scales (drawn from a ``torch.Generator``, so
the numbers differ from ``jax.random``'s; tests carry the reference's
weights over with ``models.convert.params_from_jax``), the ``(1 + scale)``
RMS norm computed in float32, standard RoPE, and the cross-entropy with the
reference's z-loss.  M-RoPE waits for the other block kinds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


class ParamFactory:
    """Deterministic initialiser: every tensor is drawn in float32 from one
    ``torch.Generator`` (on the generator's device) and cast to ``dtype``."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype):
        self.generator = generator
        self.dtype = dtype
        self.device = generator.device

    def _randn(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device,
                           dtype=torch.float32)

    def normal(self, shape: Sequence[int], stddev: Optional[float] = None) -> torch.Tensor:
        """N(0, stddev^2); the default stddev is ``1 / sqrt(shape[-1])`` (the
        reference's: the last dimension, not the fan-in)."""
        if stddev is None:
            stddev = 1.0 / np.sqrt(shape[-1] if len(shape) > 1 else shape[0])
        return (self._randn(shape) * stddev).to(self.dtype)

    def embedding(self, shape: Sequence[int], stddev: float = 0.02) -> torch.Tensor:
        return (self._randn(shape) * stddev).to(self.dtype)

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dt)


def mlp_apply(x: torch.Tensor, w_in: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_out: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (``w_gate`` given) or GELU (tanh form, as ``jax.nn.gelu``) MLP.
    The SiLU is the reference's ``g * (1 / (1 + exp(-g)))`` with each step
    rounded to the compute dtype; ``F.silu`` rounds once, which in bf16
    parts from the reference in about a third of the elements."""
    h = x @ w_in
    if act == "swiglu":
        g = x @ w_gate
        h = g * (1 / (1 + torch.exp(-g))) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ w_out


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles at positions (..., S), each
    (..., S, 1, head_dim / 2) in float32: computed once per decode step and
    shared by every layer's q and k."""
    angles = positions[..., None].float() * rope_freqs(head_dim, theta, device=positions.device)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, head_dim) by ``rope_angles``' (cos, sin) in
    float32; the result in x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard rotary embedding of x (..., S, H, head_dim) at positions
    (..., S); the angles and the rotation in float32, the result in x's dtype."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


def token_losses(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4) -> torch.Tensor:
    """Each token's ``logz - logits[label] + z_loss * logz**2``, the logits
    (..., V) cast to float32 before the log-sum-exp, as the reference's."""
    logits = logits.float()
    m = logits.amax(dim=-1)
    logz = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    picked = logits.gather(-1, labels[..., None].long())[..., 0]
    return -(picked - logz) + z_loss * logz.square()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                          z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token loss with z-loss: ``token_losses`` summed under the
    mask over ``max(sum(mask), 1)``."""
    return (token_losses(logits, labels, z_loss) * mask).sum() / mask.sum().clamp(min=1.0)
