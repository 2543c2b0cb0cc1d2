"""Shared model layers: the initialiser, RMS norm, activations, the MLP,
RoPE and M-RoPE, sinusoidal positions and the cross-entropy loss.

The port's counterpart of the reference's ``models/layers.py``: the same
initialiser scales (drawn from a ``torch.Generator``, so the numbers differ
from ``jax.random``'s; tests carry the reference's weights over with
``models.convert.params_from_jax``), the ``(1 + scale)`` RMS norm computed in
float32, standard RoPE and Qwen2-VL's M-RoPE, Whisper's sinusoidal table,
and the cross-entropy with the reference's z-loss.

The activations (``sigmoid``, ``silu``, ``softplus``, ``gelu``) are written
out step by step as JAX composes them, each step rounded to the input's
dtype, with JAX's constants rounded to it first.  In bfloat16 the library
functions round once and part from the reference's in many elements
(``torch.sigmoid`` in about a third, ``F.gelu`` in about two fifths,
``F.softplus`` in about a sixth); the steps below equal them bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..act_sharding import block_input, row_parallel, shard_act


class ParamFactory:
    """Deterministic initialiser: every tensor is drawn in float32 from one
    ``torch.Generator`` (on the generator's device) and cast to ``dtype``.

    Each method takes the tensor's logical axes (``"embed"``, ``"heads"``,
    ``"vocab"``, ...), as the reference's does; ``AxesFactory`` returns them
    in place of the tensor, so that one ``init_*`` function gives either
    tree with the same structure.  With ``generator=None`` the tensors lie
    on ``device`` (``"meta"``: shapes and dtypes, nothing allocated, the
    counterpart of the reference's ``abstract=True``)."""

    def __init__(self, generator: Optional[torch.Generator], dtype: torch.dtype,
                 device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = generator.device if generator is not None else torch.device(device or "meta")

    def _randn(self, shape: Sequence[int], stddev: float) -> torch.Tensor:
        """Scaled in place: a large draw holds one float32 copy at a time."""
        if self.device.type == "meta":
            return torch.empty(tuple(shape), dtype=self.dtype, device="meta")
        t = torch.randn(tuple(shape), generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return t.mul_(stddev).to(self.dtype)

    def normal(self, shape: Sequence[int], axes: Sequence[str],
               stddev: Optional[float] = None) -> torch.Tensor:
        """N(0, stddev^2); the default stddev is ``1 / sqrt(shape[-1])`` (the
        reference's: the last dimension, not the fan-in)."""
        if stddev is None:
            stddev = 1.0 / np.sqrt(shape[-1] if len(shape) > 1 else shape[0])
        return self._randn(shape, stddev)

    def embedding(self, shape: Sequence[int], axes: Sequence[str],
                  stddev: float = 0.02) -> torch.Tensor:
        return self._randn(shape, stddev)

    def zeros(self, shape: Sequence[int], axes: Sequence[str]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, shape: Sequence[int], axes: Sequence[str]) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)

    def constant(self, value, axes: Sequence[str]) -> torch.Tensor:
        """``value`` (an array of any float type) in the factory's dtype."""
        if self.device.type == "meta":
            return torch.empty(np.shape(value), dtype=self.dtype, device="meta")
        return torch.as_tensor(np.asarray(value, dtype=np.float32)).to(self.device, self.dtype)

    def stack(self, make: Callable[[], dict], n: int) -> dict:
        """``n`` layers from ``make`` stacked on a leading axis, filled one at
        a time (one layer is alive beside the stack; a single layer is a
        view)."""
        first = make()
        if n == 1:
            return map_dict(lambda t: t.unsqueeze(0), first)
        if self.device.type == "meta":  # shapes only: one layer stands for all
            return map_dict(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
        out = map_dict(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
        for g in range(n):
            layer = first if g == 0 else make()
            _fill(out, layer, g)
            first = None
        return out


class AxesFactory:
    """``ParamFactory``'s methods returning each tensor's logical axes, so
    that an ``init_*`` function gives the axes tree of its parameters (the
    reference's ``unzip_params(...)[1]``); ``stack`` prefixes ``"layers"``."""

    def normal(self, shape, axes, stddev=None):
        return tuple(axes)

    embedding = normal

    def zeros(self, shape, axes):
        return tuple(axes)

    ones = zeros

    def constant(self, value, axes):
        return tuple(axes)

    def stack(self, make: Callable[[], dict], n: int) -> dict:
        return map_dict(lambda a: ("layers",) + a, make())


def map_dict(fn: Callable, tree):
    """``fn`` over the leaves of a tree of nested dictionaries."""
    if isinstance(tree, dict):
        return {k: map_dict(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fill(out: dict, layer: dict, g: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _fill(out[k], v, g)
        else:
            out[k][g].copy_(v)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dt)


def sequence_whole(x: torch.Tensor) -> torch.Tensor:
    """Under a mesh, an activation with its sequence whole (the "attn_seq"
    rule; the residual stream's "seq" may be split)."""
    return shard_act(x, ("batch", "attn_seq", "embed_act"))


def rms_norm_in(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """``rms_norm`` of the residual stream into a mixer or an MLP: under a
    mesh an ``act_sharding.BlockInput``, whose products gather the
    sequence where their weight is split on its axis (the gather's backward
    pass reduce-scatters the gradient onto the split) and run on each
    rank's sequence block where it is whole; the block's output comes back
    onto the split through its ``row_parallel`` product."""
    return block_input(rms_norm(x, scale, eps))


def dtype_const(c: float, like: torch.Tensor) -> float:
    """The Python float ``c`` rounded to ``like``'s dtype, as JAX casts a
    constant to its operand's dtype before the operation."""
    return float(torch.tensor(c, dtype=torch.float32).to(like.dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))``, each step rounded."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, each step rounded."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))``, each step rounded."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its tanh form), each step rounded."""
    inner = dtype_const(float(np.sqrt(2 / np.pi)), x) * (x + dtype_const(0.044715, x) * x ** 3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp_apply(x: torch.Tensor, w_in: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_out: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (``w_gate`` given) or GELU (tanh form) MLP."""
    h = x @ w_in
    if act == "swiglu":
        h = silu(x @ w_gate) * h
    else:
        h = gelu(h)
    return row_parallel(h, w_out)


def init_mlp(pf: ParamFactory, d: int, ff: int, act: str) -> dict:
    p = {"w_in": pf.normal((d, ff), ("embed", "ff")), "w_out": pf.normal((ff, d), ("ff", "embed"))}
    if act == "swiglu":
        p["w_gate"] = pf.normal((d, ff), ("embed", "ff"))
    return p


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Sequence[int] = ()):
    """(cos, sin) of the rotary angles at positions (B, S), each
    (B, S, 1, head_dim / 2) in float32: computed once per decode step and
    shared by every layer's q and k.

    With ``mrope_sections`` (M-RoPE, Qwen2-VL) the frequency bands go in
    order to the (temporal, height, width) position streams, as many bands
    each as its section says: positions are (3, B, S), or (B, S) taken for
    all three streams, which is standard RoPE bit for bit."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    if mrope_sections:
        if sum(mrope_sections) != head_dim // 2:
            raise ValueError(f"mrope_sections {tuple(mrope_sections)} do not sum to "
                             f"head_dim / 2 = {head_dim // 2}")
        if positions.ndim == 2:
            positions = positions.expand(3, *positions.shape)
        band = torch.tensor([i for i, n in enumerate(mrope_sections) for _ in range(n)],
                            device=positions.device)
        angles = positions[band].movedim(0, -1).float() * freqs   # (B, S, hd / 2)
    else:
        angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, head_dim) by ``rope_angles``' (cos, sin) in
    float32; the result in x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Sequence[int] = ()) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, head_dim) at positions (B, S) (or
    (3, B, S) with ``mrope_sections``); the angles and the rotation in
    float32, the result in x's dtype."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta, mrope_sections))


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal absolute position table (S, d) in float32,
    computed in numpy float64 as the reference computes it."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d)
    table = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


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
