"""Carry the reference's parameters over to the port.

``params_from_jax`` turns the reference's decoder parameter tree, with its
leaves as numpy arrays (``jax.tree.map(np.asarray, model.init(key))``), into
the port's layout (``models.transformer``): the layers that the reference
stacks under ``params["scan"]["pos0"]`` for its scan become the leading layer
axis of each layer weight.  ``adamw_state_from_jax`` carries the reference's
``AdamWState`` over the same way, its moments kept in their dtype.  Tests
use them so that both packages start from the same weights and optimizer
state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..train.optimizer import AdamWState
from . import config as C
from .transformer import check_supported


def params_from_jax(tree: Dict, cfg: C.ModelConfig, dtype: torch.dtype = torch.float32) -> Dict:
    """The port's parameter tree (leaves in ``dtype``); float32 and bfloat16
    leaves come over exactly."""
    def _t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)

    check_supported(cfg)
    if cfg.remainder_kinds or set(tree["scan"]) != {"pos0"}:
        raise ValueError("expected every layer stacked under params['scan']['pos0']")
    layer = tree["scan"]["pos0"]
    out = {"embed": _t(tree["embed"]), "unembed": _t(tree["unembed"]),
           "final_ln": _t(tree["final_ln"]),
           "layers": {"ln1": _t(layer["ln1"]), "ln2": _t(layer["ln2"])}}
    out["layers"].update({k: _t(v) for k, v in layer["mixer"].items()})
    out["layers"].update({k: _t(v) for k, v in layer["mlp"].items()})
    for k, v in out["layers"].items():
        if v.shape[0] != cfg.num_layers:
            raise ValueError(f"{k}: {v.shape[0]} stacked layers, config has {cfg.num_layers}")
    return out


def adamw_state_from_jax(state, cfg: C.ModelConfig) -> AdamWState:
    """The reference's ``AdamWState`` (leaves as numpy arrays) as the port's:
    the step as a 0-d int32 host tensor, the moments in the port's layout and
    in their own dtype (float32 or bfloat16)."""
    dtype = getattr(torch, np.asarray(state.mu["embed"]).dtype.name)
    return AdamWState(torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
                      params_from_jax(state.mu, cfg, dtype), params_from_jax(state.nu, cfg, dtype))
