"""Carry the reference's parameters over to the port.

``params_from_jax`` turns the reference's decoder parameter tree, with its
leaves as numpy arrays (``jax.tree.map(np.asarray, model.init(key))``), into
the port's layout (``models.transformer``): the layers that the reference
stacks under ``params["scan"]["pos0"]`` for its scan become the leading layer
axis of each layer weight.  Tests use it so that both packages compute with
the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import config as C
from .transformer import check_supported


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_jax(tree: Dict, cfg: C.ModelConfig) -> Dict:
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
