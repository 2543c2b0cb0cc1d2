"""Carry the reference's parameters over to the port.

``params_from_jax`` turns the reference's parameter tree, with its leaves as
numpy arrays (``jax.tree.map(np.asarray, model.init(key))``), into the
port's: the layout is the reference's (``scan/pos{j}``, ``rem{j}``,
``enc_scan``/``dec_scan``, no ``unembed`` when tied), so each leaf becomes a
tensor where it lies.  ``adamw_state_from_jax`` carries the reference's
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
from .layers import map_dict


def _expected_keys(cfg: C.ModelConfig) -> set:
    if cfg.is_encdec:
        return {"embed", "enc_final_ln", "dec_final_ln", "enc_scan", "dec_scan"}
    keys = {"embed", "final_ln"} | {f"rem{j}" for j in range(len(cfg.remainder_kinds))}
    if not cfg.tie_embeddings:
        keys.add("unembed")
    if cfg.scan_groups:
        keys.add("scan")
    return keys


def params_from_jax(tree: Dict, cfg: C.ModelConfig, dtype: torch.dtype = torch.float32) -> Dict:
    """The port's parameter tree (leaves in ``dtype``); float32 and bfloat16
    leaves come over exactly."""
    if set(tree) != _expected_keys(cfg):
        raise ValueError(f"{cfg.name}: parameter tree has keys {sorted(tree)}, "
                         f"the config's layout {sorted(_expected_keys(cfg))}")
    stacks = ({"enc_scan": cfg.encoder_layers, "dec_scan": cfg.num_layers} if cfg.is_encdec
              else {"scan": cfg.scan_groups})
    for key, n in stacks.items():
        if key in tree:
            got = {int(np.shape(x)[0]) for x in _leaves(tree[key])}
            if got != {n}:
                raise ValueError(f"{key}: {sorted(got)} stacked layers, config has {n}")
    return map_dict(lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype), tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def adamw_state_from_jax(state, cfg: C.ModelConfig) -> AdamWState:
    """The reference's ``AdamWState`` (leaves as numpy arrays) as the port's:
    the step as a 0-d int32 host tensor, the moments in the port's layout and
    in their own dtype (float32 or bfloat16)."""
    dtype = getattr(torch, np.asarray(state.mu["embed"]).dtype.name)
    return AdamWState(torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
                      params_from_jax(state.mu, cfg, dtype), params_from_jax(state.nu, cfg, dtype))
