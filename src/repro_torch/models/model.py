"""Model facade: one ``nn.Module`` per configuration, holding its weights.

* ``init(generator)``  -> float parameters (``transformer`` layout), as the
                          reference's ``Model.init(rng)``
* ``train_loss(params, batch)`` -> (loss, {"ce_loss", "moe_aux"}); ``params``
                          explicit, as the reference's facade takes them
                          (float32 leaves with ``requires_grad`` to train)
* ``prefill(params, batch, slots=None)`` -> (last-position logits, cache)
* ``load(params)``     -> the module, holding them in the compute dtype
                          (cast once) as buffers, for serving
* ``decode_step(cache, tokens, pos)`` -> (logits, cache), over the loaded
                          weights
* ``init_cache(batch, slots)``

Only the dense decoder is ported; any other family raises
``NotImplementedError``.  The module moves with ``.to(device)`` like any
other; its caches are made on the device its weights lie on.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import config as C
from . import transformer
from .attention import KVCache


class Model(nn.Module):
    def __init__(self, cfg: C.ModelConfig):
        super().__init__()
        transformer.check_supported(cfg)
        self.cfg = cfg

    # -- params ----------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict:
        return transformer.init_decoder_params(generator, self.cfg)

    def load(self, params: Dict) -> "Model":
        cast = transformer.cast_params(params, self.cfg)
        for name in ("embed", "unembed", "final_ln"):
            self.register_buffer(name, cast[name])
        for name, value in cast["layers"].items():
            self.register_buffer(name, value)
        return self

    @property
    def params(self) -> Dict:
        if getattr(self, "embed", None) is None:
            raise RuntimeError("no weights: call Model.load(params) first")
        return {"embed": self.embed, "unembed": self.unembed, "final_ln": self.final_ln,
                "layers": {k: getattr(self, k) for k in transformer.LAYER_KEYS}}

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    # -- training --------------------------------------------------------------
    def train_loss(self, params: Dict, batch: Dict[str, torch.Tensor]):
        return transformer.train_loss(params, batch, self.cfg)

    # -- serving ---------------------------------------------------------------
    def prefill(self, params: Dict, batch: Dict[str, torch.Tensor],
                slots: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
        return transformer.prefill(params, batch["inputs"], batch.get("positions"), self.cfg,
                                   slots)

    def decode_step(self, cache: KVCache, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, KVCache]:
        return transformer.decode_step(self.params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch_size: int, slots: int) -> KVCache:
        return transformer.init_cache(self.cfg, batch_size, slots, device=self.device)


def build_model(cfg: C.ModelConfig) -> Model:
    return Model(cfg)
