"""Model facade: one ``nn.Module`` per configuration, holding its weights.

* ``init(generator)``  -> float parameters (the reference's layout), as the
                          reference's ``Model.init(rng)``
* ``abstract_params()`` -> (a tree of ``meta`` tensors in the parameter
                          dtype, the logical-axes tree of the same
                          structure): shapes without allocation, the
                          reference's ``ShapeDtypeStruct`` tree
* ``train_loss(params, batch)`` -> (loss, {"ce_loss", "moe_aux"}); ``params``
                          explicit, as the reference's facade takes them
                          (float32 leaves with ``requires_grad`` to train),
                          under the model's ``remat`` policy ("none",
                          "full" or "dots", as the reference's)
* ``prefill(params, batch, slots=None)`` -> (last-position logits, cache) of
                          {"inputs"} or {"embeds"} with optional
                          {"positions"}; an encoder-decoder model takes
                          {"encoder_embeds"} and returns (encoder states,
                          cache)
* ``load(params)``     -> the module, holding them in the compute dtype
                          (cast once) as buffers, for serving
* ``decode_step(cache, tokens, pos)`` -> (logits, cache), over the loaded
                          weights
* ``init_cache(batch, slots, enc_slots=0)``

Decoder-only models run in ``transformer``, encoder-decoder ones (Whisper)
in ``encdec``.  The module moves with ``.to(device)`` like any other; its
caches are made on the device its weights lie on.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..pytree import flatten_with_path
from . import config as C
from . import encdec, transformer
from .layers import AxesFactory, ParamFactory


def impl(cfg: C.ModelConfig):
    """The module that computes ``cfg``'s model."""
    return encdec if cfg.is_encdec else transformer


class Model(nn.Module):
    def __init__(self, cfg: C.ModelConfig, remat: str = "none"):
        super().__init__()
        transformer.check_remat(remat)
        self.cfg = cfg
        self.remat = remat
        self._paths = None

    # -- params ----------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict:
        if self.cfg.is_encdec:
            return encdec.init_encdec_params(generator, self.cfg)
        return transformer.init_decoder_params(generator, self.cfg)

    def _tree(self, pf) -> Dict:
        return impl(self.cfg).encdec_tree(pf, self.cfg) if self.cfg.is_encdec else \
            transformer.decoder_tree(pf, self.cfg)

    def param_axes(self) -> Dict:
        """Each parameter's logical axes (``"embed"``, ``"heads"``, ...), in
        the parameter tree's structure."""
        return self._tree(AxesFactory())

    def abstract_params(self):
        """(parameters on the ``meta`` device, ``param_axes()``): nothing is
        allocated."""
        pf = ParamFactory(None, getattr(torch, self.cfg.param_dtype), device="meta")
        return self._tree(pf), self.param_axes()

    def load(self, params: Dict) -> "Model":
        """Hold ``params`` cast for decoding (``cast_params``) as buffers,
        one per leaf, named by its key path."""
        self._paths = []
        for path, value in flatten_with_path(impl(self.cfg).cast_params(params, self.cfg)):
            self.register_buffer("__".join(path), value)
            self._paths.append(path)
        return self

    @property
    def params(self) -> Dict:
        if self._paths is None:
            raise RuntimeError("no weights: call Model.load(params) first")
        tree: Dict = {}
        for path in self._paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return tree

    @property
    def device(self) -> torch.device:
        return getattr(self, "__".join(self._paths[0])).device

    # -- training --------------------------------------------------------------
    def train_loss(self, params: Dict, batch: Dict[str, torch.Tensor]):
        return impl(self.cfg).train_loss(params, batch, self.cfg, self.remat)

    # -- serving ---------------------------------------------------------------
    def prefill(self, params: Dict, batch: Dict[str, torch.Tensor], slots: Optional[int] = None,
                cache=None):
        """``slots``: the decode cache's (self-attention) slots, by default
        the prompt's length (the decoder's ``decoder_slots`` for an
        encoder-decoder model); ``cache``: a zeroed cache of as many slots
        to fill instead of a new one."""
        if self.cfg.is_encdec:
            return encdec.encode_prefill(params, batch["encoder_embeds"], self.cfg,
                                         slots or self.cfg.decoder_slots, cache=cache)
        return transformer.prefill(params, batch.get("embeds", batch.get("inputs")),
                                   batch.get("positions"), self.cfg, slots, cache=cache)

    def decode_step(self, cache, tokens: torch.Tensor, pos: int, **kw):
        """``kw``: a decoder-only model's ``capacity_factor`` for its MoE
        layers (default 4, the reference's)."""
        return impl(self.cfg).decode_step(self.params, cache, tokens, pos, self.cfg, **kw)

    def init_cache(self, batch_size: int, slots: int, enc_slots: int = 0):
        if self.cfg.is_encdec:
            return encdec.init_dec_cache(self.cfg, batch_size, slots, enc_slots,
                                         device=self.device)
        return transformer.init_cache(self.cfg, batch_size, slots, device=self.device)


def build_model(cfg: C.ModelConfig, remat: str = "none") -> Model:
    return Model(cfg, remat=remat)
