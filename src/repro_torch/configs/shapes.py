"""Assigned input shapes (one set, paired with every LM architecture).

``train_*`` lowers ``train_step``; ``prefill_*`` lowers the prefill forward;
``decode_*``/``long_*`` lower ``serve_step`` — one new token against a KV
cache of ``seq_len``.  ``long_500k`` requires bounded decode state and only
runs for the sub-quadratic architectures (DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SMOKE_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 128, 4),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 128, 2),
    "decode_32k": ShapeSpec("decode_32k", "decode", 128, 2),
    "long_500k": ShapeSpec("long_500k", "decode", 256, 1),
}
