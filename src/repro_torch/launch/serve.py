"""Serving launcher: the KV-page-dedup server over a model with random
weights (drawn from ``--seed``; no checkpoint is loaded).

The port's counterpart of the reference's ``repro.launch.serve``, with the
same request mix and JSON fields, plus ``--device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke \\
      --requests 16 --decode-steps 8 --device cuda
"""

from __future__ import annotations

import argparse
import json
from typing import List, Tuple

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..serving.dedup_kv import DedupKVServer


def request_mix(vocab: int, requests: int, shared_prompt_tokens: int,
                rng: np.random.Generator) -> List[Tuple[int, np.ndarray]]:
    """The launcher's traffic, as (tenant, tokens) per request: even requests
    come from a chat tenant (a shared system prompt plus 16 unique tokens),
    odd ones from a batch tenant (as many one-off tokens)."""
    shared = rng.integers(0, vocab, shared_prompt_tokens)
    mix = []
    for r in range(requests):
        tenant = r % 2
        if tenant == 0:
            toks = np.concatenate([shared, rng.integers(0, vocab, 16)])
        else:
            toks = rng.integers(0, vocab, shared_prompt_tokens + 16)
        mix.append((tenant, toks))
    return mix


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--cache-entries", type=int, default=512)
    ap.add_argument("--shared-prompt-tokens", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encdec:
        raise SystemExit("enc-dec serving demo not wired; use a decoder-only arch")
    device = torch.device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    srv = DedupKVServer(
        model, params,
        page_tokens=args.page_tokens,
        max_slots=max(256, 4 * args.shared_prompt_tokens),
        cache_entries=args.cache_entries,
        seed=args.seed,
        device=device,
    )
    del params  # the model holds its compute-dtype copy
    mix = request_mix(cfg.vocab_size, args.requests, args.shared_prompt_tokens,
                      np.random.default_rng(args.seed))
    last = None
    for tenant, toks in mix:
        last = srv.prefill_request(tenant, toks)
    cache, pos, _ = last
    out, _ = srv.decode(cache, pos, steps=args.decode_steps)
    srv.run_postprocess()
    m = srv.metrics
    print(json.dumps({
        "decoded_tokens": out,
        "blocks_total": m.blocks_total,
        "blocks_prefill_skipped": m.blocks_prefill_skipped,
        "prefill_compute_saving": round(m.prefill_saving, 4),
        "kv_hbm_saving": round(m.hbm_saving, 4),
        "pages_merged_by_postprocess": m.post_pages_merged,
    }, indent=1))


if __name__ == "__main__":
    main()
