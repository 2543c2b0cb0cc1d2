"""Serving with HPDedup'd KV pages on the PyTorch port: shared prompts
prefill once (``examples/serve_kv_dedup.py`` through ``repro_torch``).

  PYTHONPATH=src python examples/torch_serve_kv_dedup.py [--device cpu]

The decoded tokens differ from the reference example's (the weights come
from a ``torch.Generator``); the dedup metrics do not depend on them.  The
last line is a JSON record of what it printed.
"""

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.dedup_kv import DedupKVServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    srv = DedupKVServer(model, params, page_tokens=16, max_slots=256, cache_entries=256,
                        device=device)

    rng = np.random.default_rng(0)
    system_prompt = rng.integers(0, cfg.vocab_size, 64)     # shared by tenant 0
    out = None
    for req in range(8):
        # tenant 0: chat requests sharing the system prompt (prefix dedup hits)
        toks = np.concatenate([system_prompt, rng.integers(0, cfg.vocab_size, 16)])
        cache, pos, info = srv.prefill_request(0, toks)
        # tenant 1: embedding-style one-off content (no reuse; LDSS learns it)
        srv.prefill_request(1, rng.integers(0, cfg.vocab_size, 80))
        if req == 7:
            out, _ = srv.decode(cache, pos, steps=8)
            print(f"last request decoded: {out}")

    srv.run_postprocess()   # exact page dedup for whatever inline missed
    m = srv.metrics
    print(f"prefill blocks: {m.blocks_total}, skipped via dedup: {m.blocks_prefill_skipped}")
    print(f"prefill compute saved: {m.prefill_saving:.1%}; KV HBM saved: {m.hbm_saving:.1%}")
    print(json.dumps({"decoded": [int(t) for t in out], "blocks_total": m.blocks_total,
                      "blocks_prefill_skipped": m.blocks_prefill_skipped,
                      "prefill_saving": m.prefill_saving, "hbm_saving": m.hbm_saving}))


if __name__ == "__main__":
    main()
