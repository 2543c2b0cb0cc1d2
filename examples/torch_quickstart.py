"""Quickstart on the PyTorch port: train a small LM on HPDedup-deduplicated
multi-tenant data (``examples/quickstart.py`` through ``repro_torch``).

On the card (the default), or on the CPU in about a minute:
  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The last line is a JSON record of what it printed, plus the number of
batches the pipeline made and a SHA-256 of the batches the trainer took.
"""

import argparse
import hashlib
import json

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DedupIngestPipeline, TenantSpec
from repro_torch.models import build_model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig


def recorded(batches, steps):
    """The batches as they come, counted, the first ``steps`` hashed."""
    record = {"made": 0, "sha": hashlib.sha256()}

    def gen():
        for b in batches:
            if record["made"] < steps:
                for k in sorted(b):
                    record["sha"].update(k.encode() + b[k].tobytes())
            record["made"] += 1
            yield b

    return gen(), record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))

    # Two tenants sharing one storage system: one duplicates heavily with
    # good temporal locality (mail-server-like), one barely repeats itself
    # (Cloud-FTP-like).  HPDedup's LDSS estimator learns this and gives the
    # first tenant the fingerprint cache.
    tenants = [
        TenantSpec(0, rate=2.0, dup_ratio=0.75, locality="good", overlap_group="shared"),
        TenantSpec(1, rate=1.0, dup_ratio=0.10, locality="weak", overlap_group="shared"),
    ]
    pipe = DedupIngestPipeline(tenants, block_tokens=32, vocab=cfg.vocab_size, cache_entries=512,
                               device=device)
    steps = 30
    batches, record = recorded(pipe.batches(batch_size=4, seq_len=64), steps)
    trainer = Trainer(
        model,
        AdamW(learning_rate=2e-3, warmup_steps=5),
        params,
        batches,
        TrainerConfig(steps=steps, log_every=10),
    )
    out = trainer.run()
    m = pipe.metrics
    print(f"\nloss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    print(f"ingested blocks: {m.blocks_in}, deduped inline: {m.blocks_deduped_inline} "
          f"({m.dedup_saving:.1%} of ingest never hits the store or the model)")
    ldss = pipe.engine.inline.estimator.predicted
    print(f"predicted LDSS per tenant (higher => more cache): "
          f"{ {k: round(v, 1) for k, v in ldss.items()} }")
    print(json.dumps({"first_loss": out["losses"][0], "final_loss": out["losses"][-1],
                      "blocks_in": m.blocks_in, "deduped_inline": m.blocks_deduped_inline,
                      "dedup_saving": m.dedup_saving,
                      "ldss": {str(k): v for k, v in ldss.items()},
                      "batches_made": record["made"], "steps": out["final_step"],
                      "batches_sha256": record["sha"].hexdigest()}))


if __name__ == "__main__":
    main()
