"""End-to-end run on the PyTorch port: train a llama-family model on the
deduplicated multi-tenant pipeline, with checkpointing
(``examples/train_e2e.py`` through ``repro_torch``).

Full run (a ~100M-parameter model, 300 steps of 8 x 256) on the card:
  PYTHONPATH=src python examples/torch_train_e2e.py --steps 300
Short demo on the CPU:
  PYTHONPATH=src python examples/torch_train_e2e.py --steps 40 --d-model 256 --device cpu

Checkpoints go to ``--ckpt-dir`` (by default a directory under the
system's temporary directory).  The last line is a JSON record of what it
printed, plus the number of batches the pipeline made and a SHA-256 of the
batches the trainer took.
"""

import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DedupIngestPipeline, TenantSpec
from repro_torch.models import build_model
from repro_torch.pytree import leaves
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig

from torch_quickstart import recorded


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_e2e_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config("tinyllama-1.1b").replace(
        name="llama-e2e",
        num_layers=args.layers,
        d_model=args.d_model,
        num_heads=max(4, args.d_model // 64),
        num_kv_heads=max(2, args.d_model // 128),
        head_dim=64,
        d_ff=args.d_model * 3,
        vocab_size=32000,
    )
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    n = sum(p.numel() for p in leaves(params))
    print(f"model: {n/1e6:.1f}M params; {args.steps} steps of {args.batch}x{args.seq}")

    tenants = [
        TenantSpec(0, rate=3.0, dup_ratio=0.8, locality="good", overlap_group="g"),
        TenantSpec(1, rate=2.0, dup_ratio=0.1, locality="weak", overlap_group="g"),
        TenantSpec(2, rate=1.0, dup_ratio=0.5, locality="good"),
    ]
    pipe = DedupIngestPipeline(tenants, block_tokens=64, vocab=cfg.vocab_size, cache_entries=8192,
                               device=device)
    batches, record = recorded(pipe.batches(args.batch, args.seq), args.steps)
    trainer = Trainer(
        model,
        AdamW(learning_rate=3e-4, warmup_steps=20, total_steps=args.steps),
        params,
        batches,
        TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      log_every=10),
        pipeline_state_fn=pipe.state_dict,
        pipeline_restore_fn=pipe.load_state,
    )
    out = trainer.run()
    m = pipe.metrics
    print(f"\nloss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} over {out['final_step']} steps")
    print(f"dedup saved {m.dedup_saving:.1%} of ingested blocks from ever reaching training")
    print(json.dumps({"params": n, "first_loss": out["losses"][0],
                      "final_loss": out["losses"][-1], "steps": out["final_step"],
                      "restarts": out["restarts"], "blocks_in": m.blocks_in,
                      "deduped_inline": m.blocks_deduped_inline, "dedup_saving": m.dedup_saving,
                      "batches_made": record["made"],
                      "batches_sha256": record["sha"].hexdigest()}))


if __name__ == "__main__":
    main()
