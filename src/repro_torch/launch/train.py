"""Training launcher: the dedup ingest pipeline -> the trainer, on one card.

The port's counterpart of the reference's ``repro.launch.train``, with the
same flags and JSON fields, plus ``--device`` (default ``cuda``, which fails
where there is no card).  The weights are random, drawn from ``--seed`` on
the device.  ``build`` makes the launcher's pipeline and trainer from its
arguments, for callers that drive the run themselves.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \\
      --steps 100 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt --device cpu
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..configs import ARCH_IDS, get_config
from ..data.pipeline import DedupIngestPipeline, TenantSpec
from ..models import ModelConfig, build_model
from ..pytree import leaves
from ..train.optimizer import AdamW
from ..train.trainer import Trainer, TrainerConfig


def default_tenants() -> list:
    """A paper-like tenant mix: mail-ish, ftp-ish, web-ish."""
    return [
        TenantSpec(0, rate=3.0, dup_ratio=0.8, locality="good", overlap_group="g"),
        TenantSpec(1, rate=2.0, dup_ratio=0.15, locality="weak", overlap_group="g"),
        TenantSpec(2, rate=1.0, dup_ratio=0.5, locality="good"),
        TenantSpec(3, rate=0.5, dup_ratio=0.3, locality="good"),
    ]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--block-tokens", type=int, default=64)
    ap.add_argument("--cache-entries", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_pipeline(args: argparse.Namespace, vocab: int, device) -> DedupIngestPipeline:
    return DedupIngestPipeline(
        default_tenants(),
        block_tokens=args.block_tokens,
        vocab=vocab,
        cache_entries=args.cache_entries,
        seed=args.seed,
        device=device,
    )


def build(args: argparse.Namespace, cfg: Optional[ModelConfig] = None,
          chaos: Optional[Callable[[int], None]] = None,
          remat: str = "none") -> Tuple[Trainer, DedupIngestPipeline]:
    """The launcher's trainer over its pipeline, both on ``args.device``;
    ``cfg`` stands in for ``--arch``/``--smoke``'s config (a cut of it),
    ``chaos`` is the trainer's failure injection, ``remat`` the model's
    policy (the launcher itself, as the reference's, trains without).  Any
    decoder-only model trains; an encoder-decoder one raises ``ValueError``
    (the reference's launcher fails on it too)."""
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: an encoder-decoder model trains on encoder_embeds, "
                         f"which the token pipeline's batches do not carry")
    device = torch.device(args.device)
    model = build_model(cfg, remat=remat)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    pipe = make_pipeline(args, cfg.vocab_size, device)
    trainer = Trainer(
        model,
        AdamW(learning_rate=args.lr, warmup_steps=max(args.steps // 20, 5), total_steps=args.steps),
        params,
        pipe.batches(args.batch, args.seq),
        TrainerConfig(
            steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            microbatches=args.microbatches,
        ),
        pipeline_state_fn=pipe.state_dict,
        pipeline_restore_fn=pipe.load_state,
        chaos=chaos,
    )
    return trainer, pipe


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    trainer, pipe = build(args)
    cfg = trainer.model.cfg
    n_params = sum(p.numel() for p in leaves(trainer.params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M vocab={cfg.vocab_size}")
    out = trainer.run()
    m = pipe.metrics
    print(json.dumps({
        "final_loss": out["losses"][-1],
        "first_loss": out["losses"][0],
        "steps": out["final_step"],
        "restarts": out["restarts"],
        "ingest_blocks": m.blocks_in,
        "inline_deduped": m.blocks_deduped_inline,
        "dedup_saving": round(m.dedup_saving, 4),
    }, indent=1))


if __name__ == "__main__":
    main()
