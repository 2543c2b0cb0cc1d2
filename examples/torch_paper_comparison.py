"""The paper's core comparison on the PyTorch port: iDedup vs HPDedup vs pure
post-processing on workload C (weak-locality-heavy), FIU-like traces
(``examples/paper_comparison.py`` through ``repro_torch``).

  PYTHONPATH=src python examples/torch_paper_comparison.py [--device cpu]
      [--requests 250000]

The reports equal the reference example's bit for bit at the same
``--requests``.  The last line is a JSON record of the three reports'
fields it printed.
"""

import argparse
import json

from repro_torch.core import (HPDedup, PurePostProcessing, generate_workload, make_idedup,
                              trace_stats)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=250_000)
    args = ap.parse_args(argv)
    dev = args.device

    trace, _ = generate_workload("C", total_requests=args.requests, seed=0)
    print("workload C:", trace_stats(trace))

    cache = 2048
    ide = make_idedup(cache_entries=cache, device=dev)
    ide.replay(trace)
    r_ide = ide.finish(run_post_to_exact=False)

    hp = HPDedup(cache_entries=cache, adaptive_threshold=False, fixed_threshold=4, device=dev)
    hp.replay(trace)
    r_hp = hp.finish()

    pp = PurePostProcessing(device=dev).replay(trace)
    r_pp = pp.finish()

    print(f"\n{'':24s}{'inline ratio':>14s}{'peak blocks':>14s}{'exact?':>8s}")
    print(f"{'iDedup (LRU, T=4)':24s}{r_ide.inline_dedup_ratio:>13.1%}{r_ide.peak_disk_blocks:>14d}{'no':>8s}")
    print(f"{'HPDedup (LRU, T=4)':24s}{r_hp.inline_dedup_ratio:>13.1%}{r_hp.peak_disk_blocks:>14d}{'yes':>8s}")
    print(f"{'pure post-processing':24s}{0.0:>13.1%}{r_pp.peak_disk_blocks:>14d}{'yes':>8s}")
    rel = (r_hp.inline_dedup_ratio - r_ide.inline_dedup_ratio) / max(r_ide.inline_dedup_ratio, 1e-9)
    print(f"\nHPDedup inline-ratio improvement over iDedup: "
          f"{r_hp.inline_dedup_ratio - r_ide.inline_dedup_ratio:+.1%} absolute ({rel:+.1%} relative)")
    print(f"peak-capacity reduction vs post-processing: "
          f"{1 - r_hp.peak_disk_blocks / r_pp.peak_disk_blocks:.1%}")
    print(json.dumps({name: {"inline_dedup_ratio": r.inline_dedup_ratio,
                             "peak_disk_blocks": int(r.peak_disk_blocks)}
                      for name, r in (("idedup", r_ide), ("hpdedup", r_hp), ("post", r_pp))}))


if __name__ == "__main__":
    main()
