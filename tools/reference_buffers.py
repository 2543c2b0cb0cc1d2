"""The reference's compiled step per device, from its own dry run: the
``memory_analysis`` peak of each cell and what the largest is made of
(XLA's buffer assignment), and the FLOPs of its matrix products.

Runs ``repro.launch.dryrun.run_cell`` (jax, 512 forced host devices) and
prints one JSON line a cell:

  * ``bytes_per_device``: the cell's step scanned, as the reference's dry
    run compiles it;
  * ``dot_flops_per_device``: the step compiled again with its layers
    unrolled (``scan_mode.unrolled()``) and its loss head in checkpointed
    chunks as the step runs it (``loss_head_as_run``), so that the module
    holds the whole step: 2 x result elements x contracted size over its
    ``dot`` instructions (``hlo_dots``), what ``FlopCounterMode`` counts on
    the port's side.  XLA's ``cost_analysis`` counts every elementwise
    operation too, and the record's ``flops_per_device`` is
    ``analytic_terms``, a model, not a compiled count.  ``loops``: the
    while loops left in that module (0: none of its dots counted once for
    several trips).

For one cell (``--arch`` an id, one mesh) it also dumps the scanned module
and prints its allocations and the largest values of its largest
allocation (the preallocated temp), by shape and name, and with ``--dots
N`` the unrolled module's N heaviest groups of dots by operand shapes.
The counterpart on the port's side is ``python -m
repro_torch.launch.dryrun --arch A --shape S --peak-live``.  A full-size
unrolled compile takes from half a minute to many minutes a cell
(RecurrentGemma-2B ``train_4k``: about ten).

Usage:
  PYTHONPATH=src python tools/reference_buffers.py --arch tinyllama-1.1b
  PYTHONPATH=src python tools/reference_buffers.py --arch all --mesh both
  PYTHONPATH=src python tools/reference_buffers.py --arch recurrentgemma-2b \\
      --measure flops --dots 12
"""

import argparse
import contextlib
import functools
import glob
import json
import math
import os
import re
import shutil
import tempfile

# An HLO instruction's name and result dimensions, and a dot's operands and
# contracted dimensions of its left operand.
DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = \w+\[([0-9,]*)\]")
DOT = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = \w+\[([0-9,]*)\]\S* "
                 r"dot\(%?([\w.\-]+), %?([\w.\-]+)\).*?lhs_contracting_dims=\{([0-9,]*)\}")


def _dims(s: str):
    return [int(d) for d in s.split(",") if d]


def hlo_dots(text: str):
    """(left, right and result dimensions, FLOPs) of each ``dot`` of an HLO
    module's text: 2 x result elements x contracted size."""
    shapes = {m.group(1): _dims(m.group(2)) for m in map(DEF.match, text.splitlines()) if m}
    out = []
    for m in filter(None, map(DOT.match, text.splitlines())):
        lhs, rhs, res = shapes[m.group(3)], shapes[m.group(4)], _dims(m.group(2))
        flops = 2 * math.prod(res) * math.prod(lhs[c] for c in _dims(m.group(5)))
        out.append((lhs + rhs + res, flops))
    return out


def hlo_dot_flops(text: str) -> int:
    return sum(f for _, f in hlo_dots(text))


def capture_modules(R) -> list:
    """The text of every module ``R.run_cell`` compiles from now on, in
    order (``R``: ``repro.launch.dryrun``, which hands the compiled step's
    text to its ``collective_bytes``)."""
    texts = []
    original = R.collective_bytes
    R.collective_bytes = lambda text: (texts.append(text), original(text))[1]
    return texts


@contextlib.contextmanager
def loss_head_as_run():
    """The reference's loss head as its step runs it, in sequence chunks
    each under ``jax.checkpoint`` (its forward, recompute and two backward
    products), inside ``scan_mode.unrolled()``, whose cost mode would take
    it whole without the recompute; the chunks' scan unrolled, so that no
    loop holds them."""
    import jax
    import repro.models.transformer as T

    ce, unroll = T.chunked_ce_loss, T.scan_unroll

    def chunked_ce_loss(*args):
        scan = jax.lax.scan
        T.scan_unroll, jax.lax.scan = (lambda: False), functools.partial(scan, unroll=True)
        try:
            return ce(*args)
        finally:
            T.scan_unroll, jax.lax.scan = unroll, scan

    T.chunked_ce_loss = chunked_ce_loss
    try:
        yield
    finally:
        T.chunked_ce_loss = ce


def compiled_dots(R, texts: list, arch: str, shape: str, multi_pod: bool):
    """(record, dots, loops) of the cell's step compiled unrolled with the
    loss head as it runs (``loss_head_as_run``): ``R.run_cell``'s record,
    ``hlo_dots`` of the module, and the while loops left in it.  ``texts``
    is ``capture_modules(R)``."""
    from repro.models import scan_mode

    n = len(texts)
    with scan_mode.unrolled(), loss_head_as_run():
        rec = R.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
    if len(texts) == n:  # skipped: nothing compiled
        return rec, None, None
    return rec, hlo_dots(texts[-1]), texts[-1].count(" while(")


def _heaviest_dots(dots, top: int) -> None:
    groups = {}
    for shapes, flops in dots:
        n, total = groups.get(tuple(shapes), (0, 0))
        groups[tuple(shapes)] = (n + 1, total + flops)
    print(f"{len(dots)} dots in {len(groups)} groups by operand and result shapes; "
          f"the heaviest:")
    for shapes, (n, total) in sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {total:>20,d}  {n:>4d} x  {list(shapes)}")


def _largest_values(dump: str, top: int) -> None:
    # the step's module is the one with the most bytes (a cell may also
    # compile small helpers, e.g. RWKV6's)
    texts = []
    for path in glob.glob(os.path.join(dump, "*jit_*after_optimizations-buffer-assignment.txt")):
        with open(path) as f:
            texts.append(f.read())
    text = max(texts, key=lambda t: sum(int(n) for n in re.findall(
        r"^allocation \d+: size (\d+)", t, re.M)))
    allocs = sorted(((int(size), i, rest.strip(" ,:")) for i, size, rest in
                     re.findall(r"^allocation (\d+): size (\d+)(.*)$", text, re.M)), reverse=True)
    print(f"{len(allocs)} allocations, {sum(a[0] for a in allocs):,d} bytes; the largest:")
    for size, i, what in allocs[:4]:
        print(f"  {size:>16,d}  allocation {i}: {what[:100]}")
    block = re.search(rf"^allocation {allocs[0][1]}:.*?(?=^allocation |\Z)", text, re.M | re.S)
    values = sorted(((int(size), name, shape) for name, size, shape in re.findall(
        r"value: <\d+ ([^>]+)>.*?\(size=(\d+),offset=\d+\): (\S+)", block.group(0))),
        reverse=True)
    print(f"allocation {allocs[0][1]}'s largest values (of {len(values)}; values that "
          f"are not alive together share its bytes):")
    for size, name, shape in values[:top]:
        print(f"  {size:>16,d}  {shape}  {name}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="an id, or all")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--measure", choices=["peak", "flops", "both"], default="both",
                    help="the scanned step's peak, the unrolled step's dot FLOPs, or both")
    ap.add_argument("--top", type=int, default=24)
    ap.add_argument("--dots", type=int, default=0,
                    help="one cell: print the unrolled module's N heaviest groups of dots")
    args = ap.parse_args()

    import repro.launch.dryrun as R  # sets XLA_FLAGS (512 devices) on import
    from repro.configs import ARCH_IDS

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    peak, flops = args.measure in ("peak", "both"), args.measure in ("flops", "both")
    one = len(archs) == 1 and len(meshes) == 1
    texts = capture_modules(R)
    dump = None
    if one and peak:
        dump = tempfile.mkdtemp(prefix="xla_dump_")
        os.environ["XLA_FLAGS"] += f" --xla_dump_to={dump} --xla_dump_hlo_pass_re=NONE"
    try:
        for multi_pod in meshes:
            for arch in archs:
                out, dots = {"arch": arch, "shape": args.shape}, None
                if peak:
                    rec = R.run_cell(arch, args.shape, multi_pod=multi_pod, verbose=False)
                    out.update(mesh=rec["mesh"], status=rec["status"],
                               bytes_per_device=rec.get("bytes_per_device"))
                if flops:
                    rec, dots, loops = compiled_dots(R, texts, arch, args.shape, multi_pod)
                    out.update(mesh=rec["mesh"], status=rec["status"])
                    if dots is not None:
                        out.update(loops=loops, compile_s=rec.get("compile_s"),
                                   dot_flops_per_device=sum(f for _, f in dots),
                                   flops_per_device=rec.get("flops_per_device"))
                print(json.dumps(out), flush=True)
        if dump:
            _largest_values(dump, args.top)
        if one and dots is not None and args.dots:
            _heaviest_dots(dots, args.dots)
    finally:
        if dump:
            shutil.rmtree(dump, ignore_errors=True)


if __name__ == "__main__":
    main()
