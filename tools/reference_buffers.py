"""The reference's compiled step per device, from its own dry run: the
``memory_analysis`` peak of each cell, and what the largest is made of
(XLA's buffer assignment).

Runs ``repro.launch.dryrun.run_cell`` (jax, 512 forced host devices, the
cell's step scanned as the reference's dry run compiles it) and prints
each cell's ``bytes_per_device``.  For one cell (``--arch`` an id) it also
dumps the compiled module and prints its allocations and the largest
values of its largest allocation (the preallocated temp), by shape and
name.  The counterpart on the port's side is ``python -m
repro_torch.launch.dryrun --arch A --shape S --peak-live``.

Usage:
  PYTHONPATH=src python tools/reference_buffers.py --arch tinyllama-1.1b
  PYTHONPATH=src python tools/reference_buffers.py --arch all --mesh both
"""

import argparse
import glob
import json
import os
import re
import shutil
import tempfile


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
    ap.add_argument("--top", type=int, default=24)
    args = ap.parse_args()

    import repro.launch.dryrun as R  # sets XLA_FLAGS (512 devices) on import
    from repro.configs import ARCH_IDS

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    dump = None
    if len(archs) == 1 and len(meshes) == 1:
        dump = tempfile.mkdtemp(prefix="xla_dump_")
        os.environ["XLA_FLAGS"] += f" --xla_dump_to={dump} --xla_dump_hlo_pass_re=NONE"
    try:
        for multi_pod in meshes:
            for arch in archs:
                rec = R.run_cell(arch, args.shape, multi_pod=multi_pod, verbose=False)
                print(json.dumps({"arch": arch, "shape": args.shape, "mesh": rec["mesh"],
                                  "status": rec["status"],
                                  "bytes_per_device": rec.get("bytes_per_device")}), flush=True)
        if dump:
            _largest_values(dump, args.top)
    finally:
        if dump:
            shutil.rmtree(dump, ignore_errors=True)


if __name__ == "__main__":
    main()
