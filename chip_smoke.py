#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of HPDedup on one CUDA card, end to end.

    python3 chip_smoke.py [--requests N] [--seed S]

Phases, one JSON line each (any failure exits non-zero; nothing is caught):

* ``device``      the card's name and power limit.
* ``build``       builds every CUDA source of ``src/repro_torch/csrc`` (one
                  ``nvcc`` each, all started together) and prints ptxas's
                  register/spill lines.
* ``fingerprint`` the fingerprint kernel against the golden digests of
                  ``tests/golden/fingerprint_digests.json`` and against its
                  plain PyTorch version on 65,536 random 4 KB blocks and odd
                  shapes, bit for bit; its time by CUDA events.
* ``fp_index``    the probe/insert/remove kernels on a 2^24-slot table filled
                  to load 0.3, against the plain versions and the host probe;
                  per-launch device times at 8,192 and 1,048,576 keys, and
                  the rate of back-to-back wrapper calls at 8,192.
* ``crossover``   the batch size from which a probe through the table on the
                  card beats the host set (``FingerprintIndex.small_batch``).
* ``replay``    the slice's main path: paper workload A (32 VM streams),
                  2,000,000 requests by default.  Each write's 4 KB block is
                  made on the card from its trace fingerprint, hashed by the
                  fingerprint kernel, and the resulting fingerprints drive
                  ``HPDedup(cache_entries=32768, device="cuda")
                  .replay_batched(trace, 8192).finish()``, which must equal the
                  same run on the host (``device="cpu"``) field for field.
                  Launch counts are zeroed just before this phase and read
                  just after: every kernel must have run on the main path.
                  The batched probes answered by the host set instead of
                  the table are counted beside them.
* ``cdc_kernels`` the Gear candidate kernel against its plain version on
                  4,096 random haloed rows at avg_size 256, 1,024 and 4,096,
                  and the fused chunk gather + fingerprint kernel against its
                  plain version on chunks of every start phase, length 1 and
                  max_size, crossing rows, reaching before the payload's
                  first byte and past its last; bit for bit.  The golden cases of
                  ``tests/golden/cdc_digests.json`` through the device backend.
* ``cdc``         the byte path at a realistic size: 32 VM images of 32 MiB
                  re-ingested in 3 edited snapshot rounds (about 4 GiB),
                  ``ContentDefinedChunker().batch_from_buffers`` once per
                  round (about 1 GiB each, ``lba_next`` carried), then the
                  chunk trace through ``HPDedup`` on the card and on the host,
                  whose reports must be equal.  The host numpy backend must
                  give the same ends and fingerprints on two sampled buffers,
                  and the byte dup ratio must lie inside ``analytic_bounds``.
                  Launch counts are zeroed just before the path and read just
                  after: the CDC kernels and the index kernels must have run.
                  Then the device time of each CDC kernel at one round's shapes.
* ``kernels``     one object per kernel: launches on the main paths (replay
                  and cdc, summed), largest disagreement with its plain
                  version (exact: 0), times, and the least time the card could
                  take for the same work.

The next-to-last line is ``nvidia-smi``'s name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published rates (NVIDIA's data sheet, at the 700 W limit):
# 3.35 TB/s of device memory.  The sheet gives no 32-bit integer rate.  The
# CUDA programming guide's throughput table (compute capability 9.0) gives
# 64 results per SM per clock for each 32-bit integer instruction class;
# Hopper runs integer multiply-adds (IMAD) on the FMA pipe and logic, shifts,
# compares and byte moves on the ALU pipe, 64 lanes each, and issues at most
# 4 warp instructions (128 thread operations) per SM per clock in all.
# 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
ALU_OPS_PER_S = 64 * SM_CLOCKS_PER_S
BOTH_PIPES_OPS_PER_S = 128 * SM_CLOCKS_PER_S

# Integer instructions counted by hand from each function's definition, as
# (ALU, IMAD) pairs: a shift-xor is a shift and an xor (2 ALU), a multiply
# and a multiply-add are one IMAD each, a rotate is one funnel shift.
# The block hash (``fingerprint_torch``), for the 4 key sets together: per
# word, xor with the lane key, shift and xor (3 ALU), multiply by P1, by P2,
# and by the lane weight added into the lane sum (3 IMAD); per 128-word
# group, the fold: rotate, xor (2 ALU), multiply-add by P3, multiply by P1
# (2 IMAD); per block, the length xor and 3 shift-xors (7 ALU) and 2
# multiplies.
FP_OPS_PER_WORD = (4 * 3, 4 * 3)
FP_OPS_PER_GROUP = (4 * 2, 4 * 2)
FP_OPS_PER_BLOCK = (4 * 7, 4 * 2)
# The Gear candidates, per payload byte: take the byte (1 ALU), the GEAR mix
# (3 shift-xors, 6 ALU; the multiply-add and 2 multiplies, 3 IMAD), the
# window as the recurrence h = 2h + g (1 IMAD), the mask test and the flag
# bit (2 ALU).
CDC_OPS_PER_BYTE = (9, 4)
# A spin of this many clocks (~0.5 ms) keeps the stream busy while the host
# enqueues the launch that ``device_ms`` times.
SPIN_CYCLES = 1_000_000
# The cdc phase's VM images: 32 streams of this base size, 3 edited rounds.
CDC_BASE_BYTES = 32 << 20

REPLACES = {
    "fingerprint": "src/repro/kernels/fingerprint.py:113",
    "fp_probe": "src/repro/kernels/fp_index.py:181",
    "fp_insert": "src/repro/kernels/fp_index.py:277",
    "fp_remove": "src/repro/kernels/fp_index.py:350",
    "cdc_candidates": "src/repro/kernels/cdc.py:112",
    "chunk_fingerprint": "src/repro/kernels/ops.py:129",
}
SOURCES = {
    "fingerprint": "src/repro_torch/csrc/fingerprint.cu",
    "fp_probe": "src/repro_torch/csrc/fp_index.cu",
    "fp_insert": "src/repro_torch/csrc/fp_index.cu",
    "fp_remove": "src/repro_torch/csrc/fp_index.cu",
    "cdc_candidates": "src/repro_torch/csrc/cdc.cu",
    "chunk_fingerprint": "src/repro_torch/csrc/cdc.cu",
}
KERNELS = tuple(SOURCES)


def ops_ms(alu: float, imad: float) -> float:
    """The least time for ``alu`` ALU-pipe and ``imad`` FMA-pipe integer
    instructions: the ALU pipe's share, or the issue limit of both."""
    return max(alu / ALU_OPS_PER_S, (alu + imad) / BOTH_PIPES_OPS_PER_S) * 1e3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events after ``warm`` untimed calls: the rate at which the host feeds
    the card, where the host is the slower of the two."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of one call of ``fn`` (one kernel launch), in ms.

    Before each call a spin kernel holds the stream busy for longer than the
    host takes to enqueue the call, so the CUDA events around it time the
    card's work alone and not the wrapper's host cost."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


# -- phases ------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    seconds = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)  # load now: a failure shows here, not mid-replay
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for name, log in _build.BUILD_LOG.items()
    }
    emit("build", seconds=seconds, ptxas=ptxas)


def _golden_blocks(kind: str, b: int, w: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros((b, w), dtype=np.uint32)
    if kind == "ones":
        return np.full((b, w), 0xDEADBEEF, dtype=np.uint32)
    if kind == "ramp":
        return (np.arange(b * w, dtype=np.uint64) % (1 << 32)).astype(np.uint32).reshape(b, w)
    i = np.arange(b, dtype=np.uint64)[:, None]
    j = np.arange(w, dtype=np.uint64)[None, :]
    v = i * np.uint64(2654435761) + j * np.uint64(40503) + np.uint64(1)
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def phase_fingerprint(dev, results: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.fingerprint import fingerprint, fingerprint_torch

    with open(os.path.join(ROOT, "tests", "golden", "fingerprint_digests.json")) as f:
        cases = json.load(f)["cases"]
    for case in cases:
        x = _golden_blocks(case["kind"], case["b"], case["w"])
        got = ops.digests_to_host(ops.fingerprint_blocks(x, device=dev))
        check(np.array_equal(got, np.asarray(case["digests"], dtype=np.uint32)),
              f"golden digests {case['kind']} {case['b']}x{case['w']}")
        hexes = [f"{int(v):016x}" for v in ops.fingerprint_ints(x, device=dev)]
        check(hexes == case["fp64_hex"], f"golden fp64 {case['kind']}")

    rng = np.random.default_rng(0)
    b, w = 65536, 1024
    x = torch.from_numpy(rng.integers(0, 2**32, size=(b, w), dtype=np.uint32).view(np.int32))
    x = x.to(dev)
    x[0] = -1  # all-ones words: every product and sum at its wrap edge
    err = (fingerprint(x).long() - fingerprint_torch(x).long()).abs().max().item()
    check(err == 0, "fingerprint kernel != plain version on 65536 x 1024")
    odd = [(1, 1024), (257, 1024), (300, 128), (300, 2048)]
    for ob, ow in odd:
        y = x[:ob, :ow].contiguous() if ow <= w else torch.cat([x[:ob], x[:ob]], dim=1)
        e = (fingerprint(y).long() - fingerprint_torch(y).long()).abs().max().item()
        check(e == 0, f"fingerprint kernel != plain at {ob}x{ow}")
        err = max(err, e)
    x8 = torch.from_numpy(rng.integers(0, 256, size=(300, 4095), dtype=np.uint8)).to(dev)
    words = ops.as_words(x8)
    e = (fingerprint(words).long() - fingerprint_torch(words).long()).abs().max().item()
    check(e == 0, "fingerprint kernel != plain on uint8 length 4095")

    ms = device_ms(lambda: fingerprint(x), reps=30)
    per_call_ms = cuda_ms(lambda: fingerprint(x), reps=50)
    plain_ms = cuda_ms(lambda: fingerprint_torch(x), reps=3, warm=1)
    bytes_moved = b * w * 4 + b * 16
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(*(b * (w * pw + w // 128 * pg + pb)
                     for pw, pg, pb in zip(FP_OPS_PER_WORD, FP_OPS_PER_GROUP, FP_OPS_PER_BLOCK)))
    results["fingerprint"] = dict(
        max_abs_err=max(err, e), ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
        shape=[b, w], per_call_ms=per_call_ms, bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
    )
    emit("fingerprint", golden_cases=len(cases), blocks=b, words=w, odd_shapes=odd,
         uint8_len=4095, agree=True, ms=ms, per_call_ms=per_call_ms,
         ns_per_block=ms * 1e6 / b, plain_ms=plain_ms, bytes_bound_ms=t_bytes,
         ops_bound_ms=t_ops, gb_per_s=bytes_moved / ms / 1e6)


def _index_bytes(name: str, t64: np.ndarray, keys: np.ndarray, cap: int) -> int:
    """Bytes that ``name`` must move for ``keys`` on the table ``t64``.

    Each key is read once (8 B).  Of its window, the 32-byte sectors from the
    home slot to the slot that decides the key: the key's own slot, or the
    first EMPTY one (no key sits past a slot that was EMPTY when it came, so
    a probe, a remove and an insert's absence check may stop there); the
    whole window where neither comes.  Then the flag (1 B) or status (4 B)
    written, and for insert and remove the one slot written (8 B)."""
    from repro_torch.kernels.fp_index import WINDOW, phys_homes_host

    home = phys_homes_host(keys, cap)
    win = t64[home[:, None] + np.arange(WINDOW)]
    stop = (win == keys[:, None]) | (win == 0)
    last = np.where(stop.any(axis=1), stop.argmax(axis=1), WINDOW - 1)
    sectors = (home + last) * 8 // 32 - home * 8 // 32 + 1
    out = {"fp_probe": 1, "fp_insert": 4 + 8, "fp_remove": 1 + 8}[name]
    return int(keys.size * (8 + out) + 32 * sectors.sum())


def phase_fp_index(dev, results: dict) -> None:
    from repro_torch.kernels import fp_index as k
    from repro_torch.kernels.ops import keys_to_device

    cap = 1 << 24
    slots = k.table_phys_len(cap)
    rng = np.random.default_rng(1)
    n = int(0.3 * cap)
    keys = np.unique(rng.integers(1, 2**64 - 1, size=n + n // 50, dtype=np.uint64))[:n]
    rng.shuffle(keys)
    batch = np.concatenate([keys, keys[: n // 20]])  # later copies: PRESENT
    kt = keys_to_device(batch, dev)

    table = torch.zeros(slots, dtype=torch.int64, device=dev)
    plain = torch.zeros(slots, dtype=torch.int64, device=dev)
    st = k.fp_insert(kt, table, cap)
    st_plain = k.fp_insert_torch(kt, plain, cap)
    counts = torch.bincount(st.long(), minlength=4).tolist()
    counts_plain = torch.bincount(st_plain.long(), minlength=4).tolist()
    check(counts[k.PRESENT] == counts_plain[k.PRESENT], f"PRESENT {counts} vs {counts_plain}")
    placed_sum = counts[k.PLACED] + counts[k.PLACED_TOMB] + counts[k.OVERFLOW]
    check(placed_sum == counts_plain[k.PLACED] + counts_plain[k.PLACED_TOMB]
          + counts_plain[k.OVERFLOW], "placed + overflow totals")
    ins_err = abs(counts[k.PRESENT] - counts_plain[k.PRESENT])

    t64 = table.cpu().numpy().view(np.uint64)
    occupied = t64[(t64 != 0) & (t64 != np.uint64(2**64 - 1))]
    check(occupied.size == np.unique(occupied).size, "duplicate keys in the kernel's table")
    placed = st[: keys.size].cpu().numpy()
    in_table = (placed == k.PLACED) | (placed == k.PLACED_TOMB)
    check(occupied.size == int(in_table.sum()), "table holds exactly the placed keys")

    absent = rng.integers(1, 2**64 - 1, size=keys.size, dtype=np.uint64)
    absent = absent[~np.isin(absent, keys)]
    probe = np.concatenate([keys, absent])
    truth = np.concatenate([in_table, np.zeros(absent.size, dtype=bool)])
    pt = keys_to_device(probe, dev)
    got = k.fp_probe(pt, table, cap)
    got_np = got.cpu().numpy()
    check(np.array_equal(got_np, truth), "probe kernel != truth")
    probe_err = int((got != k.fp_probe_torch(pt, table, cap)).sum().item())
    check(probe_err == 0, "probe kernel != plain probe")
    check(np.array_equal(k.probe_host(t64, probe, cap), truth), "host early-stop probe")

    gone = keys[in_table][: 1 << 20]
    removed = k.fp_remove(keys_to_device(gone, dev), table, cap)
    check(bool(removed.all().item()), "remove kernel missed resident keys")
    check(not bool(k.fp_probe(keys_to_device(gone, dev), table, cap).any().item()),
          "removed keys still probe present")
    # the plain remove on the plain table flags the same keys
    removed_plain = k.fp_remove_torch(keys_to_device(gone, dev), plain, cap)
    rem_err = int((removed != removed_plain).sum().item())
    check(rem_err == 0, "remove kernel != plain remove")

    # per-launch times: inserts take fresh keys and removes resident ones, a
    # distinct slice per launch, each timing on its own copy of the filled
    # table; ``ms`` is the device time of one launch, ``per_call_ms`` the
    # rate of back-to-back wrapper calls (8,192 keys only)
    t64 = table.cpu().numpy().view(np.uint64)  # after the removes above
    resident = keys[in_table][1 << 20:]  # the first 2^20 were removed above
    times, bounds = {}, {}
    for size, reps, warm, call_reps, plain_reps in ((8192, 30, 2, 50, 5), (1 << 20, 2, 1, 0, 2)):
        n_slices = max(reps + warm, call_reps + 3)
        fresh_np = rng.integers(1, 2**64 - 1, size=size * n_slices, dtype=np.uint64)
        res_np = resident[: size * n_slices]
        check(res_np.size == size * n_slices, "enough resident keys to time removes")
        fresh, res = keys_to_device(fresh_np, dev), keys_to_device(res_np, dev)
        probe_keys = res[:size]

        def sliced(op, src, tbl, size=size):
            it = iter(range(1 << 30))

            def run():
                i = next(it)
                op(src[i * size:(i + 1) * size], tbl, cap)

            return run

        entry = {
            "fp_probe": device_ms(lambda: k.fp_probe(probe_keys, table, cap), reps, warm),
            "fp_insert": device_ms(sliced(k.fp_insert, fresh, table.clone()), reps, warm),
            "fp_remove": device_ms(sliced(k.fp_remove, res, table.clone()), reps, warm),
        }
        if call_reps:
            entry["per_call"] = {
                "fp_probe": cuda_ms(lambda: k.fp_probe(probe_keys, table, cap), call_reps),
                "fp_insert": cuda_ms(sliced(k.fp_insert, fresh, table.clone()), call_reps),
                "fp_remove": cuda_ms(sliced(k.fp_remove, res, table.clone()), call_reps),
            }
        pr, pw = min(plain_reps, reps), 1
        entry["plain"] = {
            "fp_probe": cuda_ms(lambda: k.fp_probe_torch(probe_keys, plain, cap), pr, pw),
            "fp_insert": cuda_ms(sliced(k.fp_insert_torch, fresh, plain.clone()), pr, pw),
            "fp_remove": cuda_ms(sliced(k.fp_remove_torch, res, plain.clone()), pr, pw),
        }
        times[size] = entry
        # the bound of one timed launch: the mean over the timed slices, each
        # counted on the table as it stood before the timing
        timed = slice(warm * size, (warm + reps) * size)
        bounds[size] = {
            "fp_probe": _index_bytes("fp_probe", t64, res_np[:size], cap),
            "fp_insert": _index_bytes("fp_insert", t64, fresh_np[timed], cap) / reps,
            "fp_remove": _index_bytes("fp_remove", t64, res_np[timed], cap) / reps,
        }
    for name in ("fp_probe", "fp_insert", "fp_remove"):
        results[name] = dict(
            max_abs_err={"fp_probe": probe_err, "fp_insert": ins_err, "fp_remove": rem_err}[name],
            ms=times[8192][name], plain_ms=times[8192]["plain"][name],
            bound_ms=bounds[8192][name] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, keys_per_launch=8192, per_call_ms=times[8192]["per_call"][name],
            ms_at_1m=times[1 << 20][name], plain_ms_at_1m=times[1 << 20]["plain"][name],
            bound_ms_at_1m=bounds[1 << 20][name] / HBM_BYTES_PER_S * 1e3,
        )
    emit("fp_index", capacity=cap, table_mb=slots * 8 / 2**20, keys=int(keys.size),
         load=keys.size / cap, status_counts=counts, plain_status_counts=counts_plain,
         probed=int(probe.size), removed=int(gone.size), agree=True,
         ms={str(s): v for s, v in times.items()})
    del table, plain
    torch.cuda.empty_cache()


def phase_crossover(dev) -> None:
    """Where a batched probe through the table on the card starts to beat
    the host set's answer.  ``FingerprintIndex.contains_many`` on an index
    of 2^19 keys (the replay's seen set ends near that size), half of each
    batch resident, timed on the host clock from the call to the flags on
    the host (key copy, launch, flag copy back), against the same call
    routed to the host set.  Median of 15 calls per size and route."""
    from repro_torch.core.fp_index import SMALL_BATCH_CARD, FingerprintIndex

    rng = np.random.default_rng(2)
    keys = rng.integers(1, 2**64 - 1, size=1 << 19, dtype=np.uint64)
    idx = FingerprintIndex(device=dev)
    idx.add_many(keys)
    sizes = (64, 128, 256, 512, 768, 1024, 1536, 2048, 3072, 4096, 8192)
    ms = {}
    for n in sizes:
        probe = np.concatenate([rng.choice(keys, n // 2),
                                rng.integers(1, 2**64 - 1, size=n - n // 2, dtype=np.uint64)])
        row = {}
        for route, small in (("host", n), ("card", 0)):
            idx.small_batch = small
            want = idx.contains_many(probe)  # warm; also folds the staged keys
            t = []
            for _ in range(15):
                t0 = time.perf_counter()
                got = idx.contains_many(probe)
                t.append(time.perf_counter() - t0)
            check(np.array_equal(got, want), f"crossover probe at {n} keys")
            row[route] = float(np.median(t)) * 1e3
        ms[str(n)] = row
    crossover = next((n for n in sizes if ms[str(n)]["card"] <= ms[str(n)]["host"]), None)
    emit("crossover", index_keys=int(keys.size), small_batch=SMALL_BATCH_CARD, ms=ms,
         card_wins_from=crossover)


def _block_content(fps: torch.Tensor, w: int) -> torch.Tensor:
    """(n, w) int32 block words made from each block's 64-bit trace
    fingerprint by an integer mix: equal fingerprints, equal content.  Every
    product is a 32-bit value times a constant below 2^31, so int64 never
    overflows."""
    m = 0xFFFFFFFF
    lo, hi = fps & m, (fps >> 32) & m
    j = torch.arange(w, dtype=torch.int64, device=fps.device)
    x = (lo[:, None] ^ ((j * 0x27D4EB2D) & m)) & m
    x = (x * 0x045D9F3B) & m
    x = x ^ (x >> 16) ^ hi[:, None]
    x = (x * 0x045D9F3B) & m
    x = x ^ (x >> 16)
    return (x - ((x >> 31) << 32)).to(torch.int32)


def phase_replay(dev, results: dict, requests: int, seed: int) -> None:
    from repro_torch.core import OP_WRITE, HPDedup, fp_index, generate_workload
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.ops import keys_to_device

    t0 = time.perf_counter()
    trace, streams = generate_workload("A", total_requests=requests, seed=seed)
    gen_s = time.perf_counter() - t0
    writes = np.nonzero(trace["op"] == OP_WRITE)[0]
    trace_fps = trace["fp"][writes]

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk = 65536
    content_fps = np.empty(writes.size, dtype=np.uint64)
    src = keys_to_device(trace_fps, dev)
    for a in range(0, writes.size, chunk):
        blocks = _block_content(src[a:a + chunk], 1024)
        content_fps[a:a + chunk] = ops.fingerprint_ints(blocks)
    torch.cuda.synchronize()
    hash_s = time.perf_counter() - t0
    check(np.unique(trace_fps).size == np.unique(content_fps).size,
          "content fingerprints collide (unique counts differ)")
    pairs = np.unique(np.stack([trace_fps, content_fps], axis=1), axis=0).shape[0]
    check(pairs == np.unique(trace_fps).size, "content fingerprints are not one per trace fp")
    hashed = trace.copy()
    hashed["fp"][writes] = content_fps

    fp_index.reset_probe_routes()
    t0 = time.perf_counter()
    card = HPDedup(cache_entries=32768, device=dev)
    card.replay_batched(hashed, 8192)
    rep_card = card.finish()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    routes = dict(fp_index.PROBE_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("fingerprint", "fp_probe", "fp_insert", "fp_remove"):
        check(launches[name] > 0, f"kernel {name} never launched on the replay path")

    t0 = time.perf_counter()
    host = HPDedup(cache_entries=32768, device="cpu")
    host.replay_batched(hashed, 8192)
    rep_host = host.finish()
    host_s = time.perf_counter() - t0
    check(dataclasses.asdict(rep_card) == dataclasses.asdict(rep_host),
          "HybridReport on the card != on the host")
    indexes = {
        "seen_fps": card._seen_fps,
        "cache": card.inline.cache.index,
        "store": card.store.fp_index,
    }
    for name, idx in indexes.items():
        check(idx.table_stats()["backend"] == "torch", f"{name} index is not on the card")
        idx.check_consistency()
    host._seen_fps.check_consistency()
    card.store.check_consistency()
    for name, n in launches.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})["replay"] = n
    emit("replay", workload="A", streams=len(streams), requests=int(trace.size),
         writes=int(writes.size), unique_fps=int(np.unique(trace_fps).size), seed=seed,
         generate_s=gen_s, hash_s=hash_s, replay_card_s=card_s,
         requests_per_s_card=trace.size / card_s, replay_host_s=host_s,
         requests_per_s_host=trace.size / host_s, inline_dedup_ratio=rep_card.inline_dedup_ratio,
         final_disk_blocks=rep_card.final_disk_blocks, peak_disk_blocks=rep_card.peak_disk_blocks,
         reports_equal=True, launches=launches, probe_routes=routes, max_memory_allocated=peak,
         index_capacity={n: i.table_stats()["capacity"] for n, i in indexes.items()})


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def phase_cdc_kernels(dev, results: dict) -> None:
    from repro_torch.core import ContentDefinedChunker
    from repro_torch.kernels.cdc import SEG_BYTES, cdc_candidates, cdc_candidates_torch
    from repro_torch.kernels.ops import chunk_fingerprint, chunk_fingerprint_torch
    from repro_torch.kernels.ref import cdc_golden_buffer

    rng = np.random.default_rng(3)
    r, n_chunks = 4096, 20_000
    x = rng.integers(0, 2**32, size=(r, 520), dtype=np.uint32)
    x[0], x[1] = 0, 0xFFFFFFFF  # zero bytes (GEAR[0] != 0) and all-ones bytes
    rows = torch.from_numpy(x.view(np.int32)).to(dev)
    cand_err = 0
    for avg in (256, 1024, 4096):
        e = _max_err(cdc_candidates(rows, avg), cdc_candidates_torch(rows, avg))
        check(e == 0, f"cdc_candidates kernel != plain at avg_size {avg}")
        cand_err = max(cand_err, e)

    total = r * SEG_BYTES
    chunk_err = 0
    for w_pad in (1024, 4096):
        max_size = 4 * w_pad
        lens = rng.integers(1, max_size + 1, size=n_chunks)
        starts = rng.integers(0, total - max_size, size=n_chunks)
        # every start phase mod 4, length 1 and max_size, the payload's ends;
        # bytes before offset 0 and past the payload read as zero
        lens[:11] = [1, max_size, 2, 3, 4, 5, max_size, 5, 7, max_size, max_size]
        starts[:11] = [0, 1, 2, 3, 2046, 2047, total - max_size, total - 5, -3, -2049,
                       total - 1001]
        st = torch.from_numpy(starts.astype(np.int64)).to(dev)
        ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
        e = _max_err(chunk_fingerprint(rows, st, ln, w_pad),
                     chunk_fingerprint_torch(rows, st, ln, w_pad))
        check(e == 0, f"chunk_fingerprint kernel != plain at w_pad {w_pad}")
        chunk_err = max(chunk_err, e)

    with open(os.path.join(ROOT, "tests", "golden", "cdc_digests.json")) as f:
        golden = json.load(f)
    ck = ContentDefinedChunker(*golden["cfg"], device=dev)
    for case in golden["cases"]:
        ends, fps = ck.chunk_fingerprints(cdc_golden_buffer(case["name"], case["n"], case["salt"]))
        check(ends.tolist() == case["ends"], f"golden CDC ends {case['name']} {case['n']}")
        check([f"{int(v):016x}" for v in fps] == case["fp64_hex"],
              f"golden CDC fingerprints {case['name']} {case['n']}")
    results.setdefault("cdc_candidates", {})["max_abs_err"] = cand_err
    results.setdefault("chunk_fingerprint", {})["max_abs_err"] = chunk_err
    emit("cdc_kernels", rows=r, avg_sizes=[256, 1024, 4096], chunks=n_chunks,
         w_pads=[1024, 4096], golden_cases=len(golden["cases"]), agree=True)


def phase_cdc(dev, results: dict, seed: int) -> None:
    """The byte path: snapshot re-ingestion of 32 VM images, one
    ``batch_from_buffers`` call per round, replayed through ``HPDedup``."""
    from repro_torch.core import ContentDefinedChunker, HPDedup, fp_index, trace_stats
    from repro_torch.core.cdc import chunk_starts
    from repro_torch.data import analytic_bounds, batches_trace, vm_image_workload
    from repro_torch.kernels import _build
    from repro_torch.kernels.cdc import SEG_BYTES, cdc_candidates, cdc_candidates_torch, pack_haloed
    from repro_torch.kernels.ops import chunk_fingerprint, chunk_fingerprint_torch

    streams = 32
    t0 = time.perf_counter()
    w = vm_image_workload(num_streams=streams, base_size=CDC_BASE_BYTES, versions=3,
                          edits_per_version=8, edit_size=2048, seed=seed)
    generate_s = time.perf_counter() - t0
    rounds = [(w.stream_ids[a:a + streams], w.buffers[a:a + streams])
              for a in range(0, len(w.buffers), streams)]

    chunker = ContentDefinedChunker(device=dev)  # 2048 / 4096 / 16384
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    fp_index.reset_probe_routes()
    lba_next: dict = {}
    batches, lens_per, call_s = [], [], []
    for sids, bufs in rounds:
        t0 = time.perf_counter()
        batch, lens = chunker.batch_from_buffers(sids, bufs, lba_next=lba_next)
        call_s.append(time.perf_counter() - t0)
        batches.append(batch)
        lens_per.append(lens)
    ingest_s = sum(call_s)
    ingest_peak = torch.cuda.max_memory_allocated()

    lens = np.concatenate(lens_per)
    trace = batches_trace(batches)

    t0 = time.perf_counter()
    card = HPDedup(cache_entries=32768, device=dev)
    card.replay_batched(trace, 8192)
    rep_card = card.finish()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    routes = dict(fp_index.PROBE_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("cdc_candidates", "chunk_fingerprint", "fp_probe", "fp_insert", "fp_remove"):
        check(launches[name] > 0, f"kernel {name} never launched on the cdc path")

    t0 = time.perf_counter()
    host = HPDedup(cache_entries=32768, device="cpu")
    host.replay_batched(trace, 8192)
    rep_host = host.finish()
    host_s = time.perf_counter() - t0
    check(dataclasses.asdict(rep_card) == dataclasses.asdict(rep_host),
          "HybridReport of the chunk trace on the card != on the host")
    card.store.check_consistency()

    stats = trace_stats(trace, chunk_bytes=lens)
    lower, upper = analytic_bounds(w, chunker.config.max_size)
    check(lower <= stats["byte_dup_ratio"] <= upper,
          f"byte dup ratio {stats['byte_dup_ratio']} outside [{lower}, {upper}]")

    # the host numpy backend on stream 0's base image and its first version
    sample = [0, streams]
    t0 = time.perf_counter()
    on_host = ContentDefinedChunker(backend="numpy", device="cpu").chunk_fingerprints_many(
        [w.buffers[i] for i in sample])
    numpy_s = time.perf_counter() - t0
    for i, (ends, fps) in zip(sample, on_host):
        rnd, sid = divmod(i, streams)
        mine = batches[rnd].stream == sid
        check(np.array_equal(np.cumsum(lens_per[rnd][mine]), ends),
              f"chunk ends of buffer {i}: card != host numpy")
        check(np.array_equal(batches[rnd].fp[mine], fps),
              f"chunk fingerprints of buffer {i}: card != host numpy")

    # device time of each kernel at the last round's shapes, against its plain
    # version on the same inputs (which it must equal there too)
    sids, bufs = rounds[-1]
    haloed, spans = pack_haloed(bufs)
    rows = torch.from_numpy(haloed.view(np.int32)).to(dev)
    del haloed
    counts = np.bincount(batches[-1].stream, minlength=streams)
    ends_per = [np.cumsum(l) for l in np.split(lens_per[-1], np.cumsum(counts)[:-1])]
    starts, clens = chunk_starts(spans, ends_per)
    st = torch.from_numpy(starts).to(dev)
    ln = torch.from_numpy(clens.astype(np.int32)).to(dev)
    avg, w_pad = chunker.config.avg_size, chunker.config.max_size // 4
    timed = {}
    for name, kernel, plain in (
            ("cdc_candidates", lambda: cdc_candidates(rows, avg),
             lambda: cdc_candidates_torch(rows, avg)),
            ("chunk_fingerprint", lambda: chunk_fingerprint(rows, st, ln, w_pad),
             lambda: chunk_fingerprint_torch(rows, st, ln, w_pad))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        e = _max_err(kernel(), want)
        check(e == 0, f"{name} kernel != plain at the cdc path's shapes")
        del want
        timed[name] = (device_ms(kernel, reps=10), plain_ms, e)

    r = rows.shape[0]
    c = int(clens.size)
    data_groups = int(((clens + 511) // 512).sum())
    work = {
        "cdc_candidates": (r * (520 + 512) * 4, [r * SEG_BYTES * o for o in CDC_OPS_PER_BYTE]),
        "chunk_fingerprint": (
            int(clens.sum()) + c * (8 + 4 + 16),
            [data_groups * 128 * pw + c * (w_pad // 128) * pg + c * pb
             for pw, pg, pb in zip(FP_OPS_PER_WORD, FP_OPS_PER_GROUP, FP_OPS_PER_BLOCK)]),
    }
    for name, (nbytes, nops) in work.items():
        ms, plain_ms, e = timed[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ms(*nops)
        results[name].update(
            max_abs_err=max(results[name]["max_abs_err"], e), ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
            shape={"rows": r, "chunks": c, "payload_bytes": int(sum(b.size for b in bufs))},
        )
    for name, n in launches.items():
        results[name].setdefault("launches_by_path", {})["cdc"] = n
    del rows, st, ln
    torch.cuda.empty_cache()

    stage = chunker.stage_seconds
    emit("cdc", streams=streams, base_bytes=CDC_BASE_BYTES, rounds=len(rounds), seed=seed,
         bytes=w.total_bytes, chunks=int(lens.size), calls=len(call_s), call_s=call_s,
         generate_s=generate_s, pack_s=stage["pack"], upload_s=stage["upload"],
         candidates_s=stage["candidates"], select_s=stage["select"],
         chunk_fp_s=stage["chunk_fp"], candidates_ms=timed["cdc_candidates"][0],
         chunk_fp_ms=timed["chunk_fingerprint"][0], ingest_s=ingest_s,
         bytes_per_s=w.total_bytes / ingest_s, replay_card_s=card_s,
         requests_per_s_card=lens.size / card_s, replay_host_s=host_s,
         requests_per_s_host=lens.size / host_s, reports_equal=True,
         dup_ratio=stats["dup_ratio"], byte_dup_ratio=stats["byte_dup_ratio"],
         bounds=[lower, upper], boundary_events=w.boundary_events,
         chunk_size_mean=stats["chunk_size_mean"], inline_dedup_ratio=rep_card.inline_dedup_ratio,
         final_disk_blocks=rep_card.final_disk_blocks, numpy_sample_s=numpy_s,
         sampled_buffers_equal=True, launches=launches, probe_routes=routes,
         max_memory_allocated=peak, ingest_max_memory_allocated=ingest_peak)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--requests", type=int, default=2_000_000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    results: dict = {}
    phase_fingerprint(dev, results)
    phase_fp_index(dev, results)
    phase_crossover(dev)
    phase_replay(dev, results, args.requests, args.seed)
    phase_cdc_kernels(dev, results)
    phase_cdc(dev, results, args.seed)
    for name in KERNELS:
        results[name]["launches"] = sum(results[name]["launches_by_path"].values())
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "agree": True, **results[name]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
