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
                  to load 0.3, against the plain versions and the host probe
                  (resident keys, absent keys and both sentinel keys); a
                  removal of 2^20 keys, 4,096 of them twice: one flag per
                  key and the same membership as the plain version's;
                  per-launch device times at 8,192 and 1,048,576 keys (the
                  probe also on a batch half resident, half absent), the
                  rate of back-to-back wrapper calls at 8,192, and an empty
                  launch timed alike (``empty_launch_ms``, the floor under a
                  launch).  Then a contention case: 8,192 keys made of 64
                  distinct keys, 128 copies each, into the filled table; the
                  insert kernel's status counts must equal the plain
                  version's (64 placed or overflowed, the rest PRESENT); its
                  device time.  Then the table the replay's index ends at
                  (2^19 keys in 2^21 slots, 17 MB): the same checks, times at
                  8,192 and 131,072 keys (a probe also at 2^19, half
                  resident), and the device time of the main
                  path's launches, whose keys (and the insert's and
                  remove's results) lie in pinned host memory.
* ``fp_index_call`` where the host time of one index call at 8,192 keys
                  goes: each step of the launch path alone, and each wrapper
                  and ``ops.fp_index_*`` helper whole.
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
                  plain version, bit for bit, on random chunks and the edge
                  families of ``kernels.ref.chunk_edge_cases`` (every start
                  phase; lengths about 1, 512, a batch of groups and
                  max_size; 1 to 8 row halos crossed; the payload's last
                  byte; bytes before offset 0 and past the payload), over
                  random, zero and 0xFF bytes, and on 200,000 chunks of
                  uneven lengths; two calls must give equal bits.  The
                  golden cases of ``tests/golden/cdc_digests.json`` through
                  the device backend.
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
* ``ffh``         the FFH kernel through ``ops.ffh_counts`` on 2^24 seeded
                  heavy-tailed counts (zeros, negatives, counts past the last
                  bin) at nbins 1, 40 and 128, and on the occurrence counts of
                  the replay's fingerprints at nbins 40: exact against the
                  plain version and ``core.ffh.ffh_from_counts`` on the host;
                  device time beside ``torch.bincount``'s.
* ``serve``       the KV-page dedup server on TinyLlama-1.1B at full width
                  (22 layers, d 2048, random float32 weights from ``--seed``,
                  bf16 compute): 32 requests of ``launch/serve.py``'s mix (a
                  chat tenant's 96-token shared prompt + 16 unique tokens,
                  a batch tenant's 112 one-off tokens), 8 decode steps and
                  ``run_postprocess``, then the same requests through a server
                  that caches nothing.  Decoded tokens and the caches of the
                  last request and of the last chat request must be equal, bit
                  for bit; 90 of 224 blocks skipped; the store consistent.
* ``paged_attention`` the paged decode kernel at TinyLlama's decode shape
                  (64 rows of up to 2,048 tokens, bf16, the first 1,024 tokens'
                  pages shared by every row, lengths 0 and 2,048 included; and
                  float32 at 8 rows; and 8 bf16 rows all at 2,048 tokens,
                  the long-row case), then over the ``serve`` phase's own page
                  pool (layers 0 and 21, each request's table from its LBAs'
                  PBAs), against the plain version (bf16 atol/rtol 0.05,
                  float32 atol 3e-5); two calls on each case must give equal
                  bits; device time beside the SDPA call's, and the pages
                  per split the kernel used.
* ``kernels``     one object per kernel: launches on the main paths (replay,
                  cdc, serve, ffh and the paged pool, summed), largest
                  disagreement with its plain version, times, and the least
                  time the card could take for the same work; for the chunk
                  kernel also ptxas's registers and spill bytes.

The next-to-last line is ``nvidia-smi``'s name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
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
# Dense tensor-core rate of one H100 SXM in bf16 (the data sheet), and its
# float32 rate outside the tensor cores.
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

REPLACES = {
    "fingerprint": "src/repro/kernels/fingerprint.py:113",
    "fp_probe": "src/repro/kernels/fp_index.py:181",
    "fp_insert": "src/repro/kernels/fp_index.py:277",
    "fp_remove": "src/repro/kernels/fp_index.py:350",
    "cdc_candidates": "src/repro/kernels/cdc.py:112",
    "chunk_fingerprint": "src/repro/kernels/ops.py:129",
    "ffh": "src/repro/kernels/histogram.py:44",
    "paged_attention": "src/repro/kernels/paged_attention.py:84",
}
SOURCES = {
    "fingerprint": "src/repro_torch/csrc/fingerprint.cu",
    "fp_probe": "src/repro_torch/csrc/fp_index.cu",
    "fp_insert": "src/repro_torch/csrc/fp_index.cu",
    "fp_remove": "src/repro_torch/csrc/fp_index.cu",
    "cdc_candidates": "src/repro_torch/csrc/cdc.cu",
    "chunk_fingerprint": "src/repro_torch/csrc/cdc.cu",
    "ffh": "src/repro_torch/csrc/histogram.cu",
    "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
}
KERNELS = tuple(SOURCES)


def ops_ms(alu: float, imad: float) -> float:
    """The least time for ``alu`` ALU-pipe and ``imad`` FMA-pipe integer
    instructions: the ALU pipe's share, or the issue limit of both."""
    return max(alu / ALU_OPS_PER_S, (alu + imad) / BOTH_PIPES_OPS_PER_S) * 1e3


def ptxas_usage(source: str, kernel: str) -> dict:
    """Registers and spill bytes ptxas reported for ``kernel`` in
    ``csrc/<source>.cu`` (``_build.BUILD_LOG``)."""
    from repro_torch.kernels import _build

    lines = _build.BUILD_LOG.get(source, "").splitlines()
    start = next((i for i, ln in enumerate(lines) if "Compiling entry" in ln and kernel in ln),
                 None)
    check(start is not None, f"no ptxas report for {kernel} in the build log of {source}.cu")
    body = []
    for ln in lines[start + 1:]:
        if "Compiling entry" in ln:
            break
        body.append(ln)
    text = " ".join(body)
    regs = re.search(r"Used (\d+) registers", text)
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    check(regs is not None and spills is not None,
          f"cannot read registers and spills of {kernel} ({source}.cu) from: {text}")
    return {"registers": int(regs.group(1)), "spill_store_bytes": int(spills.group(1)),
            "spill_load_bytes": int(spills.group(2))}


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


TOMB_KEY = (1 << 64) - 1


def _mixed(rng, resident: np.ndarray, absent: np.ndarray, size: int) -> np.ndarray:
    """``size`` keys, half resident and half absent, shuffled."""
    out = np.concatenate([resident[: size // 2], absent[: size - size // 2]])
    rng.shuffle(out)
    return out


def _check_probes(k, dev, table, cap: int, resident: np.ndarray, absent: np.ndarray,
                  what: str) -> int:
    """The probe kernel on resident keys, absent keys and both sentinels
    against the truth, the plain version and the host early-stop probe."""
    from repro_torch.kernels.ops import keys_to_device

    probe = np.concatenate([resident, absent, np.array([0, TOMB_KEY], dtype=np.uint64)])
    truth = np.concatenate([np.ones(resident.size, bool), np.zeros(absent.size, bool)])
    pt = keys_to_device(probe, dev)
    got = k.fp_probe(pt, table, cap).cpu().numpy()
    check(np.array_equal(got[:-2], truth), f"{what}: probe kernel != truth")
    err = int((got != k.fp_probe_torch(pt, table, cap).cpu().numpy()).sum())
    check(err == 0, f"{what}: probe kernel != plain probe (sentinels included)")
    t64 = table.cpu().numpy().view(np.uint64)
    check(np.array_equal(k.probe_host(t64, probe, cap), got), f"{what}: host early-stop probe")
    return err


def _check_removes(k, dev, table, plain, cap: int, resident: np.ndarray, n_gone: int,
                   n_repeats: int, absent: np.ndarray, what: str, host_keys: bool = False):
    """Remove the first ``n_gone`` of ``resident`` (keys in both tables; the
    first ``n_repeats`` of them twice, and absent keys) on the kernel's table,
    through ``fp_remove`` or, with ``host_keys``, through the main path's
    ``ops.fp_index_remove``, and on the plain version's.  Returns the removed
    keys and the disagreement: the difference of the flag counts, the keys
    flagged by one and not the other, and the keys whose membership differs
    afterwards; it must be 0, with one flag per removed key."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import keys_to_device

    gone = resident[:n_gone]
    batch = np.concatenate([gone, gone[:n_repeats], absent])
    np.random.default_rng(7).shuffle(batch)
    bt = keys_to_device(batch, dev)
    if host_keys:
        removed = ops.fp_index_remove(batch, table, cap)
    else:
        removed = k.fp_remove(bt, table, cap).cpu().numpy()
    removed_plain = k.fp_remove_torch(bt, plain, cap).cpu().numpy()
    every = keys_to_device(np.concatenate([resident, absent]), dev)
    member = k.fp_probe(every, table, cap)
    err = (abs(int(removed.sum()) - int(removed_plain.sum()))
           + np.setxor1d(batch[removed], batch[removed_plain]).size
           + int((member != k.fp_probe_torch(every, plain, cap)).sum()))
    check(err == 0, f"{what}: remove flags or membership differ from the plain version's "
                    f"({err} disagreements)")
    # each removed key flagged once, on one of its copies
    check(np.array_equal(np.sort(batch[removed]), np.sort(gone)),
          f"{what}: remove flagged other keys, or a key twice")
    check(int(member.sum()) == resident.size - gone.size, f"{what}: removed keys still present")
    return gone, err


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
    occupied = t64[(t64 != 0) & (t64 != np.uint64(TOMB_KEY))]
    check(occupied.size == np.unique(occupied).size, "duplicate keys in the kernel's table")
    placed = st[: keys.size].cpu().numpy()
    in_table = (placed == k.PLACED) | (placed == k.PLACED_TOMB)
    check(occupied.size == int(in_table.sum()), "table holds exactly the placed keys")
    both = in_table & (st_plain[: keys.size].cpu().numpy() != k.OVERFLOW)  # in both tables

    absent = rng.integers(1, 2**64 - 1, size=keys.size, dtype=np.uint64)
    absent = absent[~np.isin(absent, keys)]
    probe_err = _check_probes(k, dev, table, cap, keys[in_table], absent, "2^24 table")
    # a removal of 2^20 resident keys, 4,096 of them twice, with absent keys
    gone, rem_err = _check_removes(k, dev, table, plain, cap, keys[both], 1 << 20, 4096,
                                   absent[:4096], "2^24 table")

    # per-launch times: inserts take fresh keys and removes resident ones, a
    # distinct slice per launch, each timing on its own copy of the filled
    # table; probes one batch of resident keys (``fp_probe``) and one half
    # resident, half absent (``fp_probe_mixed``); ``ms`` is the device time
    # of one launch, ``per_call_ms`` the rate of back-to-back wrapper calls
    # (8,192 keys only)
    t64 = table.cpu().numpy().view(np.uint64)  # after the removes above
    resident = keys[in_table][~np.isin(keys[in_table], gone)]
    times, bounds = _time_index(k, dev, rng, table, plain, cap, t64, resident, absent,
                                ((8192, 30, 2, 50, 5), (1 << 20, 2, 1, 0, 2)))
    # contention: 8,192 keys made of 64 distinct keys, 128 copies each, into
    # the filled table; the kernel's status counts must equal the plain
    # version's (64 placed or overflowed, the rest PRESENT), and afterwards
    # every key that no copy reported OVERFLOW is in the table, as in the
    # plain version's; timed like the fresh keys, a new set of 64 keys per
    # launch
    distinct, copies, reps, warm = 64, 128, 30, 2
    hot_np = rng.integers(1, 2**64 - 1, size=(reps + warm + 1, distinct), dtype=np.uint64)
    hot_np = np.repeat(hot_np, copies, axis=1)
    for row in hot_np:
        rng.shuffle(row)
    hot = keys_to_device(hot_np.reshape(-1), dev)
    size = distinct * copies
    got_tbl, want_tbl = table.clone(), plain.clone()
    got_hot = k.fp_insert(hot[:size], got_tbl, cap)
    want_hot = k.fp_insert_torch(hot[:size], want_tbl, cap)
    hot_counts = torch.bincount(got_hot.long(), minlength=4).tolist()
    hot_plain = torch.bincount(want_hot.long(), minlength=4).tolist()
    check(hot_counts == hot_plain, f"contention status counts {hot_counts} vs {hot_plain}")
    check(hot_counts[k.PRESENT] == size - distinct, f"contention PRESENT {hot_counts}")
    hot_keys = keys_to_device(np.unique(hot_np[0]), dev)
    spilled = torch.isin(hot_keys, hot[:size][got_hot == k.OVERFLOW])
    present = k.fp_probe(hot_keys, got_tbl, cap)
    check(torch.equal(present, ~spilled), "contention: a key neither in the table nor spilled")
    check(torch.equal(present, k.fp_probe_torch(hot_keys, want_tbl, cap)),
          "contention: membership differs from the plain version's")
    del got_tbl, want_tbl
    hot_tbl = table.clone()
    hot_it = iter(range(1, reps + warm + 1))
    contention_ms = device_ms(
        lambda: k.fp_insert(hot[next(hot_it) * size:][:size], hot_tbl, cap), reps, warm)
    del hot_tbl, table, plain
    torch.cuda.empty_cache()

    main = _main_table(k, dev, rng)
    # the floor under a launch at 8,192 keys: an empty kernel, timed alike
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 30)
    for name in ("fp_probe", "fp_insert", "fp_remove"):
        results[name] = dict(
            max_abs_err=max({"fp_probe": probe_err, "fp_insert": ins_err,
                             "fp_remove": rem_err}[name], main["err"][name]),
            ms=times[8192][name], plain_ms=times[8192]["plain"][name],
            bound_ms=bounds[8192][name] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, keys_per_launch=8192, per_call_ms=times[8192]["per_call"][name],
            empty_launch_ms=floor_ms,
            ms_at_1m=times[1 << 20][name], plain_ms_at_1m=times[1 << 20]["plain"][name],
            bound_ms_at_1m=bounds[1 << 20][name] / HBM_BYTES_PER_S * 1e3,
            main_table=main["times"][name],
        )
    for name in ("fp_probe", "fp_remove"):
        results[name]["ms_host_keys"] = main["host_keys_ms"][name]
    for size, tag in ((8192, ""), (1 << 20, "_at_1m")):
        results["fp_probe"]["ms_mixed" + tag] = times[size]["fp_probe_mixed"]
        results["fp_probe"]["bound_ms_mixed" + tag] = (
            bounds[size]["fp_probe_mixed"] / HBM_BYTES_PER_S * 1e3)
    results["fp_insert"].update(contention_ms=contention_ms, contention_status_counts=hot_counts,
                                ms_host_keys=main["host_keys_ms"]["fp_insert"])
    emit("fp_index", capacity=cap, table_mb=slots * 8 / 2**20, keys=int(keys.size),
         load=keys.size / cap, status_counts=counts, plain_status_counts=counts_plain,
         probed=int(in_table.sum() + absent.size + 2), removed=int(gone.size), agree=True,
         ms={str(s): v for s, v in times.items()},
         bound_ms={str(s): {nm: b / HBM_BYTES_PER_S * 1e3 for nm, b in v.items()}
                   for s, v in bounds.items()},
         empty_launch_ms=floor_ms,
         contention={"keys": distinct * copies, "distinct": distinct,
                     "status_counts": hot_counts,
                     "plain_status_counts": hot_plain, "insert_ms": contention_ms,
                     "fresh_insert_ms": times[8192]["fp_insert"]},
         main_table={kk: v for kk, v in main.items() if kk != "err"})


def _time_index(k, dev, rng, table, plain, cap, t64, resident, absent, sizes):
    """Device ms per launch of the three kernels (and of a probe batch half
    resident, half absent), their plain versions' and the wrappers'
    back-to-back rate, and the bytes each launch must move, at each of
    ``sizes``: (keys, reps, warm-up, wrapper reps, plain reps)."""
    from repro_torch.kernels.ops import keys_to_device

    times, bounds = {}, {}
    for size, reps, warm, call_reps, plain_reps in sizes:
        n_slices = max(reps + warm, call_reps + 3)
        fresh_np = rng.integers(1, 2**64 - 1, size=size * n_slices, dtype=np.uint64)
        res_np = resident[: size * n_slices]
        check(res_np.size == size * n_slices, "enough resident keys to time removes")
        fresh, res = keys_to_device(fresh_np, dev), keys_to_device(res_np, dev)
        probe_keys = res[:size]
        mixed_np = _mixed(rng, res_np, absent, size)
        mixed = keys_to_device(mixed_np, dev)

        def sliced(op, src, tbl, size=size):
            it = iter(range(1 << 30))

            def run():
                i = next(it)
                op(src[i * size:(i + 1) * size], tbl, cap)

            return run

        entry = {
            "fp_probe": device_ms(lambda: k.fp_probe(probe_keys, table, cap), reps, warm),
            "fp_probe_mixed": device_ms(lambda: k.fp_probe(mixed, table, cap), reps, warm),
            "fp_insert": device_ms(sliced(k.fp_insert, fresh, table.clone()), reps, warm),
            "fp_remove": device_ms(sliced(k.fp_remove, res, table.clone()), reps, warm),
        }
        if call_reps:
            entry["per_call"] = {
                "fp_probe": cuda_ms(lambda: k.fp_probe(probe_keys, table, cap), call_reps),
                "fp_insert": cuda_ms(sliced(k.fp_insert, fresh, table.clone()), call_reps),
                "fp_remove": cuda_ms(sliced(k.fp_remove, res, table.clone()), call_reps),
            }
        if plain_reps:
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
            "fp_probe_mixed": _index_bytes("fp_probe", t64, mixed_np, cap),
            "fp_insert": _index_bytes("fp_insert", t64, fresh_np[timed], cap) / reps,
            "fp_remove": _index_bytes("fp_remove", t64, res_np[timed], cap) / reps,
        }
    return times, bounds


def _main_table(k, dev, rng) -> dict:
    """The table the replay's seen-fingerprint index ends at: 2^19 keys in
    2^21 logical slots (about 17 MB, inside the 50 MB L2).  Checks, then
    times at 8,192 keys (the replay's batch) and at 2^17 (a probe also at
    2^19, half resident), and the main path's launches, whose keys and
    results lie in pinned host memory."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import keys_to_device

    cap, n = 1 << 21, 1 << 19
    keys = np.unique(rng.integers(1, 2**64 - 1, size=n + n // 50, dtype=np.uint64))[:n]
    rng.shuffle(keys)
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64, device=dev)
    plain = table.clone()
    st = ops.fp_index_insert(keys, table, cap)  # the main path's insert, host keys
    st_plain = k.fp_insert_torch(keys_to_device(keys, dev), plain, cap).cpu().numpy()
    ins_err = int((np.bincount(st, minlength=4) != np.bincount(st_plain, minlength=4)).sum())
    check(ins_err == 0, "main table: insert status counts differ from the plain version's")
    check(bool((st == k.PLACED).all()), f"main table: statuses {np.bincount(st, minlength=4)}")
    absent = rng.integers(1, 2**64 - 1, size=n, dtype=np.uint64)
    absent = absent[~np.isin(absent, keys)]
    probe_err = _check_probes(k, dev, table, cap, keys, absent, "main table")
    # the main path's helpers, whose kernels read host keys: held key by key
    mixed_np = _mixed(rng, keys, absent, 8192)
    flags = ops.fp_index_probe(mixed_np, table, cap).cpu().numpy()
    want = k.fp_probe_torch(keys_to_device(mixed_np, dev), table, cap).cpu().numpy()
    probe_err = max(probe_err, int((flags != want).sum()))
    check(probe_err == 0 and int(flags.sum()) == 4096, "main table: the host-key probe helper")
    _, rem_err = _check_removes(k, dev, table, plain, cap, keys, 8192, 512, absent[:512],
                                "main table", host_keys=True)
    t64 = table.cpu().numpy().view(np.uint64)
    resident = keys[8192:]
    times, bounds = _time_index(k, dev, rng, table, plain, cap, t64, resident, absent,
                                ((8192, 30, 2, 0, 0), (n // 4, 2, 1, 0, 0)))
    out = {nm: {} for nm in ("fp_probe", "fp_insert", "fp_remove")}
    for size, entry in times.items():
        for nm in out:
            out[nm][str(size)] = {"ms": entry[nm],
                                  "bound_ms": bounds[size][nm] / HBM_BYTES_PER_S * 1e3}
        out["fp_probe"][str(size)].update(
            ms_mixed=entry["fp_probe_mixed"],
            bound_ms_mixed=bounds[size]["fp_probe_mixed"] / HBM_BYTES_PER_S * 1e3)
    # a probe as large as the table's key count, half resident
    whole_np = _mixed(rng, resident, absent, n)
    whole = keys_to_device(whole_np, dev)
    out["fp_probe"][str(n)] = {
        "ms_mixed": device_ms(lambda: k.fp_probe(whole, table, cap), 5, 1),
        "bound_ms_mixed": _index_bytes("fp_probe", t64, whole_np, cap) / HBM_BYTES_PER_S * 1e3}
    # the main path's launches read their keys from pinned host memory, and
    # insert and remove write their results there (``ops.fp_index_*``)
    host_keys = {}
    mixed = ops.pinned_keys(_mixed(rng, resident, absent, 8192))
    flags = torch.empty(8192, dtype=torch.bool, device=dev)
    host_keys["fp_probe"] = device_ms(
        lambda: k.launch("fp_probe", mixed, table, flags, cap), 30)
    for nm, dtype, src in (("fp_insert", torch.int32, absent[8192:]),
                           ("fp_remove", torch.bool, resident[8192:])):
        staged = ops.pinned_keys(src[: 8192 * 33])
        res_out = torch.empty(8192, dtype=dtype, pin_memory=True)
        tbl = table.clone()
        it = iter(range(33))
        host_keys[nm] = device_ms(
            lambda: k.launch(nm, staged[next(it) * 8192:][:8192], tbl, res_out, cap), 30)
        del tbl
    del table, plain
    torch.cuda.empty_cache()
    return {"capacity": cap, "keys": int(keys.size), "table_mb": k.table_phys_len(cap) * 8 / 2**20,
            "times": out, "host_keys_ms": host_keys,
            "err": {"fp_probe": probe_err, "fp_insert": ins_err, "fp_remove": rem_err}}


def phase_fp_index_call(dev) -> None:
    """Where the host time of one index call goes, at 8,192 keys: each step
    of the wrappers' launch path and of the ``ops.fp_index_*`` helpers, timed
    alone by ``time.perf_counter_ns`` (median of 2,000 calls after 50), and
    each wrapper and helper call whole."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fp_index as k
    from repro_torch.kernels.ops import keys_to_device

    cap, n = 1 << 21, 8192
    rng = np.random.default_rng(3)
    keys_np = rng.integers(1, 2**64 - 1, size=n, dtype=np.uint64)
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64, device=dev)
    ops.fp_index_insert(keys_np, table, cap)
    kt = keys_to_device(keys_np, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    fn = k.launcher("fp_probe")
    _, mask, shift = k.cap_args(cap)
    stream = torch._C._cuda_getCurrentRawStream(0)

    def med(f) -> float:
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t = []
        for _ in range(2000):
            t0 = time.perf_counter_ns()
            f()
            t.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
        return float(np.median(t))

    steps = {
        "check": med(lambda: k.check_args(kt, table, cap)),
        "alloc": med(lambda: kt.new_empty(n, dtype=torch.bool)),
        "current_device": med(torch.cuda.current_device),
        "stream": med(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "ctypes_call": med(lambda: fn(kt.data_ptr(), table.data_ptr(), out.data_ptr(), n, mask,
                                      shift, stream)),
        "error_check": med(lambda: _build.check(0, "fp_probe")),
        "stage_keys_pinned": med(lambda: ops.pinned_keys(keys_np)),
        "stream_sync": med(lambda: torch.cuda.current_stream(dev).synchronize()),
    }
    wrappers = {
        "fp_probe": med(lambda: k.fp_probe(kt, table, cap)),
        "fp_insert": med(lambda: k.fp_insert(kt, table, cap)),
        "fp_remove": med(lambda: k.fp_remove(kt, table, cap)),
    }
    helpers = {
        "fp_probe": med(lambda: ops.fp_index_probe(keys_np, table, cap).cpu().numpy()),
        "fp_insert": med(lambda: ops.fp_index_insert(keys_np, table, cap)),
        "fp_remove": med(lambda: ops.fp_index_remove(keys_np, table, cap)),
    }
    del table
    torch.cuda.empty_cache()
    emit("fp_index_call", keys=n, steps_ns=steps, wrapper_ns=wrappers, helper_ns=helpers)


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


def phase_replay(dev, results: dict, requests: int, seed: int) -> np.ndarray:
    """Returns the content fingerprints of the replay's writes."""
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
    return content_fps


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def phase_cdc_kernels(dev, results: dict) -> None:
    from repro_torch.core import ContentDefinedChunker
    from repro_torch.kernels.cdc import SEG_BYTES, cdc_candidates, cdc_candidates_torch
    from repro_torch.kernels.ops import CHUNK_FP_BATCH, chunk_fingerprint, chunk_fingerprint_torch
    from repro_torch.kernels.ref import cdc_golden_buffer, chunk_edge_cases

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
    zeros, ones = torch.zeros_like(rows), torch.full_like(rows, -1)
    for w_pad in (1024, 4096):
        max_size = 4 * w_pad
        lens = rng.integers(1, max_size + 1, size=n_chunks)
        starts = rng.integers(0, total - max_size, size=n_chunks)
        # every edge family: start phases, lengths about 1, 512, a batch of
        # groups and max_size, 1 to 8 row halos crossed, the payload's last
        # byte, bytes before offset 0 and past the payload (read as zero)
        edges = chunk_edge_cases(r, max_size, CHUNK_FP_BATCH).values()
        starts = np.concatenate([starts, *(e for e, _ in edges)])
        lens = np.concatenate([lens, *(n for _, n in edges)])
        st = torch.from_numpy(starts.astype(np.int64)).to(dev)
        ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
        for name, x in (("random", rows), ("zero", zeros), ("0xFF", ones)):
            got = chunk_fingerprint(x, st, ln, w_pad)
            e = _max_err(got, chunk_fingerprint_torch(x, st, ln, w_pad))
            check(e == 0, f"chunk_fingerprint kernel != plain at w_pad {w_pad}, {name} bytes")
            check(torch.equal(got, chunk_fingerprint(x, st, ln, w_pad)),
                  f"chunk_fingerprint: two calls differ at w_pad {w_pad}, {name} bytes")
            chunk_err = max(chunk_err, e)
    # many uneven chunks: more than the persistent grid has warps, long ones
    # clustered, so that the warps walk many chunks and end apart
    c = 200_000
    lens = np.minimum(16384, 1 + rng.geometric(1 / 3000, size=c))
    lens[rng.random(c) < 0.05] = 16384
    lens[50_000:52_000] = 16384
    st = torch.from_numpy(rng.integers(0, total - 16384, size=c).astype(np.int64)).to(dev)
    ln = torch.from_numpy(lens.astype(np.int32)).to(dev)
    got = chunk_fingerprint(rows, st, ln, 4096)
    e = _max_err(got, chunk_fingerprint_torch(rows, st, ln, 4096))
    check(e == 0, "chunk_fingerprint kernel != plain on 200,000 uneven chunks")
    check(torch.equal(got, chunk_fingerprint(rows, st, ln, 4096)),
          "chunk_fingerprint: two calls differ on 200,000 uneven chunks")
    chunk_err = max(chunk_err, e)
    del zeros, ones

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
         w_pads=[1024, 4096], edge_families=["phases", "halos", "payload_end", "outside"],
         row_bytes=["random", "zero", "0xFF"], uneven_chunks=c, equal_bits_twice=True,
         golden_cases=len(golden["cases"]), agree=True)


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
    results["chunk_fingerprint"]["ptxas"] = ptxas_usage("cdc", "chunk_fingerprint_kernel")
    for name, n in launches.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})["cdc"] = n
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


def _heavy_tailed_counts(n: int, nbins: int, rng) -> np.ndarray:
    """Occurrence counts as dedup traces have them (most 1, then 2, ...),
    with zeros, negatives and counts far past the last bin mixed in."""
    c = rng.geometric(0.45, size=n).astype(np.int32)
    c[rng.random(n) < 0.10] = 0
    neg = rng.random(n) < 0.02
    c[neg] = -rng.integers(1, 1000, size=int(neg.sum()))
    big = rng.random(n) < 0.02
    c[big] = rng.integers(nbins, 100 * nbins, size=int(big.sum()))
    return c


def phase_ffh(dev, results: dict, content_fps: np.ndarray, seed: int) -> None:
    """The FFH through its entry point ``ops.ffh_counts``; the launch count
    is zeroed just before that path and read just after."""
    from repro_torch.core.ffh import ffh_from_counts, occurrence_counts
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.histogram import ffh, ffh_torch

    n, nbins_list = 1 << 24, (1, 40, 128)
    counts = _heavy_tailed_counts(n, 40, np.random.default_rng(seed + 5))
    replay_counts = occurrence_counts(content_fps)
    c = torch.from_numpy(counts).to(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    got = {nb: ops.ffh_counts(c, nb) for nb in nbins_list}
    got_replay = ops.ffh_counts(replay_counts, 40, device=dev)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["ffh"]
    check(launches == len(nbins_list) + 1, f"ffh launched {launches} times on its path")

    err = 0
    for nb, out in got.items():
        e = _max_err(out, ffh_torch(c, nb))
        check(e == 0, f"ffh kernel != plain at nbins {nb}")
        host = ffh_from_counts(counts[counts > 0].astype(np.int64), max_bins=nb)
        check(np.array_equal(out.cpu().numpy(), host), f"ffh kernel != ffh_from_counts at {nb}")
        err = max(err, e)
    rc = torch.from_numpy(replay_counts.astype(np.int32)).to(dev)
    e = _max_err(got_replay, ffh_torch(rc, 40))
    check(e == 0, "ffh kernel != plain on the replay's counts")
    check(np.array_equal(got_replay.cpu().numpy(), ffh_from_counts(replay_counts, max_bins=40)),
          "ffh kernel != ffh_from_counts on the replay's counts")

    nb = 40
    ms = device_ms(lambda: ffh(c, nb), reps=20)
    plain_ms = cuda_ms(lambda: ffh_torch(c, nb), reps=3, warm=1)
    # one PyTorch call for the same function: negatives and zeros to bin 0,
    # counts past the last bin clamped into it, bin 0 dropped
    library_ms = device_ms(lambda: torch.bincount(c.clamp(0, nb), minlength=nb + 1)[1:], reps=20)
    lib_out = torch.bincount(c.clamp(0, nb), minlength=nb + 1)[1:]
    check(_max_err(lib_out, got[nb]) == 0, "torch.bincount yardstick != ffh")
    t_bytes = (4 * n + 4 * nb) / HBM_BYTES_PER_S * 1e3
    results["ffh"]["launches_by_path"]["ffh"] = launches
    results["ffh"].update(
        max_abs_err=max(err, e), ms=ms, plain_ms=plain_ms, bound_ms=t_bytes, bound_by="bytes",
        library_ms=library_ms, counts=n, nbins=nb, gb_per_s=4 * n / ms / 1e6,
    )
    emit("ffh", counts=n, nbins=list(nbins_list), replay_distinct_fps=int(replay_counts.size),
         replay_ffh_head=got_replay[:8].tolist(), agree=True, launches=launches, ms=ms,
         plain_ms=plain_ms, bincount_ms=library_ms, bound_ms=t_bytes,
         gb_per_s=4 * n / ms / 1e6)


SERVE_REQUESTS = 32
SERVE_DECODE_STEPS = 8


def _serve_once(srv, mix, keep):
    """Prefill every request of the mix, decode the last, post-process.
    Returns the caches of the requests in ``keep``, the decoded tokens and
    seconds of prefill and of each decode step."""
    caches = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r, (tenant, toks) in enumerate(mix):
        cache, pos, _ = srv.prefill_request(tenant, toks)
        if r in keep:
            caches[r] = (cache, pos)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache, pos = caches[len(mix) - 1]
    # the decode writes past the prompt: decode a copy, keep the prompt's cache
    work = type(cache)(cache.k.clone(), cache.v.clone())
    t0 = time.perf_counter()
    out, _ = srv.decode(work, pos, steps=SERVE_DECODE_STEPS)
    decode_s = time.perf_counter() - t0
    merged = srv.run_postprocess()
    return caches, out, prefill_s, decode_s, merged


def _device_busy(fn) -> dict:
    """Wall ms of ``fn`` under ``torch.profiler``, the device ms its kernels
    took (the sum of their self device times; ``None`` where the profiler saw
    no kernel) and the kernels that took the most.  The profiler's own
    cost inflates the wall time, so the idle share it gives is an upper
    bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel entries only: an operator's entry repeats its kernels' device time
    on_device = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    on_device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3 or None
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            "device_entries": sum(e.count for e in on_device),
            "top": [{"name": e.key[:100], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in on_device[:8]]}


def phase_serve(dev, results: dict, seed: int):
    """TinyLlama-1.1B at full width behind the KV-page dedup server; returns
    the server and its request mix for the paged-attention phase."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import request_mix
    from repro_torch.models import build_model
    from repro_torch.serving.dedup_kv import DedupKVServer

    cfg = get_config("tinyllama-1.1b")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
           cfg.vocab_size) == (22, 2048, 32, 4, 64, 5632, 32000), "TinyLlama-1.1B's widths")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "unembed", "final_ln"))
    kw = dict(page_tokens=16, max_slots=256, seed=seed, device=dev)
    srv = DedupKVServer(model, params, cache_entries=512, **kw)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    mix = request_mix(cfg.vocab_size, SERVE_REQUESTS, 96, np.random.default_rng(seed))
    keep = {SERVE_REQUESTS - 2, SERVE_REQUESTS - 1}  # the last chat and the last batch request
    _build.reset_launches()
    caches, out, prefill_s, decode_s, merged = _serve_once(srv, mix, keep)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches["fingerprint"] > 0, "the fingerprint kernel never launched on the serve path")
    m = srv.metrics
    check((m.blocks_total, m.blocks_prefill_skipped) == (224, 90),
          f"blocks skipped {m.blocks_prefill_skipped} of {m.blocks_total}, want 90 of 224")
    srv.dedup.store.check_consistency()

    nodedup = DedupKVServer(model, None, cache_entries=0, **kw)
    caches0, out0, prefill0_s, decode0_s, _ = _serve_once(nodedup, mix, keep)
    check(nodedup.metrics.blocks_prefill_skipped == 0, "a server without a cache skipped blocks")
    check(out == out0, f"decoded tokens {out} != {out0} without dedup")
    for r in keep:
        (c1, p1), (c2, p2) = caches[r], caches0[r]
        check(p1 == p2 and torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v),
              f"request {r}'s cache differs from the one a server without dedup computed")
    for name, n in launches.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})["serve"] = n
    # device time against wall time over 4 decode steps of the last request
    cache, pos = caches[SERVE_REQUESTS - 1]
    busy = _device_busy(lambda: srv.decode(type(cache)(cache.k.clone(), cache.v.clone()), pos, 4))
    tokens = sum(t.size for _, t in mix)
    emit("serve", model=cfg.name, params=n_params, layers=cfg.num_layers, d_model=cfg.d_model,
         requests=len(mix), tokens=int(tokens), blocks_total=m.blocks_total,
         blocks_prefill_skipped=m.blocks_prefill_skipped, tokens_prefilled=m.tokens_prefilled,
         prefill_saving=m.prefill_saving, kv_hbm_saving=m.hbm_saving, pages=len(srv.pages),
         pages_merged_by_postprocess=m.post_pages_merged, duplicates_found_by_postprocess=merged,
         decoded_tokens=out, decoded_equal=True, caches_equal=True, init_s=init_s,
         prefill_s=prefill_s, prefill_tokens_per_s=tokens / prefill_s,
         prefill_computed_tokens_per_s=m.tokens_prefilled / prefill_s,
         decode_ms_per_step=decode_s / SERVE_DECODE_STEPS * 1e3,
         nodedup_prefill_s=prefill0_s, nodedup_prefill_tokens_per_s=tokens / prefill0_s,
         nodedup_decode_ms_per_step=decode0_s / SERVE_DECODE_STEPS * 1e3,
         max_memory_allocated=peak, launches=launches, profiled_4_decode_steps=busy)
    del nodedup, caches, caches0
    torch.cuda.empty_cache()
    return srv, mix


def _paged_bound(table: np.ndarray, lengths: np.ndarray, page_bytes: int, h: int, d: int,
                 elem: int, page: int, peak_ops: float):
    """Least time of one paged-attention call on these inputs: every needed
    K and V page read once (a page shared by rows counts once; a row of
    length 0 needs its V pages only, for the mean), q read and o written
    once; 4 * D operations per query head and valid position (2 * D per
    slot of a length-0 row)."""
    need = [table[b, : -(-int(n) // page)] for b, n in enumerate(lengths) if n > 0]
    k_pages = np.unique(np.concatenate(need)) if need else np.zeros(0, np.int64)
    zero_rows = table[lengths <= 0]
    v_pages = np.union1d(k_pages, zero_rows.reshape(-1))
    qo = 2 * table.shape[0] * h * d * elem
    nbytes = (k_pages.size + v_pages.size) * page_bytes + qo
    ops = 4 * h * d * int(np.clip(lengths, 0, None).sum()) + 2 * h * d * zero_rows.size * page
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    all_pages = table.size * 2 * page_bytes + qo
    return t_bytes, t_ops, nbytes, all_pages


def _sdpa_ms(q, k_pages, v_pages, table, lengths):
    """Device ms of ``F.scaled_dot_product_attention`` with GQA on K/V already
    gathered dense, and of that gather; the yardstick only."""
    import torch.nn.functional as F

    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    t = table.shape[1] * page

    def gather():
        k = k_pages[table.long()].reshape(b, t, kvh, d).transpose(1, 2)
        v = v_pages[table.long()].reshape(b, t, kvh, d).transpose(1, 2)
        return k.contiguous(), v.contiguous()

    k, v = gather()
    mask = (torch.arange(t, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True)
    return device_ms(sdpa, reps=20), device_ms(gather, reps=20)


def phase_paged_attention(dev, results: dict, srv, mix, seed: int) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import (
        bf16_err_ratio,
        paged_attention,
        paged_attention_torch,
        split_pages,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the float32 plain version in full float32
    rng = np.random.default_rng(seed + 7)
    gen = torch.Generator(dev).manual_seed(seed + 7)
    h, kvh, d, page, pps = 32, 4, 64, 16, 128
    shared = 64  # a 1,024-token prompt's pages, shared by every row
    pages_per_split = split_pages(pps, page)
    cases = {}
    bf16_tol, f32_tol = dict(atol=0.05, rtol=0.05), dict(atol=3e-5, rtol=0)
    # (name, rows, dtype, tolerance, every row at the full 2,048 tokens)
    for name, b, dtype, tol, full in (("bf16", 64, torch.bfloat16, bf16_tol, False),
                                      ("f32", 8, torch.float32, f32_tol, False),
                                      ("long_bf16", 8, torch.bfloat16, bf16_tol, True)):
        num_pages = shared + b * (pps - shared)
        table = np.empty((b, pps), np.int32)
        table[:, :shared] = np.arange(shared)
        table[:, shared:] = shared + np.arange(b * (pps - shared)).reshape(b, -1)
        if full:
            lengths = np.full(b, pps * page, np.int32)
        else:
            lengths = rng.integers(0, pps * page + 1, size=b).astype(np.int32)
            lengths[0], lengths[1] = 0, pps * page
        q = torch.randn((b, h, d), generator=torch.Generator().manual_seed(seed)).to(dev, dtype)
        kp = torch.randn((num_pages, page, kvh, d), generator=gen, device=dev).to(dtype)
        vp = torch.randn((num_pages, page, kvh, d), generator=gen, device=dev).to(dtype)
        tt, lt = torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev)
        got = paged_attention(q, kp, vp, tt, lt)
        want = paged_attention_torch(q, kp, vp, tt, lt)
        torch.testing.assert_close(got.float(), want.float(), **tol)  # raises on a mismatch
        err = float((got.float() - want.float()).abs().max().item())
        # bf16: also within a limit scaled to the outputs, which 0.05 is not
        scaled = bf16_err_ratio(got, want) if dtype == torch.bfloat16 else None
        check(scaled is None or scaled <= 1, f"paged {name}: error {scaled} x the scaled bf16 limit")
        # no float atomics, splits merged in a fixed order: equal bits
        check(torch.equal(got, paged_attention(q, kp, vp, tt, lt)),
              f"two paged_attention calls on the {name} case differ")
        ms = device_ms(lambda: paged_attention(q, kp, vp, tt, lt), reps=20)
        plain_ms = cuda_ms(lambda: paged_attention_torch(q, kp, vp, tt, lt), reps=3, warm=1)
        sdpa_ms, gather_ms = _sdpa_ms(q, kp, vp, tt, lt)
        elem = torch.finfo(dtype).bits // 8
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        t_bytes, t_ops, nbytes, all_bytes = _paged_bound(
            table, lengths, page * kvh * d * elem, h, d, elem, page, peak)
        cases[name] = dict(rows=b, pages=num_pages, pages_per_split=pages_per_split,
                           splits=-(-pps // pages_per_split), equal_bits=True,
                           max_abs_err=err, max_abs_want=float(want.float().abs().max()),
                           bf16_err_ratio=scaled, ms=ms, plain_ms=plain_ms,
                           sdpa_ms=sdpa_ms, gather_ms=gather_ms, bytes_bound_ms=t_bytes,
                           ops_bound_ms=t_ops, bytes=nbytes,
                           bytes_all_pages_ms=all_bytes / HBM_BYTES_PER_S * 1e3)
        del q, kp, vp, got, want
        torch.cuda.empty_cache()

    # the serve phase's own page pool: every page the server holds, for two
    # layers, and each request's table from its LBAs' PBAs
    store = srv.dedup.store
    pbas = sorted(srv.pages)
    slot = {pba: i for i, pba in enumerate(pbas)}
    tables, lens = [], []
    for r, (tenant, toks) in enumerate(mix):
        nblocks = toks.size // srv.page_tokens
        row = [store.lba_map[(tenant, (r << 24) | i)] for i in range(nblocks)]
        check(all(p in slot for p in row), f"request {r} maps a block to a PBA with no page")
        tables.append([slot[p] for p in row])
        lens.append(nblocks * srv.page_tokens)
    table = np.asarray(tables, np.int32)
    lengths = np.asarray(lens, np.int32)
    tt, lt = torch.from_numpy(table).to(dev), torch.from_numpy(lengths).to(dev)
    cfg = srv.model.cfg
    q = torch.randn((len(mix), cfg.num_heads, cfg.head_dim),
                    generator=torch.Generator().manual_seed(seed + 1)).to(dev, torch.bfloat16)
    pools = {}
    for layer in (0, cfg.num_layers - 1):
        pools[layer] = (torch.stack([srv.pages[p].k[layer] for p in pbas]).contiguous(),
                        torch.stack([srv.pages[p].v[layer] for p in pbas]).contiguous())
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = {layer: paged_attention(q, kp, vp, tt, lt) for layer, (kp, vp) in pools.items()}
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["paged_attention"]
    check(launches == len(pools), f"paged_attention launched {launches} times over the pool")
    pool_err = pool_ratio = 0.0
    for layer, (kp, vp) in pools.items():
        want = paged_attention_torch(q, kp, vp, tt, lt)
        torch.testing.assert_close(outs[layer].float(), want.float(), atol=0.05, rtol=0.05)
        pool_err = max(pool_err, float((outs[layer].float() - want.float()).abs().max().item()))
        pool_ratio = max(pool_ratio, bf16_err_ratio(outs[layer], want))
    check(pool_ratio <= 1, f"paged pool: error {pool_ratio} x the scaled bf16 limit")
    kp, vp = pools[0]
    pool_ms = device_ms(lambda: paged_attention(q, kp, vp, tt, lt), reps=20)
    distinct = int(np.unique(table).size)

    a = cases["bf16"]
    results["paged_attention"]["launches_by_path"]["serve_pool"] = launches
    results["paged_attention"].update(
        max_abs_err=max(a["max_abs_err"], cases["long_bf16"]["max_abs_err"], pool_err),
        ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=max(a["bytes_bound_ms"], a["ops_bound_ms"]),
        bound_by="bytes" if a["bytes_bound_ms"] >= a["ops_bound_ms"] else "operations",
        library_ms=a["sdpa_ms"], gather_ms=a["gather_ms"],
        shape={"B": 64, "H": h, "KVH": kvh, "D": d, "page": page, "pps": pps, "dtype": "bf16",
               "pages_per_split": pages_per_split},
        f32=cases["f32"], long_rows=cases["long_bf16"], pool_ms=pool_ms,
        pool_max_abs_err=pool_err, pool_bf16_err_ratio=pool_ratio,
    )
    emit("paged_attention", cases=cases, pool_rows=int(table.shape[0]),
         pool_pages_per_split=split_pages(table.shape[1], srv.page_tokens),
         pool_pages=len(pbas), pool_distinct_pages_used=distinct,
         pool_table_entries=int(table.size), pool_layers=list(pools), pool_ms=pool_ms,
         pool_max_abs_err=pool_err, pool_bf16_err_ratio=pool_ratio, launches=launches,
         agree=True)


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
    phase_fp_index_call(dev)
    phase_crossover(dev)
    content_fps = phase_replay(dev, results, args.requests, args.seed)
    phase_cdc_kernels(dev, results)
    phase_cdc(dev, results, args.seed)
    phase_ffh(dev, results, content_fps, args.seed)
    srv, mix = phase_serve(dev, results, args.seed)
    phase_paged_attention(dev, results, srv, mix, args.seed)
    for name in KERNELS:
        results[name]["launches"] = sum(results[name]["launches_by_path"].values())
        check(results[name]["launches"] > 0, f"kernel {name} never launched on a main path")
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
