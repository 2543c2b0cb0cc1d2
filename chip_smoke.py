#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of HPDedup on one CUDA card, end to end.

    python3 chip_smoke.py [--requests N] [--seed S]
    python3 chip_smoke.py --band [SRC]   # (e) of ``long`` and RecurrentGemma's
                                         # ``blocks`` step alone, the port
                                         # imported from SRC (e.g. a parent
                                         # commit's checkout's src) if given

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
                  1,000,000 requests by default.  Each write's 4 KB block is
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
                  cut to 8 of its 22 layers (d 2048, random float32 weights
                  from ``--seed``, bf16 compute): 32 requests of ``launch/serve.py``'s mix (a
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
                  pool (layers 0 and 7, each request's table from its LBAs'
                  PBAs), against the plain version (bf16 atol/rtol 0.05,
                  float32 atol 3e-5); two calls on each case must give equal
                  bits; device time beside the SDPA call's, and the pages
                  per split the kernel used.
* ``cluster``     the sharded cluster at the reference's cluster benchmark
                  settings (4 shards, 32,768 cache entries, batch 8,192),
                  replication factor 2, over 2,000,000 requests of workload A
                  through ``ingest_batched`` a chunk at a time, with the
                  shard engines' worker threads: a GC step (512 moves a
                  shard) every 4 chunks; at half the trace a snapshot ->
                  JSON -> ``restore_engine`` to carry on with; ``resize`` to
                  8 shards at three quarters; shard 1 failed and recovered
                  at seven eighths.  The same schedule runs serially on the
                  card and with workers on the host: the three reports,
                  per-shard reports, ``moved_fps``, GC and recovery stats
                  must be equal, the counts equal a single ``HPDedup``'s, and
                  every shard consistent.  Launch counts are zeroed just
                  before the card run and read just after: the three index
                  kernels must have run.  The sizes of the cluster's index
                  launches, and each kernel's device time on a table like a
                  shard's at the median size.  Then ``cluster_serve``:
                  ``DedupKVServer(num_shards=4)`` on the ``serve`` phase's
                  model and mix beside a one-engine server, 6 requests, a
                  snapshot round trip and a GC step, one more request and 4
                  decode steps: infos, metrics, caches, pages and tokens
                  equal.
* ``ingest``      the training-data ingest pipeline at its class defaults
                  (256-token blocks, 64 a fingerprint launch, 8,192 cache
                  entries) over ``launch/train.py``'s four-tenant mix and a
                  32,000-token vocabulary: ``next_batch(8, 2048)`` until
                  2^18 blocks are in: one engine on the card, then the same
                  on the host, each with no other run alive (equal batches
                  and metrics expected, else within 0.02 of dedup saving,
                  the first difference printed), then two runs at once of 4
                  shards on the card, with shard workers on every batch and
                  without them (equal batches).
                  The state after 32,768 blocks, through JSON into a fresh
                  pipeline on the card, must continue the uninterrupted run
                  bit for bit for 16 batches.  Blocks/s, admitted tokens/s,
                  the seconds of hashing, engine writes and stream
                  generation, one fingerprint launch's device time at 64 x
                  256 words, the snapshot's seconds and bytes, launches,
                  probe routes and the index tables' staged keys.
* ``train``       the training path through ``repro_torch.launch.train``'s
                  ``build`` at the launcher's defaults (its tenants, 64-token
                  blocks, 4,096 cache entries, batch 8 x 256, lr 1e-3, warmup
                  5), the pipeline on the card in the trainer's producer
                  thread: (a) TinyLlama-1.1B at full width and depth, float32
                  weights, bf16 compute, 30 steps: finite losses, the last 3
                  below the first 3, no restart, the fingerprint kernel
                  launched, the batches consumed in the order made and equal
                  to the same pipeline's on the host (else within 0.02 of
                  dedup saving, the first difference printed); median step
                  ms, tokens/s, model FLOPs and TFLOP/s, peak memory, two
                  steps under the profiler, and the producer's fingerprint
                  calls against an idle card's (their wait behind the queued
                  step).  (b) A 2-layer cut at full width, 10 steps, a
                  checkpoint every 5, one failure injected before step 7: one
                  restart, step 10 reached, the batches after the restore
                  the uninterrupted run's, losses within 1e-3 of its;
                  checkpoint bytes, save and restore seconds.  (c) Prefill of
                  4 x 255 tokens and one decode step against a prefill of 4 x
                  256, float32 and bf16, at TinyLlama's widths: held at 2
                  layers (float32 within 1e-3, bf16 within the larger of 5e-2
                  and the bf16 prefill's distance from the float32 one),
                  printed at 4, 8 and 22.  (d) The same, held, for
                  DeepSeek-67B, Yi-34B and Phi-3-medium at full width cut to 2
                  layers, with peak memory.  Launch counts are zeroed just
                  before each trainer run of (a) and (b) and read just after.
* ``blocks``      the other block kinds at their published widths, each
                  line with the card's name and power limit: (a) Mixtral-8x7B
                  (sliding window 4096, 8 experts, top-2) cut to 2 layers,
                  float32 weights, bf16 compute, behind ``DedupKVServer``
                  (``launch/serve.py``'s 16-request mix, 8 decode steps),
                  decoding what a server that caches nothing decodes;
                  (b) ``launch.train.build`` at the launcher's defaults, 10
                  steps each, on RWKV6-1.6B (24 layers), RecurrentGemma-2B
                  (5 of 26 layers: one (RG-LRU, RG-LRU, local) group and
                  the two remainder RG-LRU layers) and Mixtral at 2 layers:
                  finite losses, the host pipeline's batches, median step
                  ms, tokens/s, model TFLOP/s, peak memory; (c) prefill +
                  decode at 4 x 256 (RWKV6: 224 tokens and 32 steps) as in
                  ``train`` (c), MoE at a capacity that drops nothing (the
                  share 1.25 would drop printed): Mixtral, Qwen2-VL at 2
                  layers, RecurrentGemma at 5, RWKV6 at 2 (printed at 24),
                  Qwen2-VL's M-RoPE (equal streams are RoPE bit for bit,
                  distinct ones change the logits), and Llama-4 Maverick at
                  2 layers with bf16 weights (37 GB), held in bf16 to the
                  tolerance of a float32/bf16 run with 16 experts; (d)
                  Whisper-small at full size: ``encode_prefill`` of 4 x
                  1,024 frame embeddings, 32 decode steps held to the
                  teacher-forced decoder's logits.  Launch counts are zeroed
                  before (a) and each run of (b) and read after.
* ``long``        the reference's long-sequence attention schedules and remat
                  at ``configs/shapes.py``'s lengths, each line with the
                  card's name and power limit: (a) ``flash_attend`` (causal
                  and not; 2 x 4,096 tokens, 32 query heads over 4 KV heads
                  of 64) and ``banded_attend`` (8,192 tokens, windows 4,096
                  and 2,048) against ``attend_plain`` on the same unit-normal
                  q, k, v, forward and the gradients of ``sum(out * w)``:
                  float32 within 3e-5 (gradients 1e-4), bf16 within one
                  bf16 step (2^-7 of the plain value) plus those, element
                  by element; flash and the plain version in float32 each
                  against the plain version in float64; ms forward and
                  forward + backward, the peak MB of a forward + backward
                  beside the plain version's.  (b) TinyLlama-1.1B at full
                  width and depth through the launcher's objects at
                  train_4k's 4,096 tokens: batch 2 without remat (6 steps),
                  batch 2 with "full" (5 steps): finite losses, the host
                  pipeline's batches, median step ms, tokens/s, model
                  TFLOP/s, peak memory; on the first batch, "none"'s and
                  "full"'s loss equal to the first step's, and every
                  gradient leaf of "full" (whose backward recomputes each
                  block) equal to "none"'s, within 1e-5 relative.  (c) Its prefill of prefill_32k's 32,768
                  tokens (batch 1, full depth, bf16 compute) and 8 decode
                  steps; at 2 layers in float32, a prefill 512 tokens shorter
                  and 512 decode steps against the whole prefill (1e-3).
                  (d) Mixtral-8x7B at 2 layers (window 4,096) and
                  RecurrentGemma-2B at 5 (local window 2,048) prefill 8,192
                  tokens, every attention layer through ``banded_attend``;
                  one Mixtral attention layer against the plain version in
                  float32 (1e-4).  (e) RecurrentGemma-2B's band (10 heads,
                  1 KV head of 256, window 2,048) at 2 x 4,096 tokens
                  against the plain version in float32 (3e-5, gradients
                  1e-4; ms forward and forward + backward); 5 layers under
                  remat "none", "dots" and "full" on one batch: loss and
                  gradients within 1e-5 relative of "none"'s, ms, peak GB,
                  and the band's products by call, as many under "dots" as
                  under "none".  Launch counts are zeroed before each run
                  of (b) and read after.
* ``sharding``    the port's sharding on the card, under a one-process NCCL
                  group (in-memory store, no port) and its 1 x 1 ("data",
                  "model") mesh, each line with the card's name and power
                  limit: (a) TinyLlama-1.1B at full width and depth,
                  ``launch/train.py``'s batch (8 x 256) and optimizer, 2
                  steps of the sharded ``train_step`` (every leaf a DTensor
                  placed by ``param_pspecs``/``batch_pspecs``) beside the
                  plain one from the same weights and batches: losses within
                  1e-5 relative, every weight within 1e-6; (b) one
                  Mixtral-8x7B MoE layer at published width (bf16 weights,
                  4 x 512 tokens) through the mesh branch on a "model" group
                  of one against ``moe_local`` at capacity E / k: outputs
                  and aux within 1e-5 relative, kept masks equal; (c)
                  ``compressed_psum_mean`` of (a)'s first gradients, each
                  leaf within 5% of its largest value, and
                  ``ErrorFeedback.apply``, with seconds and the int8 bytes
                  handed to the collectives; (d) the ``train`` phase's last
                  checkpoint (its 2-layer restore run) restored onto the
                  mesh by ``param_pspecs``, bit for bit the trained weights;
                  (e) ``analytic_terms`` for TinyLlama beside the ``long``
                  phase's measured step, and the meta-device dry run's 80
                  records (count, cells over the card's memory, seconds).
                  Launch counts are zeroed just before the phase and read
                  just after: the fingerprint kernel (the launcher's
                  pipeline, hashing (a)'s batches) must have run.
* ``frontend``    ``AsyncDedupFrontend`` at ``benchmarks/serving_latency.py``'s
                  default scale (16 Zipf-skewed tenants, 256 connections,
                  120,000 requests, 4 shards of 8,192 cache entries) on the
                  card; ``contended`` (cache 192), ``resize_under_load`` (4
                  -> 6 shards) and ``gc_under_load`` (a GC step every 400
                  writes of a connection) at 30,000 requests; and 4,000
                  writes over the
                  ``serve`` phase's server.  Each executed trace replayed on
                  the card and on the host gives the served report (the
                  resize: the fixed-layout oracle's counts; the GC: a GC-free
                  oracle's report, then ``check_consistency``).  Per
                  scenario: rps, p50/p99 ms, mean batch, batches, throttled
                  writes, launches and probe routes.
* ``kernels``     one object per kernel: launches on the main paths (replay,
                  cdc, serve, ffh, the paged pool, cluster, the cluster
                  server, ingest, train, blocks, long, sharding and
                  frontend, summed), largest
                  disagreement with its plain version, times, and the least
                  time the card could take for the same work; for the chunk
                  kernel also ptxas's registers and spill bytes.

The next-to-last line is ``nvidia-smi``'s name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

START = time.perf_counter()
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
    """One JSON line; ``script_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "script_s": time.perf_counter() - START}),
          flush=True)


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
                                ((8192, 30, 2, 50, 5), (1 << 20, 2, 1, 0, 2)), library=True)
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
            library_ms=times[8192]["isin"] if name == "fp_probe" else None,
            keys_per_launch=8192, per_call_ms=times[8192]["per_call"][name],
            empty_launch_ms=floor_ms,
            ms_at_1m=times[1 << 20][name], plain_ms_at_1m=times[1 << 20]["plain"][name],
            bound_ms_at_1m=bounds[1 << 20][name] / HBM_BYTES_PER_S * 1e3,
            main_table=main["times"][name],
        )
    for name in ("fp_probe", "fp_remove"):
        results[name]["ms_host_keys"] = main["host_keys_ms"][name]
    results["fp_probe"]["library_ms_at_1m"] = times[1 << 20]["isin"]
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


def _time_index(k, dev, rng, table, plain, cap, t64, resident, absent, sizes,
                library=False):
    """Device ms per launch of the three kernels (and of a probe batch half
    resident, half absent), their plain versions' and the wrappers'
    back-to-back rate, and the bytes each launch must move, at each of
    ``sizes``: (keys, reps, warm-up, wrapper reps, plain reps); with
    ``library``, also the probe's library call, ``torch.isin`` (``isin``),
    whose flags must equal the kernel's."""
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
        if library:
            # the one PyTorch call of the probe's function: membership of the
            # packed keys among the table's packed slots (no key here is a
            # pad key, 0 or TOMB_KEY, which mark empty and removed slots)
            check(torch.equal(torch.isin(mixed, table), k.fp_probe(mixed, table, cap)),
                  f"{size} keys: the probe kernel's flags differ from torch.isin's")
            entry["isin"] = device_ms(lambda: torch.isin(probe_keys, table), 5, 1)
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
# TinyLlama-1.1B at full width cut to this many of its 22 layers: the blocks
# skipped and the checks do not depend on the depth, the host-bound decode
# steps do (a cut of script time).
SERVE_LAYERS = 8


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
    from repro_torch.pytree import leaves
    from repro_torch.serving.dedup_kv import DedupKVServer

    full = get_config("tinyllama-1.1b")
    check((full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
           full.d_ff, full.vocab_size) == (22, 2048, 32, 4, 64, 5632, 32000),
          "TinyLlama-1.1B's widths")
    cfg = full.replace(num_layers=SERVE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    n_params = sum(t.numel() for t in leaves(params))
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


# The cluster phase: the reference's cluster benchmark settings
# (``benchmarks/cluster_scaling.py``: 4 shards, 32,768 cache entries, batch
# 8,192) and GC schedule (``benchmarks/gc_reclaim.py``: a step every 4
# chunks, 512 moves a shard), over 1 M requests of workload A.
CLUSTER_REQUESTS = 1_000_000
CLUSTER_SHARDS, CLUSTER_GROWN, CLUSTER_REPLICAS = 4, 8, 2
CLUSTER_CACHE, CLUSTER_BATCH = 32768, 8192
CLUSTER_GC_EVERY, CLUSTER_GC_MOVES = 4, 512
CLUSTER_SERVE_REQUESTS = 6  # then one more after a snapshot round trip and a GC step


def _cluster_schedule(trace: np.ndarray, device, parallel: bool, seed: int) -> dict:
    """Ingest ``trace`` into ``ShardedCluster(4 shards, R=2)`` with
    ``ingest_batched`` one chunk (batch x shards records) a call, a GC step
    every 4 chunks; at half the trace snapshot -> JSON -> ``restore_engine``
    and carry on with the restored cluster; at three quarters ``resize`` to 8
    shards; at seven eighths fail shard 1 and recover it.  ``parallel``
    attaches the executor (one worker thread per shard).  Returns the
    cluster, its report, the stats of each step and the seconds of each."""
    from repro_torch.core import ShardedCluster, restore_engine, snapshot_engine

    t0 = time.perf_counter()
    c = ShardedCluster(num_shards=CLUSTER_SHARDS, replication_factor=CLUSTER_REPLICAS,
                       cache_entries=CLUSTER_CACHE, seed=seed, device=device)
    if parallel:
        c.start_executor()
    n = len(trace)
    marks = (n // 2, 3 * n // 4, 7 * n // 8, n)
    a = chunks = 0
    gc, secs = [], {"gc": 0.0, "snapshot": 0.0, "restore": 0.0, "resize": 0.0,
                    "fail_recover": 0.0}
    out = {}
    for mark in marks:
        while a < mark:
            b = min(a + CLUSTER_BATCH * c.num_shards, mark)
            c.ingest_batched(trace[a:b], batch_size=CLUSTER_BATCH)
            a, chunks = b, chunks + 1
            if chunks % CLUSTER_GC_EVERY == 0:
                t1 = time.perf_counter()
                gc.append(c.run_gc(max_moves_per_shard=CLUSTER_GC_MOVES))
                secs["gc"] += time.perf_counter() - t1
        t1 = time.perf_counter()
        if mark == marks[0]:
            payload = json.dumps(snapshot_engine(c))
            t2 = time.perf_counter()
            secs["snapshot"] = t2 - t1
            c.stop_executor()
            c = restore_engine(json.loads(payload), device=device)
            if parallel:
                c.start_executor()
            secs["restore"] = time.perf_counter() - t2
            out["snapshot_bytes"] = len(payload)
        elif mark == marks[1]:
            out["resize"] = c.resize(CLUSTER_GROWN)
            secs["resize"] = time.perf_counter() - t1
        elif mark == marks[2]:
            c.fail_shard(1)
            out["recover"] = c.recover_shard(1)
            secs["fail_recover"] = time.perf_counter() - t1
    report = c.finish()
    c.stop_executor()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out.update(cluster=c, report=report, gc=gc, chunks=chunks, seconds=secs,
               total_s=time.perf_counter() - t0)
    return out


def _cluster_kernel_times(k, dev, rng, index, sizes: dict) -> dict:
    """Device ms of one launch of each index kernel on a table like a
    shard's own (its seen-fingerprint index's keys, at its capacity), with
    the keys in pinned host memory as the cluster's launches have them, at
    the median size the cluster launched each kernel; and the bytes bound
    there.  Probes run half resident, half absent keys; each insert (fresh
    keys) and each remove (resident keys) runs on its own copy of the table."""
    from repro_torch.kernels import ops

    cap = index.table_stats()["capacity"]
    resident = np.fromiter(index, dtype=np.uint64, count=len(index))
    resident = resident[(resident != 0) & (resident != np.uint64(TOMB_KEY))]
    rng.shuffle(resident)
    table = torch.zeros(k.table_phys_len(cap), dtype=torch.int64, device=dev)
    ops.fp_index_insert(resident, table, cap)
    t64 = table.cpu().numpy().view(np.uint64)
    resident = resident[k.probe_host(t64, resident, cap)]  # not the few that overflowed
    reps, warm = 20, 2
    out = {}
    for name, dtype in (("fp_probe", torch.bool), ("fp_insert", torch.int32),
                        ("fp_remove", torch.bool)):
        if not sizes[name]:
            continue
        size = min(int(np.median(sizes[name])), resident.size)
        absent = rng.integers(1, 2**64 - 1, size=2 * size, dtype=np.uint64)
        absent = absent[~np.isin(absent, resident)]
        keys = {"fp_probe": _mixed(rng, resident, absent, size),
                "fp_insert": absent[:size], "fp_remove": resident[:size]}[name]
        staged = ops.pinned_keys(keys)
        res = (torch.empty(size, dtype=dtype, device=dev) if name == "fp_probe"
               else torch.empty(size, dtype=dtype, pin_memory=True))
        tables = iter([table] * (reps + warm) if name == "fp_probe"
                      else [table.clone() for _ in range(reps + warm)])
        ms = device_ms(lambda: k.launch(name, staged, next(tables), res, cap), reps, warm)
        out[name] = {"keys": size, "ms": ms,
                     "bound_ms": _index_bytes(name, t64, keys, cap) / HBM_BYTES_PER_S * 1e3,
                     "table_capacity": cap, "table_keys": len(index)}
        del tables
    return out


def _cluster_outcome(run: dict) -> dict:
    """What every run of the schedule must agree on, as plain JSON."""
    from repro_torch.core import report_to_tree

    return json.loads(json.dumps({
        "report": report_to_tree(run["report"]),
        "shard_reports": [report_to_tree(r) for r in run["cluster"].shard_reports],
        "resize": run["resize"], "gc": run["gc"], "recover": run["recover"],
    }))


def _cluster_child(spec: str) -> None:
    """One run of the schedule in a process of its own, which
    ``phase_cluster`` starts (``spec``: JSON of device, parallel, seed,
    requests and whether to run the single-engine oracle after it); prints
    the outcome, its seconds and the oracle's report as the last line."""
    from repro_torch.core import HPDedup, generate_workload, report_to_tree

    args = json.loads(spec)
    trace, _ = generate_workload("A", total_requests=args["requests"], seed=args["seed"])
    run = _cluster_schedule(trace, args["device"], args["parallel"], args["seed"])
    out = dict(_cluster_outcome(run), total_s=run["total_s"], seconds=run["seconds"])
    if args["oracle"]:
        t0 = time.perf_counter()
        oracle = HPDedup(cache_entries=CLUSTER_CACHE, device="cpu").replay_batched(
            trace, CLUSTER_BATCH).finish()
        out.update(oracle=report_to_tree(oracle), oracle_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)


def _start_cluster_child(device: str, parallel: bool, seed: int, oracle: bool):
    return _start_child("_cluster_child", {"device": device, "parallel": parallel, "seed": seed,
                                           "requests": CLUSTER_REQUESTS, "oracle": oracle})


def _start_child(entry: str, spec: dict):
    """``chip_smoke.<entry>(json.dumps(spec))`` in a process of its own."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.{entry}(sys.argv[1])")
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(spec)], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _child_outcome(proc, what: str) -> dict:
    out, _ = proc.communicate()
    lines = out.strip().splitlines()
    check(proc.returncode == 0 and lines, f"{what} failed:\n{out[-4000:]}")
    return json.loads(lines[-1])


def phase_cluster(dev, results: dict, srv, mix, seed: int) -> None:
    """The sharded cluster on the card: the schedule of ``_cluster_schedule``
    through the parallel executor on the card, and at the same time, each in
    a process of its own, serially on the card and through the executor on
    the host (then a single ``HPDedup`` on the host).  The three reports,
    per-shard reports, ``moved_fps``, GC and recovery stats must be equal,
    and the counts equal the single engine's.  Then the cluster-backed
    server on the ``serve`` phase's model."""
    import repro_torch.core.fp_index as core_index
    from repro_torch.core import generate_workload, report_from_tree
    from repro_torch.kernels import _build
    from repro_torch.kernels import fp_index as k

    children = [_start_cluster_child("cuda", False, seed, oracle=False),
                _start_cluster_child("cpu", True, seed, oracle=True)]
    try:
        t0 = time.perf_counter()
        trace, streams = generate_workload("A", total_requests=CLUSTER_REQUESTS, seed=seed)
        gen_s = time.perf_counter() - t0

        # the sizes of the cluster's index launches, read off the helpers the
        # indexes call (a list append per call, on the card run only)
        sizes = {"fp_probe": [], "fp_insert": [], "fp_remove": []}
        helpers = {nm: getattr(core_index, f"fp_index_{nm[3:]}") for nm in sizes}

        def recorder(nm):
            def call(keys, table, cap):
                sizes[nm].append(int(np.asarray(keys).size))
                return helpers[nm](keys, table, cap)
            return call

        for nm in sizes:
            setattr(core_index, f"fp_index_{nm[3:]}", recorder(nm))
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        core_index.reset_probe_routes()
        try:
            card = _cluster_schedule(trace, dev, parallel=True, seed=seed)
        finally:
            for nm in sizes:
                setattr(core_index, f"fp_index_{nm[3:]}", helpers[nm])
        launches = dict(_build.LAUNCHES)
        routes = dict(core_index.PROBE_ROUTES)
        peak = torch.cuda.max_memory_allocated()
        for name in ("fp_probe", "fp_insert", "fp_remove"):
            check(launches[name] > 0, f"kernel {name} never launched on the cluster path")
        serial = _child_outcome(children[0], "the cluster run serially on the card")
        host = _child_outcome(children[1], "the cluster run on the host")
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    want = _cluster_outcome(card)
    for other, what in ((serial, "serially on the card"), (host, "on the host")):
        check(report_from_tree(other["report"]) == card["report"],
              f"cluster HybridReport {what} != on the card")
        check([report_from_tree(r) for r in other["shard_reports"]]
              == card["cluster"].shard_reports, f"cluster per-shard reports {what} differ")
        for key in ("resize", "gc", "recover"):
            check(other[key] == want[key], f"cluster {key} stats {what} differ")
    oracle = report_from_tree(host["oracle"])
    rep = card["report"]
    check((rep.final_disk_blocks, rep.unique_fingerprints, rep.total_writes,
           rep.total_dup_writes) == (oracle.final_disk_blocks, oracle.unique_fingerprints,
                                     oracle.total_writes, oracle.total_dup_writes),
          "cluster counts != the single-engine oracle's")
    cluster = card["cluster"]
    cluster.check_consistency()
    for e in cluster.shards:
        for idx in (e._seen_fps, e.inline.cache.index, e.store.fp_index):
            check(idx.table_stats()["backend"] == "torch", "a shard's index is not on the card")
            idx.check_consistency()
    timings = _cluster_kernel_times(k, dev, np.random.default_rng(seed + 11),
                                    cluster.shards[0]._seen_fps, sizes)
    for name, n in launches.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})["cluster"] = n
    for name, entry in timings.items():
        results[name]["cluster"] = entry

    def size_stats(v):
        return ({"launches": len(v), "min": int(np.min(v)), "median": float(np.median(v)),
                 "mean": float(np.mean(v)), "max": int(np.max(v))} if v else {"launches": 0})

    moved = [sum(g[key] for g in card["gc"]) for key in ("moved", "collected")]
    emit("cluster", workload="A", streams=len(streams), requests=int(trace.size), seed=seed,
         shards=[CLUSTER_SHARDS, CLUSTER_GROWN], replication_factor=CLUSTER_REPLICAS,
         cache_entries=CLUSTER_CACHE, batch=CLUSTER_BATCH, chunks=card["chunks"],
         generate_s=gen_s, card_s=card["total_s"], card_requests_per_s=trace.size / card["total_s"],
         serial_card_s=serial["total_s"],
         serial_card_requests_per_s=trace.size / serial["total_s"],
         host_s=host["total_s"], host_requests_per_s=trace.size / host["total_s"],
         runs_at_once=3, card_step_s=card["seconds"], serial_card_step_s=serial["seconds"],
         host_step_s=host["seconds"], oracle_host_s=host["oracle_s"], reports_equal=True,
         oracle_counts_equal=True,
         inline_dedup_ratio=rep.inline_dedup_ratio, final_disk_blocks=rep.final_disk_blocks,
         moved_fps=card["resize"]["moved_fps"], moved_fraction=card["resize"]["moved_fraction"],
         recover=card["recover"], gc_steps=len(card["gc"]), gc_moved=moved[0],
         gc_collected=moved[1], snapshot_bytes=card["snapshot_bytes"],
         replica_blocks=cluster.replica_blocks, launches=launches, probe_routes=routes,
         launch_sizes={nm: size_stats(v) for nm, v in sizes.items()},
         kernel_ms_at_cluster_sizes=timings, max_memory_allocated=peak)
    del card, cluster
    _phase_cluster_serve(dev, results, srv, mix, seed)


def _phase_cluster_serve(dev, results: dict, srv, mix, seed: int) -> None:
    """``DedupKVServer(num_shards=4)`` on the ``serve`` phase's model and mix
    beside a one-engine server: equal infos, metrics, caches and pages for
    the first requests; then the cluster server takes a snapshot, loads it
    back and runs a GC step, and the next request and its decoded tokens
    still equal the one-engine server's."""
    from repro_torch.core import snapshot_engine
    from repro_torch.kernels import _build
    from repro_torch.serving.dedup_kv import DedupKVServer

    kw = dict(page_tokens=srv.page_tokens, max_slots=srv.max_slots, cache_entries=512,
              seed=seed, device=dev)
    one = DedupKVServer(srv.model, None, **kw)
    clu = DedupKVServer(srv.model, None, num_shards=CLUSTER_SHARDS, **kw)
    requests = mix[:CLUSTER_SERVE_REQUESTS + 1]
    _build.reset_launches()
    t0 = time.perf_counter()
    got = [clu.prefill_request(t, toks) for t, toks in requests[:-1]]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = clu.snapshot()
    engine_json = json.dumps(snap["engine"])
    clu.load_state(dict(snap, engine=json.loads(engine_json)))
    gc = clu.run_gc()
    state_s = time.perf_counter() - t0
    got.append(clu.prefill_request(*requests[-1]))
    launches = dict(_build.LAUNCHES)
    want = [one.prefill_request(t, toks) for t, toks in requests]
    check(launches["fingerprint"] > 0, "the fingerprint kernel never launched on the cluster "
                                       "server's path")
    check(dataclasses.asdict(clu.metrics) == dataclasses.asdict(one.metrics),
          "cluster server metrics != one-engine server's")
    for r, ((c1, p1, i1), (c2, p2, i2)) in enumerate(zip(got, want)):
        check(p1 == p2 and i1 == i2, f"request {r}: positions or hits differ")
        check(torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v), f"request {r}: caches differ")
    pages = 0
    for r, (tenant, toks) in enumerate(requests):
        for i in range(toks.size // clu.page_tokens):
            lba = (r << 24) | i
            a = one.pages[one.dedup.store.lba_map[(tenant, lba)]]
            shard = next(e for e in clu.dedup.shards if (tenant, lba) in e.store.lba_map)
            b = clu.pages[shard.store.lba_map[(tenant, lba)]]
            check(torch.equal(a.k, b.k) and torch.equal(a.v, b.v), f"page {r}.{i} differs")
            pages += 1
    c1, p1, _ = got[-1]
    c2, p2, _ = want[-1]
    tokens = clu.decode(c1, p1, steps=4)[0]
    check(tokens == one.decode(c2, p2, steps=4)[0], "cluster server decodes other tokens")
    clu.dedup.check_consistency()
    for name, n in launches.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})["cluster_serve"] = n
    shards_used = len({pba >> 48 for pba in clu.pages})
    emit("cluster_serve", shards=CLUSTER_SHARDS, requests=len(requests),
         blocks_total=clu.metrics.blocks_total,
         blocks_prefill_skipped=clu.metrics.blocks_prefill_skipped, pages=len(clu.pages),
         pages_checked=pages, shards_holding_pages=shards_used, prefill_s=prefill_s,
         snapshot_load_gc_s=state_s, engine_tree_bytes=len(engine_json), gc=gc,
         decoded_tokens=tokens, equal_to_one_engine=True, launches=launches,
         tree_kind=json.loads(json.dumps(snapshot_engine(clu.dedup)))["kind"])
    del one, clu, got, want
    torch.cuda.empty_cache()


# The ingest phase: the training launcher's tenant mix
# (``repro_torch.launch.train.default_tenants``) through
# ``DedupIngestPipeline`` at its class defaults (256-token blocks, 8,192
# cache entries, 64 blocks a fingerprint launch, post-processing every 4,096
# blocks, Zipf 1.2 tokens) over TinyLlama's 32,000-token vocabulary, ``next_batch(8, 2048)`` until 2^18 blocks are in.
INGEST_VOCAB = 32000
INGEST_BLOCKS = 1 << 18
INGEST_BATCH = (8, 2048)
INGEST_SHARDS = 4
INGEST_CRASH_AT = 32768  # blocks in when the crash snapshot is taken
INGEST_AFTER_CRASH = 16  # batches the restored pipeline takes
RATIO_TOL = 0.02  # inline-ratio tolerance of the float32 LDSS solver (ROADMAP §3)


def _batch_digest(batch: dict) -> str:
    h = hashlib.blake2b(digest_size=16)
    for key in ("inputs", "targets", "mask"):
        h.update(np.ascontiguousarray(batch[key]).tobytes())
    return h.hexdigest()


def _ingest_pipeline(device, seed: int, num_shards: int = 1, parallel: bool = False):
    from repro_torch.data import DedupIngestPipeline
    from repro_torch.launch.train import default_tenants

    return DedupIngestPipeline(default_tenants(), vocab=INGEST_VOCAB,
                               num_shards=num_shards, parallel_shards=parallel, seed=seed,
                               device=device)


def _predicted_ldss(pipe) -> dict:
    """Each tenant's predicted LDSS, summed over the shards' estimators."""
    out: dict = {}
    for est in pipe._estimators():
        for s, v in est.predicted.items():
            if v is not None:
                out[str(s)] = out.get(str(s), 0.0) + float(v)
    return out


def _ingest_run(device, seed: int, num_shards: int = 1, parallel: bool = False,
                crash_at: int = 0) -> dict:
    """Take ``next_batch(8, 2048)`` until the pipeline has ingested 2^18
    blocks.  Returns each batch's digest, the metrics and predicted LDSS
    after it, the seconds of the run and of its fingerprinting, engine
    writes and stream generation; with ``crash_at``, the pipeline's state
    as JSON after the first batch that brings the blocks in to
    ``crash_at`` (its seconds are not counted in the run's)."""
    import repro_torch.data.pipeline as pipeline_mod

    pipe = _ingest_pipeline(device, seed, num_shards, parallel)
    if parallel:
        # fan every batch out to the shard workers: at the cluster's default
        # floor of 2,048 records no 64-block batch would reach them
        pipe.engine.min_parallel_batch = 0
    secs = {"fingerprint": 0.0, "write_batch": 0.0, "streams": 0.0}

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                secs[key] += time.perf_counter() - t0
        return call

    for stream in pipe.streams.values():
        stream.next_block = timed("streams", stream.next_block)
    pipe.engine.write_batch = timed("write_batch", pipe.engine.write_batch)
    fingerprint_ints = pipeline_mod.fingerprint_ints
    pipeline_mod.fingerprint_ints = timed("fingerprint", fingerprint_ints)
    out: dict = {"digests": [], "metrics": [], "ldss": []}
    paused = 0.0
    try:
        t0 = time.perf_counter()
        while pipe.metrics.blocks_in < INGEST_BLOCKS:
            batch = pipe.next_batch(*INGEST_BATCH)
            out["digests"].append(_batch_digest(batch))
            out["metrics"].append(dataclasses.asdict(pipe.metrics))
            out["ldss"].append(_predicted_ldss(pipe))
            if crash_at and "state" not in out and pipe.metrics.blocks_in >= crash_at:
                t1 = time.perf_counter()
                out["state"] = json.dumps(pipe.state_dict())
                out["snapshot_s"] = time.perf_counter() - t1
                out["crash_batches"] = len(out["digests"])
                paused += out["snapshot_s"]
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0 - paused
    finally:
        pipeline_mod.fingerprint_ints = fingerprint_ints
        if parallel:
            pipe.engine.stop_executor()
    out["step_s"] = secs
    out["admitted_tokens"] = pipe.metrics.blocks_admitted * pipe.block_tokens
    out["index_tables"] = _index_tables(pipe.engine)
    return out


def _index_tables(engine) -> dict:
    """Keys in the engine's fingerprint indexes, summed over its shards:
    in the host set, in the table, and staged for the table but not yet
    folded into it (folded at the next probe through the table)."""
    out = {"set": 0, "table": 0, "staged": 0}
    for e in getattr(engine, "shards", [engine]):
        for index in (e._seen_fps, e.inline.cache.index, e.store.fp_index):
            st = index.table_stats()
            out["set"] += len(index)
            out["table"] += st["live"]
            out["staged"] += st["pending"]
    return out


def _ingest_child(spec: str) -> None:
    """One ingest run in a process of its own, which ``phase_ingest`` starts
    (``spec``: JSON of ``_ingest_run``'s arguments); prints its outcome and
    its launch counts as the last line."""
    from repro_torch.kernels import _build

    args = json.loads(spec)
    _build.reset_launches()
    out = _ingest_run(**args)
    out["launches"] = dict(_build.LAUNCHES)
    print(json.dumps(out), flush=True)


def _first_difference(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def _ingest_rates(run: dict) -> dict:
    blocks = run["metrics"][-1]["blocks_in"]
    return {"seconds": run["seconds"], "blocks_in": blocks,
            "blocks_per_s": blocks / run["seconds"],
            "admitted_tokens_per_s": run["admitted_tokens"] / run["seconds"],
            "batches": len(run["digests"]), "step_s": run["step_s"],
            "dedup_saving": blocks and run["metrics"][-1]["blocks_deduped_inline"] / blocks}


def phase_ingest(dev, results: dict, seed: int) -> None:
    """The ingest pipeline: (a) one engine on the card, then (b) the same on
    the host, each in this process with no other run alive; then (c) four
    shards on the card with shard worker threads, fanned out on every batch,
    and without them, at once in two processes of their own.  (d): the state
    after 32,768 blocks of (a), through JSON into a fresh pipeline on the
    card, which takes the next 16 batches (run between (a) and (b)).  (c)
    and (d) must equal their serial and uninterrupted runs bit for bit; (a)
    and (b) are expected equal, else within 0.02 of inline ratio with the
    first difference printed.  The fingerprint kernel must launch in (a),
    and the restore in (d) must rebuild the index tables on the card (insert
    launches); the path's launches are those of (a) and (d)."""
    import repro_torch.core.fp_index as core_index
    from repro_torch.data import PipelineMetrics
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fingerprint import fingerprint
    from repro_torch.launch.train import default_tenants

    # (a) the card, alone
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    core_index.reset_probe_routes()
    card = _ingest_run(dev, seed, crash_at=INGEST_CRASH_AT)
    launches = dict(_build.LAUNCHES)
    routes = dict(core_index.PROBE_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    check(launches["fingerprint"] > 0, "the fingerprint kernel never launched on the ingest path")

    # (d) crash and restore
    k = card["crash_batches"]
    _build.reset_launches()
    t0 = time.perf_counter()
    cold = _ingest_pipeline(dev, seed)
    cold.load_state(json.loads(card["state"]))
    load_s = time.perf_counter() - t0
    after = [_batch_digest(cold.next_batch(*INGEST_BATCH)) for _ in range(INGEST_AFTER_CRASH)]
    restore_launches = dict(_build.LAUNCHES)
    check(restore_launches["fp_insert"] > 0,
          "no insert launched: the restored pipeline did not rebuild its index tables on the card")
    check(after == card["digests"][k:k + INGEST_AFTER_CRASH],
          "the restored pipeline's batches != the uninterrupted run's")
    check(cold.metrics == PipelineMetrics(**card["metrics"][k + INGEST_AFTER_CRASH - 1]),
          "the restored pipeline's metrics != the uninterrupted run's")
    del cold

    # one fingerprint launch at the pipeline's shape, and one whole call
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, INGEST_VOCAB, size=(64, 256), dtype=np.int32)
    x = torch.from_numpy(blocks).to(dev)
    launch_ms = device_ms(lambda: fingerprint(x), reps=50)
    ops.fingerprint_ints(blocks, device=dev)
    t0 = time.perf_counter()
    for _ in range(200):
        ops.fingerprint_ints(blocks, device=dev)
    call_ms = (time.perf_counter() - t0) / 200 * 1e3

    # (b) the host, alone
    host_run = _ingest_run("cpu", seed)

    # (c) four shards, with and without workers, at once
    children = [_start_child("_ingest_child", spec) for spec in (
        {"device": "cuda", "seed": seed, "num_shards": INGEST_SHARDS, "parallel": True},
        {"device": "cuda", "seed": seed, "num_shards": INGEST_SHARDS})]
    try:
        sharded, serial_run = (
            _child_outcome(proc, f"the ingest run {what}") for proc, what in zip(
                children, ("on 4 shards with workers", "on 4 shards")))
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(sharded["digests"] == serial_run["digests"],
          "sharded ingest with worker threads != without them on the card")
    check(sharded["metrics"][-1] == serial_run["metrics"][-1], "sharded ingest metrics differ")

    # (a) against (b): equal, or within the estimator's tolerance
    first = _first_difference(card["digests"], host_run["digests"])
    versus_host = {"batches_equal": first is None,
                   "metrics_equal": card["metrics"][-1] == host_run["metrics"][-1]}
    if first is not None or not versus_host["metrics_equal"]:
        at = min(first if first is not None else len(card["ldss"]) - 1,
                 len(card["ldss"]) - 1, len(host_run["ldss"]) - 1)
        a, b = card["ldss"][at], host_run["ldss"][at]
        rel = max((abs(a[s] - b[s]) / max(abs(a[s]), abs(b[s]), 1e-30)
                   for s in set(a) & set(b)), default=0.0)
        gap = abs(_ingest_rates(card)["dedup_saving"] - _ingest_rates(host_run)["dedup_saving"])
        versus_host.update(first_differing_batch=first, ldss_max_rel_diff_there=rel,
                           ldss_keys_differ=sorted(set(a) ^ set(b)), dedup_saving_gap=gap)
        check(gap <= RATIO_TOL, f"ingest dedup saving on the card is {gap} from the host's")

    for name, n in launches.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})["ingest"] = (
            n + restore_launches[name])
    emit("ingest", tenants=len(default_tenants()), vocab=INGEST_VOCAB, block_tokens=256,
         fingerprint_batch=64, cache_entries=8192, batch=list(INGEST_BATCH), seed=seed,
         card=_ingest_rates(card), host=_ingest_rates(host_run), card_host_runs_at_once=1,
         host_cpus=os.cpu_count(), versus_host=versus_host, launches=launches,
         probe_routes=routes, index_tables=card["index_tables"], max_memory_allocated=peak,
         sharded={"shards": INGEST_SHARDS, "runs_at_once": 2, "workers": _ingest_rates(sharded),
                  "serial": _ingest_rates(serial_run), "equal": True,
                  "launches": sharded["launches"], "serial_launches": serial_run["launches"]},
         crash={"at_blocks": card["metrics"][k - 1]["blocks_in"], "batches_before": k,
                "snapshot_s": card["snapshot_s"], "json_bytes": len(card["state"]),
                "load_s": load_s, "batches_after": INGEST_AFTER_CRASH, "equal": True,
                "launches": restore_launches},
         fingerprint_launch_ms=launch_ms, fingerprint_ints_call_ms=call_ms,
         fingerprint_shape=[64, 256])
    del card, host_run, sharded, serial_run


# The train phase: ``repro_torch.launch.train``'s pipeline and trainer at the
# launcher's defaults (``default_tenants()``, 64-token blocks, 4,096 cache
# entries, batch 8 x 256, lr 1e-3, warmup max(steps // 20, 5)).  (a)
# TinyLlama-1.1B at full width and depth, 30 steps.  (b) The same widths cut
# to 2 layers (about 2.6 GB a checkpoint), 10 steps with a checkpoint every
# 5 and one failure injected before step 7.  (c) Prefill + one decode step
# against a longer prefill at TinyLlama's widths: held at 2 layers, printed at
# 4, 8 and 22 (with the reference's random initialisation the rounding gap
# grows about 2.3x a layer, ROADMAP.md §3).  (d) The other three dense
# configs at full width cut to 2 layers, held alike: at full depth none of
# them trains on one card, and DeepSeek-67B's bf16 weights alone are about
# 134 GB.
TRAIN_STEPS = 30
FT_LAYERS, FT_STEPS, FT_EVERY, FT_FAIL_AT = 2, 10, 5, 7
FT_LOSS_TOL = 1e-3  # the embedding backward accumulates with atomics
PREFILL_SHAPE = (4, 256)
PREFILL_DEPTHS = (2, 4, 8, 22)  # TinyLlama-1.1B; held at PREFILL_HELD_AT
PREFILL_HELD_AT = 2
OTHER_DENSE = ("deepseek-67b", "yi-34b", "phi3-medium-14b")
PREFILL_F32_TOL = 1e-3
PREFILL_BF16_TOL = 5e-2  # or the bf16 prefill's distance from the float32 one, if larger


def _train_run(dev, seed: int, steps: int, cfg=None, ckpt_dir: str = "", chaos=None,
               batch: int = 0, seq: int = 0, remat: str = "none") -> dict:
    """``launch.train.build`` at the launcher's defaults on the card (or at
    ``batch`` x ``seq`` tokens and the model's ``remat`` policy, if given),
    run: the outcome, the digest of each batch the trainer consumed (in
    order), each batch the pipeline made (digest, metrics after it), each
    step's seconds (synchronised), the launches of the run and the trainer
    and pipeline for what follows."""
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch

    argv = ["--steps", str(steps), "--seed", str(seed), "--device", str(dev)]
    if ckpt_dir:
        argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", str(FT_EVERY)]
    if batch:
        argv += ["--batch", str(batch), "--seq", str(seq)]
    args = launch.parse_args(argv)
    tr, pipe = launch.build(args, cfg=cfg, chaos=chaos, remat=remat)
    rec = {"consumed": [], "made": [], "step_s": [], "args": args}
    source, to_device, step = tr.batch_iter, tr._device_batch, tr._step

    def made():
        batch = next(source)
        rec["made"].append((_batch_digest(batch), dataclasses.asdict(pipe.metrics)))
        return batch

    def consume(batch):
        rec["consumed"].append(_batch_digest(batch))
        return to_device(batch)

    def timed_step(*a):
        t0 = time.perf_counter()
        out = step(*a)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        return out

    tr.batch_iter, tr._device_batch, tr._step = iter(made, None), consume, timed_step
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rec["out"] = tr.run()
    torch.cuda.synchronize()
    rec["run_s"] = time.perf_counter() - t0
    rec["launches"] = dict(_build.LAUNCHES)
    rec["trainer"], rec["pipe"] = tr, pipe
    tr._device_batch, tr._step = to_device, step
    return rec


def _versus_host(rec: dict, vocab: int) -> dict:
    """The card pipeline's batches against the launcher's pipeline on the
    host: equal, else dedup saving within ``RATIO_TOL`` (the first
    difference printed)."""
    from repro_torch.launch import train as launch

    host = launch.make_pipeline(rec["args"], vocab, "cpu")
    b, s = rec["args"].batch, rec["args"].seq
    want = []
    for _ in rec["made"]:
        batch = host.next_batch(b, s)
        want.append((_batch_digest(batch), dataclasses.asdict(host.metrics)))
    first = _first_difference([d for d, _ in rec["made"]], [d for d, _ in want])
    out = {"batches": len(want), "batches_equal": first is None,
           "metrics_equal": [m for _, m in rec["made"]] == [m for _, m in want]}
    if first is not None or not out["metrics_equal"]:
        def saving(m):
            return m["blocks_deduped_inline"] / max(m["blocks_in"], 1)
        gap = abs(saving(rec["made"][-1][1]) - saving(want[-1][1]))
        out.update(first_differing_batch=first, dedup_saving_gap=gap)
        check(gap <= RATIO_TOL, f"train: dedup saving on the card is {gap} from the host's")
    return out


def _attention_flops(cfg, b: int, s: int) -> float:
    """Forward FLOPs of the attention's QK^T and PV over a sequence of ``s``
    in every attention layer, as the reference's schedules compute them: a
    banded layer S x (window + c) per head (its band of window // c + 1
    chunks of c), any other S x S (the reference's flash schedule computes
    every chunk; the port's skips the rows before a causal chunk, about half
    of it, which this count ignores)."""
    from repro_torch.models.attention import KV_CHUNK, _banded
    from repro_torch.models.transformer import ATTENTION, window_of

    total = 0
    for mixer, _ in cfg.layer_kinds:
        if mixer not in ATTENTION:
            continue
        window = window_of(cfg, mixer)
        keys = window + min(window, KV_CHUNK, s) if _banded(s, window) else s
        total += 4 * b * s * keys * cfg.num_heads * cfg.head_dim
    return float(total)


def _step_flops(cfg, b: int, s: int) -> float:
    """Model FLOPs of one train step of a dense config: 6 per weight of a
    matrix product and token (forward, and twice that backward) and the
    attention's QK^T and PV (``_attention_flops``), 3x their forward; the
    loss chunks' recompute and remat's are not counted."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) + 3 * d * cfg.d_ff
    matmul = cfg.num_layers * per_layer + d * cfg.vocab_size
    return 6.0 * matmul * b * s + 3.0 * _attention_flops(cfg, b, s)


def _producer_wait(calls: list, dev, vocab: int, block_tokens: int, seed: int) -> dict:
    """The producer's ``fingerprint_ints`` calls under training against the
    same call on an idle card: their sum less as many idle calls is the time
    they waited on the stream behind the step's queued work."""
    from repro_torch.kernels import ops

    blocks = np.random.default_rng(seed).integers(0, vocab, (64, block_tokens), dtype=np.int32)
    ops.fingerprint_ints(blocks, device=dev)
    idle = []
    for _ in range(100):
        t0 = time.perf_counter()
        ops.fingerprint_ints(blocks, device=dev)
        idle.append(time.perf_counter() - t0)
    idle_ms = float(np.median(idle)) * 1e3
    return {"calls": len(calls), "total_s": float(np.sum(calls)),
            "median_ms": float(np.median(calls)) * 1e3, "max_ms": float(np.max(calls)) * 1e3,
            "idle_call_ms": idle_ms,
            "wait_s": float(np.sum(calls)) - len(calls) * idle_ms / 1e3}


def _train_full(dev, results: dict, seed: int) -> None:
    """(a) TinyLlama-1.1B at full width and depth through the launcher's
    trainer, the pipeline on the card in its producer thread."""
    import repro_torch.data.pipeline as pipeline_mod
    from repro_torch.pytree import leaves

    fp_calls = []
    fingerprint_ints = pipeline_mod.fingerprint_ints

    def timed_fingerprint(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fingerprint_ints(*args, **kw)
        finally:
            fp_calls.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipeline_mod.fingerprint_ints = timed_fingerprint
    try:
        rec = _train_run(dev, seed, TRAIN_STEPS)
    finally:
        pipeline_mod.fingerprint_ints = fingerprint_ints
    peak = torch.cuda.max_memory_allocated()
    tr, pipe, out, launches = rec["trainer"], rec["pipe"], rec["out"], rec["launches"]
    cfg, b, s = tr.model.cfg, rec["args"].batch, rec["args"].seq
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
           cfg.vocab_size) == (22, 2048, 32, 4, 64, 5632, 32000), "TinyLlama-1.1B's widths")
    losses = out["losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train: losses not all finite: {losses}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"train: loss did not fall: first {losses[:3]}, last {losses[-3:]}")
    check(out["restarts"] == 0, f"train: {out['restarts']} restarts, no failure injected")
    check(launches["fingerprint"] > 0, "the fingerprint kernel never launched on the train path")
    check(rec["consumed"] == [d for d, _ in rec["made"][:TRAIN_STEPS]],
          "train: the trainer did not consume the pipeline's batches in order")
    versus_host = _versus_host(rec, cfg.vocab_size)

    median_s = float(np.median(rec["step_s"][3:]))
    flops = _step_flops(cfg, b, s)
    batches = [tr._device_batch(pipe.next_batch(b, s)) for _ in range(2)]

    def two_steps():
        for batch in batches:
            tr.params, tr.opt_state, _, _ = tr._step(tr.params, tr.opt_state, batch)

    busy = _device_busy(two_steps)
    busy["launches_a_step"] = busy["device_entries"] / 2
    m = pipe.metrics
    emit("train", part="full", model=cfg.name, params=sum(t.numel() for t in leaves(tr.params)),
         layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size, batch=[b, s],
         steps=out["final_step"], restarts=out["restarts"], backup_fires=out["backup_fires"],
         first_loss=losses[0], final_loss=losses[-1], losses=losses, run_s=rec["run_s"],
         median_step_ms=median_s * 1e3, step_ms=[x * 1e3 for x in rec["step_s"]],
         tokens_per_s=b * s / median_s, step_model_flops=flops,
         model_tflops_per_s=flops / median_s / 1e12, max_memory_allocated=peak,
         profiled_2_steps=busy,
         producer=_producer_wait(fp_calls, dev, cfg.vocab_size, rec["args"].block_tokens, seed),
         versus_host=versus_host, launches=launches, ingest_blocks=m.blocks_in,
         inline_deduped=m.blocks_deduped_inline, dedup_saving=m.dedup_saving)
    for name, n in launches.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})["train"] = n
    del tr, pipe, rec, batches
    torch.cuda.empty_cache()


def _train_fault_tolerance(dev, results: dict, seed: int) -> None:
    """(b) A 2-layer cut at full width: an uninterrupted run, then the same
    run with a checkpoint every 5 steps and one failure before step 7."""
    import shutil
    import tempfile

    import repro_torch.ckpt.checkpoint as ckpt_mod
    from repro_torch.configs import get_config

    cut = get_config("tinyllama-1.1b").replace(num_layers=FT_LAYERS)
    plain = _train_run(dev, seed, FT_STEPS, cfg=cut)
    plain_out = plain["out"]
    del plain["trainer"], plain["pipe"]
    torch.cuda.empty_cache()

    fired = []

    def chaos(step):
        if step == FT_FAIL_AT and not fired:
            fired.append(step)
            raise RuntimeError("injected failure")

    seconds = {"save": [], "restore": []}
    save, restore = ckpt_mod.save, ckpt_mod.restore

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                seconds[key].append(time.perf_counter() - t0)
        return call

    tmp = tempfile.mkdtemp(prefix="train_ckpt_", dir=os.path.join(ROOT, "build"))
    ckpt_mod.save, ckpt_mod.restore = timed("save", save), timed("restore", restore)
    try:
        rec = _train_run(dev, seed, FT_STEPS, cfg=cut, ckpt_dir=tmp, chaos=chaos)
        step_dir = os.path.join(tmp, f"step_{FT_STEPS}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        # the last checkpoint and the weights it holds, for the sharding phase
        kept = os.path.join(ROOT, "build", "sharding_ckpt")
        shutil.rmtree(kept, ignore_errors=True)
        os.makedirs(kept)
        os.replace(step_dir, os.path.join(kept, f"step_{FT_STEPS}"))
        results["_train_ckpt"] = (kept, FT_STEPS, cut, {
            k: v for k, v in _host_leaves(rec["trainer"].params).items()})
    finally:
        ckpt_mod.save, ckpt_mod.restore = save, restore
        shutil.rmtree(tmp, ignore_errors=True)
    out = rec["out"]
    check(out["restarts"] == len(fired) == 1,
          f"fault tolerance: {out['restarts']} restarts for {len(fired)} injected failure")
    check(plain_out["restarts"] == 0, "fault tolerance: the uninterrupted run restarted")
    check(out["final_step"] == FT_STEPS, f"fault tolerance: ended at step {out['final_step']}")
    consumed, want = rec["consumed"], plain["consumed"]
    check(consumed[:FT_FAIL_AT] == want[:FT_FAIL_AT] and consumed[FT_FAIL_AT:] == want[FT_EVERY:],
          "fault tolerance: the batches after the restore are not the uninterrupted run's")
    loss_gap = float(np.max(np.abs(np.array(out["losses"]) - np.array(plain_out["losses"]))))
    check(loss_gap <= FT_LOSS_TOL,
          f"fault tolerance: losses {loss_gap} from the uninterrupted run's")
    emit("train", part="fault_tolerance", layers=FT_LAYERS, steps=FT_STEPS, ckpt_every=FT_EVERY,
         failure_before_step=FT_FAIL_AT, restarts=out["restarts"], final_step=out["final_step"],
         batches_after_restore_equal=True, max_loss_gap=loss_gap, loss_tol=FT_LOSS_TOL,
         losses=out["losses"], checkpoint_bytes=ckpt_bytes, save_s=seconds["save"],
         restore_s=seconds["restore"], launches=rec["launches"],
         uninterrupted_launches=plain["launches"])
    for name in KERNELS:
        by_path = results.setdefault(name, {}).setdefault("launches_by_path", {})
        by_path["train"] = (by_path.get("train", 0) + rec["launches"].get(name, 0)
                            + plain["launches"].get(name, 0))
    del rec
    torch.cuda.empty_cache()


def _host_leaves(tree) -> dict:
    """Each leaf of a tensor tree, by its key path, copied to the host."""
    from repro_torch.pytree import flatten_with_path

    return {"__".join(path): t.detach().to("cpu", copy=True)
            for path, t in flatten_with_path(tree)}


def _prefill_check(dev, cfg, seed: int, held: bool, dtypes=("float32", "bfloat16"),
                   bf16_tol=None, both_paths: bool = False) -> dict:
    """``Model.prefill`` of S - 1 tokens, then one ``decode_step``, against
    the last-token logits of ``Model.prefill`` of all S tokens, in each of
    ``dtypes`` from the same weights (in ``cfg.param_dtype``).  A model with
    RWKV6 layers prefills S - 32 tokens and decodes 32 (its chunked prefill
    takes multiples of 32).  MoE layers route at a capacity that drops no
    token (E / k), in prefill and decode; the share the config's capacity
    factor would drop is printed.  With ``held``: float32 within
    ``PREFILL_F32_TOL``, bf16 within the larger of ``PREFILL_BF16_TOL`` and
    the bf16 prefill's distance from the float32 one (or ``bf16_tol``);
    with ``both_paths`` also the bf16 decode's distance from the float32
    decode, if larger: the two bf16 paths round apart, each by about its
    own distance from float32 (``_bf16_tol``)."""
    from repro_torch.models import build_model
    from repro_torch.models.config import RWKV

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b, s = PREFILL_SHAPE
    start = s - 32 if any(m == RWKV for m, _ in cfg.layer_kinds) else s - 1
    decode_kw, config_cf = {}, cfg.capacity_factor
    if cfg.num_experts:
        no_drop = cfg.num_experts / cfg.top_k
        cfg, decode_kw = cfg.replace(capacity_factor=no_drop), {"capacity_factor": no_drop}
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(seed))
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed + 1))
    out = {"params": _n_params(params), "layers": cfg.num_layers, "d_model": cfg.d_model,
           "param_dtype": cfg.param_dtype, "held": held, "prefix": start}
    prefills, decodes = {}, {}
    for dt in dtypes:
        model = build_model(cfg.replace(compute_dtype=dt))
        longer, last = _MoeProbe(config_cf), _MoeProbe(config_cf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with longer:
            want, _ = model.prefill(params, {"inputs": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        _, cache = model.prefill(params, {"inputs": toks[:, :start]}, slots=s)
        model.load(params)
        for pos in range(start, s):
            with last if pos == s - 1 else contextlib.nullcontext():
                got, cache = model.decode_step(cache, toks[:, pos:pos + 1], pos, **decode_kw)
        check(bool(torch.isfinite(want).all() and torch.isfinite(got).all()),
              f"{cfg.name} {dt}: non-finite logits")
        prefills[dt], decodes[dt] = want.float(), got.float()
        out[dt] = {"gap": float((got.float() - want.float()).abs().max()),
                   "row_gaps": (got.float() - want.float()).abs().amax(dim=-1).tolist(),
                   "max_abs_logit": float(want.float().abs().max()),
                   "prefill_ms": prefill_s * 1e3}
        if longer.shares:
            # a row's last token routed to other experts by the decode step
            # than by the longer prefill: a near-tie the two paths round apart
            flips = [(a != b).any(dim=-1).int().tolist()
                     for a, b in zip(longer.last_experts, last.last_experts)]
            out[dt].update(dropped_at_config_capacity=longer.shares, routing_flips=flips)
        del model, cache, want, got
    if "float32" in out:
        out["float32"]["tol"] = PREFILL_F32_TOL
    if "bfloat16" in out:
        if "float32" in prefills:
            d = float((prefills["bfloat16"] - prefills["float32"]).abs().max())
            d_dec = float((decodes["bfloat16"] - decodes["float32"]).abs().max())
            out["bfloat16"].update(bf16_vs_float32_prefill=d, bf16_vs_float32_decode=d_dec,
                                   tol=_bf16_tol(d, d_dec if both_paths else 0.0))
        else:
            out["bfloat16"]["tol"] = bf16_tol
    if held:
        for dt in dtypes:
            check(out[dt]["gap"] <= out[dt]["tol"],
                  f"{cfg.name} {dt}: prefill + decode_step is {out[dt]['gap']} from the longer "
                  f"prefill (> {out[dt]['tol']})")
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params, prefills
    _free()
    return out


def _bf16_tol(*distances: float) -> float:
    """A bf16 path against another: ``PREFILL_BF16_TOL``, or the larger of
    the paths' measured distances from their float32 runs."""
    return max(PREFILL_BF16_TOL, *distances)


def phase_train(dev, results: dict, seed: int) -> None:
    """The training path through ``repro_torch.launch.train``'s objects:
    (a) full TinyLlama-1.1B, (b) a failure and a restore, (c) prefill +
    decode at TinyLlama's widths, (d) the other three dense configs.
    Launch counts are zeroed just before each trainer run and read just
    after; ``launches_by_path["train"]`` sums (a) and (b)."""
    from repro_torch.configs import get_config

    _train_full(dev, results, seed)
    _train_fault_tolerance(dev, results, seed)
    tiny = get_config("tinyllama-1.1b")
    emit("train", part="prefill", shape=list(PREFILL_SHAPE),
         depths={n: _prefill_check(dev, tiny.replace(num_layers=n), seed, n == PREFILL_HELD_AT)
                 for n in PREFILL_DEPTHS})
    emit("train", part="other_dense", shape=list(PREFILL_SHAPE),
         configs={arch: _prefill_check(dev, get_config(arch).replace(num_layers=PREFILL_HELD_AT),
                                       seed, True)
                  for arch in OTHER_DENSE})


# The blocks phase: the other block kinds at their published widths, depth
# cut where one card or the script's time forces it (PERF.md §4).
BLOCKS_SERVE_LAYERS = 2          # Mixtral-8x7B behind the server
BLOCKS_TRAIN = (("rwkv6-1.6b", None), ("recurrentgemma-2b", 5), ("mixtral-8x7b", 2))
BLOCKS_TRAIN_STEPS = 10
BLOCKS_PREFILL = (("mixtral-8x7b", 2), ("qwen2-vl-7b", 2), ("recurrentgemma-2b", 5),
                  ("rwkv6-1.6b", 2))
RWKV_PRINTED_AT = 24
MAVERICK_LAYERS, MAVERICK_TOL_EXPERTS = 2, 16
WHISPER_FRAMES, WHISPER_STEPS = 1024, 32


def _widths(cfg) -> tuple:
    return (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size)


def _blocks_serve(dev, smi: str, seed: int) -> dict:
    """(a) Mixtral-8x7B cut to 2 layers behind ``DedupKVServer`` at
    ``launch/serve.py``'s defaults, beside a server that caches nothing."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import request_mix
    from repro_torch.models import build_model
    from repro_torch.pytree import leaves
    from repro_torch.serving.dedup_kv import DedupKVServer

    full = get_config("mixtral-8x7b")
    check(_widths(full) + (full.attn_window, full.num_experts, full.top_k)
          == (4096, 32, 8, 128, 14336, 32000, 4096, 8, 2), "Mixtral-8x7B's widths")
    cfg = full.replace(num_layers=BLOCKS_SERVE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    n_params = sum(t.numel() for t in leaves(params))
    # launch/serve.py's defaults: 16 requests, 96 shared tokens, 8 decode steps
    kw = dict(page_tokens=16, max_slots=max(256, 4 * 96), seed=seed, device=dev)
    srv = DedupKVServer(model, params, cache_entries=512, **kw)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    mix = request_mix(cfg.vocab_size, 16, 96, np.random.default_rng(seed))
    last = len(mix) - 1
    _build.reset_launches()
    _, out, prefill_s, decode_s, merged = _serve_once(srv, mix, {last})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches["fingerprint"] > 0, "blocks serve: the fingerprint kernel never launched")
    m = srv.metrics
    check(m.blocks_prefill_skipped > 0, "blocks serve: no block skipped")
    srv.dedup.store.check_consistency()
    nodedup = DedupKVServer(model, None, cache_entries=0, **kw)
    _, out0, prefill0_s, decode0_s, _ = _serve_once(nodedup, mix, {last})
    check(out == out0, f"blocks serve: decoded tokens {out} != {out0} without dedup")
    tokens = int(sum(t.size for _, t in mix))
    emit("blocks", part="serve", card=smi, model=cfg.name, params=n_params,
         layers=cfg.num_layers, d_model=cfg.d_model, experts=cfg.num_experts,
         window=cfg.attn_window, max_slots=kw["max_slots"], requests=len(mix), tokens=tokens,
         blocks_total=m.blocks_total, blocks_prefill_skipped=m.blocks_prefill_skipped,
         prefill_saving=m.prefill_saving, pages=len(srv.pages),
         duplicates_found_by_postprocess=merged, decoded_tokens=out, decoded_equal=True,
         init_s=init_s, prefill_s=prefill_s, prefill_tokens_per_s=tokens / prefill_s,
         decode_ms_per_step=decode_s / SERVE_DECODE_STEPS * 1e3,
         nodedup_prefill_tokens_per_s=tokens / prefill0_s,
         nodedup_decode_ms_per_step=decode0_s / SERVE_DECODE_STEPS * 1e3,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
    del srv, nodedup, model
    _free()
    return launches


def _blocks_train(dev, smi: str, seed: int, arch: str, layers) -> dict:
    """(b) ``launch.train.build`` at the launcher's defaults on one config
    (depth cut to ``layers`` if given), 10 steps."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = _train_run(dev, seed, BLOCKS_TRAIN_STEPS, cfg=cfg)
    peak = torch.cuda.max_memory_allocated()
    out, launches = rec["out"], rec["launches"]
    losses = out["losses"]
    check(len(losses) == BLOCKS_TRAIN_STEPS and all(np.isfinite(losses)),
          f"blocks train {arch}: losses not all finite: {losses}")
    check(out["restarts"] == 0, f"blocks train {arch}: {out['restarts']} restarts")
    check(launches["fingerprint"] > 0, f"blocks train {arch}: the fingerprint kernel never ran")
    check(rec["consumed"] == [d for d, _ in rec["made"][:BLOCKS_TRAIN_STEPS]],
          f"blocks train {arch}: the trainer did not consume the pipeline's batches in order")
    versus_host = _versus_host(rec, cfg.vocab_size)
    b, s = rec["args"].batch, rec["args"].seq
    median_s = float(np.median(rec["step_s"][2:]))
    flops = 6.0 * cfg.active_params_per_token_matmul() * b * s
    n_params = _n_params(rec["trainer"].params)
    emit("blocks", part="train", card=smi, model=cfg.name, params=n_params,
         layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size, batch=[b, s],
         steps=out["final_step"], losses=losses, run_s=rec["run_s"],
         median_step_ms=median_s * 1e3, step_ms=[x * 1e3 for x in rec["step_s"]],
         tokens_per_s=b * s / median_s, step_model_flops=flops,
         model_tflops_per_s=flops / median_s / 1e12, max_memory_allocated=peak,
         versus_host=versus_host, launches=launches, phase_s=time.perf_counter() - t0)
    del rec
    _free()
    return launches


def _free() -> None:
    """Collect the trainer's and server's reference cycles (closures that
    hold them) and return the card memory they held."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _n_params(tree) -> int:
    from repro_torch.pytree import leaves

    return sum(t.numel() for t in leaves(tree))


class _MoeProbe:
    """Within the block, for each MoE layer called: the share of its
    (token, choice) assignments that ``capacity_factor`` would drop, and the
    experts chosen for each row's last token (sorted)."""

    def __init__(self, capacity_factor: float):
        self.cf, self.shares, self.last_experts = capacity_factor, [], []

    def __enter__(self):
        from repro_torch.models import moe, transformer

        self._orig = transformer.moe_apply

        def recording(p, x, *, top_k, capacity_factor, act="swiglu"):
            self.shares.append(moe.drop_share(p, x, top_k, self.cf))
            ids = moe.route(x[:, -1], p["router"], top_k, self.cf).expert_ids
            self.last_experts.append(torch.sort(ids, dim=-1).values)
            return self._orig(p, x, top_k=top_k, capacity_factor=capacity_factor, act=act)

        transformer.moe_apply = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        transformer.moe_apply = self._orig


def _mrope_check(dev, cfg, seed: int) -> dict:
    """Qwen2-VL's M-RoPE at PREFILL_SHAPE in the config's compute dtype: with
    one position stream (all three equal) the prefill equals standard
    RoPE's bit for bit; with distinct (temporal, height, width) streams, as
    an image's patches give, it is finite and another function."""
    from repro_torch.models import transformer

    b, s = PREFILL_SHAPE
    params = transformer.init_decoder_params(torch.Generator(dev).manual_seed(seed), cfg)
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed + 1))
    t = torch.arange(s, device=dev)
    pos = t.expand(b, s)
    one_stream, _ = transformer.prefill(params, toks, pos, cfg)
    plain, _ = transformer.prefill(params, toks, pos, cfg.replace(mrope_sections=()))
    check(torch.equal(one_stream, plain), "qwen2-vl: M-RoPE with equal streams != RoPE")
    streams = torch.stack([t // 64, (t // 8) % 8, t % 8])[:, None].expand(3, b, s)
    image, _ = transformer.prefill(params, toks, streams, cfg)
    check(bool(torch.isfinite(image).all()), "qwen2-vl: non-finite logits at three streams")
    moved = float((image.float() - one_stream.float()).abs().max())
    check(moved > 0, "qwen2-vl: three distinct position streams changed nothing")
    del params
    torch.cuda.empty_cache()
    return {"equal_streams_bit_equal_rope": True, "distinct_streams_max_change": moved,
            "sections": list(cfg.mrope_sections)}


def _maverick_check(dev, seed: int) -> dict:
    """Llama-4 Maverick at 2 layers (a dense layer and a 128-expert MoE
    layer, 18.4 B weights): its weights in bf16 (37 GB; float32 does not fit
    beside a prefill), checked in bf16 against the tolerance a float32-vs-
    bf16 run at the same widths with 16 experts gives."""
    from repro_torch.configs import get_config

    full = get_config("llama4-maverick-400b-a17b")
    check(_widths(full) + (full.num_experts, full.top_k) == (5120, 40, 8, 128, 8192, 202048,
                                                             128, 1), "Maverick's widths")
    cut = full.replace(num_layers=MAVERICK_LAYERS)
    tol_run = _prefill_check(dev, cut.replace(num_experts=MAVERICK_TOL_EXPERTS), seed, True,
                             both_paths=True)
    tol = tol_run["bfloat16"]["tol"]
    held = _prefill_check(dev, cut.replace(param_dtype="bfloat16"), seed, True,
                          dtypes=("bfloat16",), bf16_tol=tol)
    return {"bf16_weights": held, f"tolerance_run_{MAVERICK_TOL_EXPERTS}_experts": tol_run}


def _whisper_run(dev, cfg, seed: int) -> dict:
    """``encode_prefill`` of 4 x ``WHISPER_FRAMES`` frame embeddings, then
    ``WHISPER_STEPS`` decode steps against the teacher-forced decoder's
    logits, float32 and bf16 from the same float32 weights: each step's gap,
    the times, and each dtype's distance from the float32 run."""
    from repro_torch.models import build_model, encdec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = PREFILL_SHAPE[0]
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(seed))
    gen = torch.Generator(dev).manual_seed(seed + 1)
    frames = torch.randn(b, WHISPER_FRAMES, cfg.d_model, device=dev, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (b, WHISPER_STEPS), device=dev, generator=gen)
    out = {"params": _n_params(params), "encoder_layers": cfg.encoder_layers,
           "decoder_layers": cfg.num_layers}
    forced, decoded = {}, {}
    for dt in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dt)
        model = build_model(c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, cache = model.prefill(params, {"encoder_embeds": frames})
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        with torch.no_grad():
            want = encdec.decoder_logits(params, enc, toks, c).float()
        model.load(params)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(WHISPER_STEPS):
            got, cache = model.decode_step(cache, toks[:, pos:pos + 1], pos)
            steps.append(got.float())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        got = torch.stack(steps, dim=1)
        check(bool(torch.isfinite(want).all() and torch.isfinite(got).all()),
              f"whisper {dt}: non-finite logits")
        forced[dt], decoded[dt] = want, got
        out[dt] = {"gap": float((got - want).abs().max()),
                   "step_gaps": (got - want).abs().amax(dim=(0, 2)).tolist(),
                   "encode_prefill_ms": encode_s * 1e3,
                   "decode_ms_per_step": decode_s / WHISPER_STEPS * 1e3,
                   "max_abs_logit": float(want.abs().max())}
        del model, enc, cache
    d = float((forced["bfloat16"] - forced["float32"]).abs().max())
    d_dec = float((decoded["bfloat16"] - decoded["float32"]).abs().max())
    out["float32"]["tol"] = PREFILL_F32_TOL
    out["bfloat16"].update(bf16_vs_float32_forced=d, bf16_vs_float32_decode=d_dec,
                           tol=_bf16_tol(d, d_dec))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params, forced, decoded
    _free()
    return out


def _whisper_check(dev, smi: str, seed: int) -> None:
    """(d) Whisper-small at full width and depth (12 + 12 layers) and cut to
    2 + 2: ``encode_prefill`` of 4 x 1,024 frame embeddings, 32 decode
    steps against the teacher-forced decoder.  Held at 2 + 2 layers over all
    32 steps at (c)'s tolerances; at full depth the float32 gap grows with
    the decode position (each step's self-attention reads K/V the earlier
    decode steps rounded apart from the teacher-forced pass's, through 12
    layers), so there the first step is held to ``PREFILL_F32_TOL`` and the
    rest printed."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-small")
    check((cfg.encoder_layers, cfg.num_layers) + _widths(cfg) == (12, 12, 768, 12, 12, 64, 3072,
                                                                   51865), "Whisper's widths")
    t0 = time.perf_counter()
    full = _whisper_run(dev, cfg, seed)
    check(full["float32"]["step_gaps"][0] <= PREFILL_F32_TOL,
          f"whisper float32: the first decode step is {full['float32']['step_gaps'][0]} from the "
          f"teacher-forced logits")
    cut = _whisper_run(dev, cfg.replace(num_layers=2, encoder_layers=2), seed)
    for dt in ("float32", "bfloat16"):
        check(cut[dt]["gap"] <= cut[dt]["tol"],
              f"whisper 2+2 layers {dt}: decode is {cut[dt]['gap']} from the teacher-forced "
              f"logits (> {cut[dt]['tol']})")
    emit("blocks", part="whisper", card=smi, model=cfg.name, batch=PREFILL_SHAPE[0],
         frames=WHISPER_FRAMES, decode_steps=WHISPER_STEPS, full_depth=full, held_2_2=cut,
         phase_s=time.perf_counter() - t0)


def phase_blocks(dev, results: dict, smi: str, seed: int) -> None:
    """The other block kinds through the port's entry points: (a) Mixtral
    behind the KV-page server, (b) RWKV6, RecurrentGemma and Mixtral through
    the training launcher, (c) prefill + decode on the five decoder-only
    configs, (d) Whisper's encoder-decoder.  Launch counts are zeroed just
    before the serve run and each trainer run and read just after;
    ``launches_by_path["blocks"]`` sums them."""
    from repro_torch.configs import get_config

    total: dict = {}
    t0 = time.perf_counter()
    for launches in [_blocks_serve(dev, smi, seed)] + [
            _blocks_train(dev, smi, seed, arch, layers) for arch, layers in BLOCKS_TRAIN]:
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    configs = {}
    for arch, layers in BLOCKS_PREFILL:
        configs[arch] = _prefill_check(dev, get_config(arch).replace(num_layers=layers), seed,
                                       True, both_paths=True)
    configs["rwkv6-1.6b"]["printed_at_full_depth"] = _prefill_check(
        dev, get_config("rwkv6-1.6b").replace(num_layers=RWKV_PRINTED_AT), seed, False,
        both_paths=True)
    configs["qwen2-vl-7b"]["mrope"] = _mrope_check(
        dev, get_config("qwen2-vl-7b").replace(num_layers=2), seed)
    configs["llama4-maverick-400b-a17b"] = _maverick_check(dev, seed)
    emit("blocks", part="prefill", card=smi, shape=list(PREFILL_SHAPE), configs=configs,
         phase_s=time.perf_counter() - t0)
    _whisper_check(dev, smi, seed)
    for name in KERNELS:
        results.setdefault(name, {}).setdefault("launches_by_path", {})["blocks"] = \
            total.get(name, 0)
    check(total.get("fingerprint", 0) > 0, "blocks: the fingerprint kernel never launched")
    emit("blocks_summary", card=smi, launches=total, serve_and_train_s=train_s)


# The long phase: the reference's long-sequence attention schedules
# (``models.attention.flash_attend`` and ``banded_attend``) and its remat
# policies at ``configs/shapes.py``'s lengths, at published widths.  (a) Each
# schedule against the plain version (``attend_plain``, the whole Sq x Sk)
# on the card; (b) TinyLlama-1.1B training at train_4k's 4,096 tokens; (c)
# its prefill at prefill_32k's 32,768 tokens, then decode; (d) the banded
# schedule inside Mixtral-8x7B and RecurrentGemma-2B prefills.
LONG_FLASH = (2, 4096, 32, 4, 64)        # batch, S, heads, KV heads, head dim
LONG_BANDED = (1, 8192, 32, 4, 64)
LONG_WINDOWS = (4096, 2048)
LONG_TOL, LONG_GRAD_TOL = 3e-5, 1e-4     # tests/test_attention_equivalence.py's
# flash_attend(q_offset=): LONG_FLASH's causal sequence in this many blocks of
# query rows, each at its offset against the whole K and V (float32)
LONG_Q_BLOCKS = 4
# bf16, per element: one bf16 step (2^-7 of the value) plus the float32 limit
LONG_BF16_RTOL = 2.0 ** -7
LONG_TRAIN_SEQ = 4096                    # train_4k
LONG_TRAIN = ((2, "none", 6), (2, "full", 5))  # batch, remat, steps
LONG_LOSS_RTOL = 1e-5
LONG_PREFILL_SEQ = 32768                 # prefill_32k
LONG_DECODE_STEPS = 8
# Held at 2 layers: a prefill 512 tokens shorter (the flash schedule takes
# multiples of 512) and 512 decode steps against the whole prefill.
LONG_HELD_LAYERS, LONG_HELD_DECODE = 2, 512
LONG_BANDED_SEQ = 8192
LONG_BANDED_MODELS = (("mixtral-8x7b", 2), ("recurrentgemma-2b", 5))
LONG_LAYER_TOL = 1e-4
# (e) RecurrentGemma-2B's local attention (10 heads, 1 KV head, head dim 256,
# window 2,048) at train_4k's 4,096 tokens, batch 2: the banded schedule
# against the plain version in float32 (LONG_TOL, LONG_GRAD_TOL); then 5
# layers (one block_pattern group, its attention layer inside a remat unit,
# and the two remainder layers) under each remat policy against "none"
# (LONG_LOSS_RTOL), with the band's products counted by call
LONG_RG = "recurrentgemma-2b"
LONG_RG_BATCH, LONG_RG_LAYERS = 2, 5
LONG_RG_REMATS = ("none", "dots", "full")
LONG_RG_PRODUCTS = ("_logits", "_pv", "_tp")


def _gb(n: int) -> float:
    return n / 1e9


def _schedule_case(dev, fn, plain, shape, dtype, seed: int, float64: bool = False) -> dict:
    """One schedule against the plain version on the same unit-normal q, k,
    v: the largest gaps of the output and of dq, dk, dv (of ``sum(out *
    w)``), each one's ms forward and forward + backward (CUDA events), the
    peak MB a forward + backward adds to its inputs, and under ``over`` what
    passed its limit (checked once the line is printed).  With ``float64``
    (float32 inputs), also each one's largest gaps from the plain version
    in float64: which of the two a gap between them comes from."""
    b, s, h, kvh, d = shape
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, s, kvh, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, s, kvh, d, device=dev, generator=gen).to(dtype)
    w = torch.randn(b, s, h, d, device=dev, generator=gen)
    got, row = {}, {}
    for name, f in (("schedule", fn), ("plain", plain)):
        def fwd_bwd():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            (f(*ins).float() * w).sum().backward()
            return ins

        _free()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = f(*ins)
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        got[name] = [out.detach().float()] + [t.grad.float() for t in ins]
        del out, ins
        with torch.no_grad():
            fwd = cuda_ms(lambda: f(q, k, v), reps=3, warm=1)
        row[name] = {"ms": fwd, "fwd_bwd_ms": cuda_ms(fwd_bwd, reps=3, warm=1),
                     "fwd_bwd_peak_mb": peak / 2**20}
    gaps = [float((a - b_).abs().max()) for a, b_ in zip(got["schedule"], got["plain"])]
    atols = [LONG_TOL] + [LONG_GRAD_TOL] * 3
    rtol = LONG_BF16_RTOL if dtype == torch.bfloat16 else 0.0
    # each element's gap over its limit atol + rtol * |plain|: at most 1
    ratios = [float(((a - b_).abs() / (atol + rtol * b_.abs())).max())
              for a, b_, atol in zip(got["schedule"], got["plain"], atols)]
    row.update(dtype=str(dtype).split(".")[-1], out_gap=gaps[0], dq_gap=gaps[1], dk_gap=gaps[2],
               dv_gap=gaps[3], atols=atols, rtol=rtol, gap_over_limit=ratios)
    row["over"] = [f"long: {fn.__name__} {what} is {gap} from the plain version ({ratio} of "
                   f"its per-element limit)"
                   for what, gap, ratio in zip(("out", "dq", "dk", "dv"), gaps, ratios) if ratio > 1]
    if float64 and dtype == torch.float32:
        _free()
        ins = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
        out = plain(*ins)
        (out * w.double()).sum().backward()
        ref = [out.detach()] + [t.grad for t in ins]
        del out, ins
        row["from_float64"] = {name: [float((a.double() - r).abs().max())
                                      for a, r in zip(got[name], ref)] for name in got}
        del ref
    del got
    _free()
    return row


def _q_offset_case(dev, seed: int) -> dict:
    """``flash_attend(q_offset=)`` in float32 at LONG_FLASH: the causal
    sequence in LONG_Q_BLOCKS blocks of query rows, each at its offset
    against the whole K and V (as a rank of a sharded step whose heads do
    not split attends), against the matching rows of ``attend_plain`` over
    the whole sequence: the output's and dq's rows, and dK and dV summed
    over the blocks (of ``sum(out * w)``); the blocks' forward ms beside
    one whole run's, and under ``over`` what passed its limit."""
    from repro_torch.models import attention

    b, s, h, kvh, d = LONG_FLASH
    gen = torch.Generator(dev).manual_seed(seed)
    q, w = (torch.randn(b, s, h, d, device=dev, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, s, kvh, d, device=dev, generator=gen) for _ in range(2))
    _free()
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = attention.attend_plain(*ins, causal=True, window=0)
    (out * w).sum().backward()
    want = [out.detach()] + [t.grad for t in ins]
    del out, ins
    _free()
    n = s // LONG_Q_BLOCKS
    blocks = [(i * n, slice(i * n, (i + 1) * n)) for i in range(LONG_Q_BLOCKS)]
    kk, vv = k.detach().requires_grad_(True), v.detach().requires_grad_(True)
    outs, dqs = [], []
    for off, rows in blocks:
        qb = q[:, rows].detach().requires_grad_(True)
        out = attention.flash_attend(qb, kk, vv, causal=True, window=0, q_offset=off)
        (out * w[:, rows]).sum().backward()
        outs.append(out.detach())
        dqs.append(qb.grad)
    got = [torch.cat(outs, 1), torch.cat(dqs, 1), kk.grad, vv.grad]
    gaps = [float((a - b_).abs().max()) for a, b_ in zip(got, want)]
    del got, want, outs, dqs, kk, vv
    _free()
    with torch.no_grad():
        blocks_ms = cuda_ms(lambda: [attention.flash_attend(q[:, rows], k, v, causal=True,
                                                            window=0, q_offset=off)
                                     for off, rows in blocks], reps=3, warm=1)
        whole_ms = cuda_ms(lambda: attention.flash_attend(q, k, v, causal=True, window=0),
                           reps=3, warm=1)
    atols = [LONG_TOL] + [LONG_GRAD_TOL] * 3
    return {"dtype": "float32", "blocks": LONG_Q_BLOCKS, "block_rows": n,
            "out_gap": gaps[0], "dq_gap": gaps[1], "dk_gap": gaps[2], "dv_gap": gaps[3],
            "atols": atols, "blocks_ms": blocks_ms, "whole_ms": whole_ms,
            "over": [f"long: flash_attend(q_offset=) {what} is {gap} from the plain version's "
                     f"rows (limit {atol})"
                     for what, gap, atol in zip(("out", "dq", "dk", "dv"), gaps, atols)
                     if gap > atol]}


def _long_schedules(dev, smi: str, seed: int) -> None:
    """(a) ``flash_attend`` (causal and not) at 2 x 4,096 tokens and
    ``banded_attend`` at 8,192 tokens under windows of 4,096 and 2,048,
    TinyLlama's heads (32 query, 4 KV, head dim 64), against the plain
    version in float32 and bf16; flash and the plain version in float32
    also against the plain version in float64; ``flash_attend(q_offset=)``
    over blocks of query rows against the plain version's rows
    (``_q_offset_case``)."""
    from repro_torch.models import attention

    t0 = time.perf_counter()
    rows = {"flash_q_offset": _q_offset_case(dev, seed)}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        for causal in (True, False):
            fn = functools.partial(attention.flash_attend, causal=causal, window=0)
            fn.__name__ = "flash_attend"
            rows[f"flash_{'causal' if causal else 'full'}_{i}"] = _schedule_case(
                dev, fn, functools.partial(attention.attend_plain, causal=causal, window=0),
                LONG_FLASH, dtype, seed + i, float64=True)
        for window in LONG_WINDOWS:
            fn = functools.partial(attention.banded_attend, window=window)
            fn.__name__ = "banded_attend"
            rows[f"banded_{window}_{i}"] = _schedule_case(
                dev, fn, functools.partial(attention.attend_plain, causal=True, window=window),
                LONG_BANDED, dtype, seed + i)
    emit("long", part="schedules", card=smi, flash_shape=list(LONG_FLASH),
         banded_shape=list(LONG_BANDED), cases=rows, phase_s=time.perf_counter() - t0)
    over = [msg for row in rows.values() for msg in row["over"]]
    check(not over, "; ".join(over))


def _long_train(dev, smi: str, seed: int, results: dict) -> dict:
    """(b) TinyLlama-1.1B at full width and depth through the launcher's
    objects at 4,096 tokens: batch 2 without remat, batch 2 with "full";
    then, on the first run's first batch, the loss and every gradient under
    "none" and "full" (whose backward pass recomputes each block) against
    each other and the loss against the trainer's step 1."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models import build_model
    from repro_torch.pytree import leaves
    from repro_torch.train.train_step import trainable

    tiny = get_config("tinyllama-1.1b")
    total: dict = {}
    first = None
    for batch, remat, steps in LONG_TRAIN:
        _free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = _train_run(dev, seed, steps, batch=batch, seq=LONG_TRAIN_SEQ, remat=remat)
        peak = torch.cuda.max_memory_allocated()
        out, launches = rec["out"], rec["launches"]
        losses = out["losses"]
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"long train {remat}: losses not all finite: {losses}")
        check(out["restarts"] == 0, f"long train {remat}: {out['restarts']} restarts")
        check(launches["fingerprint"] > 0, f"long train {remat}: the fingerprint kernel never ran")
        check(rec["consumed"] == [d for d, _ in rec["made"][:steps]],
              f"long train {remat}: the trainer did not consume the pipeline's batches in order")
        versus_host = _versus_host(rec, tiny.vocab_size)
        b, s = rec["args"].batch, rec["args"].seq
        median_s = float(np.median(rec["step_s"][1:]))
        flops = _step_flops(tiny, b, s)
        emit("long", part="train", card=smi, model=tiny.name, layers=tiny.num_layers,
             batch=[b, s], remat=remat, steps=out["final_step"], losses=losses,
             run_s=rec["run_s"], median_step_ms=median_s * 1e3,
             step_ms=[x * 1e3 for x in rec["step_s"]], tokens_per_s=b * s / median_s,
             step_model_flops=flops, model_tflops_per_s=flops / median_s / 1e12,
             max_memory_allocated=peak, peak_gb=_gb(peak), versus_host=versus_host,
             launches=launches, phase_s=time.perf_counter() - t0)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        if first is None:
            first = (rec["args"], losses[0])
            results["_long_step"] = {"batch": [b, s], "remat": remat,
                                     "median_step_ms": median_s * 1e3, "card": smi}
        del rec
        _free()
    args, want = first
    batch = launch.make_pipeline(args, tiny.vocab_size, "cpu").next_batch(args.batch, args.seq)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    params = trainable(build_model(tiny).init(torch.Generator(dev).manual_seed(args.seed)))
    losses, grads, peaks = {}, {}, {}
    for remat in ("none", "full"):
        torch.cuda.reset_peak_memory_stats()
        loss, _ = build_model(tiny, remat=remat).train_loss(params, batch)
        grads[remat] = torch.autograd.grad(loss, leaves(params))
        torch.cuda.synchronize()
        losses[remat] = float(loss.detach())
        peaks[remat] = _gb(torch.cuda.max_memory_allocated())
        del loss
    for remat, got in losses.items():
        check(abs(got - want) <= LONG_LOSS_RTOL * abs(want),
              f"long train: remat {remat}'s first loss {got} != the trainer's step 1 {want}")
    # remat's recompute in the backward pass against the kept activations:
    # each leaf's gradient, its largest gap over its largest entry
    grad_gaps = [float((f - n).abs().max() / n.abs().max().clamp(min=1e-30))
                 for n, f in zip(grads["none"], grads["full"])]
    worst = int(np.argmax(grad_gaps))
    check(grad_gaps[worst] <= LONG_LOSS_RTOL,
          f"long train: remat full's gradient of leaf {worst} is {grad_gaps[worst]} (relative) "
          f"from none's")
    emit("long", part="train_remat_check", card=smi, batch=[args.batch, args.seq],
         trainer_first_loss=want, first_loss=losses,
         loss_rel_gap={r: abs(g - want) / abs(want) for r, g in losses.items()},
         grad_leaves=len(grad_gaps), grad_max_rel_gap=grad_gaps[worst], rtol=LONG_LOSS_RTOL,
         fwd_bwd_peak_gb=peaks)
    del params, batch, grads
    _free()
    return total


def _long_prefill(dev, smi: str, seed: int) -> None:
    """(c) TinyLlama-1.1B at full depth prefills 32,768 tokens (bf16 compute)
    and decodes 8; at 2 layers in float32, a prefill 512 tokens shorter and
    512 decode steps are held against the whole prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    tiny = get_config("tinyllama-1.1b")
    s, n = LONG_PREFILL_SEQ, LONG_DECODE_STEPS
    toks = torch.randint(0, tiny.vocab_size, (1, s + n), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed + 1))
    t0 = time.perf_counter()
    _free()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(tiny)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, cache = model.prefill(params, {"inputs": toks[:, :s]}, slots=s + n)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    prefill_peak = torch.cuda.max_memory_allocated()
    model.load(params)
    del params
    steps = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(n):
        got, cache = model.decode_step(cache, toks[:, s + i:s + i + 1], s + i)
        steps.append(got)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    check(bool(torch.isfinite(logits).all()) and all(bool(torch.isfinite(g).all()) for g in steps),
          "long prefill: non-finite logits")
    full = {"layers": tiny.num_layers, "compute_dtype": tiny.compute_dtype, "prefill_s": prefill_s,
            "prefill_tokens_per_s": s / prefill_s, "prefill_peak_gb": _gb(prefill_peak),
            "decode_ms_per_step": decode_s / n * 1e3, "decode_steps": n,
            "peak_gb": _gb(torch.cuda.max_memory_allocated())}
    del model, cache, logits, steps
    _free()

    cut = tiny.replace(num_layers=LONG_HELD_LAYERS, compute_dtype="float32")
    model = build_model(cut)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    start = s - LONG_HELD_DECODE
    want, _ = model.prefill(params, {"inputs": toks[:, :s]})
    _, cache = model.prefill(params, {"inputs": toks[:, :start]}, slots=s)
    model.load(params)
    for pos in range(start, s):
        got, cache = model.decode_step(cache, toks[:, pos:pos + 1], pos)
    gap = float((got - want).abs().max())
    check(gap <= PREFILL_F32_TOL,
          f"long prefill: {LONG_HELD_LAYERS} layers, prefill + {LONG_HELD_DECODE} decode steps "
          f"is {gap} from the longer prefill (> {PREFILL_F32_TOL})")
    emit("long", part="prefill", card=smi, model=tiny.name, tokens=s, full_depth=full,
         held={"layers": LONG_HELD_LAYERS, "prefix": start, "decode_steps": LONG_HELD_DECODE,
               "float32_gap": gap, "tol": PREFILL_F32_TOL,
               "max_abs_logit": float(want.abs().max())},
         phase_s=time.perf_counter() - t0)
    del model, params, cache, want, got
    _free()


def _long_banded(dev, smi: str, seed: int) -> None:
    """(d) Mixtral-8x7B at 2 layers (window 4,096) and RecurrentGemma-2B at 5
    (local window 2,048) prefill 8,192 tokens through the banded schedule;
    one Mixtral attention layer against the plain version in float32."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, build_model
    from repro_torch.models.transformer import ATTENTION, window_of

    s = LONG_BANDED_SEQ
    banded = attention.banded_attend
    calls = []

    def counted(*a, **kw):
        calls.append(kw["window"])
        return banded(*a, **kw)

    rows = {}
    for arch, layers in LONG_BANDED_MODELS:
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(num_layers=layers)
        windows = [window_of(cfg, m) for m, _ in cfg.layer_kinds if m in ATTENTION]
        _free()
        torch.cuda.reset_peak_memory_stats()
        params = build_model(cfg).init(torch.Generator(dev).manual_seed(seed))
        toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                             generator=torch.Generator(dev).manual_seed(seed + 1))
        del calls[:]
        attention.banded_attend = counted
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = build_model(cfg).prefill(params, {"inputs": toks})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1
        finally:
            attention.banded_attend = banded
        check(bool(torch.isfinite(logits).all()), f"long banded {arch}: non-finite logits")
        check(calls == windows and all(0 < w < s for w in windows),
              f"long banded {arch}: banded schedule calls {calls}, attention windows {windows}")
        rows[arch] = {"layers": layers, "windows": windows, "banded_calls": len(calls),
                      "prefill_s": prefill_s, "prefill_tokens_per_s": s / prefill_s,
                      "attention_fwd_flops": _attention_flops(cfg, 1, s),
                      "peak_gb": _gb(torch.cuda.max_memory_allocated())}
        if arch == "mixtral-8x7b":
            p = {k: t[0].clone() for k, t in params["scan"]["pos0"]["mixer"].items()}
        del params, cache, logits
        _free()
        if arch == "mixtral-8x7b":
            rows[arch]["layer_vs_plain"] = _banded_layer_check(dev, cfg, p, seed)
            del p
            _free()
        rows[arch]["phase_s"] = time.perf_counter() - t0
    emit("long", part="banded", card=smi, tokens=s, models=rows)


def _banded_layer_check(dev, cfg, p: dict, seed: int) -> dict:
    """One Mixtral attention layer (float32 weights and input, 8,192 tokens)
    through ``attention_train`` (the banded schedule) against the same
    projections through ``attend_plain``."""
    from repro_torch.models import attention

    s, d = LONG_BANDED_SEQ, cfg.d_model
    x = torch.randn(1, s, d, device=dev, generator=torch.Generator(dev).manual_seed(seed + 2))
    pos = torch.arange(s, device=dev, dtype=torch.int32)[None]
    with torch.no_grad():
        got = attention.attention_train(p, x, pos, window=cfg.attn_window,
                                        rope_theta=cfg.rope_theta)[0]
        q, k, v = attention.project_qkv(p, x, pos, rope_theta=cfg.rope_theta)
        want = attention.attend_plain(q, k, v, causal=True, window=cfg.attn_window)
        want = want.reshape(1, s, -1) @ p["wo"].reshape(-1, d)
    gap = float((got - want).abs().max())
    check(gap <= LONG_LAYER_TOL, f"long banded: a Mixtral layer is {gap} from the plain version")
    return {"float32_gap": gap, "tol": LONG_LAYER_TOL, "max_abs_out": float(want.abs().max())}


def _long_rg(dev, smi: str, seed: int) -> None:
    """(e) RecurrentGemma-2B's banded attention at train_4k's 4,096 tokens:
    ``banded_attend`` against the plain version in float32 at its shapes
    (``_schedule_case``: the gaps, the ms forward and forward + backward);
    then LONG_RG_LAYERS layers at batch LONG_RG_BATCH, one forward and
    backward of ``train_loss`` under each of LONG_RG_REMATS on one batch:
    the loss and every gradient against "none"'s (LONG_LOSS_RTOL relative),
    the ms and peak GB of each, and the band's products counted by call
    (``attention``'s LONG_RG_PRODUCTS; no other layer makes them): "dots"
    makes as many as "none" (the remat unit keeps the band's output, so its
    rerun in the backward pass makes none), "full" more (it reruns the
    band's forward)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, build_model
    from repro_torch.pytree import leaves
    from repro_torch.train.train_step import trainable

    t0 = time.perf_counter()
    cfg = get_config(LONG_RG)
    b, s = LONG_RG_BATCH, LONG_TRAIN_SEQ
    fn = functools.partial(attention.banded_attend, window=cfg.local_window)
    fn.__name__ = "banded_attend"
    schedule = _schedule_case(
        dev, fn, functools.partial(attention.attend_plain, causal=True, window=cfg.local_window),
        (b, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim), torch.float32, seed)
    cut = cfg.replace(num_layers=LONG_RG_LAYERS)
    gen = torch.Generator(dev).manual_seed(seed)
    tokens = torch.randint(0, cut.vocab_size, (b, s + 1), device=dev, generator=gen)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:],
             "mask": torch.ones(b, s, device=dev)}
    params = trainable(build_model(cut).init(torch.Generator(dev).manual_seed(seed)))
    calls = {}
    originals = {name: getattr(attention, name) for name in LONG_RG_PRODUCTS}

    def counted(name, f):
        def call(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return call

    losses, grads, rows = {}, {}, {}
    for remat in LONG_RG_REMATS:
        model = build_model(cut, remat=remat)

        def step():
            loss, _ = model.train_loss(params, batch)
            return loss, torch.autograd.grad(loss, leaves(params))

        _free()
        torch.cuda.reset_peak_memory_stats()
        calls.update(dict.fromkeys(LONG_RG_PRODUCTS, 0))
        for name, f in originals.items():
            setattr(attention, name, counted(name, f))
        try:
            loss, grads[remat] = step()
        finally:
            for name, f in originals.items():
                setattr(attention, name, f)
        torch.cuda.synchronize()
        losses[remat] = float(loss.detach())
        rows[remat] = {"products_by_call": dict(calls),
                       "fwd_bwd_peak_gb": _gb(torch.cuda.max_memory_allocated())}
        del loss
        rows[remat]["fwd_bwd_ms"] = cuda_ms(step, reps=3, warm=1)
    gaps = {remat: max(float((g - n).abs().max() / n.abs().max().clamp(min=1e-30))
                       for n, g in zip(grads["none"], grads[remat]))
            for remat in LONG_RG_REMATS[1:]}
    del params, batch, grads
    _free()
    emit("long", part="rg_banded", card=smi, model=cut.name, layers=cut.num_layers,
         batch=[b, s], window=cfg.local_window, schedule=schedule, first_loss=losses,
         grad_max_rel_gap=gaps, rtol=LONG_LOSS_RTOL, remats=rows,
         part_s=time.perf_counter() - t0)
    check(not schedule["over"], "; ".join(schedule["over"]))
    for remat, gap in gaps.items():
        check(abs(losses[remat] - losses["none"]) <= LONG_LOSS_RTOL * abs(losses["none"])
              and gap <= LONG_LOSS_RTOL,
              f"long rg: remat {remat}'s loss {losses[remat]} (none {losses['none']}) or a "
              f"gradient ({gap} relative) is off none's")
    made = {r: sum(row["products_by_call"].values()) for r, row in rows.items()}
    check(made["dots"] == made["none"] < made["full"],
          f"long rg: the band's products by remat {made}: \"dots\" replays them")


def phase_long(dev, results: dict, smi: str, seed: int) -> None:
    """The long-sequence schedules and remat: (a) against the plain version,
    (b) TinyLlama training at 4,096 tokens, (c) its 32,768-token prefill,
    (d) banded prefills, (e) RecurrentGemma's band at 4,096 tokens and under
    each remat policy.  Launch counts are zeroed just before each trainer
    run of (b) and read just after; ``launches_by_path["long"]`` sums them."""
    t0 = time.perf_counter()
    _long_schedules(dev, smi, seed)
    total = _long_train(dev, smi, seed, results)
    _long_prefill(dev, smi, seed)
    _long_banded(dev, smi, seed)
    _long_rg(dev, smi, seed)
    for name in KERNELS:
        results.setdefault(name, {}).setdefault("launches_by_path", {})["long"] = \
            total.get(name, 0)
    check(total.get("fingerprint", 0) > 0, "long: the fingerprint kernel never launched")
    emit("long_summary", card=smi, launches=total, phase_s=time.perf_counter() - t0)


# The sharding phase: the partition rules, the sharded train step, the MoE's
# mesh branch, the int8 compressed mean, elastic restore and the dry run, on
# the card under a one-process NCCL group (a 1 x 1 mesh).
SHARD_STEPS = 2
SHARD_LOSS_RTOL, SHARD_WEIGHT_TOL = 1e-5, 1e-6
SHARD_MOE_TOKENS = (4, 512)       # Mixtral-8x7B's layer at published width
SHARD_MOE_RTOL = 1e-5
SHARD_MEAN_TOL = 0.05             # of each leaf's largest gradient
SHARD_REMATS = ("dots", "full")   # (f): the sharded step under each, against the plain one
SHARD_PROMPT = (4, 512)           # (g): TinyLlama's sharded prefill, then SHARD_DECODE steps
SHARD_DECODE = 4
SHARD_WHISPER = (2, 4096)         # (g): Whisper-small's sharded prefill, (rows, frames)
# (h): the dry-run CLI's cells, train, prefill and decode on both meshes
SHARD_DRY_ARGS = ("--arch", "tinyllama-1.1b", "--mesh", "both")
SHARD_DRY_OPS_SHOWN = 8  # (h): each cell's largest operations by traced FLOPs
# (h): a train cell's loss head, its vocabulary split over "model": the
# forward product, its recompute and two backward products, each 2 x rows a
# device x S x d x V / "model"
SHARD_LOSS_HEAD_PRODUCTS = 4
# (i): the 1 x 1 trace of (f)'s steps against the card: the peak within 10% of
# max_memory_allocated; the traced FLOPs at most this far above _step_flops
# (which counts neither remat's recompute, nor the loss head's, nor the
# local regions' second forward pass)
SHARD_TRACE_PEAK_RTOL = 0.10
SHARD_TRACE_FLOPS_OVER = 0.40


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))


def _sharded_step(dev, mesh, smi: str, seed: int) -> tuple:
    """(a) TinyLlama-1.1B at full width and depth, the launcher's batch
    (8 x 256) and optimizer: the plain ``train_step`` and the sharded one
    (every leaf a DTensor placed by ``param_pspecs``/``batch_pspecs``) from
    the same weights and batches; returns the plain run's first gradients."""
    from repro_torch.act_sharding import is_dtensor, mesh_shape
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models import build_model
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import (_value_and_grad, make_sharded_train_step,
                                              make_train_step, trainable)

    t0 = time.perf_counter()
    cfg = get_config("tinyllama-1.1b")
    args = launch.parse_args(["--seed", str(seed), "--device", str(dev)])
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    pipe = launch.make_pipeline(args, cfg.vocab_size, dev)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in pipe.next_batch(args.batch,
                                                                           args.seq).items()}
               for _ in range(SHARD_STEPS)]
    opt = AdamW(learning_rate=args.lr, warmup_steps=max(args.steps // 20, 5),
                total_steps=args.steps)
    sds, axes = model.abstract_params()
    specs = param_pspecs(sds, axes, mesh, mode="train", fsdp=True)
    bspecs = batch_pspecs(cfg, "train", args.batch, mesh)
    sharded = trainable(distribute_tree(tree_map(torch.clone, params), specs, mesh))
    plain = trainable(params)
    grads = _value_and_grad(model, plain, batches[0])[2]
    dstate, state = opt.init(sharded), opt.init(plain)
    sstep, step = make_sharded_train_step(model, opt, mesh), make_train_step(model, opt)
    losses, dlosses, step_s, dstep_s = [], [], [], []
    for batch in batches:
        t1 = time.perf_counter()
        plain, state, loss, _ = step(plain, state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        sharded, dstate, dloss, _ = sstep(sharded, dstate, distribute_tree(batch, bspecs, mesh))
        torch.cuda.synchronize()
        dstep_s.append(time.perf_counter() - t1)
        losses.append(float(loss))
        dlosses.append(float(dloss))
    check(all(is_dtensor(t) for t in leaves(sharded)),
          "sharding: a parameter of the sharded step is not a DTensor")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(dlosses, losses))
    check(loss_gap <= SHARD_LOSS_RTOL,
          f"sharding: sharded losses {dlosses} against plain {losses}")
    weight_gap, equal = 0.0, 0
    with torch.no_grad():
        for a, b in zip(leaves(sharded), leaves(plain)):
            local = a.to_local()
            weight_gap = max(weight_gap, float((local - b).abs().max()))
            equal += int(torch.equal(local, b))
    check(weight_gap <= SHARD_WEIGHT_TOL, f"sharding: weights {weight_gap} from the plain step's")
    emit("sharding", part="train_step", card=smi, model=cfg.name, layers=cfg.num_layers,
         mesh=mesh_shape(mesh), batch=[args.batch, args.seq], steps=SHARD_STEPS,
         losses=losses, sharded_losses=dlosses, loss_rel_gap=loss_gap,
         max_weight_gap=weight_gap, leaves_equal=equal, leaves=len(leaves(plain)),
         plain_step_ms=[x * 1e3 for x in step_s], sharded_step_ms=[x * 1e3 for x in dstep_s],
         part_s=time.perf_counter() - t0)
    del sharded, dstate, state, batches, pipe, params
    return plain, grads


def _sharded_moe(dev, mesh, smi: str, seed: int) -> None:
    """(b) One Mixtral-8x7B MoE layer at published width, bf16 weights, at
    capacity E / k: the mesh branch on a "model" group of one against
    ``moe_local``; outputs, aux and kept masks."""
    from repro_torch.act_sharding import activation_rules
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import ParamFactory

    t0 = time.perf_counter()
    cfg = get_config("mixtral-8x7b")
    p = moe.init_moe(ParamFactory(torch.Generator(dev).manual_seed(seed), torch.bfloat16),
                     cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.act)
    g = torch.Generator(dev).manual_seed(seed + 1)
    x = torch.randn(*SHARD_MOE_TOKENS, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    cf = cfg.num_experts / cfg.top_k
    kept = []
    route = moe.route

    def recorded(*a, **kw):
        r = route(*a, **kw)
        kept.append(r.keep)
        return r

    moe.route = recorded
    try:
        want, want_aux = moe.moe_local(x.reshape(-1, cfg.d_model), p["router"], p["w_in"],
                                       p["w_gate"], p["w_out"], top_k=cfg.top_k,
                                       capacity_factor=cf, act=cfg.act)
        with activation_rules(mesh):
            got, aux = moe.moe_apply(p, x, top_k=cfg.top_k, capacity_factor=cf, act=cfg.act)
        torch.cuda.synchronize()
    finally:
        moe.route = route
    out_gap = _rel_gap(got.reshape(want.shape), want)
    aux_gap = abs(float(aux) - float(want_aux)) / abs(float(want_aux))
    check(len(kept) == 2 and torch.equal(kept[0], kept[1]), "sharding: MoE kept masks differ")
    check(out_gap <= SHARD_MOE_RTOL and aux_gap <= SHARD_MOE_RTOL,
          f"sharding: MoE mesh branch {out_gap} / aux {aux_gap} from moe_local")
    emit("sharding", part="moe", card=smi, model=cfg.name, experts=cfg.num_experts,
         d_model=cfg.d_model, d_ff=cfg.d_ff, weights="bfloat16", tokens=list(SHARD_MOE_TOKENS),
         capacity_factor=cf, out_rel_gap=out_gap, aux_rel_gap=aux_gap,
         kept=int(kept[0].sum()), assignments=int(kept[0].numel()),
         part_s=time.perf_counter() - t0)
    del p, x, got, want


def _compressed_mean(dev, grads, smi: str) -> None:
    """(c) ``compressed_psum_mean`` and ``ErrorFeedback.apply`` over (a)'s
    gradient tree on the group of one: each leaf's mean within 5% of its
    largest gradient of the exact mean (the gradient itself)."""
    from repro_torch.pytree import leaves
    from repro_torch.train.compression import (ErrorFeedback, compressed_psum_mean,
                                               int8_payload_bytes)

    flat = leaves(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means = [compressed_psum_mean(g) for g in flat]
    torch.cuda.synchronize()
    mean_s = time.perf_counter() - t0
    worst = max(float((m - g.float()).abs().max() / g.float().abs().max().clamp(min=1e-30))
                for m, g in zip(means, flat))
    check(worst <= SHARD_MEAN_TOL, f"sharding: compressed mean {worst} of a leaf's range off")
    del means
    t0 = time.perf_counter()
    deq, err = ErrorFeedback.apply(grads, ErrorFeedback.init(grads))
    torch.cuda.synchronize()
    ef_s = time.perf_counter() - t0
    residual = max(float((e + d - g.float()).abs().max()) for d, e, g in
                   zip(leaves(deq), leaves(err), flat))
    check(residual <= 1e-6 * max(float(g.abs().max()) for g in flat),
          f"sharding: error feedback's residual does not close: {residual}")
    numel = sum(g.numel() for g in flat)
    emit("sharding", part="compressed_mean", card=smi, leaves=len(flat), values=numel,
         ranks=1, max_err_of_leaf_range=worst, tol=SHARD_MEAN_TOL, seconds=mean_s,
         int8_bytes=sum(int8_payload_bytes(g.numel(), 1) for g in flat),
         float32_bytes=4 * numel, wire_bytes=0, error_feedback_s=ef_s)
    del deq, err


def _elastic_restore(dev, mesh, results: dict, smi: str) -> None:
    """(d) The ``train`` phase's last checkpoint (a 2-layer cut) restored
    onto the 1 x 1 mesh by ``param_pspecs``: bit for bit the trained
    weights."""
    import shutil

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models import build_model
    from repro_torch.pytree import flatten_with_path
    from repro_torch.sharding import param_pspecs

    t0 = time.perf_counter()
    kept, step, cut, weights = results.pop("_train_ckpt")
    sds, axes = build_model(cut).abstract_params()
    specs = param_pspecs(sds, axes, mesh, mode="train", fsdp=True)
    tree = ckpt.restore(kept, step, {"params": sds}, mesh=mesh, specs={"params": specs})
    unequal = [name for path, t in flatten_with_path(tree["params"])
               for name in ["__".join(path)] if not torch.equal(t.to_local().cpu(), weights[name])]
    check(not unequal and len(weights) == len(flatten_with_path(tree["params"])),
          f"sharding: restored leaves differ from the trained weights: {unequal}")
    emit("sharding", part="elastic_restore", card=smi, layers=cut.num_layers, step=step,
         leaves=len(weights), bytes=sum(t.numel() * t.element_size() for t in weights.values()),
         placements=str(next(iter(flatten_with_path(tree["params"])))[1].placements),
         equal=True, part_s=time.perf_counter() - t0)
    del tree, weights
    shutil.rmtree(kept, ignore_errors=True)


def _host_terms(results: dict, smi: str) -> None:
    """(e) ``analytic_terms`` for TinyLlama on a 1 x 1 mesh beside the
    ``long`` phase's measured step, and the dry run's 40 x 2 records."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytic import analytic_terms

    t0 = time.perf_counter()
    cfg = get_config("tinyllama-1.1b")
    long = results.pop("_long_step")
    b, s = long["batch"]
    mesh = {"data": 1, "model": 1}
    at_long = analytic_terms(cfg, "train", s, b, mesh, remat=long["remat"])
    shape = SHAPES["train_4k"]
    at_shape = analytic_terms(cfg, "train", shape.seq_len, shape.global_batch, mesh,
                              remat=long["remat"])
    cells = dryrun.run_all(verbose=False, trace=False)  # the accounting; (h) traces
    ok = [c for c in cells if c["status"] == "ok"]
    check(len(cells) == 80 and len(ok) == 66, f"sharding: dry run {len(cells)} cells, {len(ok)} ok")
    emit("sharding", part="host_terms", card=smi, long_step=long,
         analytic_at_long_step={"flops": at_long.flops, "hbm_bytes": at_long.hbm_bytes,
                                "wire_bytes": at_long.wire_bytes},
         measured_flops_per_s=at_long.flops / (long["median_step_ms"] / 1e3),
         analytic_train_4k={"batch": shape.global_batch, "flops": at_shape.flops,
                            "hbm_bytes": at_shape.hbm_bytes, "wire_bytes": at_shape.wire_bytes},
         dry_run_records=len(cells), dry_run_ok=len(ok), dry_run_device=ok[0]["device"],
         dry_run_device_bytes=ok[0]["device_memory_bytes"], part_s=time.perf_counter() - t0)


def _remat_steps(dev, mesh, smi: str, seed: int) -> dict:
    """(f) TinyLlama-1.1B at full size and the launcher's batch under remat
    "dots" and "full": SHARD_STEPS plain and sharded steps from the same
    weights and batches, losses and every leaf equal (else within
    SHARD_LOSS_RTOL, the gap printed); the first sharded step's peak memory
    above what else the process holds (``torch.cuda.max_memory_allocated``,
    reset first) for (i); and flash attention's products by call in the
    first plain and the first sharded step (``attention``'s
    LONG_RG_PRODUCTS), those made where a local region rebuilds its graph
    apart: that rebuild takes flash's output from the unit's rerun and
    makes none, so the sharded step makes as many as the plain one.
    Returns {remat: that step's bytes}."""
    from repro_torch import act_sharding
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models import attention, build_model
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import (make_sharded_train_step, make_train_step,
                                              trainable)

    cfg = get_config("tinyllama-1.1b")
    args = launch.parse_args(["--seed", str(seed), "--device", str(dev)])
    pipe = launch.make_pipeline(args, cfg.vocab_size, dev)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in pipe.next_batch(args.batch,
                                                                           args.seq).items()}
               for _ in range(SHARD_STEPS)]
    opt = AdamW(learning_rate=args.lr, warmup_steps=max(args.steps // 20, 5),
                total_steps=args.steps)
    peaks = {}
    originals = {name: getattr(attention, name) for name in LONG_RG_PRODUCTS}

    def counted(calls, name, f):
        def call(*a, **kw):
            calls["rebuild" if act_sharding.rebuilding_graph() else name] += 1
            return f(*a, **kw)
        return call

    def products(run):
        """(run's result, flash's products by call while it ran)."""
        calls = dict.fromkeys(LONG_RG_PRODUCTS + ("rebuild",), 0)
        for name, f in originals.items():
            setattr(attention, name, counted(calls, name, f))
        try:
            return run(), calls
        finally:
            for name, f in originals.items():
                setattr(attention, name, f)

    for remat in SHARD_REMATS:
        t0 = time.perf_counter()
        model = build_model(cfg, remat=remat)
        params = model.init(torch.Generator(dev).manual_seed(seed))
        sds, axes = model.abstract_params()
        specs = param_pspecs(sds, axes, mesh, mode="train", fsdp=True)
        bspecs = batch_pspecs(cfg, "train", args.batch, mesh)
        sharded = trainable(distribute_tree(tree_map(torch.clone, params), specs, mesh))
        plain = trainable(params)
        dstate, state = opt.init(sharded), opt.init(plain)
        sstep, step = make_sharded_train_step(model, opt, mesh), make_train_step(model, opt)
        losses, dlosses, step_s, dstep_s = [], [], [], []
        flash = {}
        for i, batch in enumerate(batches):
            t1 = time.perf_counter()
            if i == 0:
                (plain, state, loss, _), flash["plain"] = products(
                    lambda: step(plain, state, batch))
            else:
                plain, state, loss, _ = step(plain, state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            placed = distribute_tree(batch, bspecs, mesh)
            if i == 0:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                inputs = sum(t.to_local().untyped_storage().nbytes() for t in
                             leaves(sharded) + leaves(dstate.mu) + leaves(dstate.nu)
                             + leaves(placed))
            t1 = time.perf_counter()
            if i == 0:
                (sharded, dstate, dloss, _), flash["sharded"] = products(
                    lambda: sstep(sharded, dstate, placed))
            else:
                sharded, dstate, dloss, _ = sstep(sharded, dstate, placed)
            torch.cuda.synchronize()
            dstep_s.append(time.perf_counter() - t1)
            if i == 0:
                peak = torch.cuda.max_memory_allocated()
                peaks[remat] = {"max_memory_allocated": peak, "held_before": base,
                                "inputs": inputs, "step_peak": peak - base + inputs}
            del placed
            losses.append(float(loss))
            dlosses.append(float(dloss))
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(dlosses, losses))
        weight_gap, equal = 0.0, 0
        with torch.no_grad():
            for a, b in zip(leaves(sharded), leaves(plain)):
                gap = _rel_gap(a.to_local(), b)
                weight_gap = max(weight_gap, gap)
                equal += int(torch.equal(a.to_local(), b))
        check(loss_gap <= SHARD_LOSS_RTOL and weight_gap <= SHARD_LOSS_RTOL,
              f"sharding: remat {remat}: losses {dlosses} against {losses}, weights "
              f"{weight_gap} apart")
        made = {k: sum(v.values()) for k, v in flash.items()}
        check(flash["sharded"]["rebuild"] == 0 and made["sharded"] == made["plain"] > 0,
              f"sharding: remat {remat}: flash's products by call {flash}: a local region's "
              f"graph rebuild makes some")
        emit("sharding", part="remat_step", card=smi, remat=remat, model=cfg.name,
             layers=cfg.num_layers, batch=[args.batch, args.seq], steps=SHARD_STEPS,
             losses=losses, sharded_losses=dlosses, loss_rel_gap=loss_gap,
             max_weight_rel_gap=weight_gap, leaves_equal=equal, leaves=len(leaves(plain)),
             bit_equal=bool(loss_gap == 0 and equal == len(leaves(plain))),
             flash_products_by_call=flash,
             plain_step_ms=[x * 1e3 for x in step_s], sharded_step_ms=[x * 1e3 for x in dstep_s],
             memory=peaks[remat], part_s=time.perf_counter() - t0)
        del sharded, dstate, state, plain, params, model
        _free()
    del batches, pipe
    return peaks


def _sharded_serving(dev, mesh, smi: str, seed: int) -> None:
    """(g) TinyLlama-1.1B at full width, bf16 weights: a sharded prefill of
    SHARD_PROMPT into a cache placed by ``cache_pspecs`` and SHARD_DECODE
    sharded decode steps, against the plain prefill and decode steps."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.act_sharding import placements
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.train_step import (make_serve_step, make_sharded_prefill_step,
                                              make_sharded_serve_step)

    t0 = time.perf_counter()
    cfg = get_config("tinyllama-1.1b").replace(param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    g = torch.Generator(dev).manual_seed(seed + 2)
    b, s = SHARD_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (SHARD_DECODE, b, 1), device=dev, generator=g)
    slots = s + SHARD_DECODE
    t1 = time.perf_counter()
    logits, cache = model.prefill(params, {"inputs": prompt}, slots)
    serve = make_serve_step(model)
    want = [logits] + [serve(params, cache, toks[i], s + i)[0] for i in range(SHARD_DECODE)]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    del cache
    sds, axes = model.abstract_params()
    dparams = distribute_tree(params, param_pspecs(sds, axes, mesh, mode="serve", fsdp=False),
                              mesh)
    t1 = time.perf_counter()
    dlogits, dcache = make_sharded_prefill_step(model, mesh, slots)(
        dparams, distribute_tree({"inputs": prompt}, batch_pspecs(cfg, "prefill", b, mesh), mesh))
    dserve = make_sharded_serve_step(model, mesh)
    got = [dlogits] + [dserve(dparams, dcache, distribute_tensor(toks[i], mesh,
                                                                 placements((), mesh)),
                              s + i)[0] for i in range(SHARD_DECODE)]
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t1
    gaps = [_rel_gap(a.full_tensor(), w) for a, w in zip(got, want)]
    equal = [bool(torch.equal(a.full_tensor(), w)) for a, w in zip(got, want)]
    check(max(gaps) <= SHARD_LOSS_RTOL, f"sharding: sharded prefill/decode logits {gaps} off")
    emit("sharding", part="prefill_decode", card=smi, model=cfg.name, layers=cfg.num_layers,
         weights="bfloat16", prompt=list(SHARD_PROMPT), decode_steps=SHARD_DECODE,
         logits_rel_gap=gaps, logits_equal=equal, plain_s=plain_s, sharded_s=sharded_s,
         cache_placements=str(dcache.k.placements), part_s=time.perf_counter() - t0)
    del params, dparams, dcache, got, want


def _sharded_whisper(dev, mesh, smi: str, seed: int) -> None:
    """(g) Whisper-small at full width and depth, bf16 weights: a sharded
    prefill of SHARD_WHISPER (rows, frames) of stub frame embeddings, whose
    encoder runs on the residual stream's sequence split
    (``act_sharding.split_sequence``; one rank here), into a cache placed by
    ``cache_pspecs``, and SHARD_DECODE sharded decode steps, against the
    plain prefill and decode steps: the encoder states and logits."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.act_sharding import placements
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding import batch_pspecs, distribute_tree, param_pspecs
    from repro_torch.train.train_step import (make_serve_step, make_sharded_prefill_step,
                                              make_sharded_serve_step)

    t0 = time.perf_counter()
    cfg = get_config("whisper-small").replace(param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed))
    g = torch.Generator(dev).manual_seed(seed + 3)
    b, s = SHARD_WHISPER
    frames = torch.randn(b, s, cfg.d_model, device=dev, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (SHARD_DECODE, b, 1), device=dev, generator=g)
    t1 = time.perf_counter()
    enc, cache = model.prefill(params, {"encoder_embeds": frames}, SHARD_DECODE)
    serve = make_serve_step(model)
    want = [enc] + [serve(params, cache, toks[i], i)[0] for i in range(SHARD_DECODE)]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    del cache
    sds, axes = model.abstract_params()
    dparams = distribute_tree(params, param_pspecs(sds, axes, mesh, mode="serve", fsdp=False),
                              mesh)
    t1 = time.perf_counter()
    denc, dcache = make_sharded_prefill_step(model, mesh, SHARD_DECODE)(
        dparams, distribute_tree({"encoder_embeds": frames},
                                 batch_pspecs(cfg, "prefill", b, mesh), mesh))
    dserve = make_sharded_serve_step(model, mesh)
    got = [denc] + [dserve(dparams, dcache, distribute_tensor(toks[i], mesh,
                                                              placements((), mesh)), i)[0]
                    for i in range(SHARD_DECODE)]
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t1
    gaps = [_rel_gap(a.full_tensor(), w) for a, w in zip(got, want)]
    equal = [bool(torch.equal(a.full_tensor(), w)) for a, w in zip(got, want)]
    check(max(gaps) <= SHARD_LOSS_RTOL,
          f"sharding: Whisper's sharded prefill/decode (states, logits) {gaps} off")
    emit("sharding", part="prefill_decode", card=smi, model=cfg.name,
         layers=[cfg.encoder_layers, cfg.num_layers], weights="bfloat16",
         frames=list(SHARD_WHISPER), decode_steps=SHARD_DECODE, states_and_logits_rel_gap=gaps,
         states_and_logits_equal=equal, plain_s=plain_s, sharded_s=sharded_s,
         state_placements=str(denc.placements),
         cache_placements=str(dcache["cross_k"].placements), part_s=time.perf_counter() - t0)
    del params, dparams, dcache, got, want


def _start_dry_cli(out: str):
    """(h) The dry-run CLI on SHARD_DRY_ARGS, in a process of its own (the
    fake process group needs one), writing its records to ``out``."""
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *SHARD_DRY_ARGS,
                             "--out", out], cwd=ROOT, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def _trace_child(spec: str) -> None:
    """(i) ``dryrun.trace_step`` of TinyLlama-1.1B at full depth on a fake
    1 x 1 mesh at the launcher's batch, for each remat of ``spec``, beside
    the dry run's straight line from 1 and 2 layers (``trace_cell``);
    prints one JSON line."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun

    spec = json.loads(spec)
    b, s = spec["batch"]
    cfg = get_config("tinyllama-1.1b")
    shape, dims = ShapeSpec("launcher", "train", s, b), {"data": 1, "model": 1}
    out = {}
    for remat in spec["remats"]:
        t0 = time.perf_counter()
        t = dryrun.trace_step(cfg, shape, dryrun.fake_mesh(dims), remat=remat)
        line = dryrun.trace_cell(cfg, shape, dims, remat=remat)
        out[remat] = {"trace_s": time.perf_counter() - t0 - line["trace_s"],
                      "line": {k: line[k] for k in ("peak", "flops", "depths", "trace_s")},
                      **{k: t[k] for k in ("peak", "flops", "args_live", "collectives")}}
    dryrun.close_fake_mesh()
    print(json.dumps(out), flush=True)


def _dry_cli(proc, out: str, smi: str) -> None:
    """(h) The CLI's cells: each ok, with its collectives, peak and trace
    seconds printed, its traced FLOPs by operation (the largest, and those
    of the loss head and of operations with an operand as wide as the
    vocabulary), and which cells the traced peak puts over the card's
    memory.  A train cell's loss head must trace its vocabulary split over
    "model" (``_split_loss_head_flops``), and its moves between split
    dimensions must trace as all-to-alls."""
    from repro_torch.configs import SHAPES, get_config

    text, _ = proc.communicate()
    check(proc.returncode == 0 and os.path.exists(out), f"sharding: dry-run CLI:\n{text[-4000:]}")
    with open(out) as f:
        cells = json.load(f)
    os.remove(out)
    ok = [c for c in cells if c["status"] == "ok"]
    check(all(c["status"] in ("ok", "skipped") for c in cells)
          and {(c["kind"], c["mesh"]) for c in ok} >= {(k, m) for k in ("train", "prefill",
                                                                          "decode")
                                                       for m in ("16x16", "2x16x16")},
          f"sharding: dry-run CLI cells {[(c['shape'], c['mesh'], c['status']) for c in cells]}")
    for c in ok:
        # TinyLlama's heads split "model": no block at a rank's offset, so
        # the last rank's work is rank 0's
        check(c["traced_flops_rank0"] == c["traced_flops_last_rank"],
              f"sharding: {c['mesh']} {c['arch']} {c['shape']}: rank 0 traces "
              f"{c['traced_flops_rank0']} FLOPs, the last rank {c['traced_flops_last_rank']}")
        if c["kind"] == "train":
            want = _split_loss_head_flops(get_config(c["arch"]), SHAPES[c["shape"]], c["mesh"])
            got = _vocab_wide_flops(c["traced_flops_by_op"], get_config(c["arch"]).vocab_size)
            check(got == want, f"sharding: {c['mesh']} {c['arch']} {c['shape']}: the loss head "
                               f"traces {got} FLOPs a device, split over the vocabulary {want}")
            # K and V move from the sequence split to the heads split: on the
            # fake group an all-to-all (``launch.mesh``), not an all-gather
            check(c["collectives"]["counts"]["all-to-all"] > 0,
                  f"sharding: {c['mesh']} {c['arch']} {c['shape']}: no all-to-all traced "
                  f"({c['collectives']['counts']})")
    emit("sharding", part="dry_run_cli", card=smi, args=list(SHARD_DRY_ARGS),
         cells=[{"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"], "status": c["status"],
                 **({"collective_bytes": c["collectives"]["total_bytes"],
                     "collective_counts": c["collectives"]["counts"],
                     "peak": c["bytes_per_device"]["peak"], "args": c["bytes_per_device"]["args"],
                     "traced_flops": c["traced_flops_per_device"],
                     "traced_flops_rank0": c["traced_flops_rank0"],
                     "traced_flops_last_rank": c["traced_flops_last_rank"],
                     "last_rank_traced": c["last_rank_traced"], "trace_s": c["trace_s"],
                     "fits_hbm": c["fits_hbm"],
                     "flops_by_op": dict(list(c["traced_flops_by_op"].items())
                                         [:SHARD_DRY_OPS_SHOWN]),
                     "vocab_wide_flops": _vocab_wide_flops(
                         c["traced_flops_by_op"], get_config(c["arch"]).vocab_size)}
                    if c["status"] == "ok" else {})}
                for c in cells],
         traced_cells_over_memory=[f"{c['mesh']} {c['arch']} {c['shape']}" for c in ok
                                   if not c["fits_hbm"]])


def _vocab_wide_flops(by_op: dict, vocab: int) -> int:
    """The traced FLOPs of the loss head (keys labelled ``loss_head/``) and
    of operations with an operand dimension of the vocabulary's size
    (``StepTrace``'s keys list the operand shapes)."""
    wide = (f"({vocab},", f" {vocab},", f" {vocab})")
    return sum(n for key, n in by_op.items()
               if key.startswith("loss_head/") or any(w in key for w in wide))


def _split_loss_head_flops(cfg, shape, mesh: str) -> int:
    """A train cell's loss-head FLOPs a device with its vocabulary split
    over "model" (16 ranks): SHARD_LOSS_HEAD_PRODUCTS products of each
    device's rows (the global batch over the batch axes) by S x d x V /
    16."""
    batch_ranks = {"16x16": 16, "2x16x16": 32}[mesh]
    return (SHARD_LOSS_HEAD_PRODUCTS * 2 * (shape.global_batch // batch_ranks) * shape.seq_len
            * cfg.d_model * cfg.vocab_size // 16)


def _traced_against_card(proc, peaks: dict, smi: str) -> None:
    """(i) The 1 x 1 full-depth traces of (f)'s steps against the card: the
    traced peak within SHARD_TRACE_PEAK_RTOL of the step's measured peak,
    the traced FLOPs between ``_step_flops`` and SHARD_TRACE_FLOPS_OVER
    above it; the dry run's straight line from 1 and 2 layers printed
    beside (at this batch the optimizer's pieces, which stop growing with
    depth, set the peak, so the line overshoots it)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch

    traced = _child_outcome(proc, "sharding: the 1 x 1 trace")
    cfg = get_config("tinyllama-1.1b")
    args = launch.parse_args([])
    flops = _step_flops(cfg, args.batch, args.seq)
    for remat, t in traced.items():
        real = peaks[remat]["step_peak"]
        peak_gap = (t["peak"] - real) / real
        flops_over = t["flops"] / flops - 1.0
        check(abs(peak_gap) <= SHARD_TRACE_PEAK_RTOL,
              f"sharding: traced peak {t['peak']} against the card's {real} ({remat})")
        check(0.0 <= flops_over <= SHARD_TRACE_FLOPS_OVER,
              f"sharding: traced FLOPs {t['flops']} against _step_flops {flops} ({remat})")
        emit("sharding", part="trace_vs_card", card=smi, remat=remat, model=cfg.name,
             batch=[args.batch, args.seq], traced_peak=t["peak"], card_step_peak=real,
             peak_rel_gap=peak_gap, traced_args=t["args_live"],
             card_inputs=peaks[remat]["inputs"], traced_flops=t["flops"], step_flops=flops,
             flops_over=flops_over, traced_collectives=t["collectives"], trace_s=t["trace_s"],
             straight_line=t["line"],
             straight_line_peak_rel_gap=(t["line"]["peak"] - real) / real)


def phase_sharding(dev, results: dict, smi: str, seed: int) -> None:
    """The port's sharding on one card: a one-process NCCL group (no port,
    an in-memory store) and its 1 x 1 ("data", "model") mesh; (a) the
    sharded train step, (b) the MoE's mesh branch, (c) the compressed mean,
    (d) elastic restore, (e) the host arithmetic, (f) the sharded step under
    remat "dots" and "full", (g) sharded prefill and decode (TinyLlama,
    Whisper), (h) the traced dry run's CLI and (i) the 1 x 1 trace of (f)'s
    steps against the card ((h) and (i) in processes of their own on the
    host, from the phase's start).  Launch counts are zeroed just before
    the phase and read just after (``launches_by_path``)."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_single_process, make_host_mesh

    _free()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    # (h) and (i) trace on the host's cores, beside the card's parts
    dry_out = os.path.join(ROOT, "build", "sharding_dry_run.json")
    os.makedirs(os.path.dirname(dry_out), exist_ok=True)
    from repro_torch.launch import train as launch

    largs = launch.parse_args([])
    tracer = _start_child("_trace_child", {"batch": [largs.batch, largs.seq],
                                           "remats": list(SHARD_REMATS)})
    cli = _start_dry_cli(dry_out)
    init_single_process(str(dev))
    try:
        want = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
        check(dist.get_backend() == want, f"sharding: backend {dist.get_backend()}, not {want}")
        mesh = make_host_mesh(device=str(dev))
        _plain, grads = _sharded_step(dev, mesh, smi, seed)
        del _plain
        _free()
        _compressed_mean(dev, grads, smi)
        del grads
        _free()
        peaks = _remat_steps(dev, mesh, smi, seed)
        _free()
        _sharded_serving(dev, mesh, smi, seed)
        _free()
        _sharded_whisper(dev, mesh, smi, seed)
        _free()
        _sharded_moe(dev, mesh, smi, seed)
        _free()
        _elastic_restore(dev, mesh, results, smi)
        _host_terms(results, smi)
        _dry_cli(cli, dry_out, smi)
        _traced_against_card(tracer, peaks, smi)
    finally:
        dist.destroy_process_group()
        for proc in (tracer, cli):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for name in KERNELS:
        results.setdefault(name, {}).setdefault("launches_by_path", {})["sharding"] = \
            launches.get(name, 0)
    # the path's kernel: the launcher's pipeline hashes (a)'s batches
    check(launches.get("fingerprint", 0) > 0, "sharding: the fingerprint kernel never launched")
    _free()
    emit("sharding_summary", card=smi, launches=launches, phase_s=time.perf_counter() - t0)


# The frontend phase: ``benchmarks/serving_latency.py`` at its default scale
# (16 tenants with Zipf volume skew, 16 connections each, 120,000 requests, 4
# shards of 8,192 cache entries, batches of up to 1,024 writes or 2 ms, 16,384
# writes pending, an admission budget of half the connections) with the
# engine on the card; its ``contended`` (cache 192) and ``resize_under_load``
# (4 -> 6 shards) scenarios, GC steps under traffic as ``tests/test_gc_online.py``
# runs them, and a front end over the ``serve`` phase's server.
FE_TENANTS = 16
FE_CONNS = 16
FE_REQUESTS = 120_000
FE_SIDE_REQUESTS = 30_000  # contended, resize_under_load, gc_under_load
FE_SHARDS, FE_GROWN = 4, 6
FE_CACHE, FE_CONTENDED_CACHE = 8192, 192
FE_MAX_BATCH, FE_MAX_DELAY, FE_MAX_PENDING = 1024, 0.002, 16384
FE_BUDGET = FE_TENANTS * FE_CONNS // 2
FE_GC_EVERY, FE_GC_MOVES = 400, 64
# the writes over the server's engine use tenants past its own (0 and 1)
FE_SERVER_WRITES, FE_SERVER_CONNS, FE_SERVER_TENANT0 = 4000, 4, 100


def _fe_workload(n_requests: int, seed: int) -> dict:
    """Per-tenant (lba, fp) columns, as ``benchmarks/serving_latency.py``'s
    ``make_tenant_workload`` draws them: tenant t's share of requests goes
    as 1/(t+1), its duplicate ratio falls from 0.7 to 0.05, about 4% of
    requests hit a pool shared by all tenants, and 10% of LBAs jump back."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / (np.arange(FE_TENANTS) + 1.0)
    weights /= weights.sum()
    shared_pool = rng.integers(1, 2**62, size=256, dtype=np.uint64)
    out = {}
    for t in range(FE_TENANTS):
        n = max(64, int(n_requests * weights[t]))
        dup_ratio = 0.7 - 0.65 * t / (FE_TENANTS - 1)
        n_unique = max(8, int(n * (1.0 - dup_ratio)))
        pool = rng.integers(1, 2**62, size=n_unique, dtype=np.uint64)
        take_shared = rng.random(n) < 0.04
        fps = np.where(
            take_shared,
            shared_pool[rng.integers(0, len(shared_pool), size=n)],
            pool[rng.integers(0, n_unique, size=n)],
        ).astype(np.uint64)
        lbas = np.arange(n, dtype=np.int64)
        jump = rng.random(n) < 0.1
        lbas[jump] = rng.integers(0, n, size=int(jump.sum()))
        out[t] = (lbas, fps)
    return out


async def _fe_serve(engine, workload: dict, conns: int, resize_to: int = 0,
                    gc_every: int = 0):
    """Each tenant's columns strided over ``conns`` connections, all at once,
    through ``AsyncDedupFrontend``; with ``resize_to`` a resize 10 ms in,
    with ``gc_every`` a GC step after every that many writes of a
    connection.  Returns the front end's stats (with wall seconds and
    rps), the executed trace, the GC and resize results, and the front end."""
    from repro_torch.serving.frontend import AsyncDedupFrontend

    fe = AsyncDedupFrontend(engine, max_batch=FE_MAX_BATCH, max_delay=FE_MAX_DELAY,
                            max_pending=FE_MAX_PENDING, admission_budget=FE_BUDGET,
                            record_trace=True)
    extra: dict = {"gc": []}

    async def connection(tenant, lbas, fps):
        for i, (lba, fp) in enumerate(zip(lbas.tolist(), fps.tolist())):
            await fe.write(tenant, fp, lba=lba)
            if gc_every and i % gc_every == gc_every - 1:
                extra["gc"].append(await fe.run_gc(max_moves_per_shard=FE_GC_MOVES))

    async def resize_midway():
        await asyncio.sleep(0.01)
        extra["resize"] = await fe.resize(resize_to)

    clients = [connection(t, lbas[c::conns], fps[c::conns])
               for t, (lbas, fps) in workload.items() for c in range(conns)]
    if resize_to:
        clients.append(resize_midway())
    t0 = time.perf_counter()
    await asyncio.gather(*clients)
    await fe.drain()
    wall = time.perf_counter() - t0
    stats = fe.stats()
    stats.update(wall_s=wall, rps=stats["completed"] / wall,
                 connections=len(workload) * conns)
    await fe.close()
    return stats, fe.executed_trace(), extra, fe


def _fe_cluster(device, cache: int):
    from repro_torch.core import ShardedCluster

    return ShardedCluster(num_shards=FE_SHARDS, cache_entries=cache, device=device)


def _fe_scenario(device, workload: dict, cache: int, **kw) -> dict:
    """One scenario on a fresh 4-shard cluster on ``device``, with the launch
    and probe-route counts zeroed just before and read just after (the
    served run and its ``finish``)."""
    import repro_torch.core.fp_index as core_index
    from repro_torch.kernels import _build

    engine = _fe_cluster(device, cache)
    if kw.get("gc_every"):
        engine.min_parallel_batch = 0  # shard workers on every batch, as the GC test runs
    _build.reset_launches()
    core_index.reset_probe_routes()
    stats, cols, extra, _ = asyncio.run(_fe_serve(engine, workload, FE_CONNS, **kw))
    report = engine.finish()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out = {"stats": stats, "cols": cols, "extra": extra, "report": report, "engine": engine,
           "index_tables": _index_tables(engine), "launches": dict(_build.LAUNCHES),
           "probe_routes": dict(core_index.PROBE_ROUTES)}
    return out


def _fe_line(run: dict) -> dict:
    st = run["stats"]
    line = {k: st[k] for k in ("completed", "connections", "rps", "wall_s", "p50_ms", "p99_ms",
                               "mean_batch", "batches", "throttled", "deduped")}
    line.update(dup_writes=run["report"].total_dup_writes, launches=run["launches"],
                probe_routes=run["probe_routes"], index_tables=run["index_tables"])
    return line


def phase_frontend(dev, results: dict, srv, seed: int) -> None:
    """``AsyncDedupFrontend`` over engines on the card.  Each scenario's
    executed trace, replayed through a fresh engine on the card and on the
    host, must give the served report (``resize_under_load``: the aggregate
    counts of the fixed-layout oracle; ``gc_under_load``: a GC-free oracle,
    then ``check_consistency``); ``contended`` must throttle.  Launches,
    probe routes and the index tables' staged keys are read after each
    served card run."""
    import repro_torch.core.fp_index as core_index
    from repro_torch.core import restore_engine, snapshot_engine
    from repro_torch.kernels import _build

    counts = ("total_writes", "unique_fingerprints", "final_disk_blocks")
    lines, total = {}, {}

    def replays_equal(run, cache, what, exact=True):
        for device in (dev, "cpu"):
            oracle = _fe_cluster(device, cache)
            oracle.write_batch(*run["cols"])
            want = oracle.finish()
            if exact:
                check(want == run["report"], f"frontend {what}: replay on {device} != served")
            else:
                check(all(getattr(want, c) == getattr(run["report"], c) for c in counts),
                      f"frontend {what}: counts of the fixed-layout oracle on {device} differ")

    def keep(name, run, **extra):
        lines[name] = dict(_fe_line(run), **extra)
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n
        emit("frontend", scenario=name, **lines[name])

    full = _fe_workload(FE_REQUESTS, seed=11)
    side = _fe_workload(FE_SIDE_REQUESTS, seed=11)
    run = _fe_scenario(dev, full, FE_CACHE)
    replays_equal(run, FE_CACHE, "skewed16")
    keep("skewed16", run)
    del run

    run = _fe_scenario(dev, side, FE_CONTENDED_CACHE)
    check(run["stats"]["throttled"] > 0, "frontend contended: admission control throttled nothing")
    replays_equal(run, FE_CONTENDED_CACHE, "contended")
    keep("contended", run)

    run = _fe_scenario(dev, side, FE_CACHE, resize_to=FE_GROWN)
    check(run["engine"].num_shards == FE_GROWN and "resize" in run["extra"],
          "frontend resize_under_load did not resize")
    check(run["report"].total_writes == run["stats"]["completed"],
          "frontend resize_under_load lost writes")
    replays_equal(run, FE_CACHE, "resize_under_load", exact=False)
    keep("resize_under_load", run, moved_fps=run["extra"]["resize"]["moved_fps"])

    run = _fe_scenario(dev, side, FE_CACHE, gc_every=FE_GC_EVERY)
    steps = run["extra"]["gc"]
    check(steps and all(g is not None for g in steps), "frontend gc_under_load ran no GC step")
    replays_equal(run, FE_CACHE, "gc_under_load")
    run["engine"].check_consistency()
    keep("gc_under_load", run, gc={"steps": len(steps), "moved": sum(g["moved"] for g in steps)})

    # a front end over the serve phase's server: its engine from where the
    # serve phase left it, replayed from a snapshot taken just before
    tree = json.loads(json.dumps(snapshot_engine(srv.dedup)))
    wl = {FE_SERVER_TENANT0 + t: c for t, c in _fe_workload(FE_SERVER_WRITES, seed + 1).items()}
    _build.reset_launches()
    core_index.reset_probe_routes()
    stats, cols, _, fe = asyncio.run(_fe_serve(srv, wl, FE_SERVER_CONNS))
    report = srv.dedup.finish()
    torch.cuda.synchronize()
    run = {"stats": stats, "report": report, "launches": dict(_build.LAUNCHES),
           "probe_routes": dict(core_index.PROBE_ROUTES), "index_tables": _index_tables(srv.dedup)}
    check(fe.engine is srv.dedup, "the front end did not unwrap the server's engine")
    for device in (dev, "cpu"):
        oracle = restore_engine(tree, device=device)
        oracle.write_batch(*cols)
        check(oracle.finish() == report, f"frontend server: replay on {device} != served")
    keep("server", run)
    for name, n in total.items():
        results.setdefault(name, {}).setdefault("launches_by_path", {})["frontend"] = n
    emit("frontend_summary", requests=FE_REQUESTS, side_requests=FE_SIDE_REQUESTS,
         tenants=FE_TENANTS, connections=FE_TENANTS * FE_CONNS, shards=FE_SHARDS,
         cache_entries=FE_CACHE, max_batch=FE_MAX_BATCH, max_delay=FE_MAX_DELAY,
         max_pending=FE_MAX_PENDING, admission_budget=FE_BUDGET, replays_equal=True,
         launches=total, scenarios=lines)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--requests", type=int, default=1_000_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--band", metavar="SRC", nargs="?", const="", default=None,
                        help="only RecurrentGemma's banded attention: the long phase's (e) and "
                             "the blocks phase's RecurrentGemma step, the port imported from "
                             "SRC (another checkout's src directory) if given")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.band:
        sys.path.insert(0, os.path.abspath(args.band))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    if args.band is not None:
        emit("band", src=os.path.dirname(os.path.abspath(repro_torch.__file__)))
        _blocks_train(dev, smi, args.seed, LONG_RG, dict(BLOCKS_TRAIN)[LONG_RG])
        _long_rg(dev, smi, args.seed)
        return 0
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
    phase_cluster(dev, results, srv, mix, args.seed)
    phase_ingest(dev, results, args.seed)
    phase_train(dev, results, args.seed)
    phase_blocks(dev, results, smi, args.seed)
    phase_long(dev, results, smi, args.seed)
    phase_sharding(dev, results, smi, args.seed)
    phase_frontend(dev, results, srv, args.seed)
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
