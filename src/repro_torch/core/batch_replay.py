"""Columnar batched replay: the high-throughput ingestion path (DESIGN §2).

Scalar replay pushes every trace record through a per-record Python call
chain (``HPDedup.write`` -> ``InlineDedupEngine.on_write`` -> dict-based
cache/estimator/threshold updates), which caps replay throughput orders of
magnitude below what the device fingerprint kernel can feed.
This module keeps the scalar path's *semantics* bit-for-bit (it remains the
reference oracle — see tests/test_batch_replay.py) while restructuring the
work per batch:

* ``ReplayBatch`` — a columnar view over ``TRACE_DTYPE`` records (one
  contiguous array per field), so the hot loop never touches ``np.void``
  record scalars or per-field ``int(...)`` conversions.
* A vectorized pre-pass per sub-batch: ground-truth duplicate accounting
  over the batch's *unique* fingerprints, ``np.bincount``-style per-stream
  write/read accumulation applied to metrics / thresholds / the
  ``StreamLocalityEstimator`` in one update per batch, batched reservoir
  sampling (``Reservoir.offer_many``), and a batched fingerprint-cache
  membership probe (``contains_many``) that lets records which *cannot* hit
  (not cached at sub-batch start, no earlier in-batch occurrence, not in a
  pending run) skip the cache lookup entirely.
* A slim Python residual loop for the state-dependent control flow only:
  duplicate-run threshold decisions and cache admissions/evictions.  Block
  store mutations go through the *staged* columnar path
  (``BlockStore.stage_new_block`` / ``flush_staged``) whenever a vectorized
  collision check proves the sub-batch overwrites no (stream, LBA) key —
  always true for the synthetic workloads, the ingest pipeline and the
  serving layer — and fall back to the per-record store methods otherwise.

Exactness across triggers: the estimator interval and the post-processing
period fire mid-stream in the scalar path, and the state they mutate (LDSS
priorities, adaptive thresholds, flushed runs) changes the decisions of
every later record.  Trigger distances are deterministic functions of
engine counters, so the replay loop splits each batch at the exact record where
the next trigger fires, runs the vectorized pre-pass on the bulk prefix,
and replays the single boundary record through the scalar path so the
trigger observes bit-identical state.

The one intentional state divergence from the scalar path is the D-LRU
data buffer: its hit/miss counters feed no ``HybridReport`` field, so the
batched path skips buffer modeling entirely.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .fingerprint import OP_WRITE, TRACE_DTYPE
from .inline_engine import _PendingRun
from .reservoir import Reservoir

DEFAULT_BATCH_SIZE = 8192


class ReplayBatch:
    """Columnar view over trace records: one contiguous array per field.

    ``op``/``ts`` may be ``None`` for write-only ingestion (the streaming
    ``write_batch`` entry point), in which case every record is a write.
    """

    __slots__ = ("stream", "lba", "fp", "op", "ts")

    def __init__(
        self,
        stream: np.ndarray,
        lba: np.ndarray,
        fp: np.ndarray,
        op: Optional[np.ndarray] = None,
        ts: Optional[np.ndarray] = None,
    ):
        self.stream = np.ascontiguousarray(stream)
        self.lba = np.ascontiguousarray(lba)
        self.fp = np.ascontiguousarray(fp, dtype=np.uint64)
        self.op = None if op is None else np.ascontiguousarray(op)
        self.ts = None if ts is None else np.ascontiguousarray(ts)
        if not (self.stream.shape == self.lba.shape == self.fp.shape):
            raise ValueError("stream/lba/fp columns must be the same length")

    @classmethod
    def from_trace(cls, trace: np.ndarray) -> "ReplayBatch":
        if trace.dtype != TRACE_DTYPE:
            raise TypeError(f"expected TRACE_DTYPE records, got {trace.dtype}")
        return cls(trace["stream"], trace["lba"], trace["fp"], op=trace["op"], ts=trace["ts"])

    def __len__(self) -> int:
        return self.stream.size

    def slice(self, a: int, b: int) -> "ReplayBatch":
        return ReplayBatch(
            self.stream[a:b],
            self.lba[a:b],
            self.fp[a:b],
            op=None if self.op is None else self.op[a:b],
            ts=None if self.ts is None else self.ts[a:b],
        )

    def batches(self, batch_size: int):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        for a in range(0, len(self), batch_size):
            yield self.slice(a, a + batch_size)

    def write_positions(self) -> Optional[np.ndarray]:
        """Indices of write records; ``None`` means *all* records are writes."""
        if self.op is None:
            return None
        return np.nonzero(self.op == OP_WRITE)[0]

    def scatter(self, shard_ids: np.ndarray, num_shards: int):
        """Split into per-shard sub-batches in one vectorized pass.

        One stable argsort groups records by shard while preserving each
        shard's record order; every column is gathered once and sliced per
        shard.  Returns ``(parts, order)``: ``parts[s]`` is shard ``s``'s
        sub-batch (``None`` when empty) and ``order`` maps concatenated
        per-part positions back to original record indices, so per-record
        outputs realign with ``out[order] = np.concatenate(part_outputs)``.
        """
        order = np.argsort(shard_ids, kind="stable")
        counts = np.bincount(shard_ids, minlength=num_shards)
        stream = self.stream[order]
        lba = self.lba[order]
        fp = self.fp[order]
        op = None if self.op is None else self.op[order]
        ts = None if self.ts is None else self.ts[order]
        parts = []
        a = 0
        for c in counts.tolist():
            b = a + c
            parts.append(
                None
                if c == 0
                else ReplayBatch(
                    stream[a:b],
                    lba[a:b],
                    fp[a:b],
                    op=None if op is None else op[a:b],
                    ts=None if ts is None else ts[a:b],
                )
            )
            a = b
        return parts, order


def run_replay(engine, trace: np.ndarray, batched: bool = True,
               batch_size: int = DEFAULT_BATCH_SIZE, parallel: bool = False):
    """Drive any Engine over a merged trace; batched when the engine supports
    it.  ``parallel=True`` additionally runs cluster shards on worker threads
    (engines without an executor — the single-node ones — ignore it)."""
    if batched and hasattr(engine, "replay_batched"):
        if parallel and hasattr(engine, "start_executor"):
            return engine.replay_batched(trace, batch_size=batch_size, parallel=True)
        return engine.replay_batched(trace, batch_size=batch_size)
    return engine.replay(trace)


def engine_ingest(engine, trace: np.ndarray, batch_size: int = DEFAULT_BATCH_SIZE):
    """Mid-stream batched ingest for a single engine: ``replay_batched``
    WITHOUT the end-of-replay flush, so pending duplicate runs survive.

    This is the resumable entry point the snapshot/restore harness drives:
    ingest a prefix, ``snapshot()``, restore elsewhere, ingest the rest,
    then ``engine_finish_replay`` + ``finish()`` — bit-exact with one
    uninterrupted replay.  (``ShardedCluster.ingest_batched`` is the
    cluster-level analogue.)
    """
    rb = ReplayBatch.from_trace(trace)
    for chunk in rb.batches(batch_size):
        engine_run_batch(engine, chunk)
    return engine


def engine_run_batch(engine, rb: ReplayBatch, out: Optional[np.ndarray] = None) -> None:
    """One batched ingest step for any engine, WITHOUT the end-of-replay
    flush — the cluster coordinator feeds a shard many sub-batches and must not
    close pending duplicate runs at chunk boundaries (the scalar oracle only
    flushes once, at the end of the whole replay).

    The built-in engines dispatch to their non-flushing columnar loops.
    Other ``Engine`` implementations fall back to their own protocol
    surface — ``write_batch`` for write-only batches, ``replay`` over the
    reconstructed records otherwise — so any protocol-conformant engine
    works as a cluster shard (flush timing inside the fallback is then the
    engine's own business).
    """
    from .baselines import DIODE, PurePostProcessing
    from .hybrid import HPDedup

    if isinstance(engine, HPDedup):
        hpdedup_run(engine, rb, out)
    elif isinstance(engine, DIODE):
        _diode_bulk(engine, rb, out, 0)
    elif isinstance(engine, PurePostProcessing):
        _postproc_bulk(engine, rb)
    elif rb.op is None:
        flags = engine.write_batch(rb.stream, rb.lba, rb.fp)
        if out is not None:
            out[: len(rb)] = flags
    else:
        recs = np.zeros(len(rb), dtype=TRACE_DTYPE)
        recs["stream"] = rb.stream
        recs["op"] = rb.op
        recs["lba"] = rb.lba
        recs["fp"] = rb.fp
        if rb.ts is not None:
            recs["ts"] = rb.ts
        engine.replay(recs)


def engine_finish_replay(engine) -> None:
    """The per-engine end-of-replay flush matching ``engine_run_batch``.

    Unknown engines are a no-op: their ``write_batch``/``replay`` fallback
    owns its flush timing."""
    from .baselines import DIODE, PurePostProcessing
    from .hybrid import HPDedup

    if isinstance(engine, HPDedup):
        engine.inline.flush()
    elif isinstance(engine, DIODE):
        engine._flush_run()
        engine.store.flush_staged()


# ---------------------------------------------------------------------------
# Shared pre-pass pieces.
# ---------------------------------------------------------------------------


def _launch_dup_count(seen, w_fps: np.ndarray):
    """Batched duplicate-write accounting against the all-time seen index,
    split into launch and consume so the device probe overlaps host work.

    Returns ``(consume, uniq, first_idx, inv)`` from ``np.unique`` over the
    batch's write fingerprints.  ``seen`` is the engine's
    ``FingerprintIndex``: the batch's *unique* fingerprints are probed and
    the fresh ones inserted in one ``probe_and_add`` launch against the
    device-resident hash table — no per-fingerprint Python membership calls
    on the bulk path.  ``consume()`` yields the batch's duplicate-write
    count; the index must not be touched before it runs.
    """
    uniq, first_idx, inv = np.unique(w_fps, return_index=True, return_inverse=True)
    pending = seen.probe_and_add_async(uniq)

    def consume() -> int:
        known = pending()
        return w_fps.size - int(np.count_nonzero(~known))

    return consume, uniq, first_idx, inv


def _launch_maybe_hit(cache, uniq: np.ndarray, first_idx, inv, nw: int):
    """Per-write-record cache-hit pre-filter, split into launch and consume.

    ``consume(pending_fps)`` yields flags where False means the record
    *cannot* hit the cache: its fingerprint was not cached at sub-batch
    start (one batched probe of the cache's resident-fingerprint index over
    the unique set), did not appear earlier in the sub-batch (where it may
    have been admitted on its miss-write), and is not in a pending
    duplicate run carried over from an earlier batch (a below-threshold or
    stale-PBA run decision re-admits those mid-bulk).  Lookups are
    side-effect-free on misses, so skipping definite misses preserves exact
    cache state.  The cache must not be mutated before consume runs.
    """
    pending = cache.contains_many_async(uniq)

    def consume(pending_fps) -> np.ndarray:
        in_cache = pending()
        if pending_fps:
            in_cache |= np.fromiter(
                map(pending_fps.__contains__, uniq.tolist()), dtype=bool, count=uniq.size
            )
        is_first = np.zeros(nw, dtype=bool)
        is_first[first_idx] = True
        return in_cache[inv] | ~is_first

    return consume


def _certify_staged(store, w_streams: np.ndarray, w_lbas: np.ndarray, pending_keys=None) -> bool:
    """True when no write that may land during this sub-batch hits an
    already-mapped or repeated (stream, LBA) key, i.e. no refcount can drop
    and no PBA can be freed mid-batch — the precondition for the staged
    store path.  On success the store's per-stream LBA watermarks are raised
    over everything this bulk may map, which is what lets the next bulk
    certify with one comparison per stream instead of one probe per record.

    ``pending_keys`` are the keys of not-yet-decided duplicate runs carried
    over from earlier batches: their LBA mappings are written when the run
    decision fires, which can happen during *this* bulk, so they count as
    part of the bulk's write set for collision purposes.
    """
    nw = w_streams.size
    if nw == 0:
        return True
    # group by (stream, lba): intra-batch repeats show up as adjacent equals
    lex = np.lexsort((w_lbas, w_streams))
    sl = w_lbas[lex]
    ssl = w_streams[lex]
    if nw > 1:
        d_stream = np.diff(ssl)
        if bool(((np.diff(sl) == 0) & (d_stream == 0)).any()):
            return False
        cuts = np.nonzero(d_stream)[0] + 1
    else:
        cuts = np.empty(0, dtype=np.int64)
    starts = np.concatenate(([0], cuts))
    su = ssl[starts].tolist()
    mins = sl[starts].tolist()
    maxs = sl[np.concatenate((cuts, [nw])) - 1].tolist()

    lm = store.lba_map
    wm = store._lba_watermark
    if pending_keys:
        for key in pending_keys:
            if key in lm:
                return False
    fast = all(mn >= wm.get(s, 0) for s, mn in zip(su, mins))
    if fast and pending_keys:
        # a pending key above the watermark could collide with a fresh batch
        # key; below it, batch keys (all >= watermark) can never touch it
        fast = all(lba < wm.get(s, 0) for s, lba in pending_keys)
    if not fast:
        if pending_keys:
            for key in zip(w_streams.tolist(), w_lbas.tolist()):
                if key in lm or key in pending_keys:
                    return False
        elif any(map(lm.__contains__, zip(w_streams.tolist(), w_lbas.tolist()))):
            return False
    for s, mx in zip(su, maxs):
        if mx >= wm.get(s, 0):
            wm[s] = mx + 1
    if pending_keys:
        for s, lba in pending_keys:
            if lba >= wm.get(s, 0):
                wm[s] = lba + 1
    return True


# ---------------------------------------------------------------------------
# HPDedup (and iDedup = HPDedup minus prioritization) batched replay loop.
# ---------------------------------------------------------------------------


def _hpdedup_bulk(hp, rb: ReplayBatch, out: Optional[np.ndarray], base: int) -> None:
    """Vectorized pre-pass + residual loop for a boundary-free record span.

    Caller guarantees no estimator-interval or postprocess-period trigger
    fires for any write in ``rb``.
    """
    n = len(rb)
    if n == 0:
        return
    inline = hp.inline
    m = inline.metrics
    thr = inline.thresholds
    store = inline.store

    if rb.op is None:
        is_w = None
        w_streams, w_lbas, w_fps = rb.stream, rb.lba, rb.fp
        nw, nr = n, 0
    else:
        is_w = rb.op == OP_WRITE
        w_streams, w_lbas, w_fps = rb.stream[is_w], rb.lba[is_w], rb.fp[is_w]
        nw = int(np.count_nonzero(is_w))
        nr = n - nw

    maybe_w: Optional[np.ndarray] = None
    staged = False
    if nw:
        # launch both index probes first — the seen-set ground truth
        # (HPDedup.write's _seen_fps branch) and the cache residency
        # pre-filter — then run the host-only certify/accumulation work
        # while the device launches are in flight; the consumes land below
        dups_done, uniq, first_idx, inv = _launch_dup_count(hp._seen_fps, w_fps)
        maybe_done = _launch_maybe_hit(inline.cache, uniq, first_idx, inv, nw)
        pending_fps = {
            item[1] for run in inline._pending.values() for item in run.items
        }
        pending_keys = {
            (s, item[0]) for s, run in inline._pending.items() for item in run.items
        }
        staged = _certify_staged(store, w_streams, w_lbas, pending_keys)

        # per-stream grouping, shared by the accumulation and estimator steps
        order = np.argsort(w_streams, kind="stable")
        ss = w_streams[order]
        cuts = np.nonzero(np.diff(ss))[0] + 1
        starts = np.concatenate(([0], cuts))
        ends = np.concatenate((cuts, [nw]))
        su_list = ss[starts].tolist()
        counts_list = (ends - starts).tolist()

        # per-stream write accumulation (metrics + spatial-threshold counters)
        psw = m.per_stream_writes
        thr_writes = thr.writes
        for s, c in zip(su_list, counts_list):
            psw[s] = psw.get(s, 0) + c
            thr._ensure(s)
            thr_writes[s] += c

        # estimator: one batched update — counts and reservoir offers grouped
        # per stream (per-stream RNGs keep grouped offers bit-identical to
        # interleaved scalar offers)
        est = inline.estimator
        if est is not None:
            sf = w_fps[order]
            for s, a, b in zip(su_list, starts.tolist(), ends.tolist()):
                res = est.reservoirs.get(s)
                if res is None:
                    cap = max(16, int(est.sampling_rate * est.interval_len))
                    res = Reservoir(cap, seed=est.seed + s)
                    est.reservoirs[s] = res
                    est.stream_writes[s] = 0
                    est.on_stream_join(s)
                res.offer_many(sf[a:b].tolist())
                est.stream_writes[s] += b - a
            est.writes_in_interval += nw

        # consume the probes launched at the top of the bulk (device work
        # overlapped the host-side accumulation above)
        hp._dup_writes += dups_done()
        maybe_w = maybe_done(pending_fps)

    if nr:
        r_uniq, r_counts = np.unique(rb.stream[~is_w], return_counts=True)
        thr_reads = thr.reads
        for s, c in zip(r_uniq.tolist(), r_counts.tolist()):
            thr._ensure(s)
            thr_reads[s] += c

    m.writes += nw
    m.reads += nr
    hp._total_writes += nw
    hp._writes_since_post += nw

    # ---- residual loop: run decisions, admissions/evictions, store I/O ----
    streams_l = rb.stream.tolist()
    lbas_l = rb.lba.tolist()
    fps_l = rb.fp.tolist()
    ops_l = None if rb.op is None else rb.op.tolist()
    if maybe_w is None:
        maybe_l = [False] * n
    elif is_w is None:
        maybe_l = maybe_w.tolist()
    else:
        maybe = np.zeros(n, dtype=bool)
        maybe[is_w] = maybe_w
        maybe_l = maybe.tolist()

    if ops_l is None:
        ops_l = [OP_WRITE] * n
    lookup = inline.cache.lookup
    pending = inline._pending
    read_runs = inline._read_runs
    record_read_run = thr.record_read_run
    pending_run = _PendingRun
    hits = 0

    if staged:
        # fully inlined staged loop: store mutations are local list appends /
        # dict sets; run decisions mirror InlineDedupEngine._decide_run with
        # staged writes (TOCTOU guard included)
        lm = store.lba_map
        fp_of = store.fp_of_pba
        sw_append = store._staged_writes.append
        sd_append = store._staged_dups.append
        pba_next = store._next_pba
        admit = inline.cache.admit
        threshold_of = inline.threshold_of
        record_dup_run = thr.record_dup_run
        psd = m.per_stream_dups
        inline_dups_c = 0
        broken_c = 0
        # until the store has ever freed a PBA, a cached (fp, pba) pair
        # cannot go stale (PBAs are never reused), so the run decision may
        # skip the per-item TOCTOU revalidation.  Frees can only happen at
        # boundaries, never inside this bulk.
        check_stale = store._ever_freed

        sd_extend = store._staged_dups.extend

        def decide(s, run):
            nonlocal pba_next, inline_dups_c, broken_c
            items = run.items
            record_dup_run(s, len(items))
            if len(items) >= threshold_of(s):
                if not check_stale:
                    # no PBA has ever been freed: every item is a valid dup,
                    # so the whole run applies through C-driven bulk updates
                    lm.update(((s, it[0]), it[2]) for it in items)
                    sd_extend([it[2] for it in items])
                    run_dups = len(items)
                else:
                    run_dups = 0
                    for lba2, f2, p2 in items:
                        if fp_of.get(p2) != f2:
                            # TOCTOU guard, as in the scalar path: stale = miss
                            p_new = pba_next
                            pba_next = p_new + 1
                            fp_of[p_new] = f2
                            lm[(s, lba2)] = p_new
                            sw_append((f2, p_new))
                            admit(s, f2, p_new)
                            continue
                        lm[(s, lba2)] = p2
                        sd_append(p2)
                        run_dups += 1
                if run_dups:
                    inline_dups_c += run_dups
                    psd[s] = psd.get(s, 0) + run_dups
            else:
                broken_c += 1
                for lba2, f2, p2 in items:
                    p_new = pba_next
                    pba_next = p_new + 1
                    fp_of[p_new] = f2
                    lm[(s, lba2)] = p_new
                    sw_append((f2, p_new))
                    admit(s, f2, p_new)

        # devirtualized cache probe: PrioritizedCache exposes the owner
        # index; GlobalCache wraps a single policy object
        owner = getattr(inline.cache, "owner", None)
        owner_get = owner.get if owner is not None else None
        csubs = getattr(inline.cache, "streams", None)
        flat_lookup = None if owner is not None else inline.cache.cache.lookup

        for i, (op, s, lba, f, mh) in enumerate(
            zip(ops_l, streams_l, lbas_l, fps_l, maybe_l)
        ):
            if op == OP_WRITE:
                if not mh:
                    pba = None
                elif owner_get is not None:
                    holder = owner_get(f)
                    pba = None if holder is None else csubs[holder].lookup(f)
                else:
                    pba = flat_lookup(f)
                if pba is not None:
                    hits += 1
                    run = pending.get(s)
                    if run is not None and lba == run.next_lba:
                        run.items.append((lba, f, pba))
                        run.next_lba = lba + 1
                    else:
                        if run is not None:
                            decide(s, run)
                        pending[s] = pending_run(lba, lba + 1, [(lba, f, pba)])
                    if out is not None:
                        out[base + i] = True
                else:
                    run = pending.pop(s, None)
                    if run is not None:
                        decide(s, run)
                    p_new = pba_next
                    pba_next = p_new + 1
                    fp_of[p_new] = f
                    lm[(s, lba)] = p_new
                    sw_append((f, p_new))
                    admit(s, f, p_new)
            else:
                run = pending.pop(s, None)
                if run is not None:
                    decide(s, run)
                nxt = read_runs.get(s)
                if nxt is not None and nxt[0] == lba:
                    read_runs[s] = (lba + 1, nxt[1] + 1)
                else:
                    if nxt is not None:
                        record_read_run(s, nxt[1])
                    read_runs[s] = (lba + 1, 1)

        store._next_pba = pba_next
        m.inline_dups += inline_dups_c
        m.broken_runs += broken_c
    else:
        decide = inline._decide_run
        miss_write = inline._write_block
        store_read = inline.store.read
        for i, (op, s, lba, f, mh) in enumerate(
            zip(ops_l, streams_l, lbas_l, fps_l, maybe_l)
        ):
            if op == OP_WRITE:
                pba = lookup(s, f) if mh else None
                if pba is not None:
                    hits += 1
                    run = pending.get(s)
                    if run is not None and lba == run.next_lba:
                        run.items.append((lba, f, pba))
                        run.next_lba = lba + 1
                    else:
                        if run is not None:
                            decide(s, run)
                        pending[s] = pending_run(lba, lba + 1, [(lba, f, pba)])
                    if out is not None:
                        out[base + i] = True
                else:
                    run = pending.pop(s, None)
                    if run is not None:
                        decide(s, run)
                    miss_write(s, lba, f)
            else:
                run = pending.pop(s, None)
                if run is not None:
                    decide(s, run)
                nxt = read_runs.get(s)
                if nxt is not None and nxt[0] == lba:
                    read_runs[s] = (lba + 1, nxt[1] + 1)
                else:
                    if nxt is not None:
                        record_read_run(s, nxt[1])
                    read_runs[s] = (lba + 1, 1)
                store_read(s, lba)

    store.flush_staged()
    m.cache_hits += hits
    est = inline.estimator
    if est is not None:
        est._interval_dups += hits


def hpdedup_run(hp, rb: ReplayBatch, out: Optional[np.ndarray] = None) -> None:
    """Process one batch, splitting at estimator/postprocess boundaries."""
    n = len(rb)
    w_pos = rb.write_positions()
    est = hp.inline.estimator
    period = hp.postprocess_period
    pos = 0
    wptr = 0  # index into w_pos of the first write at/after pos
    while pos < n:
        k = None  # writes until (and including) the next trigger
        if est is not None:
            k = est.interval_len - est.writes_in_interval
        if period:
            k_post = period - hp._writes_since_post
            if k is None or k_post < k:
                k = k_post
        if k is not None and k < 1:
            k = 1  # trigger already due: next write must replay scalarly
        if k is None:
            boundary = None
        elif w_pos is None:
            boundary = pos + k - 1 if pos + k - 1 < n else None
        else:
            widx = wptr + k - 1
            boundary = int(w_pos[widx]) if widx < w_pos.size else None
        end = n if boundary is None else boundary
        if end > pos:
            _hpdedup_bulk(hp, rb.slice(pos, end), out, pos)
        if boundary is None:
            break
        # the trigger-carrying record replays through the scalar oracle path
        deduped = hp.write(int(rb.stream[boundary]), int(rb.lba[boundary]), int(rb.fp[boundary]))
        if out is not None and deduped:
            out[boundary] = True
        if w_pos is not None:
            wptr += k
        pos = boundary + 1


def _fp_column(fps) -> np.ndarray:
    """Fingerprints as uint64.  ``np.asarray`` of a Python list that mixes
    values at or above 2^63 with smaller ones gives float64 and rounds them
    to 53 bits (the reference does that); ``dtype=np.uint64`` keeps them."""
    return np.asarray(fps, dtype=np.uint64)


def hpdedup_write_batch(hp, streams, lbas, fps) -> np.ndarray:
    """Batched write ingestion; returns per-record inline-dedup flags."""
    rb = ReplayBatch(np.asarray(streams), np.asarray(lbas), _fp_column(fps))
    out = np.zeros(len(rb), dtype=bool)
    hpdedup_run(hp, rb, out)
    return out


def hpdedup_replay(hp, trace: np.ndarray, batch_size: int = DEFAULT_BATCH_SIZE):
    rb = ReplayBatch.from_trace(trace)
    for chunk in rb.batches(batch_size):
        hpdedup_run(hp, chunk)
    hp.inline.flush()
    return hp


# ---------------------------------------------------------------------------
# DIODE batched replay loop.
# ---------------------------------------------------------------------------


def _flush_run_staged(d) -> None:
    """``DIODE._flush_run`` with staged store writes."""
    if not d._run:
        return
    t = d.thresholds.get(-1)
    d.thresholds.record_dup_run(-1, len(d._run))
    store = d.store
    if len(d._run) >= t:
        for stream, lba, fp, pba in d._run:
            # same TOCTOU guard as the scalar path: never dedup against a
            # PBA freed (or freed and recycled) since the cache hit
            if store.fp_of_pba.get(pba) != fp:
                d.cache.admit(stream, fp, store.stage_new_block(stream, lba, fp))
                continue
            store.stage_duplicate(stream, lba, pba)
            d.metrics.inline_dups += 1
    else:
        for stream, lba, fp, pba in d._run:
            d.cache.admit(stream, fp, store.stage_new_block(stream, lba, fp))
    d._run = []
    d._run_next_lba = None
    d._run_stream = None


def _diode_bulk(d, rb: ReplayBatch, out: Optional[np.ndarray], base: int) -> None:
    """DIODE has no estimator interval; its global-threshold update depends
    on hit outcomes, so it stays in the residual loop and no boundary
    splitting is needed."""
    n = len(rb)
    if n == 0:
        return
    m = d.metrics
    thr = d.thresholds
    thr._ensure(-1)
    store = d.store

    if rb.op is None:
        is_w = None
        w_streams, w_lbas, w_fps = rb.stream, rb.lba, rb.fp
        nw = n
    else:
        is_w = rb.op == OP_WRITE
        w_streams, w_lbas, w_fps = rb.stream[is_w], rb.lba[is_w], rb.fp[is_w]
        nw = int(np.count_nonzero(is_w))

    maybe_w: Optional[np.ndarray] = None
    ptype_w: Optional[np.ndarray] = None
    staged = False
    if nw:
        dups_done, uniq, first_idx, inv = _launch_dup_count(d._seen, w_fps)
        maybe_done = _launch_maybe_hit(d.cache, uniq, first_idx, inv, nw)
        pending_fps = {item[2] for item in d._run}  # (stream, lba, fp, pba)
        pending_keys = {(item[0], item[1]) for item in d._run}
        staged = _certify_staged(store, w_streams, w_lbas, pending_keys)

        # vectorized P-type classification.  is_ptype computes
        # (fp * 2654435761) % 1000 in unbounded Python ints; uint64 products
        # would wrap, but (a*b) % m == ((a%m)*(b%m)) % m, so reduce fp mod
        # 1000 first and the product stays tiny.
        s_uniq = np.unique(w_streams)
        thresh_of = {int(s): int(d._ptype_fraction(int(s)) * 1000) for s in s_uniq}
        if any(thresh_of.values()):
            th = np.array([thresh_of[int(s)] for s in s_uniq], dtype=np.uint64)
            per_rec_th = th[np.searchsorted(s_uniq, w_streams)]
            mod_vals = (w_fps % np.uint64(1000)) * np.uint64(2654435761 % 1000) % np.uint64(1000)
            ptype_w = mod_vals < per_rec_th

        # consume the probes launched above (overlapped with certify/P-type)
        d._dup_writes += dups_done()
        maybe_w = maybe_done(pending_fps)

    m.writes += nw
    d._total_writes += nw

    streams_l = rb.stream.tolist()
    lbas_l = rb.lba.tolist()
    fps_l = rb.fp.tolist()
    ops_l = None if rb.op is None else rb.op.tolist()

    def expand(flags_w, default):
        if flags_w is None:
            return [default] * n
        if is_w is None:
            return flags_w.tolist()
        full = np.full(n, default, dtype=bool)
        full[is_w] = flags_w
        return full.tolist()

    maybe_l = expand(maybe_w, False)
    ptype_l = expand(ptype_w, False)

    lookup = d.cache.lookup
    thr_reads = thr.reads
    thr_writes = thr.writes
    hits = 0

    if staged:
        def flush_run():
            _flush_run_staged(d)

        def write_through(s, lba, f):
            d.cache.admit(s, f, store.stage_new_block(s, lba, f))

        store_write = store.stage_new_block
        store_read = None
    else:
        flush_run = d._flush_run
        write_through = d._write_through
        store_write = store.write_new_block
        store_read = store.read

    for i in range(n):
        s = streams_l[i]
        lba = lbas_l[i]
        if ops_l is None or ops_l[i] == OP_WRITE:
            thr_writes[-1] += 1  # record_request(-1, is_read=False)
            f = fps_l[i]
            if ptype_l[i]:
                flush_run()
                store_write(s, lba, f)  # P-type bypass: no cache admission
                continue
            pba = lookup(s, f) if maybe_l[i] else None
            if pba is not None:
                hits += 1
                if d._run and d._run_stream == s and lba == d._run_next_lba:
                    d._run.append((s, lba, f, pba))
                    d._run_next_lba = lba + 1
                else:
                    flush_run()
                    d._run = [(s, lba, f, pba)]
                    d._run_next_lba = lba + 1
                    d._run_stream = s
                if out is not None:
                    out[base + i] = True
            else:
                flush_run()
                write_through(s, lba, f)
                d._maybe_update_threshold()
        else:
            flush_run()
            thr_reads[-1] += 1  # record_request(-1, is_read=True)
            if store_read is not None:
                store_read(s, lba)

    store.flush_staged()
    m.cache_hits += hits


def diode_write_batch(d, streams, lbas, fps) -> np.ndarray:
    rb = ReplayBatch(np.asarray(streams), np.asarray(lbas), _fp_column(fps))
    out = np.zeros(len(rb), dtype=bool)
    _diode_bulk(d, rb, out, 0)
    return out


def diode_replay(d, trace: np.ndarray, batch_size: int = DEFAULT_BATCH_SIZE):
    rb = ReplayBatch.from_trace(trace)
    for chunk in rb.batches(batch_size):
        _diode_bulk(d, chunk, None, 0)
    d._flush_run()
    d.store.flush_staged()
    return d


# ---------------------------------------------------------------------------
# PurePostProcessing batched replay loop.
# ---------------------------------------------------------------------------


def _postproc_bulk(pp, rb: ReplayBatch) -> None:
    n = len(rb)
    if n == 0:
        return
    store = pp.store
    if rb.op is None:
        is_w = None
        w_streams, w_lbas, w_fps = rb.stream, rb.lba, rb.fp
        nw = n
    else:
        is_w = rb.op == OP_WRITE
        w_streams, w_lbas, w_fps = rb.stream[is_w], rb.lba[is_w], rb.fp[is_w]
        nw = int(np.count_nonzero(is_w))
    staged = False
    if nw:
        dups_done, _, _, _ = _launch_dup_count(pp._seen, w_fps)
        staged = _certify_staged(store, w_streams, w_lbas)
        pp._dup_writes += dups_done()
    pp._total_writes += nw
    pp.metrics.writes += nw

    if staged:
        # no cache, no run state, and batched reads touch nothing but the
        # (unmodeled) buffer: the whole write column applies via C-driven
        # dict updates — fully columnar ingest
        ws_l = w_streams.tolist()
        wl_l = w_lbas.tolist()
        wf_l = w_fps.tolist()
        pba0 = store._next_pba
        pbas = range(pba0, pba0 + nw)
        store._next_pba = pba0 + nw
        store.lba_map.update(zip(zip(ws_l, wl_l), pbas))
        store.fp_of_pba.update(zip(pbas, wf_l))
        store._staged_writes.extend(zip(wf_l, pbas))
    else:
        streams_l = rb.stream.tolist()
        lbas_l = rb.lba.tolist()
        fps_l = rb.fp.tolist()
        ops_l = None if rb.op is None else rb.op.tolist()
        store_write = store.write_new_block
        store_read = store.read
        for i in range(n):
            if ops_l is None or ops_l[i] == OP_WRITE:
                store_write(streams_l[i], lbas_l[i], fps_l[i])
            else:
                store_read(streams_l[i], lbas_l[i])
    store.flush_staged()


def postproc_write_batch(pp, streams, lbas, fps) -> np.ndarray:
    rb = ReplayBatch(np.asarray(streams), np.asarray(lbas), _fp_column(fps))
    _postproc_bulk(pp, rb)
    return np.zeros(len(rb), dtype=bool)  # nothing is ever deduped inline


def postproc_replay(pp, trace: np.ndarray, batch_size: int = DEFAULT_BATCH_SIZE):
    rb = ReplayBatch.from_trace(trace)
    for chunk in rb.batches(batch_size):
        _postproc_bulk(pp, chunk)
    return pp
