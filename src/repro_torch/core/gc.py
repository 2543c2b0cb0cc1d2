"""Online garbage collection: epoch drain + PBA compaction for one engine.

The port's counterpart of the reference's ``core/gc.py``; host code only.

``gc_engine`` is the single-shard GC step the cluster schedules on each
shard's worker lane (``ShardedCluster.run_gc``).  One call:

1. flushes staged columnar writes (idempotent — always empty at chunk
   boundaries, where the cluster schedules GC),
2. advances the store's GC epoch and drains limbo entries whose grace
   period has passed (no in-flight write still pins an epoch at or below
   the entry's tag),
3. optionally runs a budgeted post-process merge window (``max_merges`` —
   **schedule-visible**: merging changes which PBA is canonical, exactly
   like today's ``run_postprocess``, so it is off by default and excluded
   from the bit-exactness differential),
4. compacts the PBA range (``max_moves`` relocations of the highest live
   blocks into the lowest holes) and patches every piece of *decision*
   state that carries a PBA so inline decisions stay bit-exact with a
   never-compacted run.

Step 4's fixups are the heart of the bit-exactness argument.  A
relocation ``old -> new`` (moved block's fingerprint ``G``) can disturb a
decision in exactly two ways:

* a **valid** cached/pending pair ``(G, old)`` must follow its block to
  ``new`` — otherwise the TOCTOU guard (``fp_of_pba[pba] != fp``) would
  spuriously miss where the no-GC run dedups;
* a **stale** pair ``(F, new)`` — ``new`` was a freed slot the pair still
  references — must *never be resurrected* by the slot refilling with
  matching content (``F == G``).  A no-GC run never reuses PBA slots, so
  staleness there is permanent; we pin the pair to the sentinel ``-1``
  (never a real PBA, so ``fp_of_pba.get(-1)`` is always ``None`` and the
  pair is permanently stale on this side too).

Pairs stale for *other* fingerprints (``F != G``) keep failing the TOCTOU
guard naturally, and any later pass that refills their slot with matching
content re-enters the rule above.  Replacements are value-only
(``peek``/``replace``) so cache recency, frequency, and occupancy are
untouched.
"""

from __future__ import annotations

from typing import Dict, Optional


def _cache_peek(cache, fp: int) -> Optional[int]:
    """Value-only lookup across both cache wrappers (no recency update)."""
    owner = getattr(cache, "owner", None)
    if owner is not None:  # PrioritizedCache
        holder = owner.get(fp)
        return None if holder is None else cache.streams[holder].peek(fp)
    return cache.cache.peek(fp)  # GlobalCache


def _cache_replace(cache, fp: int, pba: int) -> None:
    """Value-only overwrite across both cache wrappers."""
    owner = getattr(cache, "owner", None)
    if owner is not None:
        holder = owner.get(fp)
        if holder is not None:
            cache.streams[holder].replace(fp, pba)
    elif fp in cache.cache:
        cache.cache.replace(fp, pba)


def _fix_decision_state(engine, relocs: Dict[int, int]) -> None:
    """Patch caches and pending duplicate runs after ``store.compact``."""
    store = engine.store
    fills = {new: store.fp_of_pba[new] for new in relocs.values()}

    def remap(fp: int, pba: int) -> int:
        new = relocs.get(pba)
        if new is not None:
            return new if store.fp_of_pba.get(new) == fp else -1
        if fills.get(pba) == fp:
            return -1  # resurrect-pin: see module docstring
        return pba

    # fingerprint caches: one conditional, value-only touch per relocation
    inline = getattr(engine, "inline", None)
    cache = inline.cache if inline is not None else getattr(engine, "cache", None)
    if cache is not None:
        for old, new in relocs.items():
            fp = fills[new]
            v = _cache_peek(cache, fp)
            if v == old:
                _cache_replace(cache, fp, new)
            elif v == new:
                _cache_replace(cache, fp, -1)

    # pending duplicate runs: HPDedup keeps (lba, fp, pba) items per stream,
    # DIODE one global (stream, lba, fp, pba) run
    if inline is not None:
        for run in inline._pending.values():
            run.items = [(lba, fp, remap(fp, pba)) for lba, fp, pba in run.items]
    drun = getattr(engine, "_run", None)
    if drun:
        engine._run = [(s, lba, fp, remap(fp, pba)) for s, lba, fp, pba in drun]


def gc_engine(
    engine,
    max_moves: Optional[int] = None,
    max_merges: Optional[int] = None,
) -> Dict[str, int]:
    """One online-GC step for a single engine; returns reclaim stats."""
    store = engine.store
    store.flush_staged()
    epoch = store.advance_epoch()
    collected = store.collect_limbo()
    merged = 0
    if max_merges:
        before = engine.post.metrics.merges
        engine.run_postprocess(max_merges=max_merges)
        merged = engine.post.metrics.merges - before
        collected += store.collect_limbo()
    relocs = store.compact(max_moves)
    if relocs:
        _fix_decision_state(engine, relocs)
    return {
        "epoch": epoch,
        "collected": collected,
        "moved": len(relocs),
        "merged": merged,
        "holes_left": len(store._free_pbas),
        "limbo_left": len(store._limbo),
    }
