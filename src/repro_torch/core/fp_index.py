"""Device-resident exact fingerprint index (DESIGN §4).

``FingerprintIndex`` is the one membership layer every probe in the stack
goes through: the inline phase's all-time seen set, the fingerprint cache's
batched pre-probe, the block store's fingerprint-table membership and the
cluster's multi-shard scatter probe all hold one of these.  It pairs

* a **device-layout hash table** — the tiled bounded-window open-addressing
  layout of ``repro_torch.kernels.fp_index``, one flat int64 slot array
  probed either by the kernel trio (``backend="torch"``: the CUDA kernels
  on the card, their plain PyTorch versions on a CPU tensor) or by a
  vectorized numpy implementation (``backend="numpy"``, the host path) —
  with
* the **authoritative host state** — the index *is a* ``set`` of Python
  int fingerprints; the set is the ground truth the table accelerates.

On the torch backend the table is **one persistent tensor** on the index's
device: insert/remove launches update it in place and ship keys only, and
the host ``_t64`` mirror is materialized lazily — only when
``check_consistency`` asks for it.  A rebuild (growth, tombstone pressure,
restore) resets the table host-side and re-uploads on the next launch.

``device`` names where the table lives; it defaults to the card, and
``device="cuda"`` on a host without one raises.  ``backend="auto"`` picks
``torch`` for a CUDA device and ``numpy`` for the CPU.

Exactness contract (property-tested in tests/test_fp_index.py):

* no false positives or negatives, ever: the table stores full 64-bit keys
  (not a partial-hash filter), keys that cannot live in the table — window
  **overflow**, and the two values colliding with the in-band EMPTY/
  TOMBSTONE sentinels (0 and 2^64-1) — **spill to a host set** that every
  batched probe consults, and removals tombstone their slot;
* the table is **derived, never serialized**: snapshots persist the key
  set (exactly as the engines always did) and a restored index rebuilds
  its table from it, so the snapshot state-tree format is untouched and a
  corrupted table can always be rebuilt host-side.

Mutations stage lazily and fold into the table before the next batched
probe: scalar add/discard (the per-record oracle path) stage into pending
dicts at native-set speed, and ``add_many`` stages its whole key array
into a journal — so bulk insertion costs what the plain host set costs,
and the table build happens once, vectorized, at the next probe.  Batched
probes (``contains_many``, ``probe_and_add``) are one vectorized launch
per call, with ``*_async`` variants that split the launch from the
consume so device probes overlap host work; tiny batches fall back to the
host set, below the size where a vectorized launch wins (``small_batch``,
set to 0 by tests that want the table path exercised unconditionally).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

import torch

from ..kernels.fp_index import (
    OVERFLOW,
    PLACED_TOMB,
    WINDOW,
    phys_homes_host,
    probe_host,
    table_phys_len,
)
from ..kernels.ops import fp_index_insert, fp_index_probe, fp_index_remove

EMPTY_KEY = 0  # the EMPTY slot sentinel
TOMB_KEY = (1 << 64) - 1  # the TOMBSTONE slot sentinel (-1 as int64)

DEFAULT_CAPACITY = 1 << 12
# Above this fill fraction the table rebuilds at the next power of two.
# Deliberately low (memory-for-speed): probe cost is dominated by how many
# probe rounds survive past the first gather, which shrinks geometrically
# with the load factor, for 8 bytes/slot of extra memory.  Window overflow
# (-> host spill) is also rarer at low load.
GROW_LOAD = 0.35
# Probing fewer keys than this goes through the host set: a vectorized
# launch has fixed overhead that only pays off on real batches (the
# reference measured the crossover at ~1.5-2k keys for its host path).
SMALL_BATCH = 1536
# The same crossover for a table on a CUDA device, from ``chip_smoke.py``'s
# crossover phase on an H100: the largest batch the host set answers.
# Before the index launch path was cut, a synchronous probe round trip cost
# 0.07-0.11 ms and the card won from 1,024 keys in five of six logged runs
# (1,536 in one).  Since, the kernel reads the keys from pinned host memory,
# the round trip costs 0.04-0.08 ms against the host set's 0.1-0.17 us a key,
# and the card won from 768 keys in three of five calls, from 512 in two
# (PERF.md §5 lists them).  The answers are exact on either route.
SMALL_BATCH_CARD = 512

# Batched membership probes (``contains_many_async``) by route: ``host``
# answered from the host set under ``small_batch``, ``table`` through the
# table (on the torch backend, one probe launch).  Calls and keys of each.
PROBE_ROUTES = {"host_calls": 0, "host_keys": 0, "table_calls": 0, "table_keys": 0}


def reset_probe_routes() -> None:
    for k in PROBE_ROUTES:
        PROBE_ROUTES[k] = 0


def _auto_backend(device: torch.device) -> str:
    return "torch" if device.type == "cuda" else "numpy"


class FingerprintIndex(set):
    """Exact membership index over 64-bit fingerprints.

    Subclasses ``set`` so every host-side consumer of the engines' seen
    sets (snapshots, resharding migration, harness population scans) keeps
    working unchanged — the set *is* the authoritative state; the table,
    spill and pending buffers are the device-resident acceleration layered
    on top.  All mutations must go through the overridden mutators (they
    keep the table coherent); the read-only ``set`` API is inherited as is.
    """

    __slots__ = (
        "_cap",
        "_t64",
        "_dev",
        "_device",
        "_host_dirty",
        "_spill",
        "_pending_adds",
        "_pending_removes",
        "_journal",
        "_journal_n",
        "_table_live",
        "_tombstones",
        "_backend",
        "small_batch",
    )

    def __init__(
        self,
        keys: Iterable[int] = (),
        *,
        capacity: int = DEFAULT_CAPACITY,
        backend: str = "auto",
        small_batch: int | None = None,
        device="cuda",
    ):
        super().__init__(keys)
        if backend not in ("auto", "numpy", "torch"):
            raise ValueError(f"backend must be auto|numpy|torch, got {backend!r}")
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FingerprintIndex(device={device!r}) needs a CUDA device and none is "
                "available; pass device='cpu' to run on the host"
            )
        self._backend = _auto_backend(self._device) if backend == "auto" else backend
        if small_batch is None:
            small_batch = SMALL_BATCH_CARD if self._device.type == "cuda" else SMALL_BATCH
        self.small_batch = small_batch
        cap = 1
        while cap < capacity:
            cap <<= 1
        self._rebuild(cap)

    # -- device table ------------------------------------------------------------
    def _use_torch(self) -> bool:
        return self._backend == "torch"

    def _dev_table(self) -> torch.Tensor:
        """The persistent device table, uploading the host table on first
        use (and after a rebuild dropped it)."""
        if self._dev is None:
            self._dev = torch.from_numpy(self._t64.view(np.int64)).to(self._device, copy=True)
        return self._dev

    def _sync_host(self) -> None:
        """Materialize the host ``_t64`` mirror from the device table."""
        if self._host_dirty:
            self._t64 = self._dev.to("cpu", copy=True).numpy().view(np.uint64)
            self._host_dirty = False

    # -- table maintenance -----------------------------------------------------
    def _rebuild(self, cap: int) -> None:
        """(Re)build the table from the authoritative set — the restore path
        and the growth path are the same code on purpose.  Folds any pending
        mutations (the set already reflects them), clears spill back to what
        genuinely cannot live in the table, and invalidates the device
        buffers — the next launch re-uploads the fresh table."""
        n_set = len(self)
        while n_set > GROW_LOAD * cap:
            cap <<= 1
        self._cap = cap
        # host table: one uint64 word per slot (hi << 32 | lo), the flat
        # tiled physical layout the device table shares
        self._t64 = np.zeros(table_phys_len(cap), dtype=np.uint64)
        self._dev = None
        self._host_dirty = False
        self._spill = {k for k in (EMPTY_KEY, TOMB_KEY) if k in self}
        self._pending_adds = {}
        self._pending_removes = {}
        self._journal = []
        self._journal_n = 0
        self._table_live = 0
        self._tombstones = 0
        if n_set > len(self._spill):
            keys = np.fromiter(self, dtype=np.uint64, count=n_set)
            if self._spill:
                keys = keys[(keys != np.uint64(EMPTY_KEY)) & (keys != np.uint64(TOMB_KEY))]
            for a in range(0, keys.size, 1 << 16):
                self._table_insert(keys[a : a + (1 << 16)])

    def _grow_if_needed(self, incoming: int) -> bool:
        """Rebuild at a bigger capacity if ``incoming`` more table entries
        would pass the load threshold (or tombstones piled up).  Returns
        True when it rebuilt — the rebuild re-inserts *every* set member,
        so the caller must then skip its own explicit insert.
        """
        need = self._table_live + incoming
        if need <= GROW_LOAD * self._cap and self._tombstones <= self._cap // 4:
            return False
        cap = self._cap
        while need > GROW_LOAD * cap:
            cap <<= 1
        self._rebuild(cap)
        return True

    def _flush(self) -> None:
        """Fold pending mutations into the table.

        Order matters: the scalar pending-add dict holds keys known absent
        from the table (direct insert), the ``add_many`` journal may hold
        anything (unique + probe-filter first), and removals fold last so a
        journaled key that was discarded after staging is inserted and then
        tombstoned — never left dangling in the table.
        """
        if not self._pending_adds and not self._pending_removes and not self._journal:
            return
        journal_keys = None
        if self._journal:
            journal_keys = (
                self._journal[0] if len(self._journal) == 1 else np.concatenate(self._journal)
            )
            journal_keys = np.unique(journal_keys)
            self._journal = []
            self._journal_n = 0
        incoming = len(self._pending_adds) + (journal_keys.size if journal_keys is not None else 0)
        if self._grow_if_needed(incoming):
            return  # the rebuild folded every buffer (set is authoritative)
        if self._pending_adds:
            keys = np.fromiter(self._pending_adds, dtype=np.uint64, count=len(self._pending_adds))
            self._pending_adds = {}
            self._table_insert(keys)
        if journal_keys is not None:
            special = (journal_keys == np.uint64(EMPTY_KEY)) | (
                journal_keys == np.uint64(TOMB_KEY)
            )
            if special.any():
                self._spill.update(k for k in journal_keys[special].tolist() if k in self)
                journal_keys = journal_keys[~special]
            if journal_keys.size:
                known = self._table_probe(journal_keys)
                fresh = journal_keys[~known]
                if fresh.size:
                    self._table_insert(fresh)
        if self._pending_removes:
            keys = np.fromiter(
                self._pending_removes, dtype=np.uint64, count=len(self._pending_removes)
            )
            self._pending_removes = {}
            self._table_remove(keys)

    def _table_insert(self, keys: np.ndarray) -> None:
        """Place unique, sentinel-free keys known absent from the table;
        window overflow spills to the host set."""
        if keys.size == 0:
            return
        if self._use_torch():
            status = fp_index_insert(keys, self._dev_table(), self._cap)
            self._host_dirty = True  # updated in place on the device
            over = status == OVERFLOW
            self._table_live += int(keys.size - over.sum())
            self._tombstones -= int(np.count_nonzero(status == PLACED_TOMB))
            if over.any():
                self._spill.update(keys[over].tolist())
            return
        home = phys_homes_host(keys, self._cap)
        t64 = self._t64
        tomb = np.uint64(TOMB_KEY)
        for r in range(WINDOW):
            if keys.size == 0:
                return
            slot = home + r
            cur = t64[slot]
            free = (cur == 0) | (cur == tomb)
            cand = np.nonzero(free)[0]
            if cand.size:
                # one winner per distinct slot — writing candidates in
                # *reversed* batch order makes the first-in-batch write
                # land last and stick; losers (whose slot now holds the
                # winner) probe the next offset, exactly as if the winner
                # had been inserted before them
                rev = cand[::-1]
                t64[slot[rev]] = keys[rev]
                won = t64[slot[cand]] == keys[cand]
                win = cand[won]
                self._tombstones -= int((cur[win] == tomb).sum())
                self._table_live += win.size
                if win.size == keys.size:
                    return
                keep = np.ones(keys.size, dtype=bool)
                keep[win] = False
                keys, home = keys[keep], home[keep]
        if keys.size:
            self._spill.update(keys.tolist())

    def _table_remove(self, keys: np.ndarray) -> None:
        """Tombstone table slots for keys known resident in the table."""
        if keys.size == 0:
            return
        if self._use_torch():
            removed = fp_index_remove(keys, self._dev_table(), self._cap)
            self._host_dirty = True
            hits = int(np.count_nonzero(removed))
            self._table_live -= hits
            self._tombstones += hits
            return
        home = phys_homes_host(keys, self._cap)
        t64 = self._t64
        for r in range(WINDOW):
            if home.size == 0:
                return
            slot = home + r
            match = t64[slot] == keys
            if match.any():
                t64[slot[match]] = np.uint64(TOMB_KEY)
                self._table_live -= int(match.sum())
                self._tombstones += int(match.sum())
                keep = ~match
                keys, home = keys[keep], home[keep]

    def _table_probe_launch(self, keys: np.ndarray):
        """Start an exact membership probe of sentinel-free keys against
        table + spill; returns a zero-arg consumer producing the flags.

        On the torch backend the launch is enqueued immediately and its
        flags are copied to the host only in the consumer, so a probe on the
        card overlaps whatever host work runs in between.  The numpy backend
        computes eagerly — there is nothing to overlap with.
        """
        if self._use_torch():
            flags = fp_index_probe(keys, self._dev_table(), self._cap)

            def consume():
                return self._spill_fixup(keys, flags.cpu().numpy())

            return consume
        if self._table_live == 0:
            found = np.zeros(keys.size, dtype=bool)
        else:
            found = probe_host(self._t64, keys, self._cap)
        out = self._spill_fixup(keys, found)
        return lambda: out

    def _spill_fixup(self, keys: np.ndarray, found: np.ndarray) -> np.ndarray:
        # consult the spill set unless it holds nothing but sentinel keys
        # (sentinel-free probe keys can never match those)
        spill = self._spill
        if len(spill) > (1 if EMPTY_KEY in spill else 0) + (1 if TOMB_KEY in spill else 0):
            miss = np.nonzero(~found)[0]
            if miss.size:
                found[miss] = np.fromiter(
                    map(spill.__contains__, keys[miss].tolist()), dtype=bool, count=miss.size
                )
        return found

    def _table_probe(self, keys: np.ndarray) -> np.ndarray:
        return self._table_probe_launch(keys)()

    # -- batched API -----------------------------------------------------------
    def contains_many_async(self, fps):
        """Batched membership probe, split into launch and consume.

        Returns a zero-arg callable producing the (N,) bool flags.  The
        index must not be mutated between launch and consume.
        """
        keys = np.ascontiguousarray(fps, dtype=np.uint64)
        n = keys.size
        if n == 0:
            out = np.zeros(0, dtype=bool)
            return lambda: out
        if n <= self.small_batch:
            PROBE_ROUTES["host_calls"] += 1
            PROBE_ROUTES["host_keys"] += n
            out = np.fromiter(map(self.__contains__, keys.tolist()), dtype=bool, count=n)
            return lambda: out
        PROBE_ROUTES["table_calls"] += 1
        PROBE_ROUTES["table_keys"] += n
        self._flush()
        consume = self._table_probe_launch(keys)
        special = (keys == np.uint64(EMPTY_KEY)) | (keys == np.uint64(TOMB_KEY))
        if not special.any():
            return consume

        def consume_special():
            out = consume()
            si = np.nonzero(special)[0]
            out[si] = np.fromiter(
                (int(keys[i]) in self._spill for i in si), dtype=bool, count=si.size
            )
            return out

        return consume_special

    def contains_many(self, fps) -> np.ndarray:
        """Side-effect-free batched membership probe."""
        return self.contains_many_async(fps)()

    def probe_and_add_async(self, uniq: np.ndarray):
        """``probe_and_add`` split into launch and consume (see
        ``contains_many_async``); insertion happens at consume time."""
        uniq = np.ascontiguousarray(uniq, dtype=np.uint64)
        pending = self.contains_many_async(uniq)

        def consume():
            known = pending()
            fresh = uniq[~known]
            if fresh.size == 0:
                return known
            super(FingerprintIndex, self).update(fresh.tolist())
            if fresh.size <= self.small_batch:
                # stage through the pending buffer like scalar adds (the keys
                # are not in the set yet per `known`, so the invariant holds)
                for k in fresh.tolist():
                    if k == EMPTY_KEY or k == TOMB_KEY:
                        self._spill.add(k)
                    elif k in self._pending_removes:
                        del self._pending_removes[k]
                    else:
                        self._pending_adds[k] = None
                return known
            special = (fresh == np.uint64(EMPTY_KEY)) | (fresh == np.uint64(TOMB_KEY))
            if special.any():
                self._spill.update(fresh[special].tolist())
                fresh = fresh[~special]
            if not self._grow_if_needed(fresh.size):
                self._table_insert(fresh)
            return known

        return consume

    def probe_and_add(self, uniq: np.ndarray) -> np.ndarray:
        """One batched membership query + insertion of the missing keys.

        ``uniq`` must be unique (``np.unique`` output).  Returns the
        *pre-insert* membership flags — the inline pre-pass's ground-truth
        duplicate accounting in a single launch.
        """
        return self.probe_and_add_async(uniq)()

    def add_many(self, fps) -> None:
        """Batched insert (duplicates in the batch are fine).

        Costs one host-set update; the table build is journaled and folded
        lazily at the next batched probe (unique + probe-filter + one
        vectorized insert), so bulk insertion runs at native set speed.

        A staged removal of a batch key is cancelled, as ``add`` does: the
        key is still physically in the table (or in an unfolded journal),
        and ``_flush`` folds removals after the journal, so a surviving
        staged removal would tombstone the key just re-added.
        """
        keys = np.ascontiguousarray(fps, dtype=np.uint64)
        if keys.size == 0:
            return
        listed = keys.tolist()
        super().update(listed)
        if self._pending_removes:
            for fp in listed:
                self._pending_removes.pop(fp, None)
        self._journal.append(keys.copy())
        self._journal_n += keys.size

    def remove_many(self, fps) -> None:
        """Batched removal; keys not present are ignored."""
        keys = np.unique(np.ascontiguousarray(fps, dtype=np.uint64))
        if keys.size == 0:
            return
        self._flush()
        present = np.fromiter(map(self.__contains__, keys.tolist()), dtype=bool, count=keys.size)
        keys = keys[present]
        if keys.size == 0:
            return
        super().difference_update(keys.tolist())
        in_spill = np.fromiter(
            map(self._spill.__contains__, keys.tolist()), dtype=bool, count=keys.size
        )
        if in_spill.any():
            self._spill.difference_update(keys[in_spill].tolist())
            keys = keys[~in_spill]
        self._table_remove(keys)

    # -- scalar mutators (pending-buffer staged) -------------------------------
    def add(self, fp: int) -> None:
        if fp in self:
            return
        super().add(fp)
        if fp == EMPTY_KEY or fp == TOMB_KEY:
            self._spill.add(fp)
        elif fp in self._pending_removes:
            del self._pending_removes[fp]  # still physically in the table
        else:
            self._pending_adds[fp] = None

    def discard(self, fp: int) -> None:
        if fp not in self:
            return
        super().discard(fp)
        if fp == EMPTY_KEY or fp == TOMB_KEY:
            # sentinels only ever live in spill (or an unfolded journal —
            # the fold re-checks set membership, so dropping it here is
            # enough either way)
            self._spill.discard(fp)
        elif fp in self._spill:
            self._spill.discard(fp)
        elif fp in self._pending_adds:
            del self._pending_adds[fp]  # never reached the table
            if self._journal:
                # but an unfolded journal may hold it too (``add`` then
                # ``add_many``): drop it there, so no flush inserts it
                key = np.uint64(fp)
                self._journal = [a for a in (a[a != key] for a in self._journal) if a.size]
                self._journal_n = sum(a.size for a in self._journal)
        else:
            # either physically in the table, or sitting in an unfolded
            # journal; the flush folds journals before removals, so this
            # stays correct in both cases
            self._pending_removes[fp] = None

    def remove(self, fp: int) -> None:
        if fp not in self:
            raise KeyError(fp)
        self.discard(fp)

    def pop(self) -> int:
        for fp in self:
            self.discard(fp)
            return fp
        raise KeyError("pop from an empty FingerprintIndex")

    def update(self, *others) -> None:
        for other in others:
            if isinstance(other, np.ndarray):
                self.add_many(other)
            else:
                for fp in other:
                    self.add(fp)

    def difference_update(self, *others) -> None:
        for other in others:
            for fp in list(other) if other is self else other:
                self.discard(fp)

    def intersection_update(self, *others) -> None:
        keep = set(self)
        for other in others:
            keep &= set(other)
        for fp in [k for k in self if k not in keep]:
            self.discard(fp)

    def symmetric_difference_update(self, other) -> None:
        for fp in set(other):
            if fp in self:
                self.discard(fp)
            else:
                self.add(fp)

    def __ior__(self, other):
        self.update(other)
        return self

    def __isub__(self, other):
        self.difference_update(other)
        return self

    def __iand__(self, other):
        self.intersection_update(other)
        return self

    def __ixor__(self, other):
        self.symmetric_difference_update(other)
        return self

    def clear(self) -> None:
        super().clear()
        self._rebuild(self._cap)

    # -- diagnostics / tests ---------------------------------------------------
    def spilled(self) -> int:
        """Host-spilled keys (window overflow + sentinel-colliding)."""
        return len(self._spill)

    def table_stats(self) -> dict:
        return {
            "capacity": self._cap,
            "live": self._table_live,
            "tombstones": self._tombstones,
            "spilled": len(self._spill),
            "pending": len(self._pending_adds) + len(self._pending_removes) + self._journal_n,
            "backend": self._backend,
            "device_resident": self._dev is not None,
        }

    def check_consistency(self) -> None:
        """Assert the derived structures exactly re-derive the set."""
        self._flush()
        self._sync_host()
        decoded = self._t64
        occupied = decoded[(decoded != EMPTY_KEY) & (decoded != TOMB_KEY)]
        table_keys = set(occupied.tolist())
        assert len(occupied) == len(table_keys), "duplicate table entries"
        assert len(occupied) == self._table_live, (len(occupied), self._table_live)
        assert table_keys.isdisjoint(self._spill)
        assert table_keys | self._spill == set(self), "table+spill != authoritative set"
