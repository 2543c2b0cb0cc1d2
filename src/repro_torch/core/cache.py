"""Fingerprint cache for inline deduplication (paper §III-B, §IV-B).

The cache maps ``fingerprint -> PBA`` and is the scarce resource the paper's
mechanism manages.  Composition:

* Per-stream sub-caches, each run by a pluggable replacement policy
  (LRU / LFU / ARC — the three the paper evaluates).
* A global capacity (total entries across streams).
* An LDSS-driven **admission policy**: fingerprints from streams whose
  predicted LDSS is very low relative to the best stream are not admitted.
* An LDSS-driven **eviction policy**: when full, the victim *stream* is drawn
  with probability proportional to ``p_i = 1/LDSS_i`` via the segment tree,
  then that stream's policy evicts one entry.

``GlobalCache`` (single policy over all streams, no prioritization) is the
iDedup-style baseline.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, Optional, Tuple

import numpy as np

from .fp_index import FingerprintIndex
from .segment_tree import FenwickSegments
from .statetree import from_pairs, pairs

# ---------------------------------------------------------------------------
# Replacement policies (per-stream building blocks).
# ---------------------------------------------------------------------------


class LRUCache:
    """Classic least-recently-used map."""

    def __init__(self):
        self._d: "OrderedDict[int, int]" = OrderedDict()

    def lookup(self, fp: int) -> Optional[int]:
        v = self._d.get(fp)
        if v is not None:
            self._d.move_to_end(fp)
        return v

    def insert(self, fp: int, pba: int) -> None:
        d = self._d
        if fp in d:
            d[fp] = pba
            d.move_to_end(fp)
        else:
            d[fp] = pba  # a fresh key lands at the MRU end already

    def evict_one(self) -> Optional[Tuple[int, int]]:
        if not self._d:
            return None
        return self._d.popitem(last=False)

    def remove(self, fp: int) -> None:
        self._d.pop(fp, None)

    def peek(self, fp: int) -> Optional[int]:
        """Value without touching recency (shard-migration / snapshot probe)."""
        return self._d.get(fp)

    def replace(self, fp: int, pba: int) -> None:
        """Update a resident entry's value without touching recency."""
        if fp in self._d:
            self._d[fp] = pba

    def keys(self):
        """Resident fingerprints (index rebuild after snapshot load)."""
        return list(self._d)

    def __contains__(self, fp: int) -> bool:
        return fp in self._d

    def __len__(self) -> int:
        return len(self._d)

    def snapshot(self) -> dict:
        return {"kind": "lru", "items": pairs(self._d)}

    def load_snapshot(self, tree: dict) -> None:
        self._d = OrderedDict((int(fp), int(pba)) for fp, pba in tree["items"])


class LFUCache:
    """Least-frequently-used with O(1) frequency buckets (LRU tie-break)."""

    def __init__(self):
        self._val: Dict[int, int] = {}
        self._freq: Dict[int, int] = {}
        self._buckets: Dict[int, "OrderedDict[int, None]"] = defaultdict(OrderedDict)
        self._minfreq = 0

    def _touch(self, fp: int) -> None:
        f = self._freq[fp]
        del self._buckets[f][fp]
        if not self._buckets[f]:
            del self._buckets[f]
            if self._minfreq == f:
                self._minfreq = f + 1
        self._freq[fp] = f + 1
        self._buckets[f + 1][fp] = None

    def lookup(self, fp: int) -> Optional[int]:
        v = self._val.get(fp)
        if v is not None:
            self._touch(fp)
        return v

    def insert(self, fp: int, pba: int) -> None:
        if fp in self._val:
            self._val[fp] = pba
            self._touch(fp)
            return
        self._val[fp] = pba
        self._freq[fp] = 1
        self._buckets[1][fp] = None
        self._minfreq = 1

    def evict_one(self) -> Optional[Tuple[int, int]]:
        if not self._val:
            return None
        while self._minfreq not in self._buckets or not self._buckets[self._minfreq]:
            self._minfreq += 1
        fp, _ = self._buckets[self._minfreq].popitem(last=False)
        if not self._buckets[self._minfreq]:
            del self._buckets[self._minfreq]
        v = self._val.pop(fp)
        del self._freq[fp]
        return fp, v

    def remove(self, fp: int) -> None:
        if fp not in self._val:
            return
        f = self._freq.pop(fp)
        del self._val[fp]
        del self._buckets[f][fp]
        if not self._buckets[f]:
            del self._buckets[f]

    def peek(self, fp: int) -> Optional[int]:
        """Value without touching frequency (shard-migration / snapshot probe)."""
        return self._val.get(fp)

    def replace(self, fp: int, pba: int) -> None:
        """Update a resident entry's value without touching frequency."""
        if fp in self._val:
            self._val[fp] = pba

    def keys(self):
        """Resident fingerprints (index rebuild after snapshot load)."""
        return list(self._val)

    def __contains__(self, fp: int) -> bool:
        return fp in self._val

    def __len__(self) -> int:
        return len(self._val)

    def snapshot(self) -> dict:
        # buckets carry the LRU tie-break order; _freq is derivable from them
        return {
            "kind": "lfu",
            "val": pairs(self._val),
            "buckets": [[f, list(b)] for f, b in self._buckets.items()],
            "minfreq": self._minfreq,
        }

    def load_snapshot(self, tree: dict) -> None:
        self._val = from_pairs(tree["val"], value=int)
        self._buckets = defaultdict(OrderedDict)
        self._freq = {}
        for f, fps in tree["buckets"]:
            f = int(f)
            for fp in fps:
                self._buckets[f][int(fp)] = None
                self._freq[int(fp)] = f
        self._minfreq = int(tree["minfreq"])


class ARCCache:
    """Adaptive Replacement Cache (Megiddo & Modha) scoped to one stream.

    Capacity adapts: this implementation takes a *soft* capacity c used for
    the adaptation target but actual occupancy is bounded by the global
    prioritized cache, which calls ``evict_one`` explicitly.  Ghost lists B1
    and B2 are bounded by c (the paper notes — and we record in EXPERIMENTS —
    that the ghosts are extra metadata overhead).
    """

    def __init__(self, c: int = 1024):
        self.c = max(c, 16)
        self.p = 0.0
        self.t1: "OrderedDict[int, int]" = OrderedDict()
        self.t2: "OrderedDict[int, int]" = OrderedDict()
        self.b1: "OrderedDict[int, None]" = OrderedDict()
        self.b2: "OrderedDict[int, None]" = OrderedDict()

    def lookup(self, fp: int) -> Optional[int]:
        if fp in self.t1:
            v = self.t1.pop(fp)
            self.t2[fp] = v
            return v
        if fp in self.t2:
            self.t2.move_to_end(fp)
            return self.t2[fp]
        return None

    def insert(self, fp: int, pba: int) -> None:
        if fp in self.t1:
            self.t1[fp] = pba  # re-insert updates the value, like LRU/LFU
            self.lookup(fp)
            return
        if fp in self.t2:
            self.t2[fp] = pba
            self.lookup(fp)
            return
        if fp in self.b1:
            self.p = min(self.p + max(1.0, len(self.b2) / max(1, len(self.b1))), self.c)
            del self.b1[fp]
            self.t2[fp] = pba
            return
        if fp in self.b2:
            self.p = max(self.p - max(1.0, len(self.b1) / max(1, len(self.b2))), 0.0)
            del self.b2[fp]
            self.t2[fp] = pba
            return
        self.t1[fp] = pba
        self._trim_ghosts()

    def _trim_ghosts(self) -> None:
        while len(self.b1) > self.c:
            self.b1.popitem(last=False)
        while len(self.b2) > self.c:
            self.b2.popitem(last=False)

    def evict_one(self) -> Optional[Tuple[int, int]]:
        out = None
        if self.t1 and (len(self.t1) > self.p or not self.t2):
            fp, v = self.t1.popitem(last=False)
            self.b1[fp] = None
            out = (fp, v)
        elif self.t2:
            fp, v = self.t2.popitem(last=False)
            self.b2[fp] = None
            out = (fp, v)
        elif self.t1:
            fp, v = self.t1.popitem(last=False)
            self.b1[fp] = None
            out = (fp, v)
        self._trim_ghosts()
        return out

    def remove(self, fp: int) -> None:
        self.t1.pop(fp, None)
        self.t2.pop(fp, None)

    def peek(self, fp: int) -> Optional[int]:
        """Value without T1->T2 promotion (shard-migration / snapshot probe)."""
        v = self.t1.get(fp)
        return v if v is not None else self.t2.get(fp)

    def replace(self, fp: int, pba: int) -> None:
        """Update a resident entry's value without promotion or recency."""
        if fp in self.t1:
            self.t1[fp] = pba
        elif fp in self.t2:
            self.t2[fp] = pba

    def keys(self):
        """Resident fingerprints — T1+T2 only, ghosts are not members
        (index rebuild after snapshot load)."""
        return list(self.t1) + list(self.t2)

    def __contains__(self, fp: int) -> bool:
        return fp in self.t1 or fp in self.t2

    def __len__(self) -> int:
        return len(self.t1) + len(self.t2)

    def snapshot(self) -> dict:
        return {
            "kind": "arc",
            "c": self.c,
            "p": self.p,
            "t1": pairs(self.t1),
            "t2": pairs(self.t2),
            "b1": list(self.b1),
            "b2": list(self.b2),
        }

    def load_snapshot(self, tree: dict) -> None:
        self.c = int(tree["c"])
        self.p = float(tree["p"])
        self.t1 = OrderedDict((int(k), int(v)) for k, v in tree["t1"])
        self.t2 = OrderedDict((int(k), int(v)) for k, v in tree["t2"])
        self.b1 = OrderedDict((int(k), None) for k in tree["b1"])
        self.b2 = OrderedDict((int(k), None) for k in tree["b2"])


POLICIES = {"lru": LRUCache, "lfu": LFUCache, "arc": ARCCache}


def make_policy(name: str, capacity_hint: int = 1024):
    name = name.lower()
    if name == "arc":
        return ARCCache(capacity_hint)
    return POLICIES[name]()


def policy_from_snapshot(tree: dict):
    """Rebuild a replacement-policy instance from its ``snapshot()`` tree."""
    p = POLICIES[tree["kind"]]()
    p.load_snapshot(tree)
    return p


# ---------------------------------------------------------------------------
# Caches over streams.
# ---------------------------------------------------------------------------


class GlobalCache:
    """Single shared policy over the mixed stream — the iDedup-style baseline."""

    def __init__(self, capacity: int, policy: str = "lru", *, device="cuda"):
        self.capacity = capacity
        self.cache = make_policy(policy, capacity)
        self.inserted = 0
        self.device = device
        # resident-fingerprint index: membership mirror of the policy's
        # resident set, probed in one batched launch by the replay pre-pass.
        # LRU/LFU/ARC ordering state stays host-side in the policy objects.
        self.index = FingerprintIndex(device=device)

    def lookup(self, stream: int, fp: int) -> Optional[int]:
        return self.cache.lookup(fp)

    def contains_many(self, fps) -> np.ndarray:
        """Side-effect-free membership probe for a batch of fingerprints
        (the batched replay pre-pass; does not touch recency/frequency)."""
        return self.index.contains_many(fps)

    def contains_many_async(self, fps):
        """``contains_many`` split into launch and consume (see
        ``FingerprintIndex.contains_many_async``); the cache must not be
        mutated between the two."""
        return self.index.contains_many_async(fps)

    def admit(self, stream: int, fp: int, pba: int) -> None:
        if fp in self.cache:
            self.cache.insert(fp, pba)
            return
        while len(self.cache) >= self.capacity:
            out = self.cache.evict_one()
            if out is not None:
                self.index.discard(out[0])
        self.cache.insert(fp, pba)
        self.index.add(fp)
        self.inserted += 1

    def occupancy(self) -> Dict[int, int]:
        return {-1: len(self.cache)}

    def __len__(self) -> int:
        return len(self.cache)

    # -- snapshot/restore + shard migration ------------------------------------
    def snapshot(self) -> dict:
        return {"inserted": self.inserted, "policy": self.cache.snapshot()}

    def load_snapshot(self, tree: dict) -> None:
        self.inserted = int(tree["inserted"])
        self.cache = policy_from_snapshot(tree["policy"])
        # the index is derived, never serialized: rebuild from the policy
        self.index = FingerprintIndex(self.cache.keys(), device=self.device)

    def evict_fp(self, fp: int) -> Optional[int]:
        """Drop ``fp``; returns its PBA (resharding pulls moved entries out)."""
        pba = self.cache.peek(fp)
        if pba is not None:
            self.cache.remove(fp)
            self.index.discard(fp)
        return pba

    def migrate_in(self, stream: int, fp: int, pba: int) -> bool:
        """Install a migrated entry iff capacity allows — a *move*, not an
        admission: no eviction, no ``inserted`` bump, no RNG draw."""
        if fp in self.cache:
            # the migrated PBA was just validated against the source store,
            # so it supersedes whatever (possibly stale) value sits here —
            # value-only: a move must not perturb recency/frequency either
            self.cache.replace(fp, pba)
            return True
        if len(self.cache) >= self.capacity:
            return False
        self.cache.insert(fp, pba)
        self.index.add(fp)
        return True


class PrioritizedCache:
    """HPDedup's LDSS-prioritized fingerprint cache (paper §IV-B).

    ``set_ldss`` is called by the locality estimator at every estimation
    interval with the *predicted* LDSS per stream; admission and eviction
    immediately follow the new priorities.
    """

    def __init__(
        self,
        capacity: int,
        policy: str = "lru",
        admission_ratio: float = 0.01,
        min_ldss: float = 1.0,
        seed: int = 0,
        *,
        device="cuda",
    ):
        self.capacity = capacity
        self.device = device
        self.policy = policy
        self.admission_ratio = admission_ratio
        self.min_ldss = min_ldss
        self.rng = np.random.default_rng(seed)
        self.streams: Dict[int, object] = {}
        self.owner: Dict[int, int] = {}  # fp -> stream whose sub-cache holds it
        # resident-fingerprint index: membership mirror of ``owner``'s key
        # set, probed in one batched launch by the replay pre-pass (the
        # owner dict stays authoritative for holder lookups)
        self.index = FingerprintIndex(device=device)
        self.ldss: Dict[int, float] = {}
        self._best_ldss = 0.0  # memoized max; recomputed on set_ldss only
        # per-stream admission verdicts; pure function of ``ldss``, so valid
        # until the next set_ldss (which clears it)
        self._adm_memo: Dict[int, bool] = {}
        self.segments = FenwickSegments()
        self.total = 0
        self.inserted = 0

    # -- LDSS plumbing -------------------------------------------------------
    def set_ldss(self, ldss: Dict[int, float]) -> None:
        self.ldss.update({s: max(float(v), 0.0) for s, v in ldss.items()})
        self._best_ldss = max(self.ldss.values(), default=0.0)
        self._adm_memo = {}
        self._refresh_weights()

    def _refresh_weights(self) -> None:
        for s in set(list(self.ldss.keys()) + list(self.streams.keys())):
            self.segments.set_weight(s, self._evict_priority(s))

    def _evict_priority(self, stream: int) -> float:
        """p_i = 1/LDSS_i, but only streams holding entries are evictable."""
        sub = self.streams.get(stream)
        if not sub or len(sub) == 0:
            return 0.0
        return 1.0 / max(self.ldss.get(stream, self.min_ldss), self.min_ldss)

    def _admitted(self, stream: int) -> bool:
        """Admission policy: reject streams with very low LDSS relative to the best."""
        if not self.ldss:
            return True  # no estimates yet: admit everything (cold start)
        best = self._best_ldss
        mine = self.ldss.get(stream)
        if mine is None:
            return True  # new stream: give it a chance until first estimate
        if best <= self.min_ldss:
            return True
        return mine >= self.admission_ratio * best

    # -- cache ops -----------------------------------------------------------
    def _sub(self, stream: int):
        sub = self.streams.get(stream)
        if sub is None:
            sub = make_policy(self.policy, max(64, self.capacity // 8))
            self.streams[stream] = sub
        return sub

    def lookup(self, stream: int, fp: int) -> Optional[int]:
        # fingerprints are global: a block written by one VM may duplicate
        # another VM's — the owner index finds the holding sub-cache in O(1).
        holder = self.owner.get(fp)
        if holder is None:
            return None
        return self.streams[holder].lookup(fp)

    def contains_many(self, fps) -> np.ndarray:
        """Side-effect-free membership probe for a batch of fingerprints
        (the batched replay pre-pass; does not touch recency/frequency)."""
        return self.index.contains_many(fps)

    def contains_many_async(self, fps):
        """``contains_many`` split into launch and consume (see
        ``FingerprintIndex.contains_many_async``); the cache must not be
        mutated between the two."""
        return self.index.contains_many_async(fps)

    def admit(self, stream: int, fp: int, pba: int) -> None:
        holder = self.owner.get(fp)
        if holder is not None:  # already cached (possibly by another stream)
            self.streams[holder].insert(fp, pba)
            return
        adm = self._adm_memo.get(stream)
        if adm is None:
            adm = self._adm_memo[stream] = self._admitted(stream)
        if not adm:
            return
        sub = self._sub(stream)
        while self.total >= self.capacity:
            if not self._evict():
                break
        sub.insert(fp, pba)
        self.owner[fp] = stream
        self.index.add(fp)
        self.total += 1
        self.inserted += 1
        if len(sub) == 1:
            # 0 -> 1: the stream just became evictable.  Otherwise its weight
            # (1/LDSS, length-independent) is unchanged — skip the Fenwick walk.
            self.segments.set_weight(stream, self._evict_priority(stream))

    def _evict(self) -> bool:
        victim_stream = self.segments.draw(self.rng)
        if victim_stream is None:
            # no weights (e.g. all LDSS unset): evict from the largest stream
            candidates = [(len(c), s) for s, c in self.streams.items() if len(c)]
            if not candidates:
                return False
            victim_stream = max(candidates)[1]
        sub = self.streams[victim_stream]
        out = sub.evict_one()
        if out is None:
            self.segments.set_weight(victim_stream, 0.0)
            return self._evict_fallback()
        self.owner.pop(out[0], None)
        self.index.discard(out[0])
        self.total -= 1
        if len(sub) == 0:
            self.segments.set_weight(victim_stream, 0.0)
        return True

    def _evict_fallback(self) -> bool:
        for s, sub in self.streams.items():
            out = sub.evict_one()
            if out is not None:
                self.owner.pop(out[0], None)
                self.index.discard(out[0])
                self.total -= 1
                if len(sub) == 0:
                    self.segments.set_weight(s, 0.0)
                return True
        return False

    def occupancy(self) -> Dict[int, int]:
        return {s: len(c) for s, c in self.streams.items()}

    def __len__(self) -> int:
        return self.total

    # -- snapshot/restore + shard migration ------------------------------------
    def snapshot(self) -> dict:
        """Everything a restored cache needs to make bit-identical decisions:
        per-stream policy state in order, the owner index, LDSS priorities,
        the eviction RNG state and the Fenwick slot layout (a draw resolves
        by slot order, so slots must survive, not just weights)."""
        return {
            "rng": self.rng.bit_generator.state,
            "streams": [[s, sub.snapshot()] for s, sub in self.streams.items()],
            "owner": pairs(self.owner),
            "ldss": pairs(self.ldss),
            "best_ldss": self._best_ldss,
            "total": self.total,
            "inserted": self.inserted,
            "segments": self.segments.snapshot(),
        }

    def load_snapshot(self, tree: dict) -> None:
        self.rng = np.random.default_rng(0)
        self.rng.bit_generator.state = tree["rng"]
        self.streams = {int(s): policy_from_snapshot(sub) for s, sub in tree["streams"]}
        self.owner = from_pairs(tree["owner"], value=int)
        # the index is derived, never serialized: rebuild from the owner map
        self.index = FingerprintIndex(self.owner, device=self.device)
        self.ldss = from_pairs(tree["ldss"], value=float)
        self._best_ldss = float(tree["best_ldss"])
        self._adm_memo = {}
        self.total = int(tree["total"])
        self.inserted = int(tree["inserted"])
        self.segments = FenwickSegments.from_snapshot(tree["segments"])

    def evict_fp(self, fp: int) -> Optional[int]:
        """Drop ``fp``; returns its PBA (resharding pulls moved entries out).
        Mirrors ``_evict``'s bookkeeping but targets one fingerprint and
        consumes no RNG."""
        holder = self.owner.get(fp)
        if holder is None:
            return None
        sub = self.streams[holder]
        pba = sub.peek(fp)
        sub.remove(fp)
        del self.owner[fp]
        self.index.discard(fp)
        self.total -= 1
        if len(sub) == 0:
            self.segments.set_weight(holder, 0.0)
        return pba

    def migrate_in(self, stream: int, fp: int, pba: int) -> bool:
        """Install a migrated entry iff capacity allows — a *move*, not an
        admission: no admission filter, no eviction, no ``inserted`` bump,
        no RNG draw.  Dropping under pressure is safe (the cache is advisory;
        post-processing reclaims any resulting inline miss)."""
        holder = self.owner.get(fp)
        if holder is not None:
            # already resident (possibly with a stale PBA): refresh with the
            # just-validated migrated value instead of discarding it —
            # value-only: a move must not perturb recency/frequency either
            self.streams[holder].replace(fp, pba)
            return True
        if self.total >= self.capacity:
            return False
        sub = self._sub(stream)
        sub.insert(fp, pba)
        self.owner[fp] = stream
        self.index.add(fp)
        self.total += 1
        if len(sub) == 1:
            self.segments.set_weight(stream, self._evict_priority(stream))
        return True
