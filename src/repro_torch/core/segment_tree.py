"""Weighted random victim-stream selection (paper §IV-B).

Evict priorities ``p_i = 1 / LDSS_i`` are mapped to adjacent non-overlapping
segments ``[sum_{k<i} p_k, sum_{k<=i} p_k)``; eviction draws ``r`` uniform in
``[0, sum p)`` and picks the stream whose segment contains ``r``.  A Fenwick
(binary indexed) tree gives O(log M) weight updates and prefix-search draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .statetree import pairs


class FenwickSegments:
    """Fenwick tree over per-stream weights with prefix-search sampling."""

    def __init__(self, capacity: int = 64):
        self._size = 1
        while self._size < capacity:
            self._size <<= 1
        # plain Python list: element reads/writes are ~3x cheaper than numpy
        # scalar indexing, and the draw path is one-element-at-a-time anyway
        self._tree = [0.0] * (self._size + 1)
        self._weights: Dict[int, float] = {}
        self._slot_of: Dict[int, int] = {}
        self._stream_of: Dict[int, int] = {}
        self._free = list(range(self._size - 1, -1, -1))

    # -- slot management ----------------------------------------------------
    def _grow(self) -> None:
        old_size = self._size
        self._size <<= 1
        self._tree = [0.0] * (self._size + 1)
        self._free.extend(range(self._size - 1, old_size - 1, -1))
        for stream, slot in self._slot_of.items():
            self._add(slot, self._weights[stream])

    def _add(self, slot: int, delta: float) -> None:
        tree = self._tree
        i = slot + 1
        size = self._size
        while i <= size:
            tree[i] += delta
            i += i & (-i)

    # -- public API ----------------------------------------------------------
    def set_weight(self, stream: int, weight: float) -> None:
        """Set stream's segment length (0 removes it from the draw)."""
        weight = max(float(weight), 0.0)
        if weight != 0.0 and self._weights.get(stream) == weight:
            return  # no-op update: skip the zero-delta Fenwick walk
        if stream not in self._slot_of:
            if weight == 0.0:
                return
            if not self._free:
                self._grow()
            slot = self._free.pop()
            self._slot_of[stream] = slot
            self._stream_of[slot] = stream
            self._weights[stream] = 0.0
        slot = self._slot_of[stream]
        self._add(slot, weight - self._weights[stream])
        self._weights[stream] = weight
        if weight == 0.0:
            del self._weights[stream]
            del self._stream_of[slot]
            del self._slot_of[stream]
            self._free.append(slot)

    def weight(self, stream: int) -> float:
        return self._weights.get(stream, 0.0)

    def draw(self, rng: np.random.Generator) -> Optional[int]:
        """Sample a stream with probability proportional to its weight."""
        tot = self._prefix(self._size)
        if tot <= 0.0:
            return None
        r = rng.uniform(0.0, tot)
        # Fenwick prefix search: find the smallest slot with prefix sum > r
        tree = self._tree
        size = self._size
        pos = 0
        mask = size
        while mask:
            nxt = pos + mask
            if nxt <= size and tree[nxt] <= r:
                r -= tree[nxt]
                pos = nxt
            mask >>= 1
        slot = pos  # pos is the count of slots fully below r
        stream = self._stream_of.get(slot)
        if stream is None:
            # numeric edge (r == tot): fall back to the max-weight stream
            stream = max(self._weights, key=self._weights.get)
        return stream

    def _prefix(self, count: int) -> float:
        tree = self._tree
        s = 0.0
        i = count
        while i > 0:
            s += tree[i]
            i -= i & (-i)
        return float(s)

    def total_weight(self) -> float:
        return self._prefix(self._size)

    def streams(self):
        return list(self._weights.keys())

    # -- snapshot/restore ----------------------------------------------------
    def snapshot(self) -> dict:
        """Weights alone are not enough: a draw walks the tree in *slot*
        order, so the stream->slot assignment and the free-slot stack must
        restore exactly for future draws to pick identical victims.  The raw
        Fenwick node array is serialized verbatim too: the live nodes are
        sums of incrementally accumulated float deltas, and float addition
        is non-associative, so re-deriving them from the final weights can
        differ by ULPs — enough to flip a ``draw`` near a segment boundary
        and break bit-exact resumption."""
        return {
            "size": self._size,
            "tree": list(self._tree),
            "weights": pairs(self._weights),
            "slot_of": pairs(self._slot_of),
            "free": list(self._free),
        }

    @classmethod
    def from_snapshot(cls, tree: dict) -> "FenwickSegments":
        seg = cls(int(tree["size"]))
        seg._tree = [float(x) for x in tree["tree"]]
        seg._free = [int(x) for x in tree["free"]]
        weights = {int(s): float(w) for s, w in tree["weights"]}
        for s, slot in tree["slot_of"]:
            s, slot = int(s), int(slot)
            seg._slot_of[s] = slot
            seg._stream_of[slot] = s
            seg._weights[s] = weights[s]
        return seg
