"""KV-block deduplication for serving: HPDedup applied to prefix pages.

The port's counterpart of the reference's ``serving/dedup_kv.py``.  The
"blocks" are prefix-chained token blocks, ``fp_i = H(fp_{i-1} || tokens_i)``,
so equal fingerprints imply equal prefixes, hence bit-identical KV pages
(positions and content both match), which maps onto the paper's LBA->PBA
machinery: LBA = (request, block index), PBA = physical page id, refcounts
and post-processing merges included.

Per-tenant LDSS estimation decides which tenants' fingerprints hold the
scarce fingerprint-cache entries.  An inline hit skips the block's prefill
compute and its device page; the post-processing pass merges duplicate pages
the cache missed.  The server drives a real model (``models.Model``, prefill
as one decode step per token, dense attention, as the reference does).

A page is the (layers, page_tokens, KVH, hd) K/V slice of every layer of a
request's cache; pages live in ``DedupKVServer.pages`` keyed by PBA, the
store's reclaim hooks drop a page whose PBA is freed and move one whose PBA
is relocated.  One engine serves the pages: the cluster-backed server
(``num_shards > 1``), snapshots and online GC wait for the ports of
``core.snapshot``, ``core.gc`` and ``core.cluster`` (ROADMAP.md, modules to
port, "Snapshots and GC" and "Cluster").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import HPDedup
from ..kernels.ops import fingerprint_ints
from ..models.attention import KVCache

_PENDING = "(ROADMAP.md, modules to port, 'Snapshots and GC' and 'Cluster')"


def chain_fingerprint(prev_fp: int, tokens: np.ndarray, device=None) -> int:
    """Prefix-chained block fingerprint: H(prev_fp || tokens), hashed on
    ``device`` (the card by default)."""
    prev = np.array([prev_fp & 0xFFFFFFFF, prev_fp >> 32], dtype=np.uint32)
    words = np.concatenate([prev, tokens.astype(np.uint32)])
    return int(fingerprint_ints(words[None, :], device=device)[0])


_M64 = 0xFFFFFFFFFFFFFFFF


def _mix64(a: int, b: int) -> int:
    """SplitMix64-style combiner for host-side fingerprint chaining."""
    x = (a * 0x9E3779B97F4A7C15 + b) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return x or 1  # 0 is reserved


def chain_fingerprints_batched(prev_fp: int, blocks: np.ndarray, device=None) -> List[int]:
    """Prefix-chained fingerprints for a whole request in one kernel launch.

    The content hashes of all blocks come from one batched
    ``fingerprint_ints`` call on ``device`` (the card by default); the
    sequential chaining folds them on the host with a 64-bit mixer.  Equal
    prefixes still imply equal fingerprints.
    """
    if len(blocks) == 0:
        return []
    content = fingerprint_ints(np.asarray(blocks, dtype=np.int32), device=device)
    fps = []
    fp = prev_fp
    for h in content.tolist():
        fp = _mix64(fp, h)
        fps.append(fp)
    return fps


def _slot_slice(cache: KVCache, start: int, length: int) -> KVCache:
    """A page: slots ``start .. start + length`` of batch row 0 of every
    layer, (layers, length, KVH, hd) each, copied out of the cache."""
    return KVCache(cache.k[:, 0, start:start + length].clone(),
                   cache.v[:, 0, start:start + length].clone())


def _slot_assign(cache: KVCache, page: KVCache, start: int) -> KVCache:
    """Copy a page into batch row 0 of the cache at slot ``start``, in place."""
    length = page.k.shape[1]
    cache.k[:, 0, start:start + length].copy_(page.k)
    cache.v[:, 0, start:start + length].copy_(page.v)
    return cache


@dataclasses.dataclass
class ServeMetrics:
    blocks_total: int = 0
    blocks_prefill_skipped: int = 0
    tokens_prefilled: int = 0
    tokens_skipped: int = 0
    pages_allocated: int = 0
    pages_logical: int = 0
    post_pages_merged: int = 0

    @property
    def prefill_saving(self) -> float:
        t = self.tokens_prefilled + self.tokens_skipped
        return self.tokens_skipped / t if t else 0.0

    @property
    def hbm_saving(self) -> float:
        return 1.0 - self.pages_allocated / self.pages_logical if self.pages_logical else 0.0


class DedupKVServer:
    """Single-card serving engine with HPDedup'd paged prefix KV.

    ``model`` is a ``models.Model``; ``params`` (the reference's argument),
    when given, are loaded into it once, cast to the compute dtype.  The
    model moves to ``device`` (default ``"cuda"``, which raises without a
    card), where the engine's fingerprint indexes, the fingerprint kernel,
    the LDSS solver (``use_jax_estimator=True`` selects the port's torch
    solver) and every cache and page live too.
    """

    def __init__(
        self,
        model,
        params=None,
        page_tokens: int = 32,
        max_slots: int = 1024,
        cache_entries: int = 512,
        postprocess_period: int = 256,
        num_shards: int = 1,
        seed: int = 0,
        *,
        device="cuda",
    ):
        if num_shards != 1:
            raise ValueError(f"num_shards={num_shards}: the cluster-backed server is not "
                             f"ported yet {_PENDING}")
        self.device = torch.device(device)
        if params is not None:
            model.load(params)
        self.model = model.to(self.device)
        self.page_tokens = page_tokens
        self.max_slots = max_slots
        self.dedup = HPDedup(
            cache_entries=cache_entries,
            policy="lru",
            adaptive_threshold=False,
            fixed_threshold=1,  # every identical prefix block is reusable
            postprocess_period=postprocess_period,
            use_jax_estimator=True,
            seed=seed,
            device=self.device,
        )
        self.pages: Dict[int, KVCache] = {}  # pba -> page
        self.metrics = ServeMetrics()
        self._request_counter = 0
        self._attach_reclaim_hooks()

    def _attach_reclaim_hooks(self) -> None:
        """A freed PBA drops its page the moment the store reclaims it, and
        a block that compaction moves carries its page to the new PBA."""
        self.dedup.store.on_free = self._on_page_free
        self.dedup.store.on_relocate = self._on_page_relocate

    def _on_page_free(self, pba: int) -> None:
        if self.pages.pop(pba, None) is not None:
            self.metrics.post_pages_merged += 1

    def _on_page_relocate(self, old: int, new: int) -> None:
        page = self.pages.pop(old, None)
        if page is not None:
            self.pages[new] = page

    # -- internals -------------------------------------------------------------
    def _token(self, t: int) -> torch.Tensor:
        return torch.full((1, 1), int(t), dtype=torch.int64, device=self.device)

    def _compute_page(self, cache: KVCache, tokens: np.ndarray, pos0: int) -> KVCache:
        """Chunked prefill of one block via decode steps."""
        for j, t in enumerate(tokens):
            _, cache = self.model.decode_step(cache, self._token(t), pos0 + j)
        return cache

    def prefill_request(self, tenant: int, tokens: np.ndarray) -> Tuple[KVCache, int, Dict]:
        """Prefill with block-level dedup; returns (cache, position, info).

        The whole request's block fingerprints come from one batched kernel
        launch, and the dedup bookkeeping flows through the engine's
        columnar ``write_batch``.
        """
        req = self._request_counter
        self._request_counter += 1
        pt = self.page_tokens
        nblocks = len(tokens) // pt
        cache = self.model.init_cache(1, self.max_slots)
        pos = 0
        info = {"hit_blocks": 0, "blocks": nblocks}
        blocks = [np.asarray(tokens[i * pt:(i + 1) * pt]) for i in range(nblocks)]
        fps = chain_fingerprints_batched(0, np.stack(blocks), device=self.device) if blocks else []
        lbas = [(req << 24) | i for i in range(nblocks)]
        # probe cached PBAs first (prefix fps are unique within a request, so
        # probes are independent of this request's own writes)...
        pbas = [self.dedup.inline.cache.lookup(tenant, fp) for fp in fps]
        # ...then push the whole request through the batched write path
        if nblocks:
            self.dedup.write_batch(np.full(nblocks, tenant, dtype=np.int64), lbas, fps)
            self.dedup.inline.flush_stream(tenant)
        self.metrics.blocks_total += nblocks
        self.metrics.pages_logical += nblocks
        for i, blk in enumerate(blocks):
            pba = pbas[i]
            if pba is not None and pba in self.pages:
                cache = _slot_assign(cache, self.pages[pba], pos)
                self.metrics.blocks_prefill_skipped += 1
                self.metrics.tokens_skipped += pt
                info["hit_blocks"] += 1
            else:
                cache = self._compute_page(cache, blk, pos)
                new_pba = self.dedup.store.lba_map.get((tenant, lbas[i]))
                if new_pba is not None and new_pba not in self.pages:
                    self.pages[new_pba] = _slot_slice(cache, pos, pt)
                    self.metrics.pages_allocated += 1
                self.metrics.tokens_prefilled += pt
            pos += pt
        # leftover tokens (< one page) always prefill
        for t in tokens[nblocks * pt:]:
            _, cache = self.model.decode_step(cache, self._token(t), pos)
            pos += 1
            self.metrics.tokens_prefilled += 1
        return cache, pos, info

    def decode(self, cache: KVCache, pos: int, steps: int,
               first_token: int = 0) -> Tuple[List[int], KVCache]:
        out = []
        tok = self._token(first_token)
        for _ in range(steps):
            logits, cache = self.model.decode_step(cache, tok, pos)
            nxt = int(torch.argmax(logits[0]))
            out.append(nxt)
            tok = self._token(nxt)
            pos += 1
        return out, cache

    def run_postprocess(self) -> int:
        """Background exact pass: merge duplicate pages the cache missed.

        The store's ``on_free`` hook drops each merged-away page the moment
        its PBA is released.  Returns the duplicate fingerprints found."""
        before = len(self.dedup.store.duplicate_fingerprints())
        self.dedup.post.run()  # LBA tables are remapped by the store
        return before

    # -- waiting for their modules -----------------------------------------------
    def snapshot(self, include_pages: bool = True) -> dict:
        raise NotImplementedError(f"server snapshots wait for core.snapshot {_PENDING}")

    def load_state(self, tree: dict) -> None:
        raise NotImplementedError(f"server restores wait for core.snapshot {_PENDING}")

    def run_gc(self, max_moves: Optional[int] = None) -> Dict[str, int]:
        raise NotImplementedError(f"online GC waits for core.gc {_PENDING}")
