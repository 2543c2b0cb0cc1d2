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
is relocated.  With ``num_shards > 1`` a ``ShardedCluster`` serves the
pages: fingerprints partition across shards, whose disjoint PBA namespaces
keep page ids unique, and the hooks sit on every shard's store.
``snapshot``/``load_state`` carry the engine's state tree (the reference's)
and ``run_gc`` compacts the PBAs, with pages following their blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import HPDedup, ShardedCluster, load_engine_state, snapshot_engine
from ..kernels.ops import fingerprint_ints
from ..models.attention import KVCache
from ..models.transformer import ATTENTION, window_of


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


def check_servable(cfg, max_slots: int) -> None:
    """The server pages one KV cache per layer, (layers, page, KVH, hd) a
    page, and copies pages between requests by position.  So it serves a
    decoder-only model whose every layer attends (full or windowed) and
    whose window, if any, holds all ``max_slots`` positions; anything else
    raises ``ValueError`` with the reason.  The reference fails or is wrong
    there: a recurrent layer's state has no slot axis (its ``_slot_slice``
    raises ``TypeError``), a window under ``max_slots`` makes a ring whose
    slots are not positions (its ``dynamic_slice_in_dim`` clamps the start
    and returns other positions' pages), and its launcher refuses an
    encoder-decoder model."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: an encoder-decoder model has no prefix KV pages to "
                         f"serve (its decoder attends a per-request encoder memory)")
    recurrent = sorted({m for m, _ in cfg.layer_kinds if m not in ATTENTION})
    if recurrent:
        raise ValueError(f"{cfg.name}: its decode cache holds recurrent state "
                         f"({', '.join(recurrent)} layers), which has no per-position pages "
                         f"to share")
    windows = {window_of(cfg, m) for m, _ in cfg.layer_kinds} - {0}
    if windows and min(windows) < max_slots:
        raise ValueError(f"{cfg.name}: an attention window of {min(windows)} under max_slots "
                         f"{max_slots} keeps its cache as a ring, whose slots are not positions")


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

    ``model`` is a ``models.Model`` that ``check_servable`` accepts;
    ``params`` (the reference's argument), when given, are loaded into it
    once, cast to the compute dtype.  The
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
        check_servable(model.cfg, max_slots)
        self.device = torch.device(device)
        if params is not None:
            model.load(params)
        self.model = model.to(self.device)
        self.page_tokens = page_tokens
        self.max_slots = max_slots
        engine_kwargs = dict(
            cache_entries=cache_entries,
            policy="lru",
            adaptive_threshold=False,
            fixed_threshold=1,  # every identical prefix block is reusable
            postprocess_period=postprocess_period,
            use_jax_estimator=True,
            seed=seed,
        )
        self.dedup: Union[HPDedup, ShardedCluster]
        if num_shards > 1:
            # the device stays out of engine_kwargs: those go into the
            # cluster's snapshot tree, which must stay the reference's
            self.dedup = ShardedCluster(num_shards=num_shards, device=self.device,
                                        **engine_kwargs)
        else:
            self.dedup = HPDedup(device=self.device, **engine_kwargs)
        self.pages: Dict[int, KVCache] = {}  # pba -> page
        self.metrics = ServeMetrics()
        self._request_counter = 0
        self._attach_reclaim_hooks()

    def _attach_reclaim_hooks(self) -> None:
        """A freed PBA drops its page the moment the store reclaims it, and
        a block that compaction moves carries its page to the new PBA, on
        every shard's store."""
        for engine in self._engines():
            engine.store.on_free = self._on_page_free
            engine.store.on_relocate = self._on_page_relocate

    def _on_page_free(self, pba: int) -> None:
        if self.pages.pop(pba, None) is not None:
            self.metrics.post_pages_merged += 1

    def _on_page_relocate(self, old: int, new: int) -> None:
        page = self.pages.pop(old, None)
        if page is not None:
            self.pages[new] = page

    def _engines(self) -> List[HPDedup]:
        return self.dedup.shards if isinstance(self.dedup, ShardedCluster) else [self.dedup]

    def _engine_of(self, fp: int) -> HPDedup:
        """The shard engine owning ``fp`` (the engine itself when unsharded)."""
        if isinstance(self.dedup, ShardedCluster):
            return self.dedup.engine_for(fp)
        return self.dedup

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
        # probes are independent of this request's own writes); each probe
        # goes to the shard owning that fingerprint's partition...
        pbas = [self._engine_of(fp).inline.cache.lookup(tenant, fp) for fp in fps]
        # ...then push the whole request through the batched write path
        if nblocks:
            self.dedup.write_batch(np.full(nblocks, tenant, dtype=np.int64), lbas, fps)
            for engine in self._engines():
                engine.inline.flush_stream(tenant)
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
                new_pba = self._engine_of(fps[i]).store.lba_map.get((tenant, lbas[i]))
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

    # -- snapshot/restore --------------------------------------------------------
    def snapshot(self, include_pages: bool = True) -> dict:
        """Crash-recovery state for the serving layer.

        The dedup engine state is the JSON-safe versioned tree of
        ``core.snapshot`` (the reference's tree for the same state); the
        pages are copied to host tensors, so the full snapshot is picklable
        but not JSON (``include_pages=False`` gives a JSON-only tree: a
        restored server then prefills pages again on first miss, losing
        only prefill skips, never correctness).
        """
        return {
            "engine": snapshot_engine(self.dedup),
            "request_counter": self._request_counter,
            "metrics": dataclasses.asdict(self.metrics),
            "pages": (
                [[pba, KVCache(page.k.cpu(), page.v.cpu())] for pba, page in self.pages.items()]
                if include_pages
                else None
            ),
        }

    def load_state(self, tree: dict) -> None:
        """Restore into this server in place (model and config unchanged).

        The stores' reclaim hooks are process-local, so they are attached
        again here rather than serialized.
        """
        load_engine_state(self.dedup, tree["engine"])
        self._request_counter = int(tree["request_counter"])
        self.metrics = ServeMetrics(**tree["metrics"])
        self._attach_reclaim_hooks()
        if tree["pages"] is None:
            self.pages = {}
        else:
            self.pages = {
                int(pba): KVCache(page.k.to(self.device), page.v.to(self.device))
                for pba, page in tree["pages"]
            }

    def run_postprocess(self) -> int:
        """Background exact pass: merge duplicate pages the cache missed.

        Runs shard-locally on a cluster; the stores' ``on_free`` hook drops
        each merged-away page the moment its PBA is released.  Returns the
        duplicate fingerprints found."""
        before = sum(len(e.store.duplicate_fingerprints()) for e in self._engines())
        for engine in self._engines():
            engine.post.run()  # LBA tables are remapped by the store
        return before

    def run_gc(self, max_moves: Optional[int] = None) -> Dict[str, int]:
        """One online-GC step (epoch drain + PBA compaction) on the backing
        engine or cluster; freed pages drop and relocated pages follow their
        blocks through the reclaim hooks."""
        if isinstance(self.dedup, ShardedCluster):
            return self.dedup.run_gc(max_moves_per_shard=max_moves)
        return self.dedup.run_gc(max_moves=max_moves)
