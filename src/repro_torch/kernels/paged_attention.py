"""Decode attention over a paged KV cache, read through a block table.

The serving layer (``serving.dedup_kv``) stores KV as pages addressed by a
block table; deduplicated prefixes make different sequences' table entries
point at the same physical page.  Attention walks the table instead of
gathering the pages into a dense cache (which would copy the duplicates the
dedup just removed): one query token per sequence, GQA (``H`` query heads
over ``KVH`` key/value heads, head ``h`` reading KV head ``h // (H // KVH)``),
positions at or past ``lengths[b]`` masked with the finite ``NEG_INF``, q
scaled by ``D ** -0.5``, softmax and accumulation in float32, the output in
q's dtype.  A row of length 0 has every logit at ``NEG_INF`` and returns the
mean of V over all its table's slots, as the reference does.

``paged_attention_torch`` is the plain version (gather, then dense masked
attention); ``paged_attention`` takes it for CPU tensors and launches the
CUDA kernel (``csrc/paged_attention.cu``) for CUDA tensors.  Page ids outside
``[0, num_pages)`` are clamped on both paths, as a JAX gather clamps.

The kernel splits each row's pages into runs of ``pages_per_split`` pages
(``split_pages``), one block per (row, KV head, split), and merges the
splits' partial softmax states with log-sum-exp weights in split order.
``paged_attention_split_torch`` spells that arithmetic out in plain PyTorch
for the tests; nothing on the card's path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_PAGE_SIZES = (16, 32)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Tokens per split of a row's pages; a table of at most this many tokens is
# one split, which the kernel runs in one pass with no merge.
SPLIT_TOKENS = 256


def split_pages(pps: int, page: int) -> int:
    """Pages per split the kernel uses for tables of ``pps`` pages of
    ``page`` tokens: ``SPLIT_TOKENS`` tokens' worth, at most the table."""
    return max(1, min(pps, SPLIT_TOKENS // page))


def _check(q, k_pages, v_pages, block_table, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q (B, H, D) and K/V pages (P, page, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, h, d = q.shape
    _, _, kvh, dk = k_pages.shape
    if dk != d:
        raise ValueError(f"head dim of q ({d}) and of the pages ({dk}) differ")
    if h % kvh:
        raise ValueError(f"H={h} must be a multiple of KVH={kvh}")
    if block_table.dim() != 2 or block_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"expected table (B, pps) and lengths (B,) for B={b}, got "
                         f"{tuple(block_table.shape)}, {tuple(lengths.shape)}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"table and lengths must be int32, got {block_table.dtype}, "
                        f"{lengths.dtype}")
    if not (q.device == k_pages.device == v_pages.device == block_table.device == lengths.device):
        raise ValueError("all inputs must lie on one device")


def paged_attention_torch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: gather every row's pages through the table into a
    dense (B, pps * page, KVH, D) cache, then masked attention in float32."""
    b, h, d = q.shape
    num_pages, page, kvh, _ = k_pages.shape
    pps = block_table.shape[1]
    table = block_table.long().clamp(0, num_pages - 1)
    k = k_pages[table].reshape(b, pps * page, kvh, d).float()
    v = v_pages[table].reshape(b, pps * page, kvh, d).float()
    qg = (q.float() * d ** -0.5).reshape(b, kvh, h // kvh, d)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k)
    valid = torch.arange(pps * page, device=q.device)[None, :] < lengths.long()[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", attn, v)
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_split_torch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                                block_table: torch.Tensor, lengths: torch.Tensor,
                                pages_per_split: int) -> torch.Tensor:
    """The kernel's split-and-merge arithmetic in plain PyTorch (tests only).

    A row needs ``ceil(length / page)`` pages (all ``pps`` for length 0);
    split ``s`` covers its pages ``[s * pages_per_split, (s + 1) *
    pages_per_split)``, and a split with none of them takes no part.  Each
    used split keeps the max ``m_s`` of its (masked) logits, ``l_s = sum
    exp(logit - m_s)`` and ``acc_s = sum exp(logit - m_s) v``; the merge is
    ``o = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)`` with
    ``M = max_s m_s``, the splits summed in order."""
    b, h, d = q.shape
    num_pages, page, kvh, _ = k_pages.shape
    pps = block_table.shape[1]
    ps = pages_per_split
    nsplit = -(-pps // ps)
    table = block_table.long().clamp(0, num_pages - 1)
    k = k_pages[table].reshape(b, pps * page, kvh, d).float()
    v = v_pages[table].reshape(b, pps * page, kvh, d).float()
    qg = (q.float() * d ** -0.5).reshape(b, kvh, h // kvh, d)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k)
    lens = lengths.long()
    pos = torch.arange(pps * page, device=q.device)
    logits = torch.where((pos[None, :] < lens[:, None])[:, None, None, :], logits, NEG_INF)
    n_pages = torch.where(lens > 0, ((lens + page - 1) // page).clamp(max=pps), pps)
    # positions of pages a row does not need, and the pad up to nsplit splits,
    # are left out (-inf), not masked
    needed = pos[None, :] < (n_pages * page)[:, None]
    logits = torch.where(needed[:, None, None, :], logits, float("-inf"))
    pad = nsplit * ps * page - pps * page
    logits = torch.nn.functional.pad(logits, (0, pad), value=float("-inf"))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    logits = logits.reshape(b, kvh, h // kvh, nsplit, ps * page)
    m = logits.amax(dim=-1)  # (b, kvh, G, nsplit); -inf for unused splits
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l_s = p.sum(dim=-1)
    acc = torch.einsum("bkgst,bstkd->bkgsd", p, v.reshape(b, nsplit, ps * page, kvh, d))
    used = torch.arange(nsplit, device=q.device)[None, :] < (-(-n_pages // ps))[:, None]
    used = used[:, None, None, :]
    big_m = torch.where(used, m, float("-inf")).amax(dim=-1, keepdim=True)
    w = torch.where(used, torch.exp(m - big_m), 0.0)
    lsum = (l_s * w).sum(dim=-1)
    out = (acc * w[..., None]).sum(dim=-2) / lsum.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


# The bf16 check scaled to the outputs (``bf16_err_ratio``): the kernel and
# the plain version each round o to bf16 once, which can put them one ulp,
# at most 2^-7 |o|, apart; the kernel also rounds each softmax weight to
# bf16 (2^-9 relative) before P.V, which moves a row's float32 sums by far
# less than 2^-7 of its largest output.
BF16_RTOL = 2.0 ** -6
BF16_ATOL_OF_ROW_MAX = 2.0 ** -7


def bf16_err_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst ``|got - want| / (BF16_RTOL |want| + atol)`` over (B, H, D)
    outputs, with atol ``BF16_ATOL_OF_ROW_MAX`` times the row's largest
    ``|want|``; at most 1 passes (checks and tests only)."""
    g, w = got.float(), want.float()
    atol = BF16_ATOL_OF_ROW_MAX * w.abs().amax(dim=(1, 2), keepdim=True)
    return float(((g - w).abs() / (BF16_RTOL * w.abs() + atol).clamp(min=1e-30)).max())


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, H, D) attention output of one query token per sequence.

    Args:
      q: (B, H, D) queries, float32 or bfloat16.
      k_pages, v_pages: (num_pages, page, KVH, D) physical pages, q's dtype.
      block_table: (B, pages_per_seq) int32 physical page ids per row.
      lengths: (B,) int32 valid tokens per row.
    On a CUDA device the kernel takes D in {64, 128}, page in {16, 32} and
    at most 32 query heads per KV head; it raises on anything else.
    """
    _check(q, k_pages, v_pages, block_table, lengths)
    b, h, d = q.shape
    num_pages, page, kvh, _ = k_pages.shape
    pps = block_table.shape[1]
    if q.device.type == "cpu":
        return paged_attention_torch(q, k_pages, v_pages, block_table, lengths)
    if q.dtype not in KERNEL_DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q and pages of one dtype, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if d not in KERNEL_HEAD_DIMS or page not in KERNEL_PAGE_SIZES or h // kvh > 32:
        raise ValueError(f"the kernel takes D in {KERNEL_HEAD_DIMS}, page in {KERNEL_PAGE_SIZES} "
                         f"and H/KVH <= 32, got D={d}, page={page}, H/KVH={h // kvh}")
    tensors = (q, k_pages, v_pages, block_table, lengths)
    if not all(t.is_contiguous() for t in tensors) or any(t.data_ptr() % 16 for t in tensors[:3]):
        raise ValueError("the kernel reads contiguous inputs, q and pages 16-byte aligned")
    if num_pages == 0 or pps == 0:
        raise ValueError("a row needs at least one page")
    out = torch.empty_like(q)
    if b == 0:
        return out
    ps = split_pages(pps, page)
    nsplit = -(-pps // ps)
    # per split and query head (m, l, acc[D]) in float32, then one ticket per
    # (row, KV head); the launcher zeroes the tickets
    ws = (torch.empty(b * kvh * nsplit * (h // kvh) * (d + 2) + b * kvh, dtype=torch.float32,
                      device=q.device) if nsplit > 1 else None)
    lib = _build.library("paged_attention")
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*tensors, out)]
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            *ptrs, ctypes.c_void_p(None if ws is None else ws.data_ptr()),
            ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(kvh), ctypes.c_int(d),
            ctypes.c_int(page), ctypes.c_int(pps), ctypes.c_int(num_pages), ctypes.c_int(ps),
            ctypes.c_int(int(q.dtype == torch.bfloat16)),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
        )
    _build.check(err, "paged_attention")
    _build.LAUNCHES["paged_attention"] += 1
    return out
