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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_PAGE_SIZES = (16, 32)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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
    if q.device.type == "cpu":
        return paged_attention_torch(q, k_pages, v_pages, block_table, lengths)
    b, h, d = q.shape
    num_pages, page, kvh, _ = k_pages.shape
    pps = block_table.shape[1]
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
    lib = _build.library("paged_attention")
    ptrs = (ctypes.c_void_p(t.data_ptr()) for t in (*tensors, out))
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            *ptrs,
            ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(kvh), ctypes.c_int(d),
            ctypes.c_int(page), ctypes.c_int(pps), ctypes.c_int(num_pages),
            ctypes.c_int(int(q.dtype == torch.bfloat16)),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
        )
    _build.check(err, "paged_attention")
    _build.LAUNCHES["paged_attention"] += 1
    return out
