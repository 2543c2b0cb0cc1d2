"""Public wrappers over the kernels.

Handle dtype viewing and padding, the move of host arrays onto the device,
and the conversion between kernel outputs and the host-side fingerprint
ints the dedup engines consume.  Host arrays go to ``device`` (the card by
default); a tensor stays on the device it is on.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .cdc import HALO_WORDS, SEG_BYTES, SEG_WORDS, cdc_candidates, unpack_candidates
from .fingerprint import (
    LANES,
    NUM_HASHES,
    PRIME1,
    PRIME2,
    SEEDS,
    _M32,
    _finish,
    _fold,
    _group_sum,
    _lane_constants,
    _mul32,
    fingerprint,
    fingerprint_torch,
)
from .fp_index import check_table, fp_insert, fp_probe, fp_remove
from .fp_index import launch as fp_index_launch
from .histogram import NBINS_DEFAULT, ffh

# chunks per step of the plain gather: bounds its int64 temporaries
_PLAIN_CHUNKS = 1024
GROUP_BYTES = LANES * 4  # bytes of a 128-word group
# groups the chunk kernel gathers, hashes and reduces together (csrc/cdc.cu BATCH)
CHUNK_FP_BATCH = 4
# each key set's sum over a group of 128 zero words: what the hash gives a
# zero group wherever it lies (fp_hash::zero_group_sum in csrc/fp_hash.cuh)
ZERO_GROUP_SUMS = tuple(
    int(_group_sum(torch.zeros(LANES, dtype=torch.int64), *_lane_constants(k, "cpu")))
    for k in range(NUM_HASHES))


def as_words(blocks, device=None) -> torch.Tensor:
    """(B, W) int32 word tensor on the target device, W padded to LANES."""
    if isinstance(blocks, np.ndarray):
        if blocks.dtype == np.uint32:
            blocks = blocks.view(np.int32)
        blocks = torch.from_numpy(np.ascontiguousarray(blocks))
        blocks = blocks.to("cuda" if device is None else device)
    elif device is not None:
        blocks = blocks.to(device)
    if blocks.dim() != 2:
        raise ValueError(f"blocks must be (B, W), got shape {tuple(blocks.shape)}")
    if blocks.dtype == torch.uint8:
        pad = (-blocks.shape[1]) % 4
        if pad:
            blocks = torch.nn.functional.pad(blocks, (0, pad))
        # little-endian words, as the reference's bitcast of 4-byte groups
        blocks = blocks.contiguous().view(torch.int32)
    elif blocks.dtype in (torch.int32, torch.float32, torch.uint32):
        blocks = blocks.contiguous().view(torch.int32)
    else:
        raise TypeError(f"unsupported dtype {blocks.dtype}")
    pad = (-blocks.shape[1]) % LANES
    if pad:
        blocks = torch.nn.functional.pad(blocks, (0, pad))
    return blocks.contiguous()


def fingerprint_blocks(blocks, device=None) -> torch.Tensor:
    """Fingerprint content blocks.

    Args:
      blocks: (B, W) 32-bit words (int32, uint32 or float32, bitcast; bytes
        packed little-endian by the caller), or (B, W8) uint8, viewed as
        little-endian words after zero-padding to 4 bytes; a numpy array or
        a tensor.  W is zero-padded to a multiple of 128 words.
      device: where to hash a numpy array (default: the card); a tensor is
        hashed where it lies unless ``device`` names another device.
    Returns:
      (B, NUM_HASHES) int32 tensor of uint32 digest bits, on that device.
    """
    return fingerprint(as_words(blocks, device))


def _fold64(fp128: np.ndarray) -> np.ndarray:
    """Fold (B, NUM_HASHES) uint32 kernel output to (B,) uint64 (two words
    verbatim, two mixed in) — collision probability ~2^-64 per pair.  The
    zero guard stays with the callers (CDC mixes the length in first)."""
    fp = np.asarray(fp128, dtype=np.uint64)
    lo = fp[:, 0] ^ (fp[:, 2] * np.uint64(0x9E3779B97F4A7C15) & np.uint64(0xFFFFFFFFFFFFFFFF))
    hi = fp[:, 1] ^ fp[:, 3]
    return (hi << np.uint64(32)) | (lo & np.uint64(0xFFFFFFFF))


def digests_to_host(fp128: torch.Tensor) -> np.ndarray:
    """(B, NUM_HASHES) int32 digest tensor -> uint32 numpy array."""
    return fp128.cpu().numpy().view(np.uint32)


def fingerprint_ints(blocks, device=None) -> np.ndarray:
    """(B,) uint64 fingerprints for the host-side dedup engines; only the
    (B, 4) digest comes back from the device."""
    out = _fold64(digests_to_host(fingerprint_blocks(blocks, device=device)))
    out[out == 0] = 1  # 0 is reserved
    return out


def _mix_len64(lens: np.ndarray) -> np.ndarray:
    """splitmix64 of chunk lengths: XORed into chunk fingerprints so two
    chunks whose zero-padded images coincide (one is the other plus trailing
    zeros) still hash apart."""
    z = np.asarray(lens, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def chunk_fp64(fp128, lens) -> np.ndarray:
    """(C,) uint64 chunk fingerprints from kernel output + true lengths."""
    out = _fold64(fp128) ^ _mix_len64(lens)
    out[out == 0] = 1  # 0 is reserved
    return out


def as_rows(haloed, device=None) -> torch.Tensor:
    """Haloed CDC rows (numpy uint32 from ``pack_haloed``, or a tensor) as an
    int32 tensor on the target device; host rows go to the card by default."""
    if isinstance(haloed, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(haloed).view(np.int32))
        return rows.to("cuda" if device is None else device)
    return haloed if device is None else haloed.to(device)


def cdc_candidate_flags(haloed, avg_size: int, device=None) -> torch.Tensor:
    """Candidate-flag words for haloed CDC rows (see ``kernels.cdc``), left on
    the rows' device.  A tensor is used where it lies, so the fused path
    uploads once and reuses the same rows for the chunk-fingerprint launch."""
    return cdc_candidates(as_rows(haloed, device), avg_size)


def candidate_positions(flags: torch.Tensor,
                        spans: Sequence[Tuple[int, int, int]]) -> List[np.ndarray]:
    """Sorted candidate byte positions of each span, cut at its ``n_bytes``:
    for every span, ``unpack_candidates(flags, span)``.

    On the card the flag words are compacted there (the nonzero words, then
    their set bits) and only the kept positions cross to the host, not the
    flag array (one word per 4 payload bytes).  A CPU tensor goes through
    ``unpack_candidates``.
    """
    if flags.device.type == "cpu":
        host = flags.numpy().view(np.uint32)
        return [unpack_candidates(host, span) for span in spans]
    if not spans:
        return []
    dev = flags.device
    flat = flags.reshape(-1)
    words = torch.nonzero(flat).squeeze(1)  # ascending
    phase = torch.arange(4, dtype=torch.int64, device=dev)
    bits = ((flat[words].to(torch.int64)[:, None] >> phase) & 1).bool()
    pos = (words[:, None] * 4 + phase)[bits]  # row-major: still ascending
    base = torch.tensor([row0 * SEG_BYTES for row0, _, _ in spans], dtype=torch.int64)
    end = base + torch.tensor([n for _, _, n in spans], dtype=torch.int64)
    base, end = base.to(dev), end.to(dev)
    # spans are contiguous and in row order: the last span starting at or
    # before a position holds it (an empty span shares its start with the next)
    sid = torch.searchsorted(base, pos, right=True) - 1
    keep = pos < end[sid]
    sid = sid[keep]
    rel = (pos[keep] - base[sid]).cpu().numpy()
    counts = torch.bincount(sid, minlength=len(spans)).cpu().numpy()
    return np.split(rel, np.cumsum(counts)[:-1])


def chunk_fingerprint_torch(haloed: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                            w_pad: int) -> torch.Tensor:
    """Plain version of the fused gather + fingerprint: (C, NUM_HASHES) int32.

    Chunk ``i`` is payload bytes ``starts[i] .. starts[i] + lens[i]`` of the
    rows' concatenated payload columns, zero-padded to ``w_pad`` little-endian
    words and hashed by ``fingerprint_torch``.  Bytes past the payload read as
    zero.  Gathered in torch, a block of chunks at a time.
    """
    flat = haloed.reshape(-1)
    total = haloed.shape[0] * SEG_BYTES
    c = starts.shape[0]
    out = torch.empty((c, NUM_HASHES), dtype=torch.int32, device=haloed.device)
    span = torch.arange(w_pad * 4, dtype=torch.int64, device=haloed.device)[None, :]
    for a in range(0, c, _PLAIN_CHUNKS):
        s = starts[a:a + _PLAIN_CHUNKS].to(torch.int64)[:, None]
        n = lens[a:a + _PLAIN_CHUNKS].to(torch.int64)[:, None]
        p = s + span
        valid = (span < n) & (p >= 0) & (p < total)
        p = torch.where(valid, p, 0)
        q = p >> 2  # payload word q: row q // 512, column HALO_WORDS + q % 512
        word = flat[q + HALO_WORDS * ((q >> 9) + 1)].to(torch.int64) & _M32
        b = torch.where(valid, (word >> ((p & 3) * 8)) & 0xFF, 0)
        b4 = b.reshape(b.shape[0], w_pad, 4)
        words = b4[:, :, 0] | (b4[:, :, 1] << 8) | (b4[:, :, 2] << 16) | (b4[:, :, 3] << 24)
        words = (words - ((words >> 31) << 32)).to(torch.int32)
        out[a:a + words.shape[0]] = fingerprint_torch(words)
    return out


def chunk_fingerprint_batched_torch(haloed: torch.Tensor, starts: torch.Tensor,
                                    lens: torch.Tensor, w_pad: int,
                                    batch: int = CHUNK_FP_BATCH) -> torch.Tensor:
    """The chunk kernel's order of work in plain PyTorch (tests only).

    Same result as ``chunk_fingerprint_torch``, reached as ``csrc/cdc.cu``
    reaches it.  Per chunk: offsets from its first row; groups that hold
    data in batches of ``batch``; per lane and group the two 16-byte units
    at word ``x`` and ``x + 4`` (``x`` a multiple of 4), read unconditionally
    in a batch wholly inside the chunk, else only where the unit's first
    word starts before the chunk's end, then aligned by the start's word and
    byte phase and, in such a batch, masked past the end; each lane's share
    of the four sums with the lane weight premultiplied by P2; the shares of
    a batch summed over the lanes at once; each key set's digest folded in
    group order; the groups past the data folded with ``ZERO_GROUP_SUMS``.
    """
    dev = haloed.device
    flat = haloed.reshape(-1).to(torch.int64) & _M32
    total = haloed.shape[0] * SEG_BYTES
    groups = w_pad // LANES
    s = starts.to(torch.int64)[:, None]
    n = lens.to(torch.int64)[:, None]
    lane = torch.arange(32, dtype=torch.int64, device=dev)[None, :]
    end = torch.minimum(s + torch.clamp(n, max=4 * w_pad), torch.full_like(s, total))
    d = torch.where(end > s.clamp(min=0), torch.clamp((n - 1) // GROUP_BYTES + 1, max=groups), 0)
    q0 = s >> 2
    row0 = q0.clamp(min=0) >> 9
    qrel = q0 - row0 * SEG_WORDS
    r = qrel & 3
    shift = (s & 3) * 8
    xa = (qrel & ~3) + 4 * lane
    hi = (end - row0 * SEG_BYTES + 3) >> 2
    read_bytes = end - s
    full = torch.where(s >= 0, torch.minimum(d, read_bytes // GROUP_BYTES), 0)
    need_b = (r | shift) != 0
    base = row0 * (HALO_WORDS + SEG_WORDS) + HALO_WORDS  # payload of the chunk's first row
    consts = [_lane_constants(k, dev) for k in range(NUM_HASHES)]
    keys = [key.reshape(32, 4) for key, _ in consts]
    weights = [_mul32(mult, PRIME2).reshape(32, 4) for _, mult in consts]
    h = [torch.full_like(s[:, 0], SEEDS[k]) for k in range(NUM_HASHES)]

    def unit(x, read):  # the 4 words of the unit at payload word x, or zeros
        idx = base + x + HALO_WORDS * (x >> 9)
        idx = torch.where(read, idx, 0)[..., None] + torch.arange(4, device=dev)
        return torch.where(read[..., None], flat[idx], 0)

    for b in range(0, groups, batch):
        checked = b + batch > full
        shares = []
        for g in range(batch):
            live = b + g < d
            x = xa + LANES * (b + g)
            read_a = live & torch.where(checked, (x >= 0) & (x < hi), True)
            read_b = live & torch.where(checked, (x + 4 >= 0) & (x + 4 < hi), need_b)
            raw = torch.cat([unit(x, read_a), unit(x + 4, read_b)], dim=2)  # (C, 32, 8)
            words = []
            for m in range(4):
                lo = torch.gather(raw, 2, (r + m)[:, :, None].expand(-1, 32, 1))[..., 0]
                up = torch.gather(raw, 2, (r + m + 1)[:, :, None].expand(-1, 32, 1))[..., 0]
                v = ((lo >> shift) | (up << (32 - shift))) & _M32
                keep = read_bytes - GROUP_BYTES * (b + g) - 16 * lane - 4 * m
                mask = torch.where(keep >= 4, _M32, (1 << (8 * keep.clamp(0, 3))) - 1)
                words.append(torch.where(checked & (b + g >= full), v & mask, v))
            for k in range(NUM_HASHES):
                acc = torch.zeros_like(words[0])
                for q in range(4):
                    t = _mul32(words[q] ^ keys[k][:, q], PRIME1)
                    acc = acc + _mul32(t ^ (t >> 15), weights[k][:, q])
                shares.append(torch.where(live, acc & _M32, 0))
        totals = [sh.sum(dim=1) & _M32 for sh in shares]  # over the lanes, slot by slot
        for g in range(batch):
            live = (b + g < d)[:, 0]
            for k in range(NUM_HASHES):
                h[k] = torch.where(live, _fold(h[k], totals[NUM_HASHES * g + k], b + g), h[k])
    for c in range(groups):
        zero = (c >= d)[:, 0]
        for k in range(NUM_HASHES):
            h[k] = torch.where(zero, _fold(h[k], ZERO_GROUP_SUMS[k], c), h[k])
    out = torch.stack([_finish(hk, w_pad) for hk in h], dim=1)
    return (out - ((out >> 31) << 32)).to(torch.int32)


def chunk_fingerprint(haloed: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                      w_pad: int) -> torch.Tensor:
    """(C, NUM_HASHES) int32 digests of chunks of resident CDC rows.

    ``starts`` (int64) and ``lens`` (int32, at most ``4 * w_pad``) are global
    byte offsets and lengths into the rows' concatenated payload columns,
    on the rows' device; ``w_pad`` is a multiple of LANES.  A CPU tensor goes
    through ``chunk_fingerprint_torch``; a CUDA tensor through the fused
    kernel (``csrc/cdc.cu``), on the current stream.
    """
    if haloed.dtype != torch.int32 or haloed.dim() != 2 or haloed.shape[1] != HALO_WORDS + SEG_WORDS:
        raise TypeError(f"expected (R, {HALO_WORDS + SEG_WORDS}) int32 rows, got {haloed.dtype} {tuple(haloed.shape)}")
    if starts.dtype != torch.int64 or lens.dtype != torch.int32:
        raise TypeError(f"starts must be int64 and lens int32, got {starts.dtype}, {lens.dtype}")
    if starts.dim() != 1 or starts.shape != lens.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and lens {tuple(lens.shape)} must align")
    if w_pad <= 0 or w_pad % LANES:
        raise ValueError(f"w_pad={w_pad} must be a positive multiple of {LANES}")
    if not (haloed.device == starts.device == lens.device):
        raise ValueError("rows, starts and lens must lie on one device")
    if haloed.device.type == "cpu":
        return chunk_fingerprint_torch(haloed, starts, lens, w_pad)
    if not (haloed.is_contiguous() and starts.is_contiguous() and lens.is_contiguous()):
        raise ValueError("the kernel reads contiguous rows, starts and lens")
    if haloed.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte units: pass 16-byte aligned rows")
    c = starts.shape[0]
    out = torch.empty((c, NUM_HASHES), dtype=torch.int32, device=haloed.device)
    if c == 0:
        return out
    lib = _build.library("cdc")
    with torch.cuda.device(haloed.device):
        err = lib.chunk_fingerprint_launch(
            ctypes.c_void_p(haloed.data_ptr()),
            ctypes.c_longlong(haloed.shape[0]),
            ctypes.c_void_p(starts.data_ptr()),
            ctypes.c_void_p(lens.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_longlong(c),
            ctypes.c_int(w_pad),
            ctypes.c_void_p(torch.cuda.current_stream(haloed.device).cuda_stream),
        )
    _build.check(err, "chunk_fingerprint")
    _build.count_launch("chunk_fingerprint")
    return out


def cdc_chunk_fingerprints(haloed: torch.Tensor, starts, lens, max_size: int) -> np.ndarray:
    """(C,) uint64 fingerprints for chunks of resident CDC rows.

    Every chunk is zero-padded to ``max_size`` bytes (``w_pad`` words) before
    hashing, so all backends hash identical padded images; the true length is
    mixed into the fold (``chunk_fp64``).  ``max_size`` must make ``w_pad`` a
    LANES multiple (``core.cdc`` validates ``max_size % 512 == 0``).  Starts
    are int64, so one call may hold 2^31 payload bytes and more.
    """
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    if starts.size == 0:
        return np.empty(0, dtype=np.uint64)
    w_pad = max_size // 4
    if w_pad % LANES:
        raise ValueError(f"max_size={max_size} must be a multiple of {LANES * 4}")
    if (starts.min() < 0 or lens.min() < 0 or lens.max() > max_size
            or (starts + lens).max() > haloed.shape[0] * SEG_BYTES):
        raise ValueError("chunks must lie inside the rows' payload, at most max_size long")
    dev = haloed.device
    fp128 = chunk_fingerprint(haloed, torch.from_numpy(starts).to(dev),
                              torch.from_numpy(lens).to(dev), w_pad)
    return chunk_fp64(digests_to_host(fp128), lens)


def keys_to_device(keys: np.ndarray, device) -> torch.Tensor:
    """uint64 numpy keys -> int64 tensor on ``device`` (same bits)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(keys).to(device)


def pinned_keys(keys: np.ndarray) -> torch.Tensor:
    """uint64 host keys as an int64 tensor in pinned host memory, which the
    index kernels read in place (no copy to the card first)."""
    staged = torch.empty(keys.size, dtype=torch.int64, pin_memory=True)
    np.copyto(staged.numpy(), np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64))
    return staged


def fp_index_probe(keys: np.ndarray, table: torch.Tensor, cap: int) -> torch.Tensor:
    """(N,) bool membership flags of uint64 host keys against the flat
    table, left on the table's device: the launch is asynchronous, so the
    caller overlaps host work before reading them.

    On a card the kernel reads the keys in place from pinned host memory,
    which the flags tensor keeps alive (``staged_keys``) until it is dropped:
    a caller drops it only after reading the flags, which waits for the
    kernel."""
    if table.is_cpu:
        return fp_probe(keys_to_device(keys, table.device), table, cap)
    check_table(table, cap)
    staged = pinned_keys(keys)
    flags = torch.empty(staged.numel(), dtype=torch.bool, device=table.device)
    fp_index_launch("fp_probe", staged, table, flags, cap)
    flags.staged_keys = staged
    return flags


def _index_update(name: str, dtype, keys: np.ndarray, table: torch.Tensor, cap: int) -> np.ndarray:
    """Run the insert or remove kernel on uint64 host keys and wait for it.
    Keys and results stay in pinned host memory, which the kernel reads and
    writes in place: a call makes no copy to or from the card."""
    check_table(table, cap)
    staged = pinned_keys(keys)
    out = torch.empty(staged.numel(), dtype=dtype, pin_memory=True)
    fp_index_launch(name, staged, table, out, cap)
    torch.cuda.current_stream(table.device).synchronize()
    return out.numpy()


def fp_index_insert(keys: np.ndarray, table: torch.Tensor, cap: int) -> np.ndarray:
    """Insert uint64 host keys into the table in place; (N,) int32 numpy
    status in batch order (PLACED / PRESENT / OVERFLOW / PLACED_TOMB)."""
    if table.is_cpu:
        return fp_insert(keys_to_device(keys, table.device), table, cap).numpy()
    return _index_update("fp_insert", torch.int32, keys, table, cap)


def fp_index_remove(keys: np.ndarray, table: torch.Tensor, cap: int) -> np.ndarray:
    """Tombstone uint64 host keys in the table in place; (N,) bool numpy."""
    if table.is_cpu:
        return fp_remove(keys_to_device(keys, table.device), table, cap).numpy()
    return _index_update("fp_remove", torch.bool, keys, table, cap)


def ffh_counts(counts, nbins: int = NBINS_DEFAULT, device=None) -> torch.Tensor:
    """(nbins,) int32 FFH of occurrence counts (0 or below ignored), on the
    counts' device.  A host array (anything ``np.asarray`` takes, viewed as
    int32 like the reference's) goes to ``device``, the card by default; a
    tensor stays where it lies unless ``device`` names another.  Unlike the
    reference, which pads to its kernel's tile, the counts are not padded:
    the kernel takes any length."""
    if isinstance(counts, torch.Tensor):
        c = counts if device is None else counts.to(device)
    else:
        host = np.ascontiguousarray(np.asarray(counts).reshape(-1), dtype=np.int32)
        c = torch.from_numpy(host).to("cuda" if device is None else device)
    return ffh(c.reshape(-1).to(torch.int32).contiguous(), nbins)
