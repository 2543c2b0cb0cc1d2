"""Exact fingerprint-index hash table: probe, insert and remove.

The port's counterpart of the reference's Pallas kernel trio.  The table is
**one flat int64 tensor** in the physical layout below, resident on the
device the index lives on; each slot holds a whole 64-bit key as
``hi << 32 | lo`` (the reference's ``_t64`` mirror layout):

* a key's logical home slot is the 32-bit avalanche hash of its two words
  (``slot_hash_host``) masked to the power-of-two logical capacity;
  collisions probe a bounded **window** of ``WINDOW`` consecutive slots;
* logical slots are laid out in tiles of ``TILE_SLOTS``, each followed by
  ``TILE_PAD`` tail-pad slots, so a window never crosses a tile edge and
  never wraps (``phys_slots``).  The GPU kernels do not need the tiling,
  but the layout is shared with the host numpy path and with
  ``FingerprintIndex.check_consistency``, so it stays;
* ``EMPTY`` (0) and ``TOMBSTONE`` (all ones, -1 as int64) are in-band
  sentinels; the index spills the two keys that collide with them to a
  host set, so the table never stores them.

Each operation has a plain PyTorch version (``*_torch``) and a hand-written
CUDA kernel (``csrc/fp_index.cu``); the wrappers ``fp_probe``,
``fp_insert`` and ``fp_remove`` take the plain version for a CPU tensor and
launch the kernel for a CUDA tensor.  Keys arrive in batch order and
results leave in batch order: no per-tile routing.

The plain insert reproduces the reference kernel's *sequential* first-fit
layout bit for bit.  The CUDA insert places keys in parallel with 64-bit
``atomicCAS``, so its layout may differ; its membership and status counts
do not (see the kernel's source note).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .fingerprint import _mul32

# Bounded linear-probe window: every key lives within WINDOW slots of its
# home slot or spills to the host.
WINDOW = 16
# Logical slots per table tile.
TILE_SLOTS = 1 << 15
# Per-tile tail pad (>= WINDOW - 1: windows never wrap).
TILE_PAD = 128

# In-band slot sentinels (a whole int64 slot).
EMPTY64 = 0
TOMB64 = -1

# Insert statuses.
PLACED = 0  # consumed an EMPTY slot
PRESENT = 1  # key already in its window (EMPTY keys also report PRESENT)
OVERFLOW = 2  # window full -> host spill
PLACED_TOMB = 3  # consumed a TOMBSTONE slot

_M32 = 0xFFFFFFFF
_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917


def tile_shape(cap: int):
    """``(num_tiles, tile_cap, tile_phys)`` for logical capacity ``cap``.

    ``cap`` must be a power of two.  Tables at or below ``TILE_SLOTS`` are a
    single tile (``tile_cap == cap``); larger tables split into
    ``cap // TILE_SLOTS`` tiles of ``TILE_SLOTS`` logical slots each.
    """
    if cap & (cap - 1):
        raise ValueError(f"logical capacity {cap} must be a power of two")
    tile_cap = min(cap, TILE_SLOTS)
    return cap // tile_cap, tile_cap, tile_cap + TILE_PAD


def table_phys_len(cap: int) -> int:
    """Total physical slots (flat) for logical capacity ``cap``."""
    t, _, tile_phys = tile_shape(cap)
    return t * tile_phys


def phys_slots(home, cap: int):
    """Physical (flat) slot index of each logical home slot.

    The layout contract shared by the host path and the kernels: tile
    ``h // tile_cap`` starts ``TILE_PAD`` slots later per preceding tile.
    Accepts and returns integer numpy arrays.
    """
    _, tile_cap, _ = tile_shape(cap)
    return home + (home // tile_cap) * TILE_PAD


def slot_hash_host(lo, hi):
    """Home-slot hash over numpy uint32 arrays — the layout contract.

    Mirrored by ``_slot_hash_torch`` and by ``slot_hash`` in
    ``csrc/fp_index.cu``, so every path probes identical slots.
    """
    x = (lo ^ np.uint32(0x9E3779B9)) * np.uint32(2654435761)
    x ^= x >> np.uint32(15)
    x = (x + hi) * np.uint32(2246822519)
    x ^= x >> np.uint32(13)
    x = x * np.uint32(3266489917)
    return x ^ (x >> np.uint32(16))


def phys_homes_host(keys: np.ndarray, cap: int) -> np.ndarray:
    """(N,) int64 physical home slots of uint64 keys, on the host."""
    lo = (keys & np.uint64(_M32)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    home = (slot_hash_host(lo, hi) & np.uint32(cap - 1)).astype(np.int64)
    return phys_slots(home, cap)


def probe_host(t64: np.ndarray, keys: np.ndarray, cap: int) -> np.ndarray:
    """(N,) bool membership of uint64 keys in the flat uint64 table ``t64``.

    The host fast path: one vectorized gather per window offset, and an
    EMPTY slot ends a key's probe chain (inserts are first-fit, so a key
    never sits past a slot that was EMPTY when it arrived, and removals
    tombstone instead of emptying).  Every insert path — the plain version
    and the CUDA kernel — keeps that invariant, so this probe stays exact
    over any table they built.
    """
    home = phys_homes_host(keys, cap)
    found = np.zeros(keys.size, dtype=bool)
    idx = np.arange(keys.size)
    rem = keys
    for r in range(WINDOW):
        cur = t64[home + r]
        match = cur == rem
        if match.any():
            found[idx[match]] = True
        undecided = ~(match | (cur == 0))
        if not undecided.any():
            break
        idx, rem, home = idx[undecided], rem[undecided], home[undecided]
    return found


# -- plain PyTorch versions ------------------------------------------------------


def _slot_hash_torch(keys: torch.Tensor) -> torch.Tensor:
    lo = keys & _M32
    hi = (keys >> 32) & _M32
    x = _mul32(lo ^ 0x9E3779B9, _P1)
    x = x ^ (x >> 15)
    x = _mul32((x + hi) & _M32, _P2)
    x = x ^ (x >> 13)
    x = _mul32(x, _P3)
    return x ^ (x >> 16)


def _windows(keys: torch.Tensor, cap: int):
    """(N,) physical homes and (N, WINDOW) physical window slot indices."""
    _, tile_cap, _ = tile_shape(cap)
    home = _slot_hash_torch(keys) & (cap - 1)
    home = home + (home // tile_cap) * TILE_PAD
    return home, home[:, None] + torch.arange(WINDOW, device=keys.device)


def _head(keys: torch.Tensor) -> torch.Tensor:
    """(N,) batch position of the first copy of each key's value."""
    n = keys.numel()
    _, inv = torch.unique(keys, return_inverse=True)
    first = torch.full((n,), n, dtype=torch.int64, device=keys.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=keys.device), reduce="amin")
    return first[inv]


def _i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def fp_probe_torch(keys: torch.Tensor, table: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain version of the probe: (N,) bool, True iff a slot of the key's
    window holds the key (whole-window scan, like the reference kernel)."""
    _, win = _windows(keys, cap)
    return (table[win] == keys[:, None]).any(dim=1)


def fp_insert_torch(keys: torch.Tensor, table: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain version of the insert: updates ``table`` in place, returns the
    (N,) int32 status per key.

    Reproduces the reference kernel's sequential semantics — keys in batch
    order, each into the first EMPTY or TOMBSTONE slot of its window unless
    the window already holds it — without a loop over keys.  Each round,
    every undecided key proposes the first free slot of its window (free in
    the table as updated so far).  An undecided key ``j`` can still end up
    anywhere in ``[proposal_j, home_j + WINDOW)``; a key's proposal is final
    iff no *earlier* undecided key's range covers it.  The earliest
    undecided key is always final, so the loop ends, and a final key's slot
    is exactly the one sequential first-fit would give it: every slot before
    its proposal is taken, and no earlier key can take the proposal itself.
    """
    n = keys.numel()
    dev = keys.device
    status = torch.full((n,), PRESENT, dtype=torch.int32, device=dev)
    if n == 0:
        return status
    home, win = _windows(keys, cap)
    window0 = table[win]
    present = (window0 == keys[:, None]).any(dim=1)
    head = _head(keys)
    first = head == torch.arange(n, device=dev)
    valid = keys != EMPTY64
    act = torch.nonzero(valid & ~present & first).flatten()
    offs = torch.arange(WINDOW, device=dev)
    cover = torch.full((table.numel(),), n, dtype=torch.int64, device=dev)
    while act.numel():
        cur = table[win[act]]
        free = (cur == EMPTY64) | (cur == TOMB64)
        has = free.any(dim=1)
        status[act[~has]] = OVERFLOW
        act, free = act[has], free[has]
        if act.numel() == 0:
            break
        off = torch.argmax(free.to(torch.int8), dim=1)
        prop = home[act] + off
        span = prop[:, None] + offs
        in_range = span < (home[act] + WINDOW)[:, None]
        s = span[in_range]
        cover.scatter_reduce_(0, s, act[:, None].expand(-1, WINDOW)[in_range], reduce="amin")
        final = cover[prop] == act
        cover[s] = n
        fa, fs = act[final], prop[final]
        table[fs] = keys[fa]
        took_tomb = window0[fa, off[final]] == TOMB64
        status[fa] = torch.where(took_tomb, _i32(PLACED_TOMB, dev), _i32(PLACED, dev))
        act = act[~final]
    # later copies of a key in the batch: PRESENT once the first copy is in,
    # OVERFLOW when it overflowed (an insert never frees a slot)
    dup = valid & ~present & ~first
    if dup.any():
        status[dup] = torch.where(
            status[head[dup]] == OVERFLOW, _i32(OVERFLOW, dev), _i32(PRESENT, dev)
        )
    return status


def fp_remove_torch(keys: torch.Tensor, table: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain version of the remove: tombstones the slot holding each key, in
    place; (N,) bool, True where a slot was tombstoned (only the first copy
    of a key repeated in the batch finds it, as in the sequential kernel)."""
    n = keys.numel()
    pos = torch.arange(n, device=keys.device)
    if n == 0:
        return pos.to(torch.bool)
    _, win = _windows(keys, cap)
    match = table[win] == keys[:, None]
    found = match.any(dim=1) & (keys != EMPTY64) & (_head(keys) == pos)
    slot = win[pos, torch.argmax(match.to(torch.int8), dim=1)]
    table[slot[found]] = TOMB64
    return found


# -- wrappers: plain version on the CPU, CUDA kernel on the card ------------------


def _check(keys: torch.Tensor, table: torch.Tensor, cap: int) -> None:
    if keys.dtype != torch.int64 or table.dtype != torch.int64:
        raise TypeError(f"keys and table must be int64, got {keys.dtype}, {table.dtype}")
    if keys.dim() != 1 or table.dim() != 1:
        raise ValueError("keys and table must be flat 1-D tensors")
    if not (keys.is_contiguous() and table.is_contiguous()):
        raise ValueError("keys and table must be contiguous")
    if keys.device != table.device:
        raise ValueError(f"keys on {keys.device}, table on {table.device}")
    if table.numel() != table_phys_len(cap):
        raise ValueError(
            f"table has {table.numel()} slots, capacity {cap} needs {table_phys_len(cap)}"
        )


def _launch(name: str, keys, table, out, cap: int) -> None:
    _, tile_cap, _ = tile_shape(cap)
    fn = getattr(_build.library("fp_index"), f"{name}_launch")
    # the launch is asynchronous; tensors the caller drops meanwhile are safe,
    # because the caching allocator reuses their memory in stream order
    with torch.cuda.device(keys.device):  # launch in the context of the table's card
        err = fn(
            ctypes.c_void_p(keys.data_ptr()),
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_longlong(keys.numel()),
            ctypes.c_longlong(cap - 1),
            ctypes.c_int(tile_cap.bit_length() - 1),
            ctypes.c_void_p(torch.cuda.current_stream(keys.device).cuda_stream),
        )
    _build.check(err, name)
    _build.LAUNCHES[name] += 1


def _dispatch(name: str, plain, out_dtype, keys, table, cap: int) -> torch.Tensor:
    _check(keys, table, cap)
    if keys.device.type == "cpu":
        return plain(keys, table, cap)
    out = torch.empty(keys.numel(), dtype=out_dtype, device=keys.device)
    if keys.numel():
        _launch(name, keys, table, out, cap)
    return out


def fp_probe(keys: torch.Tensor, table: torch.Tensor, cap: int) -> torch.Tensor:
    """(N,) bool membership of int64 ``keys`` in the flat ``table``."""
    return _dispatch("fp_probe", fp_probe_torch, torch.bool, keys, table, cap)


def fp_insert(keys: torch.Tensor, table: torch.Tensor, cap: int) -> torch.Tensor:
    """Insert int64 ``keys`` into ``table`` in place; (N,) int32 status."""
    return _dispatch("fp_insert", fp_insert_torch, torch.int32, keys, table, cap)


def fp_remove(keys: torch.Tensor, table: torch.Tensor, cap: int) -> torch.Tensor:
    """Tombstone int64 ``keys`` in ``table`` in place; (N,) bool removed."""
    return _dispatch("fp_remove", fp_remove_torch, torch.bool, keys, table, cap)
