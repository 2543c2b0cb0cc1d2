"""Public wrappers over the kernels.

Handle dtype viewing and padding, the move of host arrays onto the device,
and the conversion between kernel outputs and the host-side fingerprint
ints the dedup engines consume.  Host arrays go to ``device`` (the card by
default); a tensor stays on the device it is on.
"""

from __future__ import annotations

import numpy as np
import torch

from .fingerprint import LANES, fingerprint
from .fp_index import fp_insert, fp_probe, fp_remove


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


def keys_to_device(keys: np.ndarray, device) -> torch.Tensor:
    """uint64 numpy keys -> int64 tensor on ``device`` (same bits)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(keys).to(device)


def fp_index_probe(keys: np.ndarray, table: torch.Tensor, cap: int) -> torch.Tensor:
    """(N,) bool membership flags of uint64 host keys against the
    device-resident flat table, left on the table's device: the launch is
    asynchronous, so the caller overlaps host work before reading them."""
    return fp_probe(keys_to_device(keys, table.device), table, cap)


def fp_index_insert(keys: np.ndarray, table: torch.Tensor, cap: int) -> np.ndarray:
    """Insert uint64 host keys into the table in place; (N,) int32 numpy
    status in batch order (PLACED / PRESENT / OVERFLOW / PLACED_TOMB)."""
    return fp_insert(keys_to_device(keys, table.device), table, cap).cpu().numpy()


def fp_index_remove(keys: np.ndarray, table: torch.Tensor, cap: int) -> np.ndarray:
    """Tombstone uint64 host keys in the table in place; (N,) bool numpy."""
    return fp_remove(keys_to_device(keys, table.device), table, cap).cpu().numpy()
