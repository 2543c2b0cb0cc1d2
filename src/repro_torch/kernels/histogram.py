"""Fingerprint-frequency histogram (FFH).

``ffh[j-1] = #{i : min(counts[i], nbins) == j}`` for ``j = 1..nbins``:
counts above ``nbins`` accumulate into the last bin, counts of 0 or below
(padding, or negatives) fall in no bin, matching ``core.ffh`` and the
reference's Pallas kernel.  The FFH is the statistic the unseen estimator
consumes every estimation interval.

``ffh_torch`` is the plain PyTorch version, the reference's one-hot compare
against the bin ids; ``ffh`` takes it for a CPU tensor and launches the CUDA
kernel (``csrc/histogram.cu``) for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

TILE = 8            # the reference kernel's sublane rows per grid step
LANES = 128         # lane width; ``ops.ffh_counts`` pads to TILE * LANES
NBINS_DEFAULT = 40  # matches core.unseen.RARE_BINS
MAX_NBINS_KERNEL = 1024  # the kernel's per-warp shared-memory histograms

# counts per step of the plain version: bounds its (chunk, nbins) one-hot
_PLAIN_CHUNK = 1 << 18


def ffh_torch(counts: torch.Tensor, nbins: int = NBINS_DEFAULT) -> torch.Tensor:
    """Plain version: (N,) int32 counts -> (nbins,) int32 FFH, by the
    reference's one-hot compare of the clipped counts against bins 1..nbins,
    a chunk of counts at a time."""
    c = counts.reshape(-1)
    bins = torch.arange(1, nbins + 1, dtype=torch.int32, device=c.device)
    out = torch.zeros(nbins, dtype=torch.int64, device=c.device)
    for a in range(0, c.numel(), _PLAIN_CHUNK):
        clipped = torch.clamp(c[a:a + _PLAIN_CHUNK], max=nbins)
        out += (clipped[:, None] == bins[None, :]).sum(dim=0)
    return out.to(torch.int32)


def ffh(counts: torch.Tensor, nbins: int = NBINS_DEFAULT) -> torch.Tensor:
    """(N,) int32 occurrence counts -> (nbins,) int32 FFH on ``counts``' device.

    A CPU tensor goes through ``ffh_torch``; a CUDA tensor through the
    kernel, on the current stream, for ``nbins`` up to 1,024.
    """
    if counts.dtype != torch.int32 or counts.dim() != 1:
        raise TypeError(f"expected (N,) int32 counts, got {counts.dtype} {tuple(counts.shape)}")
    if nbins < 1:
        raise ValueError(f"nbins={nbins} must be positive")
    if counts.device.type == "cpu":
        return ffh_torch(counts, nbins)
    if nbins > MAX_NBINS_KERNEL:
        raise ValueError(f"the kernel takes nbins <= {MAX_NBINS_KERNEL}, got {nbins}")
    if not counts.is_contiguous() or counts.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte groups: pass a contiguous, aligned tensor")
    out = torch.zeros(nbins, dtype=torch.int32, device=counts.device)
    if counts.numel() == 0:
        return out
    lib = _build.library("histogram")
    with torch.cuda.device(counts.device):
        err = lib.ffh_launch(
            ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_longlong(counts.numel()),
            ctypes.c_int(nbins),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(counts.device).cuda_stream),
        )
    _build.check(err, "ffh")
    _build.count_launch("ffh")
    return out
