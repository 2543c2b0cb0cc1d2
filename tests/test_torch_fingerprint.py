"""The port's block fingerprint against the reference, bit for bit.

The same seeded numpy blocks go through ``repro.kernels.ops`` (the Pallas
kernel, in interpret mode on the CPU) and ``repro_torch.kernels.ops`` (the
plain PyTorch version on the CPU; ``tests/test_torch_gpu.py`` holds the CUDA
kernel against it on the card).
Digests and 64-bit folds must be identical: every index placement and
stored fingerprint derives from them.
"""

import json
import os

import jax  # noqa: F401  (both frameworks in one process, data passed as numpy)
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import fingerprint_golden_numpy as ref_golden_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.fingerprint import fingerprint, fingerprint_torch
from repro_torch.kernels.ref import fingerprint_golden_numpy, fingerprint_ref

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "fingerprint_digests.json")


def _weyl(b, w):
    i = np.arange(b, dtype=np.uint64)[:, None]
    j = np.arange(w, dtype=np.uint64)[None, :]
    v = i * np.uint64(2654435761) + j * np.uint64(40503) + np.uint64(1)
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)


# the golden fixtures' input constructions (tests/test_kernels_golden.py)
CONSTRUCTIONS = {
    "zeros": lambda b, w: np.zeros((b, w), dtype=np.uint32),
    "ones": lambda b, w: np.full((b, w), 0xDEADBEEF, dtype=np.uint32),
    "ramp": lambda b, w: (np.arange(b * w, dtype=np.uint64) % (1 << 32))
    .astype(np.uint32)
    .reshape(b, w),
    "weyl": _weyl,
}


def _golden_cases():
    with open(GOLDEN_PATH) as f:
        return json.load(f)["cases"]


def _port_digests(x, device="cpu"):
    return ops.digests_to_host(ops.fingerprint_blocks(x, device=device))


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: f"{c['kind']}_{c['b']}x{c['w']}")
def test_golden_digests(case):
    x = CONSTRUCTIONS[case["kind"]](case["b"], case["w"])
    np.testing.assert_array_equal(_port_digests(x), np.asarray(case["digests"], dtype=np.uint32))
    assert [f"{int(v):016x}" for v in ops.fingerprint_ints(x, device="cpu")] == case["fp64_hex"]


@pytest.mark.parametrize("w", [128, 256, 1024])
def test_random_blocks_match_reference(w):
    x = np.random.default_rng(w).integers(0, 2**32, size=(19, w), dtype=np.uint32)
    np.testing.assert_array_equal(_port_digests(x), np.asarray(ref_ops.fingerprint_blocks(x)))
    np.testing.assert_array_equal(
        ops.fingerprint_ints(x, device="cpu"), ref_ops.fingerprint_ints(x)
    )


@pytest.mark.parametrize("length", [1, 5, 127, 4095, 4097])
def test_uint8_odd_lengths_match_reference(length):
    x = np.random.default_rng(length).integers(0, 256, size=(6, length), dtype=np.uint8)
    np.testing.assert_array_equal(
        ops.fingerprint_ints(x, device="cpu"), ref_ops.fingerprint_ints(x)
    )


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_bitcast_inputs_match_reference(dtype):
    rng = np.random.default_rng(7)
    if dtype is np.int32:
        x = rng.integers(-(2**31), 2**31, size=(9, 300), dtype=np.int32)
    else:
        x = rng.standard_normal((9, 300)).astype(np.float32)
    np.testing.assert_array_equal(
        ops.fingerprint_ints(x, device="cpu"), ref_ops.fingerprint_ints(x)
    )
    # a tensor input hashes where it lies, like the numpy one
    np.testing.assert_array_equal(
        ops.fingerprint_ints(torch.from_numpy(x)), ref_ops.fingerprint_ints(x)
    )


def test_plain_version_matches_numpy_golden_models():
    rng = np.random.default_rng(3)
    # all-ones words push every 32-bit product and sum to its wrap edge
    x = np.concatenate(
        [rng.integers(0, 2**32, size=(6, 256), dtype=np.uint32),
         np.full((2, 256), 0xFFFFFFFF, dtype=np.uint32)]
    )
    t = torch.from_numpy(x.view(np.int32))
    plain = fingerprint_torch(t).numpy().view(np.uint32)
    np.testing.assert_array_equal(plain, ref_golden_numpy(x))
    np.testing.assert_array_equal(plain, fingerprint_golden_numpy(x))
    np.testing.assert_array_equal(fingerprint_ref(t).numpy().astype(np.uint32), plain)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        fingerprint(torch.zeros((2, 100), dtype=torch.int32))
    with pytest.raises(TypeError):
        fingerprint(torch.zeros((2, 128), dtype=torch.int64))
    with pytest.raises(TypeError):
        ops.fingerprint_blocks(np.zeros((2, 8), dtype=np.int16), device="cpu")


def test_host_folds_match_reference():
    rng = np.random.default_rng(11)
    fp128 = rng.integers(0, 2**32, size=(500, 4), dtype=np.uint32)
    fp128[0] = 0
    lens = rng.integers(0, 16384, size=500)
    np.testing.assert_array_equal(ops._fold64(fp128), ref_ops._fold64(fp128))
    np.testing.assert_array_equal(ops.chunk_fp64(fp128, lens), ref_ops.chunk_fp64(fp128, lens))
