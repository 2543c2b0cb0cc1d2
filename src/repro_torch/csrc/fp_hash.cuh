// The 128-bit lane-parallel block hash, shared by every kernel that hashes.
//
// The hash of the reference's `fingerprint_pallas`
// (src/repro/kernels/fingerprint.py, body `_hash_tile`), bit for bit: for
// each of 4 key sets, every 128-word group of a block is whitened lane-wise
// (xor a per-lane Weyl key, x P1, xorshift 15, x P2), reduced by a
// lane-weighted wrapping uint32 sum, and folded in group order through
// h = rotl13(h + s * P3) * P1 ^ (c + 1) * P5; then h ^= W and the xxh32
// avalanche.
//
// One warp hashes one block: lane l holds words 4l..4l+3 of every group,
// all four key sets come from those four words, and the lane sum is a
// __shfl_xor_sync butterfly (uint32 addition wraps, so its order does not
// change the result).  After the butterfly every lane holds the group sum
// and folds h redundantly; lanes 0..3 finish the four digest words.

#pragma once

#include <cstdint>

namespace fp_hash {

constexpr uint32_t P1 = 2654435761u;
constexpr uint32_t P2 = 2246822519u;
constexpr uint32_t P3 = 3266489917u;
constexpr uint32_t P4 = 668265263u;
constexpr uint32_t P5 = 374761393u;
constexpr int LANES = 128;
constexpr int NUM_HASHES = 4;

__device__ __forceinline__ uint32_t seed(int k) {
  return k == 0 ? 0x02CC5D05u : k == 1 ? 0x9E3779B1u : k == 2 ? 0x85EBCA77u : 0xC2B2AE3Du;
}

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// The per-lane keys and lane weights of words 4*lane..4*lane+3 of a group,
// and the running digest of each key set.
struct Lane {
  uint32_t key[NUM_HASHES][4];
  uint32_t mult[NUM_HASHES][4];
  uint32_t h[NUM_HASHES];

  __device__ __forceinline__ explicit Lane(int lane) {
#pragma unroll
    for (int k = 0; k < NUM_HASHES; ++k) {
      const uint32_t salt = 0xA5A5A5A5u + 0x01000193u * (uint32_t)k;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t word = (uint32_t)(lane * 4 + q);
        key[k][q] = (word * 0x9E3779B9u + salt) | 1u;
        mult[k][q] = (word * P4 + seed(k)) | 1u;
      }
      h[k] = seed(k);
    }
  }

  // The warp's lane-weighted sum of one group, for each key set, in every
  // lane.  `words` are this lane's words 4*lane..4*lane+3 of the group.
  __device__ __forceinline__ void group_sum(const uint32_t words[4], uint32_t s[NUM_HASHES]) const {
#pragma unroll
    for (int k = 0; k < NUM_HASHES; ++k) {
      uint32_t acc = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t t = (words[q] ^ key[k][q]) * P1;
        t ^= t >> 15;
        t *= P2;
        acc += t * mult[k][q];
      }
      s[k] = acc;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < NUM_HASHES; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
    }
  }

  // Fold group c's sums into the digests.
  __device__ __forceinline__ void fold(const uint32_t s[NUM_HASHES], int c) {
    const uint32_t cmix = (uint32_t)(c + 1) * P5;
#pragma unroll
    for (int k = 0; k < NUM_HASHES; ++k) h[k] = (rotl(h[k] + s[k] * P3, 13) * P1) ^ cmix;
  }

  // Digest word `lane` (0..3) of a block of w words; other lanes return 0.
  __device__ __forceinline__ uint32_t finish(int lane, int w) const {
    uint32_t r = h[0];
#pragma unroll
    for (int k = 1; k < NUM_HASHES; ++k) r = (lane == k) ? h[k] : r;
    r ^= (uint32_t)w;
    r ^= r >> 15;
    r *= P2;
    r ^= r >> 13;
    r *= P3;
    r ^= r >> 16;
    return lane < NUM_HASHES ? r : 0u;
  }
};

}  // namespace fp_hash
