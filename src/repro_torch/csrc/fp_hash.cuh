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

__host__ __device__ constexpr uint32_t seed(int k) {
  return k == 0 ? 0x02CC5D05u : k == 1 ? 0x9E3779B1u : k == 2 ? 0x85EBCA77u : 0xC2B2AE3Du;
}

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// The whitening key and the lane weight of word `word` (0..127) of a group,
// for key set k.
__host__ __device__ constexpr uint32_t word_key(uint32_t word, int k) {
  return (word * 0x9E3779B9u + 0xA5A5A5A5u + 0x01000193u * (uint32_t)k) | 1u;
}

__host__ __device__ constexpr uint32_t word_weight(uint32_t word, int k) {
  return (word * P4 + seed(k)) | 1u;
}

// One key set's fold of group c's sum s into its digest h.
__device__ __forceinline__ uint32_t fold_one(uint32_t h, uint32_t s, int c) {
  return (rotl(h + s * P3, 13) * P1) ^ ((uint32_t)(c + 1) * P5);
}

// One key set's digest word from h, for a block of w words.
__device__ __forceinline__ uint32_t finish_one(uint32_t h, int w) {
  h ^= (uint32_t)w;
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}

// Word v's term of a group sum: v whitened with its key, times its lane
// weight premultiplied by P2 (weight_p2 = word_weight * P2, since
// (t * P2) * m == t * (P2 * m) mod 2^32).
__host__ __device__ constexpr uint32_t word_term(uint32_t v, uint32_t key, uint32_t weight_p2) {
  uint32_t t = (v ^ key) * P1;
  t ^= t >> 15;
  return t * weight_p2;
}

// The lane's share of each key set's sum of a group: the term of words
// 4*lane..4*lane+3 that the warp adds up.  A kernel that gathers several groups
// before it reduces them takes each lane's shares from here, reduces the
// shares of all those groups in one exchange, and folds each key set in a
// lane of its own with fold_one and finish_one: Lane's arithmetic, bit for
// bit.
struct LaneShare {
  uint32_t key[NUM_HASHES][4];
  uint32_t weight[NUM_HASHES][4];

  __device__ __forceinline__ explicit LaneShare(int lane) {
#pragma unroll
    for (int k = 0; k < NUM_HASHES; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        key[k][q] = word_key((uint32_t)(lane * 4 + q), k);
        weight[k][q] = word_weight((uint32_t)(lane * 4 + q), k) * P2;
      }
    }
  }

  // `words` are this lane's words 4*lane..4*lane+3 of the group.
  __device__ __forceinline__ void sums(const uint32_t words[4], uint32_t s[NUM_HASHES]) const {
#pragma unroll
    for (int k = 0; k < NUM_HASHES; ++k) {
      uint32_t acc = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc += word_term(words[q], key[k][q], weight[k][q]);
      s[k] = acc;
    }
  }
};

// A lane's shares and the running digest of each key set, for a kernel that
// reduces one group at a time.
struct Lane {
  LaneShare share;
  uint32_t h[NUM_HASHES];

  __device__ __forceinline__ explicit Lane(int lane) : share(lane) {
#pragma unroll
    for (int k = 0; k < NUM_HASHES; ++k) h[k] = seed(k);
  }

  // The warp's lane-weighted sum of one group, for each key set, in every
  // lane.  `words` are this lane's words 4*lane..4*lane+3 of the group.
  __device__ __forceinline__ void group_sum(const uint32_t words[4], uint32_t s[NUM_HASHES]) const {
    share.sums(words, s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < NUM_HASHES; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
    }
  }

  // Fold group c's sums into the digests.
  __device__ __forceinline__ void fold(const uint32_t s[NUM_HASHES], int c) {
#pragma unroll
    for (int k = 0; k < NUM_HASHES; ++k) h[k] = fold_one(h[k], s[k], c);
  }

  // Digest word `lane` (0..3) of a block of w words; other lanes return 0.
  __device__ __forceinline__ uint32_t finish(int lane, int w) const {
    uint32_t r = h[0];
#pragma unroll
    for (int k = 1; k < NUM_HASHES; ++k) r = (lane == k) ? h[k] : r;
    return lane < NUM_HASHES ? finish_one(r, w) : 0u;
  }
};

// The sum of key set k over a group of 128 zero words, by the definition:
// what group_sum gives for a zero group, in any block and at any place.
__host__ __device__ constexpr uint32_t zero_group_sum_of(int k) {
  uint32_t acc = 0;
  for (uint32_t word = 0; word < (uint32_t)LANES; ++word) {
    acc += word_term(0u, word_key(word, k), word_weight(word, k) * P2);
  }
  return acc;
}

// The same, evaluated when the kernel is compiled.
__device__ __forceinline__ uint32_t zero_group_sum(int k) {
  constexpr uint32_t s0 = zero_group_sum_of(0), s1 = zero_group_sum_of(1),
                     s2 = zero_group_sum_of(2), s3 = zero_group_sum_of(3);
  return k == 0 ? s0 : k == 1 ? s1 : k == 2 ? s2 : s3;
}

}  // namespace fp_hash
