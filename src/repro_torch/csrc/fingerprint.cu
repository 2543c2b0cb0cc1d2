// 128-bit block fingerprint for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel `fingerprint_pallas`
// (src/repro/kernels/fingerprint.py, body `_hash_tile`).  The hash is the
// same bit for bit: for each of 4 key sets, every 128-word chunk of a block
// is whitened lane-wise (xor a per-lane Weyl key, x P1, xorshift 15, x P2),
// reduced by a lane-weighted wrapping uint32 sum, and folded in chunk order
// through h = rotl13(h + s * P3) * P1 ^ (c + 1) * P5; then h ^= W and the
// xxh32 avalanche.
//
// What bounds it: at W = 1024 words a block is 4 KB read once, 1.22 ns per
// block at 3.35 TB/s.  The hash itself needs ~28 integer operations per word
// (7 per word for each of the 4 key sets: xor, two multiplies, shift-xor,
// the lane weight's multiply and the lane sum's add), 0.87 ns per block at
// 128 operations per SM per clock, so bytes bound it.  The kernel issues
// more than that (the shuffle reduction, the fold repeated in every lane,
// addressing); PERF.md holds its measured time against the bound.
//
// Design: one warp per block row.  For each 128-word chunk, lane l loads
// words 4l..4l+3 as one 16-byte load, so the warp reads the chunk as one
// coalesced 512-byte transaction, and all four digests are computed from
// that single load.  Per-lane keys and lane multipliers depend only on the
// word index, so they are computed once into registers.  The lane-weighted
// sum is a warp butterfly of __shfl_xor_sync; uint32 addition wraps, so
// the reduction order does not change the result.  After the butterfly
// every lane holds the chunk sum and folds h redundantly; lanes 0..3 write
// the four output words.  Many rows in flight hide the load latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P1 = 2654435761u;
constexpr uint32_t P2 = 2246822519u;
constexpr uint32_t P3 = 3266489917u;
constexpr uint32_t P4 = 668265263u;
constexpr uint32_t P5 = 374761393u;
constexpr int LANES = 128;
constexpr int NUM_HASHES = 4;
constexpr int WARPS_PER_BLOCK = 8;

__constant__ uint32_t SEEDS[NUM_HASHES] = {0x02CC5D05u, 0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
fingerprint_kernel(const uint4* __restrict__ x, uint32_t* __restrict__ out, long long rows, int w) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps exit together

  uint32_t key[NUM_HASHES][4];
  uint32_t mult[NUM_HASHES][4];
  uint32_t h[NUM_HASHES];
#pragma unroll
  for (int k = 0; k < NUM_HASHES; ++k) {
    const uint32_t salt = 0xA5A5A5A5u + 0x01000193u * (uint32_t)k;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t word = (uint32_t)(lane * 4 + q);
      key[k][q] = (word * 0x9E3779B9u + salt) | 1u;
      mult[k][q] = (word * P4 + SEEDS[k]) | 1u;
    }
    h[k] = SEEDS[k];
  }

  const int chunks = w / LANES;
  const uint4* src = x + row * (long long)(w / 4) + lane;
#pragma unroll 2
  for (int c = 0; c < chunks; ++c) {
    const uint4 v = __ldg(src + c * (LANES / 4));
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t s[NUM_HASHES];
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
    const uint32_t cmix = (uint32_t)(c + 1) * P5;
#pragma unroll
    for (int k = 0; k < NUM_HASHES; ++k) h[k] = (rotl(h[k] + s[k] * P3, 13) * P1) ^ cmix;
  }

  if (lane < NUM_HASHES) {
    uint32_t r = h[0];
#pragma unroll
    for (int k = 1; k < NUM_HASHES; ++k) r = (lane == k) ? h[k] : r;
    r ^= (uint32_t)w;
    r ^= r >> 15;
    r *= P2;
    r ^= r >> 13;
    r *= P3;
    r ^= r >> 16;
    out[row * NUM_HASHES + lane] = r;
  }
}

}  // namespace

// x: (rows, w) 32-bit words, contiguous, 16-byte aligned, w a multiple of
// 128.  out: (rows, 4) uint32.  Returns cudaGetLastError() after the launch.
extern "C" int fingerprint_launch(const void* x, void* out, long long rows, int w, void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  fingerprint_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint32_t*)out, rows, w);
  return (int)cudaGetLastError();
}
