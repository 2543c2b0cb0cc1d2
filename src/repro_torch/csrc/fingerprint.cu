// 128-bit block fingerprint for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel `fingerprint_pallas`
// (src/repro/kernels/fingerprint.py, body `_hash_tile`).  The hash itself,
// bit for bit the reference's, lives in fp_hash.cuh, shared with the chunk
// kernel of cdc.cu.
//
// What bounds it: at W = 1024 words a block is 4 KB read once, 1.22 ns per
// block at 3.35 TB/s.  The hash itself needs, per word and for each of the
// 4 key sets, 3 ALU instructions (the key's xor, a shift-xor) and 3
// multiply-adds (by P1, by P2, by the lane weight into the lane sum): 0.74 ns
// per block at the ALU pipe's 64 lanes per SM, so bytes bound it.  The
// kernel issues more than that (the shuffle reduction, the fold repeated in
// every lane, addressing); PERF.md holds its measured time against the bound.
//
// Design: one warp per block row.  For each 128-word group, lane l loads
// words 4l..4l+3 as one 16-byte load, so the warp reads the group as one
// coalesced 512-byte transaction, and all four digests are computed from
// that single load.  Per-lane keys and lane multipliers depend only on the
// word index, so they are computed once into registers.  Many rows in
// flight hide the load latency.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_hash.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
fingerprint_kernel(const uint4* __restrict__ x, uint32_t* __restrict__ out, long long rows, int w) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps exit together

  fp_hash::Lane st(lane);
  const int groups = w / fp_hash::LANES;
  const uint4* src = x + row * (long long)(w / 4) + lane;
#pragma unroll 2
  for (int c = 0; c < groups; ++c) {
    const uint4 v = __ldg(src + c * (fp_hash::LANES / 4));
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t s[fp_hash::NUM_HASHES];
    st.group_sum(words, s);
    st.fold(s, c);
  }
  const uint32_t r = st.finish(lane, w);
  if (lane < fp_hash::NUM_HASHES) out[row * fp_hash::NUM_HASHES + lane] = r;
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
