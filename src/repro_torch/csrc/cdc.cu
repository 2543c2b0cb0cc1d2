// Content-defined chunking on Hopper (sm_90a): the Gear candidate kernel and
// the fused chunk gather + fingerprint kernel.
//
// Both read the haloed row layout of `pack_haloed`: rows of 520 little-endian
// uint32 words, an 8-word (32-byte) halo carrying the previous row's tail
// (zeros at a buffer's first row) and 512 payload words (2048 bytes).
// Payload byte p of the concatenated stream lives at row p / 2048, word
// 8 + (p % 2048) / 4, byte p % 4.
//
// ---------------------------------------------------------------------------
// cdc_candidates_kernel replaces the reference's Pallas kernel
// `cdc_candidates_pallas` (src/repro/kernels/cdc.py, body `_cdc_kernel`).
// Byte i is a cut candidate iff (h_i & (avg - 1)) == 0, where
// h_i = sum_{j<32} GEAR[b_{i-j}] << j (mod 2^32) and GEAR[b] is the avalanche
// mix of b * P1 + GEAR_SEED.  Output: one uint32 per payload word, bit k
// flagging byte 4t + k, the reference's layout.
//
// What bounds it: each row is 2080 bytes read and 2048 written, about
// 0.65 ms per GiB of payload at 3.35 TB/s.  By the definition a byte needs
// 9 instructions on the ALU pipe (take the byte, 3 shift-xors of the GEAR
// mix, the mask test, the flag bit) and 4 multiply-adds on the FMA pipe
// (the mix's 3 multiplies, the recurrence 2h + g): about 0.58 ms per GiB at
// the ALU pipe's 64 lanes per SM, so bytes bound it, narrowly.  The warm-up
// below adds about 3.5 ALU instructions per byte (0.80 ms per GiB in all),
// so the kernel is nearer its ALU limit than its memory limit.
//
// Design: the windowed sum equals the recurrence h = (h << 1) + GEAR[b]
// once 32 bytes have passed, since older terms are shifted out.  One warp
// takes one row; lane l owns payload words 16l..16l+15, warms up on the 8
// words (32 bytes) before them (the halo for lane 0) and walks the
// recurrence.  The warm-up mixes 32 bytes for every 64 flagged, the price of
// independent lanes.  A block of 8 warps stages its 8 rows in shared memory
// with one coalesced 16-byte load per thread, and stages the flags there
// before one coalesced 16-byte store per thread.  Shared memory is skewed by
// one word per 16 (w -> w + w / 16), so the lanes' runs, 16 words apart,
// fall in distinct banks.
//
// ---------------------------------------------------------------------------
// chunk_fingerprint_kernel replaces the reference's fused gather
// `_chunk_fp_jit` (src/repro/kernels/ops.py), a jit that gathers every chunk
// out of the resident rows, zero-pads it to w_pad words and feeds the
// result to `fingerprint_pallas`.  Here gather and hash are one launch, and
// the padded image is never written.
//
// What bounds it: each chunk's bytes read once, 12 bytes of start and
// length, 16 bytes of digest written: about 0.32 ms per GiB of chunks.  The
// hash needs 12 ALU instructions and 12 multiply-adds per word only for the
// 128-word groups that hold chunk bytes: a group of zeros has a lane sum
// that is the same for every group, so a padded group costs only its fold.
//
// Design: one warp per chunk.  For each 512-byte group that holds chunk
// bytes, lane l gathers bytes 16l..16l+15 of the group as four words: five
// aligned payload-word loads (skipping each row's halo) and funnel shifts
// by 8 * (start % 4), with bytes past the chunk's length masked to zero.
// Then the shared block hash of fp_hash.cuh.  The groups past the data fold
// the zero group's lane sum, computed once per chunk.  Loads stay inside the
// chunk and the payload whatever the starts and lengths: bytes outside read
// as zero, as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_hash.cuh"

namespace {

constexpr uint32_t GEAR_SEED = 0x1F83D9ABu;
constexpr int HALO_WORDS = 8;
constexpr int SEG_WORDS = 512;
constexpr int ROW_WORDS = HALO_WORDS + SEG_WORDS;
constexpr int SEG_BYTES = SEG_WORDS * 4;

// -- Gear candidates ---------------------------------------------------------

constexpr int RUN = SEG_WORDS / 32;  // payload words per lane
constexpr int ROWS_PER_BLOCK = 8;    // one warp per row
constexpr int SIN = ROW_WORDS + ROW_WORDS / 16 + 1;
constexpr int SOUT = SEG_WORDS + SEG_WORDS / 16;

__device__ __forceinline__ int skew(int w) { return w + (w >> 4); }

__device__ __forceinline__ uint32_t gear(uint32_t b) {
  uint32_t h = b * fp_hash::P1 + GEAR_SEED;
  h ^= h >> 15;
  h *= fp_hash::P2;
  h ^= h >> 13;
  h *= fp_hash::P3;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
cdc_candidates_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, long long rows,
                      uint32_t mask) {
  __shared__ uint32_t sin[ROWS_PER_BLOCK * SIN];
  __shared__ uint32_t sout[ROWS_PER_BLOCK * SOUT];
  const long long row0 = (long long)blockIdx.x * ROWS_PER_BLOCK;
  const int nrows = (int)min((long long)ROWS_PER_BLOCK, rows - row0);

  const uint4* src = in + row0 * (ROW_WORDS / 4);
  for (int i = threadIdx.x; i < nrows * (ROW_WORDS / 4); i += blockDim.x) {
    const int r = i / (ROW_WORDS / 4), w = (i % (ROW_WORDS / 4)) * 4;
    const uint4 v = __ldg(src + i);
    uint32_t* d = sin + r * SIN + skew(w);  // w % 16 <= 12: the 4 words stay adjacent
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < nrows) {
    const uint32_t* s = sin + warp * SIN;
    uint32_t* o = sout + warp * SOUT;
    uint32_t h = 0;
    // row words RUN*lane .. +7 are the 32 bytes before this lane's run
#pragma unroll
    for (int i = 0; i < HALO_WORDS; ++i) {
      const uint32_t v = s[skew(RUN * lane + i)];
#pragma unroll
      for (int k = 0; k < 4; ++k) h = (h << 1) + gear((v >> (8 * k)) & 0xFFu);
    }
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      const uint32_t v = s[skew(RUN * lane + HALO_WORDS + i)];
      uint32_t flags = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        h = (h << 1) + gear((v >> (8 * k)) & 0xFFu);
        flags |= (uint32_t)((h & mask) == 0u) << k;
      }
      o[skew(RUN * lane + i)] = flags;
    }
  }
  __syncthreads();

  uint4* dst = out + row0 * (SEG_WORDS / 4);
  for (int i = threadIdx.x; i < nrows * (SEG_WORDS / 4); i += blockDim.x) {
    const int r = i / (SEG_WORDS / 4), p = (i % (SEG_WORDS / 4)) * 4;
    const uint32_t* q = sout + r * SOUT + skew(p);
    dst[i] = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

// -- chunk gather + fingerprint -----------------------------------------------

constexpr int WARPS_PER_BLOCK = 8;
constexpr int GROUP_BYTES = fp_hash::LANES * 4;

// Payload word q of the concatenated stream: row q / 512, column 8 + q % 512.
__device__ __forceinline__ uint32_t payload_word(const uint32_t* __restrict__ rows, long long q) {
  return __ldg(rows + q + (long long)HALO_WORDS * ((q >> 9) + 1));
}

// Stream bytes p..p+15 as four little-endian words, zero before byte 0 and
// from byte `end` on.
__device__ __forceinline__ void gather16(const uint32_t* __restrict__ rows, long long p,
                                         long long end, uint32_t words[4]) {
  const long long q0 = p >> 2;
  const int shift = 8 * (int)(p & 3);
  uint32_t w[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const long long q = q0 + j;
    w[j] = (q >= 0 && q * 4 < end) ? payload_word(rows, q) : 0u;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    uint32_t v = __funnelshift_r(w[m], w[m + 1], shift);
    const long long keep = end - (p + 4 * m);  // bytes of v inside the chunk
    if (keep <= 0) {
      v = 0u;
    } else if (keep < 4) {
      v &= (1u << (8 * (int)keep)) - 1u;
    }
    words[m] = v;
  }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
chunk_fingerprint_kernel(const uint32_t* __restrict__ rows, long long payload_bytes,
                         const long long* __restrict__ starts, const int* __restrict__ lens,
                         uint32_t* __restrict__ out, long long chunks, int w_pad) {
  const int lane = threadIdx.x & 31;
  const long long chunk = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (chunk >= chunks) return;  // whole warps exit together

  const long long start = starts[chunk];
  const int len = lens[chunk];
  const long long end = min(start + len, payload_bytes);
  fp_hash::Lane st(lane);
  const int groups = w_pad / fp_hash::LANES;
  const int data_groups = min(groups, (len + GROUP_BYTES - 1) / GROUP_BYTES);
  uint32_t zero_s[fp_hash::NUM_HASHES];
  if (data_groups < groups) {  // uniform across the warp
    const uint32_t zeros[4] = {0u, 0u, 0u, 0u};
    st.group_sum(zeros, zero_s);
  }
  for (int c = 0; c < data_groups; ++c) {
    uint32_t words[4];
    gather16(rows, start + (long long)c * GROUP_BYTES + 16 * lane, end, words);
    uint32_t s[fp_hash::NUM_HASHES];
    st.group_sum(words, s);
    st.fold(s, c);
  }
  for (int c = data_groups; c < groups; ++c) st.fold(zero_s, c);
  const uint32_t r = st.finish(lane, w_pad);
  if (lane < fp_hash::NUM_HASHES) out[chunk * fp_hash::NUM_HASHES + lane] = r;
}

}  // namespace

// rows: (n_rows, 520) uint32, contiguous, 16-byte aligned.  flags:
// (n_rows, 512) uint32.  mask = avg_size - 1.  Returns cudaGetLastError().
extern "C" int cdc_candidates_launch(const void* rows, void* flags, long long n_rows,
                                     unsigned int mask, void* stream) {
  if (n_rows <= 0) return 0;
  const long long blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  cdc_candidates_kernel<<<(unsigned)blocks, ROWS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)rows, (uint4*)flags, n_rows, (uint32_t)mask);
  return (int)cudaGetLastError();
}

// rows: (n_rows, 520) uint32.  starts: (chunks,) int64 stream byte offsets;
// lens: (chunks,) int32 in [0, 4 * w_pad].  out: (chunks, 4) uint32.
// w_pad a multiple of 128.  Returns cudaGetLastError() after the launch.
extern "C" int chunk_fingerprint_launch(const void* rows, long long n_rows, const void* starts,
                                        const void* lens, void* out, long long chunks, int w_pad,
                                        void* stream) {
  if (chunks <= 0) return 0;
  const long long blocks = (chunks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  chunk_fingerprint_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, n_rows * SEG_BYTES, (const long long*)starts, (const int*)lens,
      (uint32_t*)out, chunks, w_pad);
  return (int)cudaGetLastError();
}
