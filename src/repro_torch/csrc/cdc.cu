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
// 128-word groups that hold chunk bytes: a group of zeros has a sum that is
// the same for every chunk and group (fp_hash::zero_group_sum), so a padded
// group costs only its fold.
//
// Design: a persistent grid, one warp per chunk at a time, the warps walking
// the chunks with a grid stride (a long chunk holds up only its own warp),
// each reading the next chunk's start and length before it hashes the
// current one.  The data groups go in batches of BATCH = 4:
//   - gather: for each group of the batch, lane l loads the two 16-byte
//     units that hold bytes 16l..16l+15 of the group (payload units lie in
//     one row each, 16-byte aligned), all loads of the batch issued before
//     any is used; funnel shifts by the chunk's word and byte phase align the
//     lane's four words.  Offsets are 32-bit, added to one 64-bit base per
//     chunk.
//   - hash: each lane's share of the four key sets' sums (fp_hash::LaneShare,
//     the lane weight premultiplied by P2);
//   - reduce: the BATCH x 4 shares of every lane go through shared memory
//     at once, transposed, so that lanes m and m + 16 end with the whole sum
//     of slot m (group m / 4, key set m % 4): 16 stores, 4 16-byte loads, the
//     adds and one shuffle, in place of a 5-step butterfly per group and key
//     set;
//   - fold: lane l keeps key set l % 4's digest and folds each group's sum
//     into it (one shuffle per group), so one instruction folds all four.
// The zero groups past the data fold the constant zero-group sum.  Batches
// that reach the chunk's end (or start before the payload) test each unit
// against the chunk and mask the bytes past its end; the others test
// nothing.  A unit is read only if it holds a byte of the chunk, and it
// lies in the payload; bytes outside read as zero, as in the plain version.
// Blocks of 4 warps, registers capped so that 7 fit an SM (28 warps): the
// kernel waits on latency more than on any pipe, and more warps hide more
// of it.  PERF.md holds the batch sizes, block shapes and caps tried.

#include <algorithm>
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

constexpr int WARPS_PER_BLOCK = 4;
constexpr int MIN_BLOCKS_PER_SM = 7;  // 28 warps an SM: at most 72 registers a thread
constexpr int GROUP_BYTES = fp_hash::LANES * 4;
constexpr int BATCH = 4;                            // groups reduced in one exchange
constexpr int SLOTS = BATCH * fp_hash::NUM_HASHES;  // (group, key set) sums per batch
constexpr int SLOT_STRIDE = 36;  // words per slot in the exchange: 32 shares + 4 against conflicts
constexpr int MAX_W_PAD = 1 << 24;  // keeps every chunk offset inside 32 bits
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(SLOTS <= 32 && 32 % SLOTS == 0, "each slot's sum must end in whole lanes");

// Payload word o (o >= 0) of the rows from the chunk's first row on, where
// rp points at that row's payload.
__device__ __forceinline__ const uint4* payload_unit(const uint32_t* rp, int o) {
  return reinterpret_cast<const uint4*>(rp + (o + HALO_WORDS * (o >> 9)));
}

// The raw words of the batch: for group g, the 16-byte units at words x and
// x + 4 (x = xb + 128 g, a multiple of 4).  Unchecked, unit B is read only
// where words 4.. are needed (need_b); checked, a unit is read only if its
// first word starts before the chunk's end (word hi), and never before word
// 0.  A unit not read stays zero.
template <bool CHECKED>
__device__ __forceinline__ void load_batch(const uint32_t* __restrict__ rp, int xb, int hi,
                                           bool need_b, uint32_t raw[BATCH][8]) {
#pragma unroll
  for (int g = 0; g < BATCH; ++g) {
    const int x = xb + fp_hash::LANES * g;
    const bool read_a = CHECKED ? (unsigned)x < (unsigned)hi : true;
    const bool read_b = CHECKED ? (unsigned)(x + 4) < (unsigned)hi : need_b;
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (read_a) a = __ldg(payload_unit(rp, x));
    if (read_b) b = __ldg(payload_unit(rp, x + 4));
    raw[g][0] = a.x;
    raw[g][1] = a.y;
    raw[g][2] = a.z;
    raw[g][3] = a.w;
    raw[g][4] = b.x;
    raw[g][5] = b.y;
    raw[g][6] = b.z;
    raw[g][7] = b.w;
  }
}

// The lane's four words of each group: bytes 4R + shift / 8 on of its raw
// words, R being the chunk's word phase within a 16-byte unit.
template <int R>
__device__ __forceinline__ void align_batch(const uint32_t raw[BATCH][8], int shift,
                                            uint32_t words[BATCH][4]) {
#pragma unroll
  for (int g = 0; g < BATCH; ++g) {
#pragma unroll
    for (int m = 0; m < 4; ++m) words[g][m] = __funnelshift_r(raw[g][R + m], raw[g][R + m + 1], shift);
  }
}

// Zero the bytes of groups `first`.. that lie past the chunk's end: word m of
// group g holds image bytes from 512 g + 4 m + (lane's offset); `keep0` is
// the image bytes read (end - start) less the lane's offset in the batch.
__device__ __forceinline__ void mask_batch(uint32_t words[BATCH][4], int keep0, int first) {
#pragma unroll
  for (int g = 0; g < BATCH; ++g) {
    if (g < first) continue;  // uniform: a group wholly inside the chunk
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int keep = keep0 - GROUP_BYTES * g - 4 * m;
      const uint32_t mask = keep <= 0 ? 0u : keep >= 4 ? 0xFFFFFFFFu : (1u << (8 * keep)) - 1u;
      words[g][m] &= mask;
    }
  }
}

// What a batch needs to know of its chunk, in 32-bit coordinates from the
// chunk's first row (negative only before the payload).
struct ChunkView {
  const uint32_t* rp;  // the payload of the chunk's first row
  int xa;              // the lane's first word of group 0, a multiple of 4
  int hi;              // words that start before the chunk's end
  int r, shift;        // the start's word within a 16-byte unit; its byte, in bits
  bool need_b;         // the lane's words reach the second unit
  int read_bytes;      // image bytes read: end - start
  int full, d;         // groups wholly inside the chunk; groups holding data
};

// Gather, hash, reduce and fold groups b .. b + BATCH - 1 of the chunk into
// h, the digest of key set `lane % 4`.  CHECKED: some of them reach the
// chunk's end, lie past it or start before the payload.
template <bool CHECKED>
__device__ __forceinline__ uint32_t fold_batch(const ChunkView& ck, int b, uint32_t h,
                                               const fp_hash::LaneShare& share, uint32_t* xch,
                                               int lane) {
  uint32_t raw[BATCH][8];
  load_batch<CHECKED>(ck.rp, ck.xa + fp_hash::LANES * b, ck.hi, ck.need_b, raw);
  uint32_t words[BATCH][4];
  switch (ck.r) {
    case 0: align_batch<0>(raw, ck.shift, words); break;
    case 1: align_batch<1>(raw, ck.shift, words); break;
    case 2: align_batch<2>(raw, ck.shift, words); break;
    default: align_batch<3>(raw, ck.shift, words); break;
  }
  if (CHECKED) mask_batch(words, ck.read_bytes - GROUP_BYTES * b - 16 * lane, ck.full - b);

  uint32_t s[SLOTS];
#pragma unroll
  for (int g = 0; g < BATCH; ++g) {
    if (!CHECKED || b + g < ck.d) {
      share.sums(words[g], s + fp_hash::NUM_HASHES * g);
    } else {
#pragma unroll
      for (int k = 0; k < fp_hash::NUM_HASHES; ++k) s[fp_hash::NUM_HASHES * g + k] = 0u;
    }
  }

  // transpose through shared memory: the 32 shares of slot m into lane(s) m
  __syncwarp();
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) xch[m * SLOT_STRIDE + lane] = s[m];
  __syncwarp();
  constexpr int PER_SLOT = 32 / SLOTS, SPAN = 32 / PER_SLOT;
  const uint4* slot =
      reinterpret_cast<const uint4*>(xch + (lane % SLOTS) * SLOT_STRIDE + (lane / SLOTS) * SPAN);
  uint32_t total = 0;
#pragma unroll
  for (int i = 0; i < SPAN / 4; ++i) {
    const uint4 v = slot[i];
    total += v.x + v.y + v.z + v.w;
  }
#pragma unroll
  for (int off = SLOTS; off < 32; off <<= 1) total += __shfl_xor_sync(FULL_MASK, total, off);

  const int hk = lane & (fp_hash::NUM_HASHES - 1);
#pragma unroll
  for (int g = 0; g < BATCH; ++g) {
    if (!CHECKED || b + g < ck.d) {
      const uint32_t sum = __shfl_sync(FULL_MASK, total, fp_hash::NUM_HASHES * g + hk);
      h = fp_hash::fold_one(h, sum, b + g);
    }
  }
  return h;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, MIN_BLOCKS_PER_SM)
chunk_fingerprint_kernel(const uint32_t* __restrict__ rows, long long payload_bytes,
                         const long long* __restrict__ starts, const int* __restrict__ lens,
                         uint32_t* __restrict__ out, long long chunks, int w_pad) {
  __shared__ __align__(16) uint32_t exchange[WARPS_PER_BLOCK][SLOTS * SLOT_STRIDE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* xch = exchange[warp];
  const int hk = lane & (fp_hash::NUM_HASHES - 1);  // the key set this lane folds
  const fp_hash::LaneShare share(lane);
  const uint32_t zero_sum = fp_hash::zero_group_sum(hk);
  const int groups = w_pad / fp_hash::LANES;
  const long long span = 4LL * w_pad;  // image bytes
  const long long stride = (long long)gridDim.x * WARPS_PER_BLOCK;

  // whole warps walk the chunks together, each chunk's start and length
  // read one chunk ahead
  long long chunk = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  long long next_start = chunk < chunks ? __ldg(starts + chunk) : 0;
  int next_len = chunk < chunks ? __ldg(lens + chunk) : 0;
  for (; chunk < chunks; chunk += stride) {
    const long long start = next_start;
    const int len = next_len;
    if (chunk + stride < chunks) {
      next_start = __ldg(starts + chunk + stride);
      next_len = __ldg(lens + chunk + stride);
    }
    // image bytes start .. end - 1 are read: inside the chunk, the image
    // and the payload; the rest of the image is zero
    const long long end = min(start + min((long long)len, span), payload_bytes);
    ChunkView ck;
    ck.d = end > max(start, 0LL) ? min(groups, (len - 1) / GROUP_BYTES + 1) : 0;
    uint32_t h = fp_hash::seed(hk);
    if (ck.d > 0) {  // then start > -span: the offsets below fit 32 bits
      const long long q0 = start >> 2;
      const long long row0 = max(q0, 0LL) >> 9;
      const int qrel = (int)(q0 - row0 * SEG_WORDS);
      const uint32_t* rp = rows + row0 * ROW_WORDS + HALO_WORDS;
      asm("" : "+l"(rp));  // opaque: each load adds a 32-bit offset to this one base
      ck.rp = rp;
      ck.xa = (qrel & ~3) + 4 * lane;
      ck.hi = (int)((end - row0 * SEG_BYTES + 3) >> 2);
      ck.r = qrel & 3;
      ck.shift = 8 * (int)(start & 3);
      ck.need_b = (ck.r | ck.shift) != 0;
      ck.read_bytes = (int)(end - start);
      ck.full = start >= 0 ? min(ck.d, ck.read_bytes / GROUP_BYTES) : 0;
      for (int b = 0; b < ck.d; b += BATCH) {
        h = b + BATCH <= ck.full ? fold_batch<false>(ck, b, h, share, xch, lane)
                                 : fold_batch<true>(ck, b, h, share, xch, lane);
      }
    }
    for (int c = ck.d; c < groups; ++c) h = fp_hash::fold_one(h, zero_sum, c);
    if (lane < fp_hash::NUM_HASHES) {
      out[chunk * fp_hash::NUM_HASHES + lane] = fp_hash::finish_one(h, w_pad);
    }
  }
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

// rows: (n_rows, 520) uint32, 16-byte aligned.  starts: (chunks,) int64
// stream byte offsets; lens: (chunks,) int32.  out: (chunks, 4) uint32.
// w_pad a multiple of 128, at most 2^24.  Launches at most as many blocks as
// the card holds at once.  Returns the first CUDA error, 0 if none.
extern "C" int chunk_fingerprint_launch(const void* rows, long long n_rows, const void* starts,
                                        const void* lens, void* out, long long chunks, int w_pad,
                                        void* stream) {
  if (chunks <= 0) return 0;
  if (w_pad <= 0 || w_pad % fp_hash::LANES || w_pad > MAX_W_PAD) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunk_fingerprint_kernel,
                                                        WARPS_PER_BLOCK * 32, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const long long blocks = std::min((chunks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,
                                    (long long)std::max(sms * per_sm, 1));
  chunk_fingerprint_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, n_rows * SEG_BYTES, (const long long*)starts, (const int*)lens,
      (uint32_t*)out, chunks, w_pad);
  return (int)cudaGetLastError();
}
