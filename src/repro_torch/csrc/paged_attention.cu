// Decode attention over a paged KV cache for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel `paged_attention`
// (src/repro/kernels/paged_attention.py, body `_paged_attn_kernel`): one
// query token per sequence b, H query heads over KVH key/value heads (GQA),
// keys and values read page by page through block_table[b, :], positions at
// or past lengths[b] masked with the finite -1e30, q scaled by D^-0.5 in
// float32, an online (flash-style) softmax in float32, the output in q's type.
//
// What bounds it: bytes.  Each needed K and V page is read once, each query
// and output row once; the work is 4 * D operations per head and position,
// some 2 operations per byte read in bf16, far below what the card can do
// per byte.  Pages shared between sequences (deduplicated prefixes) need
// reading only once in all; this kernel reads them once per sequence and
// leaves the repeats to the L2 cache.
//
// Design (the Hopper redesign, flash-decoding style; PERF.md §6 row 7 dates
// it): no row's pages are walked by one block alone, and each K and V
// element is multiplied once per block on the tensor cores where the type
// allows.
//
// * Split over pages.  The grid is (sequence, KV head, split); a split is a
//   fixed run of `pages_per_split` pages (the wrapper picks 256 tokens'
//   worth from the page size; a table of at most that many pages is one
//   split).  A split wholly past a row's length (length > 0) returns at
//   once and takes no part in the merge, so the merge never sees a max of
//   -inf.  A row of length 0 keeps every page of its table, every logit
//   -1e30, and its result is the mean of V over all pps * page slots, as
//   the reference gives.  A row whose pages fit one split takes the
//   one-pass path: it writes its output directly, with no workspace and no
//   merge.
// * Merge.  Otherwise each split writes, per query head of its group, its
//   float32 (m, l, acc[D]) to a workspace the wrapper allocates; after a
//   __threadfence, one thread per block takes a ticket (atomicAdd on a
//   per-(row, KV head) counter the launcher zeroes with cudaMemsetAsync), and
//   the block that draws the last ticket merges the row's splits with
//   log-sum-exp weights (`combine`), reading every split from the workspace
//   (its own too) in split order: M = max m_s, L = sum l_s e^(m_s - M),
//   o = sum acc_s e^(m_s - M) / L.  No float atomics and a fixed order: two
//   calls on the same inputs give the same bits, and so do two rows with
//   the same inputs.
// * bf16 with G <= 16 (TinyLlama's 8), on the tensor cores
//   (`paged_attention_mma_kernel`): a block of 4 warps, warp w taking pages
//   w, w + 4, ... of the split, each page for all G query heads at once:
//   S = q K^T and o += P V as mma.sync m16n8k16 (bf16 in, float32
//   accumulate), the query heads as the 16 rows (rows past G are zero),
//   K and V fed by ldmatrix (V transposed), P taken from the logits'
//   accumulator fragments as bf16 (and l summing those rounded values, so
//   the output is an exact convex combination of V under the weights used).
//   Each K and V element is read from shared memory once per block, not
//   once per query head.  The 4 warps' states are combined in shared memory
//   at the split's end (`combine`, in warp order).
// * float32, or G > 16, on the CUDA cores (`paged_attention_kernel`): one
//   warp per query head.  For the logits, lane l takes token l % 16 (and
//   l % 16 + 16 when PAGE is 32) and the even or odd chunks of its row, its
//   half of q in registers for the whole split; max and sum by shuffles over
//   16 lanes; for P.V the lanes run over (chunk of D, token group), reading
//   whole V rows per instruction, the token groups summed by shuffles once
//   at the split's end.
// * Pages in flight.  The split's page ids are read into shared memory once,
//   beside the row's length.  Each page's K and V slices for the block's KV
//   head (PAGE x D each, token rows kvh * D apart) arrive by 16-byte
//   cp.async, K (and in the bf16 kernel V) chunks XOR-swizzled by token so
//   that 8 consecutive tokens' rows hit distinct banks (conflict-free
//   ldmatrix and quarter-warp loads).  The bf16 kernel gives each warp a ring
//   of 3 pages (12 KB at TinyLlama's shape, 2 pages ahead of the math); the
//   float kernel a block ring of 4 pages (3 when a page's K and V exceed 8
//   KB), 3 ahead.  Little's law at 3.35 TB/s and about 1 us from request to
//   data wants some 3.4 MB in flight across the card; at TinyLlama's bf16
//   shape 4 blocks of 4 warps fit on each of 132 SMs (48 KB of rings each),
//   each warp 8 KB ahead: some 17 MB, so bytes in flight do not bound it.
//   What does is each block's chain of dependent steps (length and ids,
//   the first pages, the math, the combine, the ticket, the merge) at 16
//   warps per SM; PERF.md has the measurements.
//
// An id outside [0, num_pages) is clamped, as a JAX gather clamps its index.

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// One 16-byte chunk of T as floats.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether this block is the last of `used` to arrive at `ticket`.  Every
// thread has written its partial results before the call; the fences make
// them visible to the block that draws the last ticket.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int used) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == used - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

template <bool GLOBAL>
__device__ __forceinline__ float load_f(const float* p) {
  if constexpr (GLOBAL) return __ldcg(p);  // written by other blocks: read at L2
  return *p;
}
template <bool GLOBAL>
__device__ __forceinline__ float4 load_f4(const float* p) {
  if constexpr (GLOBAL) return __ldcg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

// Combines `parts` partial softmax states of the `groups` query heads of a
// (row, KV head): part j's (m, l) for head h at ml[(j * groups + h) * 2],
// its acc at acc[(j * groups + h) * D] (in global memory when GLOBAL, else
// in shared memory).  Thread h first finds M = max_j m_j, the weights
// w_j = e^(m_j - M) and L = sum_j l_j w_j, in part order, into shared memory
// `wsm` ([parts][groups] weights, then M and L per head); a part with no
// token (m = -inf, l = 0) weighs 0.  Then every thread sums 4 values of
// a = sum_j acc_j w_j at a time, in part order, and calls
// emit(h, d, a, M, L) for dimensions d .. d + 3 of head h.  No float
// atomics and a fixed order: the same inputs give the same bits.
template <bool GLOBAL, int D, typename Emit>
__device__ void combine(const float* acc, const float* ml, int parts, int groups, float* wsm,
                        Emit emit) {
  for (int h = threadIdx.x; h < groups; h += blockDim.x) {
    float mm = __int_as_float(0xff800000);
#pragma unroll 8
    for (int j = 0; j < parts; ++j) mm = fmaxf(mm, load_f<GLOBAL>(ml + (j * groups + h) * 2));
    float lsum = 0.f;
#pragma unroll 8
    for (int j = 0; j < parts; ++j) {
      const float w = expf(load_f<GLOBAL>(ml + (j * groups + h) * 2) - mm);
      wsm[j * groups + h] = w;
      lsum = fmaf(load_f<GLOBAL>(ml + (j * groups + h) * 2 + 1), w, lsum);
    }
    wsm[parts * groups + h] = mm;
    wsm[(parts + 1) * groups + h] = lsum;
  }
  __syncthreads();
  for (int e = threadIdx.x * 4; e < groups * D; e += blockDim.x * 4) {
    const int h = e / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < parts; ++j) {
      const float w = wsm[j * groups + h];
      const float4 v = load_f4<GLOBAL>(acc + (long long)j * groups * D + e);
      a.x = fmaf(v.x, w, a.x);
      a.y = fmaf(v.y, w, a.y);
      a.z = fmaf(v.z, w, a.z);
      a.w = fmaf(v.w, w, a.w);
    }
    emit(h, e - h * D, a, wsm[parts * groups + h], wsm[(parts + 1) * groups + h]);
  }
}

// Writes o = a / max(L, 1e-30) for dimensions d .. d + 3 of row `o`.
template <typename T>
__device__ __forceinline__ void store4(T* o, float4 a, float lsum) {
  const float denom = fmaxf(lsum, 1e-30f);
  store(o, a.x / denom);
  store(o + 1, a.y / denom);
  store(o + 2, a.z / denom);
  store(o + 3, a.w / denom);
}

template <typename T, int D, int PAGE>
struct Shape {
  static constexpr int CH = Chunk<T>::N;       // elements per 16-byte chunk
  static constexpr int NCH = D / CH;           // chunks per token row (8, 16 or 32)
  static constexpr int PAGE_CH = PAGE * NCH;   // chunks per page of K (or of V)
  static constexpr int SUB = PAGE / 16;        // tokens per lane in the logits
  static constexpr int TG = 32 / NCH;          // token groups in P.V
  static constexpr int STAGES = 2 * PAGE * D * (int)sizeof(T) <= 8192 ? 4 : 3;
  static_assert(SUB == 1 || SUB == 2, "PAGE must be 16 or 32");
  static_assert(TG >= 1 && NCH % 2 == 0, "D must be 64 or 128");
};

template <typename T, int D, int PAGE, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT == 256 ? 2 : 1)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                       const int* __restrict__ table, const int* __restrict__ lengths,
                       T* __restrict__ out, float* __restrict__ ws, int num_pages, int pps,
                       int kvh, int pages_per_split, int nsplit, float scale) {
  using S = Shape<T, D, PAGE>;
  constexpr int CH = S::CH, NCH = S::NCH, STAGES = S::STAGES;

  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x >> 5;
  T* ks = reinterpret_cast<T*>(smem);                   // [STAGES][PAGE][D], chunks swizzled
  T* vs = ks + STAGES * PAGE * D;                       // [STAGES][PAGE][D]
  float* ps = reinterpret_cast<float*>(vs + STAGES * PAGE * D);  // [G][PAGE]
  int* ids = reinterpret_cast<int*>(ps + groups * PAGE);         // [pages_per_split]
  // then the merge's weights: [nsplit + 2][G] floats

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x % nsplit, bg = blockIdx.x / nsplit;
  const int b = bg / kvh, g = bg % kvh;
  const int heads = kvh * groups, h = g * groups + warp;
  const int first = split * pages_per_split;
  // the split's page ids, read beside the row's length rather than after it
  const int n_ids = min(pages_per_split, pps - first);
  const int pid = threadIdx.x < n_ids ? table[(long long)b * pps + first + threadIdx.x] : 0;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min((len + PAGE - 1) / PAGE, pps) : pps;
  if (first >= n_pages) return;  // wholly past the row's length: adds nothing
  const int used = (n_pages + pages_per_split - 1) / pages_per_split;
  const int n = min(pages_per_split, n_pages - first);

  if (threadIdx.x < n) ids[threadIdx.x] = min(max(pid, 0), num_pages - 1);
  for (int i = threadIdx.x + blockDim.x; i < n; i += blockDim.x)
    ids[i] = min(max(table[(long long)b * pps + first + i], 0), num_pages - 1);
  __syncthreads();

  auto stage = [&](int i) {  // page i of the split into buffer i % STAGES
    const int buf = i % STAGES;
    const long long row0 = ((long long)ids[i] * PAGE * kvh + g) * D;  // token t at + t * kvh * D
    for (int c = threadIdx.x; c < 2 * S::PAGE_CH; c += blockDim.x) {
      const int is_v = c >= S::PAGE_CH;
      const int r = is_v ? c - S::PAGE_CH : c;
      const int t = r / NCH, ch = r % NCH;
      const long long off = row0 + (long long)t * kvh * D + ch * CH;
      const int phys = is_v ? ch : (ch ^ (t & (NCH - 1)));
      T* dst = (is_v ? vs : ks) + (buf * PAGE + t) * D + phys * CH;
      cp_async16(dst, (is_v ? vp : kp) + off);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n) stage(j);
    cp_async_commit();
  }

  // this lane's half of q (chunks part, part + 2, ...), scaled, in registers
  const int tl = lane & 15, part = lane >> 4;
  float qr[D / 2];
  const T* qh = q + ((long long)b * heads + h) * D;
#pragma unroll
  for (int i = 0; i < NCH / 2; ++i) {
    Chunk<T>::load(qh + (part + 2 * i) * CH, qr + i * CH);
#pragma unroll
    for (int e = 0; e < CH; ++e) qr[i * CH + e] *= scale;
  }

  const int c = lane % NCH, tg = lane / NCH;  // P.V: chunk of D, token group
  float m = __int_as_float(0xff800000), l = 0.f, acc[CH];  // m starts at -inf
#pragma unroll
  for (int e = 0; e < CH; ++e) acc[e] = 0.f;
  float* pw = ps + warp * PAGE;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // page i has landed
    __syncthreads();              // ... for every thread; buffer (i - 1) % STAGES is free
    if (i + STAGES - 1 < n) stage(i + STAGES - 1);
    cp_async_commit();
    const int buf = i % STAGES;
    const int pos0 = (first + i) * PAGE;

    float s[S::SUB], mx = __int_as_float(0xff800000);
#pragma unroll
    for (int j = 0; j < S::SUB; ++j) {
      const int t = tl + 16 * j;
      const T* krow = ks + (buf * PAGE + t) * D;
      float dot = 0.f;
#pragma unroll
      for (int ii = 0; ii < NCH / 2; ++ii) {
        const int ch = part + 2 * ii;
        float kf[CH];
        Chunk<T>::load(krow + (ch ^ (t & (NCH - 1))) * CH, kf);
#pragma unroll
        for (int e = 0; e < CH; ++e) dot = fmaf(qr[ii * CH + e], kf[e], dot);
      }
      dot += __shfl_xor_sync(FULL, dot, 16);
      s[j] = pos0 + t < len ? dot : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < S::SUB; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
      if (part == 0) pw[tl + 16 * j] = s[j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(FULL, psum, off);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();

    const T* vb = vs + buf * PAGE * D + c * CH;
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[e] *= corr;
#pragma unroll
    for (int t = tg; t < PAGE; t += S::TG) {
      const float pt = pw[t];
      float vf[CH];
      Chunk<T>::load(vb + t * D, vf);
#pragma unroll
      for (int e = 0; e < CH; ++e) acc[e] = fmaf(pt, vf[e], acc[e]);
    }
    // the next iteration's __syncthreads orders these reads before the buffer
    // and pw are written again
  }
#pragma unroll
  for (int off = NCH; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[e] += __shfl_xor_sync(FULL, acc[e], off);
  }

  const long long orow = ((long long)b * heads + h) * D;
  if (used == 1) {  // the whole row in this split: no merge
    if (tg == 0) {
      const float denom = fmaxf(l, 1e-30f);
#pragma unroll
      for (int e = 0; e < CH; ++e) store(out + orow + c * CH + e, acc[e] / denom);
    }
    return;
  }

  // workspace: acc [blocks][G][D], then (m, l) [blocks][G][2], then tickets [B * KVH]
  float* acc_ws = ws;
  float* ml_ws = ws + (long long)gridDim.x * groups * D;
  int* tickets = reinterpret_cast<int*>(ml_ws + (long long)gridDim.x * groups * 2);
  const long long slot = (long long)blockIdx.x * groups + warp;
  if (tg == 0) {
#pragma unroll
    for (int e = 0; e < CH; e += 4)
      *reinterpret_cast<float4*>(acc_ws + slot * D + c * CH + e) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  }
  if (lane == 0) *reinterpret_cast<float2*>(ml_ws + slot * 2) = make_float2(m, l);
  if (!last_to_arrive(tickets + bg, used)) return;
  // the last block of this (row, KV head) merges its splits, in split order
  T* orow0 = out + ((long long)b * heads + g * groups) * D;
  combine<true, D>(acc_ws + (long long)bg * nsplit * groups * D,
                   ml_ws + (long long)bg * nsplit * groups * 2, used, groups,
                   reinterpret_cast<float*>(ids + pages_per_split),
                   [&](int hh, int d, float4 a, float, float lsum) {
                     store4(orow0 + hh * D + d, a, lsum);
                   });
}

// -- bf16 on the tensor cores: one warp per (row, KV head, split) ---------------

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// c += a (16 x 16, rows) * b (16 x 8, columns), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Warps of a tensor-core block, and the bytes of each warp's ring of pages
// (at least 3 pages).
constexpr int MMA_WARPS = 4;
constexpr int MMA_RING_BYTES = 12288;

template <int D, int PAGE>
struct MmaShape {
  static constexpr int NCH = D / 8;                  // 16-byte chunks per token row
  static constexpr int PAGE_CH = PAGE * NCH;         // chunks per page of K (or of V)
  static constexpr int PAGE_BYTES = 2 * PAGE * D * 2;  // K and V slices of a page
  static constexpr int RING = MMA_RING_BYTES / PAGE_BYTES > 3 ? MMA_RING_BYTES / PAGE_BYTES : 3;
  static constexpr int SMEM_RING = MMA_WARPS * RING * PAGE_BYTES;
  static constexpr int KS = D / 16;                  // k-steps of q . k
  static constexpr int NT = PAGE / 8;                // 8-token tiles of a page
  static constexpr int DT = D / 8;                   // 8-dimension tiles of the output
  // the warps' partial states, (m, l) and acc per head, fit in the rings
  static_assert(MMA_WARPS * 16 * (D + 2) * 4 <= SMEM_RING, "ring too small for the partials");
};

// One block of MMA_WARPS warps per (row, KV head, split); warp w takes pages
// w, w + MMA_WARPS, ... of the split through its own ring.  Rows of the
// 16-row tiles are the group's query heads (G <= 16; rows past G are zero
// queries whose results are dropped).  Lane l owns rows l / 4 and l / 4 + 8
// and, of each 8-column tile, columns 2 (l % 4) and 2 (l % 4) + 1.
template <int D, int PAGE>
__global__ void __launch_bounds__(32 * MMA_WARPS)
paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ kp,
                           const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
                           const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ ws, int num_pages, int pps, int kvh, int groups,
                           int pages_per_split, int nsplit, float scale) {
  using S = MmaShape<D, PAGE>;
  constexpr int NCH = S::NCH, RING = S::RING, W = MMA_WARPS;
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* ks = reinterpret_cast<bf16*>(smem) + warp * 2 * RING * PAGE * D;  // [RING][PAGE][D]
  bf16* vs = ks + RING * PAGE * D;                                        // [RING][PAGE][D]
  int* ids = reinterpret_cast<int*>(smem + S::SMEM_RING);                 // [pages_per_split]
  float* wsm = reinterpret_cast<float*>(ids + pages_per_split);  // [max(W, nsplit) + 2][G]

  const int split = blockIdx.x % nsplit, bg = blockIdx.x / nsplit;
  const int b = bg / kvh, g = bg % kvh;
  const int heads = kvh * groups;
  const int first = split * pages_per_split;
  // the split's page ids, read beside the row's length rather than after it
  const int n_ids = min(pages_per_split, pps - first);
  const int pid = threadIdx.x < n_ids ? table[(long long)b * pps + first + threadIdx.x] : 0;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min((len + PAGE - 1) / PAGE, pps) : pps;
  if (first >= n_pages) return;  // wholly past the row's length: adds nothing
  const int used = (n_pages + pages_per_split - 1) / pages_per_split;
  const int n_split = min(pages_per_split, n_pages - first);
  const int n = n_split > warp ? (n_split - warp + W - 1) / W : 0;  // this warp's pages

  if (threadIdx.x < n_split) ids[threadIdx.x] = min(max(pid, 0), num_pages - 1);
  for (int i = threadIdx.x + blockDim.x; i < n_split; i += blockDim.x)
    ids[i] = min(max(table[(long long)b * pps + first + i], 0), num_pages - 1);
  __syncthreads();

  auto stage = [&](int j) {  // this warp's page j (split page warp + W j) into slot j % RING
    const long long row0 = ((long long)ids[warp + W * j] * PAGE * kvh + g) * D;  // + t * kvh * D
#pragma unroll
    for (int u = 0; u < S::PAGE_CH / 32; ++u) {
      const int c = lane + 32 * u, t = c / NCH, ch = c % NCH;
      const long long off = row0 + (long long)t * kvh * D + ch * 8;
      const int dst = ((j % RING) * PAGE + t) * D + (ch ^ (t & (NCH - 1))) * 8;
      cp_async16(ks + dst, kp + off);
      cp_async16(vs + dst, vp + off);
    }
  };
#pragma unroll
  for (int j = 0; j < RING - 1; ++j) {
    if (j < n) stage(j);
    cp_async_commit();
  }

  const int r0 = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, first column
  // q as the A operand: rows r0, r0 + 8 (zero past the group), k-step columns
  unsigned qa[S::KS][4];
  {
    const unsigned* q0 = reinterpret_cast<const unsigned*>(
        q + ((long long)b * heads + g * groups + r0) * D);
    const unsigned* q1 = reinterpret_cast<const unsigned*>(
        q + ((long long)b * heads + g * groups + r0 + 8) * D);
    const bool v0 = r0 < groups, v1 = r0 + 8 < groups;
#pragma unroll
    for (int k = 0; k < S::KS; ++k) {
      qa[k][0] = v0 ? q0[(k * 16 + c2) / 2] : 0u;
      qa[k][1] = v1 ? q1[(k * 16 + c2) / 2] : 0u;
      qa[k][2] = v0 ? q0[(k * 16 + 8 + c2) / 2] : 0u;
      qa[k][3] = v1 ? q1[(k * 16 + 8 + c2) / 2] : 0u;
    }
  }
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int mi = lane >> 3, mj = lane & 7;

  float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)}, l[2] = {0.f, 0.f};
  float acc[S::DT][4];
#pragma unroll
  for (int t = 0; t < S::DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<RING - 2>();  // page i has landed
    __syncwarp();               // ... for every lane; slot (i - 1) % RING is free
    if (i + RING - 1 < n) stage(i + RING - 1);
    cp_async_commit();
    const bf16* kb = ks + (i % RING) * PAGE * D;
    const bf16* vb = vs + (i % RING) * PAGE * D;
    const int pos0 = (first + warp + W * i) * PAGE;

    // logits S = q K^T: rows heads, columns the page's tokens
    float sc[S::NT][4];
#pragma unroll
    for (int t = 0; t < S::NT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int t = 0; t < S::NT; t += 2) {
#pragma unroll
      for (int k = 0; k < S::KS; ++k) {
        const int tok = (t + (mi >> 1)) * 8 + mj, ch = 2 * k + (mi & 1);
        unsigned kb4[4];
        ldmatrix_x4(kb4, kb + tok * D + (ch ^ (tok & (NCH - 1))) * 8);
        mma_bf16(sc[t], qa[k], kb4[0], kb4[1]);
        mma_bf16(sc[t + 1], qa[k], kb4[2], kb4[3]);
      }
    }
    // scale, mask, the online softmax per row; p rounded to bf16 as the P.V
    // product takes it, and l sums the rounded values
    float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
    for (int t = 0; t < S::NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = pos0 + t * 8 + c2 + (e & 1) < len ? sc[t][e] * scale : NEG_INF;
        sc[t][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
    unsigned pa[S::NT][2];  // p as bf16 pairs: [tile][row]
#pragma unroll
    for (int t = 0; t < S::NT; ++t) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        pa[t][r] = pack_bf16(__expf(sc[t][2 * r] - m[r]), __expf(sc[t][2 * r + 1] - m[r]));
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[t][r]));
        psum[r] += f.x + f.y;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(FULL, psum[r], 1);
      psum[r] += __shfl_xor_sync(FULL, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int t = 0; t < S::DT; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }
    // o += P V: P's fragments are the logits' own, 16 tokens per k-step
#pragma unroll
    for (int kt = 0; kt < PAGE / 16; ++kt) {
      const unsigned a[4] = {pa[2 * kt][0], pa[2 * kt][1], pa[2 * kt + 1][0], pa[2 * kt + 1][1]};
#pragma unroll
      for (int t = 0; t < S::DT; t += 2) {
        const int tok = kt * 16 + (mi & 1) * 8 + mj, ch = t + (mi >> 1);
        unsigned vb4[4];
        ldmatrix_x4_trans(vb4, vb + tok * D + (ch ^ (tok & (NCH - 1))) * 8);
        mma_bf16(acc[t], a, vb4[0], vb4[1]);
        mma_bf16(acc[t + 1], a, vb4[2], vb4[3]);
      }
    }
  }

  // the warps' partial states into shared memory (over the rings, once every
  // warp is done with its own); a warp with no page leaves m = -inf, l = 0
  __syncthreads();
  float* pacc = reinterpret_cast<float*>(smem);  // [W][G][D]
  float* pml = pacc + W * groups * D;            // [W][G][2]
  const bool v0 = r0 < groups, v1 = r0 + 8 < groups;
  const int prow = warp * groups + r0;
#pragma unroll
  for (int t = 0; t < S::DT; ++t) {
    if (v0) *reinterpret_cast<float2*>(pacc + prow * D + t * 8 + c2) = make_float2(acc[t][0], acc[t][1]);
    if (v1)
      *reinterpret_cast<float2*>(pacc + (prow + 8) * D + t * 8 + c2) = make_float2(acc[t][2], acc[t][3]);
  }
  if (c2 == 0 && v0) *reinterpret_cast<float2*>(pml + prow * 2) = make_float2(m[0], l[0]);
  if (c2 == 0 && v1) *reinterpret_cast<float2*>(pml + (prow + 8) * 2) = make_float2(m[1], l[1]);
  __syncthreads();

  bf16* orow0 = out + ((long long)b * heads + g * groups) * D;
  if (used == 1) {  // the whole row in this split: no merge
    combine<false, D>(pacc, pml, W, groups, wsm, [&](int hh, int d, float4 a, float, float lsum) {
      store4(orow0 + hh * D + d, a, lsum);
    });
    return;
  }
  // this split's state to the workspace, laid out as in the float kernel:
  // acc [blocks][G][D], (m, l) [blocks][G][2], then the tickets
  float* acc_ws = ws;
  float* ml_ws = ws + (long long)gridDim.x * groups * D;
  int* tickets = reinterpret_cast<int*>(ml_ws + (long long)gridDim.x * groups * 2);
  const long long slot = (long long)blockIdx.x * groups;
  combine<false, D>(pacc, pml, W, groups, wsm, [&](int hh, int d, float4 a, float mm, float lsum) {
    *reinterpret_cast<float4*>(acc_ws + (slot + hh) * D + d) = a;
    if (d == 0) *reinterpret_cast<float2*>(ml_ws + (slot + hh) * 2) = make_float2(mm, lsum);
  });
  if (!last_to_arrive(tickets + bg, used)) return;
  // the last block of this (row, KV head) merges its splits, in split order
  combine<true, D>(acc_ws + (long long)bg * nsplit * groups * D,
                   ml_ws + (long long)bg * nsplit * groups * 2, used, groups, wsm,
                   [&](int hh, int d, float4 a, float, float lsum) {
                     store4(orow0 + hh * D + d, a, lsum);
                   });
}

// Launches `kernel` on (b * kvh * nsplit) blocks of `threads`: raises its
// shared-memory limit where it needs more than 48 KB and, when a row spans
// splits, zeroes the tickets behind the partials in the workspace.
template <typename Kernel, typename... Args>
int launch_split(Kernel kernel, size_t smem, int threads, int b, int kvh, int groups, int d,
                 int nsplit, float* ws, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)b * kvh * nsplit;
  if (nsplit > 1) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    int* tickets = reinterpret_cast<int*>(ws + blocks * groups * (d + 2));
    const cudaError_t e = cudaMemsetAsync(tickets, 0, (size_t)b * kvh * sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// One (type, D, page): bf16 with at most 16 query heads per KV head on the
// tensor cores, the rest on the CUDA cores.
template <typename T, int D, int PAGE>
int launch(const void* q, const void* kp, const void* vp, const int* table, const int* lengths,
           void* out, float* ws, int b, int kvh, int groups, int pps, int num_pages,
           int pages_per_split, cudaStream_t stream) {
  const int nsplit = (pps + pages_per_split - 1) / pages_per_split;
  const float scale = (float)(1.0 / sqrt((double)D));
  const size_t ids = (size_t)pages_per_split * sizeof(int);
  const T *qt = (const T*)q, *kt = (const T*)kp, *vt = (const T*)vp;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (groups <= 16) {
      // the rings, the ids, then the merge's weights: [max(W, nsplit) + 2][G]
      const int parts = nsplit > MMA_WARPS ? nsplit : MMA_WARPS;
      const size_t smem = MmaShape<D, PAGE>::SMEM_RING + ids + (size_t)(parts + 2) * groups * 4;
      return launch_split(paged_attention_mma_kernel<D, PAGE>, smem, 32 * MMA_WARPS, b, kvh,
                          groups, D, nsplit, ws, stream, qt, kt, vt, table, lengths, (T*)out, ws,
                          num_pages, pps, kvh, groups, pages_per_split, nsplit, scale);
    }
  }
  // the rings, the warps' p rows, the ids, then the merge's weights
  const size_t smem = 2 * (size_t)Shape<T, D, PAGE>::STAGES * PAGE * D * sizeof(T) +
                      (size_t)groups * PAGE * 4 + ids + (size_t)(nsplit + 2) * groups * 4;
  auto kernel = groups <= 8 ? paged_attention_kernel<T, D, PAGE, 256>
                            : paged_attention_kernel<T, D, PAGE, 1024>;
  return launch_split(kernel, smem, 32 * groups, b, kvh, groups, D, nsplit, ws, stream, qt, kt,
                      vt, table, lengths, (T*)out, ws, num_pages, pps, kvh, pages_per_split,
                      nsplit, scale);
}

}  // namespace

// q, out: (b, h, d); k_pages, v_pages: (num_pages, page, kvh, d), all of one
// type (bf16 when is_bf16, else float32), contiguous and 16-byte aligned;
// table: (b, pps) int32; lengths: (b,) int32.  h a multiple of kvh with
// h / kvh <= 32; d 64 or 128; page 16 or 32.  With nsplit = ceil(pps /
// pages_per_split) > 1, workspace holds b * kvh * nsplit * (h / kvh) * (d + 2)
// floats and then b * kvh ints (zeroed here); with one split it is unused and
// may be null.  Returns the first CUDA error, or cudaGetLastError() after
// the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* lengths, void* out,
                                      void* workspace, int b, int h, int kvh, int d, int page,
                                      int pps, int num_pages, int pages_per_split, int is_bf16,
                                      void* stream) {
  if (b <= 0) return 0;
  if (kvh <= 0 || h % kvh || h / kvh > 32 || pps <= 0 || num_pages <= 0 ||
      pages_per_split <= 0 || pages_per_split > pps)
    return (int)cudaErrorInvalidValue;
  const int groups = h / kvh;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = (cudaStream_t)stream;
#define PA_CASE(DD, PP)                                                                        \
  if (d == DD && page == PP)                                                                   \
    return is_bf16 ? launch<__nv_bfloat16, DD, PP>(q, k_pages, v_pages, tb, ln, out, ws, b,    \
                                                   kvh, groups, pps, num_pages,                \
                                                   pages_per_split, s)                         \
                   : launch<float, DD, PP>(q, k_pages, v_pages, tb, ln, out, ws, b, kvh,       \
                                           groups, pps, num_pages, pages_per_split, s);
  PA_CASE(64, 16)
  PA_CASE(64, 32)
  PA_CASE(128, 16)
  PA_CASE(128, 32)
#undef PA_CASE
  return (int)cudaErrorInvalidValue;
}
