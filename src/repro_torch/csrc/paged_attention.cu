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
// Design: one block per (sequence, KV head), one warp per query head of the
// group (G = H / KVH warps, 8 at TinyLlama's 32 / 4).  The block walks the
// sequence's pages in order; each page's K and V slices for the block's KV
// head (PAGE x D each) are copied into shared memory with 16-byte cp.async
// copies, double-buffered so the next page's copy overlaps this page's math.
// The K rows are stored with their 16-byte chunks XOR-swizzled by token, so
// lanes that each read a different token's row hit distinct banks.  For the
// logits, lane l takes token l % PAGE and, when PAGE is 16, the even or odd
// chunks of the row (one shuffle joins the halves); the page's max and sum
// come from warp shuffles; the probabilities go through shared memory to all
// lanes, each of which accumulates D / 32 output dimensions in registers.
//
// The page id is read through the table for every page (shared ids repeat
// within and across rows).  Pages past a row's length would get probability
// exactly 0 after the first valid page, so they are skipped; a row of length
// 0 keeps all its pages, where every logit is -1e30 and the result is the
// mean of V over all slots, as the reference gives.  An id outside
// [0, num_pages) is clamped, as a JAX gather clamps its index.

#include <cmath>
#include <cstdint>
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int D, int PAGE>
__global__ void __launch_bounds__(1024)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                       const int* __restrict__ table, const int* __restrict__ lengths,
                       T* __restrict__ out, int num_pages, int pps, int kvh, float scale) {
  constexpr int CH = Chunk<T>::N;     // elements per 16-byte chunk
  constexpr int NCH = D / CH;         // chunks per token row (a power of two)
  constexpr int PAGE_CH = PAGE * NCH; // chunks per page of K (or of V)
  constexpr int PARTS = 32 / PAGE;    // lanes per token in the logits
  constexpr int DPL = D / 32;         // output dimensions per lane
  static_assert(PARTS == 1 || PARTS == 2, "PAGE must be 16 or 32");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                  // [2][PAGE][D], chunks swizzled
  T* vs = ks + 2 * PAGE * D;                           // [2][PAGE][D]
  float* qs = reinterpret_cast<float*>(vs + 2 * PAGE * D);  // [G][D], scaled
  const int groups = blockDim.x >> 5;
  float* ps = qs + groups * D;                         // [G][PAGE]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / kvh, g = blockIdx.x % kvh;
  const int heads = kvh * groups, h = g * groups + warp;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min((len + PAGE - 1) / PAGE, pps) : pps;

  auto stage = [&](int i, int buf) {
    int pid = table[(long long)b * pps + i];
    pid = min(max(pid, 0), num_pages - 1);
    const long long row0 = ((long long)pid * PAGE * kvh + g) * D;  // token t at + t * kvh * D
    for (int c = threadIdx.x; c < 2 * PAGE_CH; c += blockDim.x) {
      const int is_v = c >= PAGE_CH;
      const int r = is_v ? c - PAGE_CH : c;
      const int t = r / NCH, ch = r % NCH;
      const long long off = row0 + (long long)t * kvh * D + ch * CH;
      const int phys = is_v ? ch : (ch ^ (t & (NCH - 1)));
      T* dst = (is_v ? vs : ks) + (buf * PAGE + t) * D + phys * CH;
      cp_async16(dst, (is_v ? vp : kp) + off);
    }
    cp_async_commit();
  };

  stage(0, 0);
  const T* qh = q + ((long long)b * heads + h) * D;
  for (int d = lane; d < D; d += 32) qs[warp * D + d] = to_float(qh[d]) * scale;

  const int t = lane % PAGE, part = lane / PAGE;
  const float* qrow = qs + warp * D;
  float m = __int_as_float(0xff800000), l = 0.f, acc[DPL];  // m starts at -inf
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int i = 0; i < n_pages; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_pages) {
      stage(i + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // logit of token t: q . k_t over this lane's chunks
    const T* krow = ks + (buf * PAGE + t) * D;
    float s = 0.f;
#pragma unroll
    for (int ch = part; ch < NCH; ch += PARTS) {
      float kf[CH];
      Chunk<T>::load(krow + (ch ^ (t & (NCH - 1))) * CH, kf);
#pragma unroll
      for (int j = 0; j < CH; j += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + ch * CH + j);
        s = fmaf(qv.x, kf[j], s);
        s = fmaf(qv.y, kf[j + 1], s);
        s = fmaf(qv.z, kf[j + 2], s);
        s = fmaf(qv.w, kf[j + 3], s);
      }
    }
    if (PARTS == 2) s += __shfl_xor_sync(FULL, s, 16);
    s = i * PAGE + t < len ? s : NEG_INF;

    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    float psum = part == 0 ? p : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(FULL, psum, off);
    l = l * corr + psum;
    m = m_new;
    if (part == 0) ps[warp * PAGE + t] = p;
    __syncwarp();

#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= corr;
    const T* vcol = vs + buf * PAGE * D + lane * DPL;
#pragma unroll 4
    for (int tt = 0; tt < PAGE; ++tt) {
      const float pt = ps[warp * PAGE + tt];
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] = fmaf(pt, to_float(vcol[tt * D + j]), acc[j]);
    }
    __syncthreads();  // every warp is done with this buffer and with ps
  }

  const float denom = fmaxf(l, 1e-30f);
  T* o = out + ((long long)b * heads + h) * D + lane * DPL;
#pragma unroll
  for (int j = 0; j < DPL; ++j) store(o + j, acc[j] / denom);
}

template <typename T, int D, int PAGE>
int launch(const void* q, const void* kp, const void* vp, const void* table, const void* lengths,
           void* out, int b, int kvh, int groups, int pps, int num_pages, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, D, PAGE>;
  const size_t smem = 4 * (size_t)PAGE * D * sizeof(T) + (size_t)groups * (D + PAGE) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)b * kvh, 32 * groups, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)table, (const int*)lengths, (T*)out,
      num_pages, pps, kvh, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, int page, const void* q, const void* kp, const void* vp, const void* table,
             const void* lengths, void* out, int b, int kvh, int groups, int pps, int num_pages,
             cudaStream_t stream) {
  if (d == 64 && page == 16)
    return launch<T, 64, 16>(q, kp, vp, table, lengths, out, b, kvh, groups, pps, num_pages, stream);
  if (d == 64 && page == 32)
    return launch<T, 64, 32>(q, kp, vp, table, lengths, out, b, kvh, groups, pps, num_pages, stream);
  if (d == 128 && page == 16)
    return launch<T, 128, 16>(q, kp, vp, table, lengths, out, b, kvh, groups, pps, num_pages, stream);
  if (d == 128 && page == 32)
    return launch<T, 128, 32>(q, kp, vp, table, lengths, out, b, kvh, groups, pps, num_pages, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out: (b, h, d); k_pages, v_pages: (num_pages, page, kvh, d), all of one
// type (bf16 when is_bf16, else float32), contiguous and 16-byte aligned;
// table: (b, pps) int32; lengths: (b,) int32.  h a multiple of kvh with
// h / kvh <= 32; d 64 or 128; page 16 or 32.  Returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* lengths, void* out, int b,
                                      int h, int kvh, int d, int page, int pps, int num_pages,
                                      int is_bf16, void* stream) {
  if (b <= 0) return 0;
  if (kvh <= 0 || h % kvh || h / kvh > 32 || pps <= 0 || num_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const int groups = h / kvh;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(d, page, q, k_pages, v_pages, table, lengths, out, b, kvh,
                                   groups, pps, num_pages, s);
  return dispatch<float>(d, page, q, k_pages, v_pages, table, lengths, out, b, kvh, groups, pps,
                         num_pages, s);
}
