// Fingerprint-frequency histogram (FFH) for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel `ffh_pallas`
// (src/repro/kernels/histogram.py, body `_histogram_kernel`):
// out[j-1] = #{i : min(counts[i], nbins) == j} for j = 1..nbins.  Counts of
// 0 or below fall in no bin; counts above nbins land in the last bin.
//
// What bounds it: each count is read once (4 bytes) and nbins words are
// written, so at N = 2^24 the work is 64 MiB, about 20 us at 3.35 TB/s.  The
// binning is a handful of integer instructions per count, well under the
// ALU budget of the byte rate (about 3 counts per SM per clock), so memory
// bounds it, unless the increments collide.
//
// Design: a grid-stride loop over 16-byte loads (four counts each, four
// loads in flight per thread), and a private histogram per warp in shared
// memory, reduced in the block and added to the output with one atomicAdd
// per bin per block (the wrapper zeroes the output).  Occurrence counts from
// dedup traces are heavy-tailed: most are 1 and many 2, so if every lane
// incremented the shared bin of a 1, the 32 lanes of a warp would serialise
// on one address.  Bins 1 and 2 are therefore counted in registers per
// thread and summed by warp shuffles at the end; only counts of 3 and above
// reach the shared-memory atomics, and those spread over the bins.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_NBINS = 1024;  // WARPS * MAX_NBINS * 4 bytes = 32 KiB of shared memory
constexpr unsigned FULL = 0xffffffffu;

struct Binner {
  int* mine;  // this warp's histogram in shared memory
  int nbins;
  unsigned ones = 0, twos = 0;

  __device__ __forceinline__ void add(int c) {
    const int b = min(c, nbins);
    if (b == 1) {
      ++ones;
    } else if (b == 2) {
      ++twos;
    } else if (b > 2) {
      atomicAdd(mine + b - 1, 1);
    }
  }
  __device__ __forceinline__ void add4(int4 v) {
    add(v.x);
    add(v.y);
    add(v.z);
    add(v.w);
  }
};

__global__ void __launch_bounds__(THREADS)
ffh_kernel(const int* __restrict__ counts, long long n, int nbins, int* __restrict__ out) {
  extern __shared__ int hist[];  // [WARPS][nbins]
  for (int i = threadIdx.x; i < WARPS * nbins; i += THREADS) hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  Binner bin{hist + (threadIdx.x >> 5) * nbins, nbins};
  const long long stride = (long long)gridDim.x * THREADS;
  const long long n4 = n / 4;
  const int4* v = reinterpret_cast<const int4*>(counts);
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const int4 a = __ldg(v + i), b = __ldg(v + i + stride);
    const int4 c = __ldg(v + i + 2 * stride), d = __ldg(v + i + 3 * stride);
    bin.add4(a);
    bin.add4(b);
    bin.add4(c);
    bin.add4(d);
  }
  for (; i < n4; i += stride) bin.add4(__ldg(v + i));
  // the last n % 4 counts
  const long long tail = n4 * 4 + (long long)blockIdx.x * THREADS + threadIdx.x;
  if (tail < n) bin.add(__ldg(counts + tail));

  for (int off = 16; off > 0; off >>= 1) {
    bin.ones += __shfl_xor_sync(FULL, bin.ones, off);
    bin.twos += __shfl_xor_sync(FULL, bin.twos, off);
  }
  if (lane == 0) {
    if (bin.ones) atomicAdd(bin.mine, (int)bin.ones);
    if (bin.twos) atomicAdd(bin.mine + 1, (int)bin.twos);  // nonzero only when nbins >= 2
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nbins; j += THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += hist[w * nbins + j];
    if (s) atomicAdd(out + j, s);
  }
}

}  // namespace

// counts: (n,) int32, 16-byte aligned.  out: (nbins,) int32, zeroed by the
// caller, 1 <= nbins <= 1024.  Returns cudaGetLastError() after the launch.
extern "C" int ffh_launch(const void* counts, long long n, int nbins, void* out, void* stream) {
  if (nbins < 1 || nbins > MAX_NBINS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks to fill every SM several times over, each walking many
  // 16-byte loads, so the per-block reduction stays a small share
  const long long want = (n / 4 + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * 8;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
  ffh_kernel<<<blocks, THREADS, WARPS * nbins * sizeof(int), (cudaStream_t)stream>>>(
      (const int*)counts, n, nbins, (int*)out);
  return (int)cudaGetLastError();
}
