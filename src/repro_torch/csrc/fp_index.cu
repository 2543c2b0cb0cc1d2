// Exact fingerprint-index hash table for Hopper (sm_90a): probe, insert,
// remove over one flat int64 table.
//
// Replaces the reference's Pallas kernels `fp_probe_pallas`,
// `fp_insert_pallas` and `fp_remove_pallas` (src/repro/kernels/fp_index.py).
// Slot layout, home hash and window are those of the reference: a slot holds
// a whole key as hi << 32 | lo (EMPTY = 0, TOMBSTONE = all ones), a key's
// logical home is slot_hash(lo, hi) & mask, its physical home adds
// TILE_PAD slots per preceding tile of 2^tile_shift slots, and it lives in
// the WINDOW = 16 slots from there.  The TPU kernels walk keys in order
// inside each tile (one grid step per tile, keys routed to tiles on the
// host); here keys come in batch order, one thread or half-warp each, and
// results go back in batch order: no routing.
//
// What bounds it: per key, 8 B of key, the 32 B sectors of its window up
// to the slot that decides it (its own, or the first EMPTY: no key sits past
// one), and a flag or status -- at load 0.3 about 50 B, 0.4 MB for the 8,192
// keys of one replay batch, ~0.12 us at 3.35 TB/s.  A launch costs more than
// that, so at the main path's batch size launch and host<->device copy
// latency bound it; at millions of keys the random sector reads bound it.
// Probe and insert read each window as one contiguous 128 B line; remove
// still walks it slot by slot (the next index kernel in the queue).
//
// Probe: a half-warp per key; lane i of the half reads slot home + i, so the
// window is one coalesced 128 B read, and __ballot_sync reports a hit.
//
// Insert (the Hopper redesign; PERF.md §6 row 3 dates it): a half-warp per
// key, like the probe, each half-warp taking INSERT_KEYS = 2 keys.  For
// each key:
//   1. lane i reads slot home + i at L2 (ld.relaxed.gpu: a CAS made by
//      another block of the same launch is seen; a load through L1 may be
//      stale), so the window is one 128 B read;
//   2. a ballot of "slot == key" gives PRESENT;
//   3. a ballot of the free slots (EMPTY or TOMBSTONE); the half walks them
//      lowest first: the lane owning the slot does atomicCAS from the value
//      it read to the key and the result goes to the half by shuffle:
//      success -> PLACED (it read EMPTY) or PLACED_TOMB (it read TOMBSTONE);
//      the CAS returned the key -> PRESENT (another copy won); anything
//      else -> clear that bit and try the next free slot;
//   4. no free bit left -> OVERFLOW; the host spills the key.
// The two keys' window reads are in flight together, and so are their
// CASes of a round.  At a million keys a launch is bound by the dependent
// chain of each key (key, window, CAS) times the keys a warp keeps in
// flight, not by bytes: two keys per half-warp halve the chains the card
// waits on.  The two halves of a warp may walk for different numbers of
// rounds: the whole warp loops until both are done, so every _sync call
// names all 32 lanes, the tail warp's lanes past n included.
//
// Why the invariants hold.  During an insert launch a slot only goes from
// free to a key, never back, so a slot read as taken stays taken and every
// slot below the one a key lands in was taken when the key arrived (read
// taken, or tried and lost): no key lands past a slot that was EMPTY when
// it came, the host probe may stop at EMPTY and stays exact, and PLACED and
// PLACED_TOMB stay apart (the host's tombstone count).  Two copies of one
// key try their free slots in the same order, lowest first; the first CAS
// that succeeds is the winner's slot s, and every slot below s holds another
// key for good, so the loser fails there too and then reads s as the key
// (PRESENT by ballot) or tries s and gets the key back from its CAS
// (PRESENT): two copies never both land.  If the window fills, every copy
// reports OVERFLOW, as the sequential kernel's later copies of an
// overflowed key do.  The layout may differ from the sequential kernel's;
// membership and status counts do not.
//
// Remove: one thread per key: find the key in its window and atomicCAS the
// slot from the key to TOMBSTONE; the flag is the CAS's success, so a key
// repeated in one batch is removed once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 16;
constexpr long long TILE_PAD = 128;
constexpr unsigned long long EMPTY = 0ull;
constexpr unsigned long long TOMB = ~0ull;
constexpr int PLACED = 0, PRESENT = 1, OVERFLOW = 2, PLACED_TOMB = 3;
constexpr int THREADS = 256;
constexpr int INSERT_KEYS = 2;  // keys per half-warp in the insert

__device__ __forceinline__ uint32_t slot_hash(uint32_t lo, uint32_t hi) {
  uint32_t x = (lo ^ 0x9E3779B9u) * 2654435761u;
  x ^= x >> 15;
  x = (x + hi) * 2246822519u;
  x ^= x >> 13;
  x *= 3266489917u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ long long phys_home(unsigned long long key, long long mask,
                                               int tile_shift) {
  const long long home = (long long)slot_hash((uint32_t)key, (uint32_t)(key >> 32)) & mask;
  return home + (home >> tile_shift) * TILE_PAD;
}

__global__ void __launch_bounds__(THREADS)
probe_kernel(const unsigned long long* __restrict__ keys, const unsigned long long* __restrict__ table,
             bool* __restrict__ out, long long n, long long mask, int tile_shift) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long i = g >> 4;
  const int lane = (int)(g & 15);
  const bool in = i < n;
  bool hit = false;
  if (in) {
    const unsigned long long key = keys[i];
    hit = table[phys_home(key, mask, tile_shift) + lane] == key;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  const unsigned half = (threadIdx.x & 16) ? (ballot >> 16) : (ballot & 0xffffu);
  if (in && lane == 0) out[i] = half != 0;
}

// A load at L2, so that a CAS made by another block of this launch is seen.
__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(THREADS)
insert_kernel(const unsigned long long* __restrict__ keys, unsigned long long* table,
              int* __restrict__ status, long long n, long long mask, int tile_shift) {
  constexpr int K = INSERT_KEYS;
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long i0 = (g >> 4) * K;  // this half-warp's first key
  const int lane = (int)(g & 15);
  const int shift = threadIdx.x & 16;  // this half's first lane in the warp
  unsigned long long key[K], cur[K], old[K];
  unsigned long long* slot[K];
  unsigned free_bits[K];
  bool done[K];
  int st[K], r[K];
  // all K window reads are in flight together
#pragma unroll
  for (int k = 0; k < K; ++k) {
    key[k] = i0 + k < n ? keys[i0 + k] : EMPTY;
    // the reference kernel's pad key (EMPTY) is skipped and reports PRESENT
    done[k] = key[k] == EMPTY;
    st[k] = PRESENT;
    slot[k] = table + (done[k] ? 0 : phys_home(key[k], mask, tile_shift) + lane);
    cur[k] = done[k] ? EMPTY : load_relaxed(slot[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool live = !done[k];
    const unsigned hit = __ballot_sync(0xffffffffu, live && cur[k] == key[k]) >> shift & 0xffffu;
    free_bits[k] = __ballot_sync(0xffffffffu, live && (cur[k] == EMPTY || cur[k] == TOMB)) >>
                   shift & 0xffffu;
    done[k] = done[k] || hit != 0;
  }
  // a round tries, for every undecided key, its lowest free slot left; the
  // K CASes of a round are in flight together
  while (true) {
    bool pending = false;
#pragma unroll
    for (int k = 0; k < K; ++k) pending = pending || !done[k];
    if (!__any_sync(0xffffffffu, pending)) break;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[k] = done[k] || free_bits[k] == 0 ? -1 : __ffs(free_bits[k]) - 1;  // uniform in the half
      if (lane == r[k]) old[k] = atomicCAS(slot[k], cur[k], key[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // the CAS's outcome, decided by the lane that owns slot r[k]
      int code = -1;
      if (lane == r[k])
        code = old[k] == cur[k] ? (cur[k] == TOMB ? PLACED_TOMB : PLACED)
                                : (old[k] == key[k] ? PRESENT : -1);
      code = __shfl_sync(0xffffffffu, code, shift + max(r[k], 0));
      if (done[k]) continue;
      if (r[k] < 0) {
        st[k] = OVERFLOW;
        done[k] = true;
      } else if (code >= 0) {
        st[k] = code;
        done[k] = true;
      } else {
        free_bits[k] &= free_bits[k] - 1;  // slot r went to another key
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane == k && i0 + k < n) status[i0 + k] = st[k];
}

__global__ void __launch_bounds__(THREADS)
remove_kernel(const unsigned long long* __restrict__ keys, unsigned long long* table,
              bool* __restrict__ out, long long n, long long mask, int tile_shift) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  bool removed = false;
  if (key != EMPTY) {
    volatile unsigned long long* win = table + phys_home(key, mask, tile_shift);
    for (int r = 0; r < WINDOW; ++r) {
      if (win[r] == key) {
        removed = atomicCAS((unsigned long long*)(win + r), key, TOMB) == key;
        break;
      }
    }
  }
  out[i] = removed;
}

inline unsigned blocks_for(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

}  // namespace

// keys: (n,) int64; table: flat int64 of the physical layout; mask: logical
// capacity - 1; tile_shift: log2 of the logical slots per tile.  Each entry
// point returns cudaGetLastError() after its launch.

extern "C" int fp_probe_launch(const void* keys, const void* table, void* out, long long n,
                               long long mask, int tile_shift, void* stream) {
  probe_kernel<<<blocks_for(n * 16), THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (const unsigned long long*)table, (bool*)out, n, mask,
      tile_shift);
  return (int)cudaGetLastError();
}

extern "C" int fp_insert_launch(const void* keys, void* table, void* status, long long n,
                                long long mask, int tile_shift, void* stream) {
  insert_kernel<<<blocks_for((n + INSERT_KEYS - 1) / INSERT_KEYS * 16), THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (unsigned long long*)table, (int*)status, n, mask,
      tile_shift);
  return (int)cudaGetLastError();
}

extern "C" int fp_remove_launch(const void* keys, void* table, void* out, long long n,
                                long long mask, int tile_shift, void* stream) {
  remove_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (unsigned long long*)table, (bool*)out, n, mask,
      tile_shift);
  return (int)cudaGetLastError();
}
