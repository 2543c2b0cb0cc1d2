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
// The design reads each window as one contiguous line.
//
// Probe: a half-warp per key; lane i of the half reads slot home + i, so the
// window is one coalesced 128 B read, and __ballot_sync reports a hit.
//
// Insert: one thread per key, in parallel with 64-bit atomicCAS:
//   1. scan the whole window for the key: found -> PRESENT;
//   2. walk the window in order; at each slot that reads EMPTY or TOMBSTONE,
//      atomicCAS it from the value just read to the key;
//   3. success -> PLACED (it was EMPTY) or PLACED_TOMB (it was a TOMBSTONE);
//   4. failure -> the CAS returned the slot's new value: the key itself ->
//      PRESENT (another copy of the key won), else go on to the next slot;
//      a slot read as holding the key during the walk is PRESENT too;
//   5. window exhausted -> OVERFLOW; the host spills the key.
// Slots only ever go from free to a key during an insert launch, so a key
// never lands past a slot that was EMPTY when it got there (the host probe
// stops at EMPTY and stays exact), PLACED and PLACED_TOMB stay apart (the
// host's tombstone count), and two copies of one key never both land: both
// walk the same slots in the same order, so the loser meets the winner's
// slot.  The layout may differ from the sequential kernel's; membership and
// status counts do not.
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

__global__ void __launch_bounds__(THREADS)
insert_kernel(const unsigned long long* __restrict__ keys, unsigned long long* table,
              int* __restrict__ status, long long n, long long mask, int tile_shift) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  if (key == EMPTY) {  // the reference kernel's pad key: skipped
    status[i] = PRESENT;
    return;
  }
  volatile unsigned long long* win = table + phys_home(key, mask, tile_shift);
  for (int r = 0; r < WINDOW; ++r) {
    if (win[r] == key) {
      status[i] = PRESENT;
      return;
    }
  }
  for (int r = 0; r < WINDOW; ++r) {
    unsigned long long cur = win[r];
    if (cur == key) {
      status[i] = PRESENT;
      return;
    }
    if (cur != EMPTY && cur != TOMB) continue;
    const unsigned long long old =
        atomicCAS((unsigned long long*)(win + r), cur, key);
    if (old == cur) {
      status[i] = (cur == TOMB) ? PLACED_TOMB : PLACED;
      return;
    }
    if (old == key) {
      status[i] = PRESENT;
      return;
    }
  }
  status[i] = OVERFLOW;
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
  insert_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
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
