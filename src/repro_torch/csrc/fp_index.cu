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
// host); here keys come in batch order (a group of lanes, a half-warp or a
// thread each) and results go back in batch order: no routing.
//
// What bounds it: per key, 8 B of key, the 32 B sectors of its window up
// to the slot that decides it (its own, or the first EMPTY: no key sits past
// one), and a flag or status -- at load 0.3 about 50 B, 0.4 MB for the 8,192
// keys of one replay batch, ~0.12 us at 3.35 TB/s.  A launch costs more than
// that, so at the main path's batch size launch and host<->device copy
// latency bound it; at millions of keys each key's chain of dependent loads
// (key, window, flag) times the keys the card keeps in flight does.  On the
// main path the keys, and the insert's and remove's results, lie in pinned
// host memory, read and written over the bus (kernels/ops.py): a launch
// takes longer on the card, and the call saves more on the host, than a
// copy each way would (PERF.md §6).
//
// Probe (the Hopper redesign; PERF.md §6 row 2 dates it): a group of
// WALK_LANES = 2 lanes per key, each group taking WALK_KEYS = 2 keys, in
// blocks of WALK_THREADS = 64 so that the 8,192 keys of a replay batch spread
// over every SM.  A key's walk starts at the even slot at or below its home,
// so each lane's 16-byte load (two slots) is aligned and a step of the group
// reads 4 slots: one or two 32 B sectors.  The slot before the home (odd
// homes) and the slots past the window take no part.  A ballot in the group
// decides the key at the first slot that holds it or is EMPTY; only an
// undecided key reads the next step, until the window plus its alignment
// slot is covered (TILE_PAD leaves room for the extra reads at a tile's end).
// The two keys' loads are in flight together.  The table is read-only during
// the launch: loads take the read-only path (__ldg).  Sentinel keys: key 0
// (EMPTY) matches the first EMPTY slot, so its flag is "the window holds an
// EMPTY slot", as the whole-window plain version's.  A TOMBSTONE key is not
// decided by an EMPTY slot (a tombstone left by a key whose home lies past
// that slot may follow it), so it walks to its match or the window's end:
// its flag equals the plain version's too.  FingerprintIndex passes neither
// sentinel to any kernel.
//
// Remove: one thread per key: find the key in its window and atomicCAS the
// slot from the key to TOMBSTONE; the flag is the CAS's success, so a key
// repeated in one batch is removed once.  The flag counts and the membership
// afterwards equal the plain version's; the flag may sit on another copy of
// a repeated key than the plain version's first copy.  A walk of the probe's
// shape with a CAS at the end was no faster (PERF.md §6 row 4): each key's
// random 8-byte write bounds the launch, not its reads.

// Insert (the Hopper redesign; PERF.md §6 row 3 dates it): a half-warp per
// key, each half-warp taking INSERT_KEYS = 2 keys.  For
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

// The probe's walk: WALK_LANES lanes per key, WALK_KEYS keys per group,
// blocks of WALK_THREADS.
constexpr int WALK_LANES = 2;
constexpr int WALK_KEYS = 2;
constexpr int WALK_THREADS = 64;

__global__ void __launch_bounds__(WALK_THREADS)
probe_kernel(const unsigned long long* __restrict__ keys, const unsigned long long* __restrict__ table,
             bool* __restrict__ out, long long n, long long mask, int tile_shift) {
  constexpr int G = WALK_LANES, K = WALK_KEYS;
  constexpr unsigned group_bits = (1u << G) - 1u;
  const long long g = (long long)blockIdx.x * WALK_THREADS + threadIdx.x;
  const long long i0 = g / G * K;  // this group's first key
  const int lane = (int)(g % G);
  const int shift = threadIdx.x & 31 & ~(G - 1);  // the group's first lane in the warp
  unsigned long long key[K];
  long long start[K], end[K];  // the aligned first slot; one past the window
  bool done[K], hit[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool in = i0 + k < n;
    key[k] = in ? keys[i0 + k] : EMPTY;
    const long long home = in ? phys_home(key[k], mask, tile_shift) : 0;
    start[k] = home & ~1LL;
    end[k] = home + WINDOW;
    done[k] = !in;
    hit[k] = false;
  }
  for (long long step = 0;; step += 2 * G) {
    bool pending = false;
#pragma unroll
    for (int k = 0; k < K; ++k) pending = pending || !done[k];
    if (!__any_sync(0xffffffffu, pending)) break;
    // all K loads in flight together
    long long s[K];
    ulonglong2 v[K];
    bool loaded[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = start[k] + step + 2 * lane;
      loaded[k] = !done[k] && s[k] < end[k];
      v[k] = loaded[k] ? __ldg(reinterpret_cast<const ulonglong2*>(table + s[k]))
                       : make_ulonglong2(EMPTY, EMPTY);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // the slots inside the window only: slot s is before the home for an
      // odd home's first pair; s + 1 lies past the window for its last pair
      const bool in0 = loaded[k] && s[k] >= end[k] - WINDOW;
      const bool in1 = loaded[k] && s[k] + 1 < end[k];
      const bool m = (in0 && v[k].x == key[k]) || (in1 && v[k].y == key[k]);
      const bool e = key[k] != TOMB;
      const bool d = m || (in0 && e && v[k].x == EMPTY) || (in1 && e && v[k].y == EMPTY);
      const unsigned hits = __ballot_sync(0xffffffffu, m) >> shift & group_bits;
      const unsigned stops = __ballot_sync(0xffffffffu, d) >> shift & group_bits;
      if (done[k]) continue;
      hit[k] = hits != 0;
      // decided, or the window (and its alignment slot) is covered
      done[k] = stops != 0 || start[k] + step + 2 * G >= end[k];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane == k % G && i0 + k < n) out[i0 + k] = hit[k];
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
  const long long threads = (n + WALK_KEYS - 1) / WALK_KEYS * WALK_LANES;
  probe_kernel<<<(unsigned)((threads + WALK_THREADS - 1) / WALK_THREADS), WALK_THREADS, 0,
                 (cudaStream_t)stream>>>((const unsigned long long*)keys,
                                         (const unsigned long long*)table, (bool*)out, n, mask,
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
