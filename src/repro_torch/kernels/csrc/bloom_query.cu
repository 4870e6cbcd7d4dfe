// Blocked-Bloom batch query (the paper's GBBF baseline).
//
// Replaces the TPU kernel repro/kernels/bloom.py: bloom_query_pallas
// (_query_kernel), which pinned the whole table in VMEM and gathered each
// key's k words. Here the table stays in device memory, and a batch takes
// one of two routes, both computing hit[i] = all k bits of key i's block
// set, with the positions from bloom::BitWalk.
//
// Direct (bloom_query_launch): one thread tests one key. Hash, the k
// (word, bit) pairs of its block, k independent read-only loads. Bound:
// device-memory bytes, each key's block read once, 8 key bytes in and 1
// hit byte out. Where the table is many times the L2 and the keys come in
// random block order, nearly every key fetches its block from device
// memory at random, and the card's rate of random accesses, not their
// bytes, sets the time.
//
// Windowed (bloom_query_windowed_launch), for a large batch on a table
// larger than the L2: the table is cut into windows of 2^s blocks, a
// window small enough to stay in L2, and the batch is partitioned by
// window, so that each window's blocks come from device memory about once
// while its keys are tested. Five launches, no host sync between them:
//   1. count: each tile of TILE keys counts its keys of each window
//      (shared-memory counters) into counts[window][tile];
//   2. scan: one block a window scans its row of counts; the last block
//      to finish turns the row totals into each window's base;
//   3. scatter: each tile takes its keys' slots in its runs (one run a
//      window, in window order) from shared-memory cursors, stages their
//      (block, hash word) pairs there, and writes each run contiguously
//      into its window's segment; each key's slot goes out as two bytes
//      in input order;
//   4. probe: blocks claim tiles of the concatenated segments in order
//      through an atomic ticket, so the tiles in flight cover one or two
//      windows; each entry's bits are tested against its block in L2, and
//      its answer is written as one byte in segment order;
//   5. un-permute: each tile loads its runs of answers into shared memory
//      and writes hit[i] = the answer at key i's slot, in input order.
// A thread's k loads of one block cost the L1 k requests, which hold a
// probe from L2 at about the rate of the direct route from device memory.
// So where a block is 4, 8, 16 or 32 words the warp stages its keys'
// blocks in shared memory first, a lane a 16-byte chunk, so that a warp
// load reads 32 / C whole blocks in C requests (staged_hits).
// The route's own floor: its streamed bytes, 39 a key (the key read twice,
// 16; its entry and slot written and read back, 20; its answer written and
// read back, 2; its hit written, 1), and the table read once. The wrapper
// chooses the route from the shape alone (kernels/bloom.py: query_plan).
#include "bloom_common.cuh"

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int TILE = 4096;          // keys a tile of passes 1, 3, 4 and 5
constexpr int WARPS = cuckoo::THREADS / 32;
constexpr int PER_LANE = TILE / cuckoo::THREADS;  // keys a lane a tile
constexpr int MAX_WINDOWS = 256;    // at most one window a thread
constexpr int SCAN_THREADS = 1024;
static_assert(MAX_WINDOWS <= cuckoo::THREADS, "tile_runs: a window a thread");
static_assert(TILE <= 1 << 16, "a slot in the tile is two bytes");
static_assert(TILE % (4 * cuckoo::THREADS) == 0, "four keys a thread a round");

// The k bits of one key tested with one read-only load each.
__device__ __forceinline__ bool loaded_hit(const uint32_t* __restrict__ table,
                                           const bloom::Geometry& g,
                                           bloom::Hashed hk) {
  // No early exit: the k loads do not depend on each other, so they are
  // all in flight at once.
  uint32_t missing = 0;
  bloom::for_each_bit(bloom::BitWalk(hk, g), g,
                      [&](size_t addr, uint32_t mask) {
                        missing |= ~__ldg(table + addr) & mask;
                      });
  return missing == 0;
}

// Rounds of 32 keys a warp stages at once: two, one for 32-word blocks, so
// that a warp's buffer stays at 4 KiB.
template <int LOG2C>
constexpr int ROUNDS = LOG2C >= 3 ? 1 : 2;

// The hits of R x 32 keys of a warp, one a lane a round (`live` false: no
// key). The warp first copies their blocks into its shared-memory buffer
// `buf` in 16-byte chunks, C = 2^LOG2C a block (words_per_block = 4C):
// lane l of a copy takes chunk l mod C of block l / C, so a warp load
// reads 32 / C whole blocks. Then each lane tests its own key's bits in
// shared memory.
template <int LOG2C, int R = ROUNDS<LOG2C>>
__device__ __forceinline__ void staged_hits(
    const uint32_t* __restrict__ table, const bloom::Geometry& g,
    const bloom::Hashed (&hk)[R], const bool (&live)[R], bool (&hit)[R],
    uint4* buf) {
  constexpr int C = 1 << LOG2C;
  const uint32_t lane = threadIdx.x & 31u;
  const uint4* chunks = reinterpret_cast<const uint4*>(table);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const uint32_t f = i * 32 + lane;
      const uint32_t src = f >> LOG2C;
      const uint32_t blk = __shfl_sync(FULL, hk[r].block, src);
      const bool on = __shfl_sync(FULL, live[r], src);
      if (on)
        buf[r * 32 * C + f] = __ldg(chunks + size_t(blk) * C + (f & (C - 1)));
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(buf + (r * 32 + lane) * C);
    uint32_t missing = 0;
    if (live[r]) {
      bloom::BitWalk w(hk[r], g);
      for (uint32_t j = 0; j < g.k; ++j) {
        const uint32_t pos = w.next();
        missing |= ~words[pos >> 5] & (1u << (pos & 31u));
      }
    }
    hit[r] = missing == 0;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(cuckoo::THREADS)
    bloom_query_kernel(const uint32_t* __restrict__ table,
                       const uint2* __restrict__ keys,
                       uint8_t* __restrict__ hit, int64_t n,
                       bloom::Geometry g) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint2 key = keys[i];  // (lo, hi)
  hit[i] = loaded_hit(table, g, bloom::hash_block(key.x, key.y, g));
}

// Exclusive prefix of v over the block's threads (in thread order); the
// block's total in *total. `buf` holds blockDim / 32 + 1 words. Every
// thread calls.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* buf,
                                                         uint32_t* total) {
  const uint32_t lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, x, d);
    if (lane >= uint32_t(d)) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t run = 0;
    for (uint32_t w = 0; w < blockDim.x / 32; ++w) {
      const uint32_t c = buf[w];
      buf[w] = run;
      run += c;
    }
    buf[blockDim.x / 32] = run;
  }
  __syncthreads();
  const uint32_t out = buf[warp] + x - v;
  *total = buf[blockDim.x / 32];
  __syncthreads();  // buf may be reused at once
  return out;
}

// A tile's runs, one a window in window order: dst[w] the run's first
// position in the segments, len[w] its keys, run[w] its first slot in the
// tile. From the scanned counts (`stride` words a window) and the
// windows' bases (windows + 1 of them). Every thread calls.
__device__ __forceinline__ void tile_runs(
    uint32_t* run, uint32_t* len, uint32_t* dst, uint32_t* buf,
    uint32_t windows, const uint32_t* __restrict__ offsets,
    const uint32_t* __restrict__ bases, uint32_t stride, uint32_t tile) {
  const uint32_t w = threadIdx.x;  // windows <= THREADS: one window a thread
  uint32_t n_w = 0;
  if (w < windows) {
    const uint32_t* row = offsets + size_t(w) * stride;
    const uint32_t first = bases[w] + row[tile];
    const uint32_t end =
        tile + 1 < gridDim.x ? bases[w] + row[tile + 1] : bases[w + 1];
    dst[w] = first;
    len[w] = n_w = end - first;
  }
  uint32_t total;
  const uint32_t at = block_exclusive_scan(n_w, buf, &total);
  if (w < windows) run[w] = at;
  __syncthreads();
}

// Pass 1: counts[w * stride + t] = keys of tile t in window w. Block 0
// also clears the scan's and the probe's counters.
__global__ void __launch_bounds__(cuckoo::THREADS)
    window_count_kernel(const uint2* __restrict__ keys, int64_t n,
                        bloom::Geometry g, uint32_t log2_window,
                        uint32_t windows, uint32_t stride,
                        uint32_t* __restrict__ counts,
                        uint32_t* __restrict__ control) {
  __shared__ uint32_t cnt[MAX_WINDOWS];
  for (uint32_t w = threadIdx.x; w < windows; w += blockDim.x) cnt[w] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) control[0] = control[1] = 0;
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * TILE;
#pragma unroll 4
  for (int r = 0; r < PER_LANE; ++r) {
    const int64_t i = base + r * cuckoo::THREADS + threadIdx.x;
    if (i < n) {
      const uint2 key = keys[i];
      atomicAdd(&cnt[bloom::hash_block(key.x, key.y, g).block >> log2_window],
                1u);
    }
  }
  __syncthreads();
  for (uint32_t w = threadIdx.x; w < windows; w += blockDim.x)
    counts[size_t(w) * stride + blockIdx.x] = cnt[w];
}

// Pass 2: block w turns row w of counts into exclusive offsets within the
// window (four to a thread, coalesced) and writes the row's total to
// bases[w]; the last block to finish turns bases[0..windows] into each
// window's exclusive prefix, bases[windows] = n.
__global__ void __launch_bounds__(SCAN_THREADS)
    window_scan_kernel(uint32_t* __restrict__ counts, uint32_t tiles,
                       uint32_t stride, uint32_t windows,
                       uint32_t* __restrict__ bases,
                       uint32_t* __restrict__ control) {
  __shared__ uint32_t buf[SCAN_THREADS / 32 + 1];
  __shared__ bool last;
  uint4* row = reinterpret_cast<uint4*>(counts + size_t(blockIdx.x) * stride);
  uint32_t carry = 0;
  for (uint32_t t0 = 0; t0 < tiles; t0 += 4 * SCAN_THREADS) {
    const uint32_t t = t0 + 4 * threadIdx.x;
    uint4 v = t < tiles ? row[t / 4] : make_uint4(0u, 0u, 0u, 0u);
    if (t + 1 >= tiles) v.y = 0;  // the row's padding
    if (t + 2 >= tiles) v.z = 0;
    if (t + 3 >= tiles) v.w = 0;
    uint32_t total;
    const uint32_t at =
        carry + block_exclusive_scan(v.x + v.y + v.z + v.w, buf, &total);
    if (t < tiles)
      row[t / 4] = make_uint4(at, at + v.x, at + v.x + v.y,
                              at + v.x + v.y + v.z);
    carry += total;
  }
  if (threadIdx.x == 0) {
    bases[blockIdx.x] = carry;
    __threadfence();
    last = atomicAdd(&control[0], 1u) == windows - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    uint32_t at = 0;
    for (uint32_t w = 0; w < windows; ++w) {
      const uint32_t c = __ldcg(bases + w);
      bases[w] = at;
      at += c;
    }
    bases[windows] = at;
  }
}

// Pass 3: each key's (block, hash word) into its window's run of its tile
// (in the order the shared-memory cursors hand out the slots), and its
// slot in the tile as two bytes in input order.
__global__ void __launch_bounds__(cuckoo::THREADS)
    window_scatter_kernel(const uint2* __restrict__ keys, int64_t n,
                          bloom::Geometry g, uint32_t log2_window,
                          uint32_t windows, uint32_t stride,
                          const uint32_t* __restrict__ offsets,
                          const uint32_t* __restrict__ bases,
                          uint2* __restrict__ seg, uint16_t* __restrict__ slot) {
  __shared__ uint2 stage[TILE];
  __shared__ uint32_t run[MAX_WINDOWS], len[MAX_WINDOWS], dst[MAX_WINDOWS];
  __shared__ uint32_t cursor[MAX_WINDOWS];
  __shared__ uint32_t buf[WARPS + 1];
  // The keys' loads go out before the runs are placed, to overlap both.
  const int64_t base = int64_t(blockIdx.x) * TILE;
  uint2 key[PER_LANE];
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r) {
    const int64_t i = base + r * cuckoo::THREADS + threadIdx.x;
    key[r] = i < n ? keys[i] : make_uint2(0u, 0u);
  }
  tile_runs(run, len, dst, buf, windows, offsets, bases, stride, blockIdx.x);
  if (threadIdx.x < windows) cursor[threadIdx.x] = run[threadIdx.x];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r) {
    const int64_t i = base + r * cuckoo::THREADS + threadIdx.x;
    if (i < n) {
      const bloom::Hashed hk = bloom::hash_block(key[r].x, key[r].y, g);
      const uint32_t at = atomicAdd(&cursor[hk.block >> log2_window], 1u);
      stage[at] = make_uint2(hk.block, hk.h);
      slot[i] = uint16_t(at);
    }
  }
  __syncthreads();
  // Each run contiguous in its segment: a warp a run.
  const uint32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31u;
  for (uint32_t w = warp; w < windows; w += WARPS) {
    const uint32_t from = run[w], to = dst[w];
    for (uint32_t k = lane; k < len[w]; k += 32) seg[to + k] = stage[from + k];
  }
}

// Pass 4: the bits of each segment entry, a tile of TILE entries at a time
// in ticket order. LOG2C >= 0: blocks staged by the warp (staged_hits);
// LOG2C < 0: a thread's own k loads.
template <int LOG2C>
__global__ void __launch_bounds__(cuckoo::THREADS)
    window_probe_kernel(const uint32_t* __restrict__ table,
                        const uint2* __restrict__ seg,
                        uint8_t* __restrict__ ans, int64_t n,
                        bloom::Geometry g, uint32_t* __restrict__ control) {
  constexpr int R = LOG2C >= 0 ? ROUNDS<LOG2C> : 1;
  __shared__ uint4 buf[WARPS][LOG2C >= 0 ? R * 32 << LOG2C : 1];
  __shared__ uint32_t ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(&control[1], 1u);
  __syncthreads();
  const int64_t base = int64_t(ticket) * TILE;
  if constexpr (LOG2C >= 0) {
#pragma unroll 1
    for (int r0 = 0; r0 < PER_LANE; r0 += R) {
      bloom::Hashed hk[R];
      bool live[R], got[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t j = base + (r0 + r) * cuckoo::THREADS + threadIdx.x;
        live[r] = j < n;
        const uint2 e = live[r] ? seg[j] : make_uint2(0u, 0u);
        hk[r] = {e.x, e.y};
      }
      staged_hits<LOG2C>(table, g, hk, live, got, buf[threadIdx.x >> 5]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live[r]) ans[base + (r0 + r) * cuckoo::THREADS + threadIdx.x] = got[r];
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < PER_LANE; ++r) {
      const int64_t j = base + r * cuckoo::THREADS + threadIdx.x;
      if (j >= n) break;
      const uint2 e = seg[j];
      ans[j] = loaded_hit(table, g, bloom::Hashed{e.x, e.y});
    }
  }
}

// Pass 5: hit[i] = the answer at key i's slot.
__global__ void __launch_bounds__(cuckoo::THREADS)
    window_unpermute_kernel(const uint16_t* __restrict__ slot,
                            const uint8_t* __restrict__ ans, int64_t n,
                            uint32_t windows, uint32_t stride,
                            const uint32_t* __restrict__ offsets,
                            const uint32_t* __restrict__ bases,
                            uint8_t* __restrict__ hit) {
  __shared__ uint8_t answers[TILE];
  __shared__ uint32_t run[MAX_WINDOWS], len[MAX_WINDOWS], dst[MAX_WINDOWS];
  __shared__ uint32_t buf[WARPS + 1];
  // A thread's four keys a round are consecutive: one 8-byte load of their
  // slots and one 4-byte store of their hits (lone bytes at the tail).
  constexpr int QUADS = TILE / (4 * cuckoo::THREADS);
  const int64_t base = int64_t(blockIdx.x) * TILE;
  uint2 slots[QUADS];
#pragma unroll
  for (int r = 0; r < QUADS; ++r) {
    const int64_t i = base + 4 * (r * cuckoo::THREADS + threadIdx.x);
    if (i + 4 <= n) {
      slots[r] = *reinterpret_cast<const uint2*>(slot + i);
    } else {
      uint16_t v[4] = {0, 0, 0, 0};
      for (int q = 0; q < 4; ++q)
        if (i + q < n) v[q] = slot[i + q];
      slots[r] = make_uint2(v[0] | uint32_t(v[1]) << 16, v[2] | uint32_t(v[3]) << 16);
    }
  }
  tile_runs(run, len, dst, buf, windows, offsets, bases, stride, blockIdx.x);
  const uint32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31u;
  for (uint32_t w = warp; w < windows; w += WARPS) {
    const uint32_t from = dst[w], to = run[w];
    for (uint32_t k = lane; k < len[w]; k += 32) answers[to + k] = ans[from + k];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < QUADS; ++r) {
    const int64_t i = base + 4 * (r * cuckoo::THREADS + threadIdx.x);
    const uint32_t got = answers[slots[r].x & 0xFFFFu] |
                         uint32_t(answers[slots[r].x >> 16]) << 8 |
                         uint32_t(answers[slots[r].y & 0xFFFFu]) << 16 |
                         uint32_t(answers[slots[r].y >> 16]) << 24;
    if (i + 4 <= n) {
      *reinterpret_cast<uint32_t*>(hit + i) = got;
    } else {
      for (int q = 0; q < 4; ++q)
        if (i + q < n) hit[i + q] = uint8_t(got >> (8 * q));
    }
  }
}

// The scratch of the windowed route, carved from one buffer: the
// segments (8 bytes a key), counts (windows rows of `stride` words, 16-byte
// aligned), bases (windows + 1), two control words, the slots (two bytes a
// key, 16-byte aligned) and the answers (a byte a key).
struct Scratch {
  uint2* seg;
  uint32_t *counts, *bases, *control;
  uint16_t* slot;
  uint8_t* ans;
  uint32_t tiles, stride;
  size_t bytes;
};

Scratch carve(void* base, int64_t n, uint32_t windows) {
  Scratch s;
  s.tiles = uint32_t((n + TILE - 1) / TILE);
  s.stride = (s.tiles + 3) & ~3u;
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t at = 0;
  s.seg = reinterpret_cast<uint2*>(p + at);
  at = (at + 8 * size_t(n) + 15) & ~size_t(15);
  s.counts = reinterpret_cast<uint32_t*>(p + at);
  at += 4 * size_t(s.stride) * windows;
  s.bases = reinterpret_cast<uint32_t*>(p + at);
  at += 4 * (size_t(windows) + 1);
  s.control = reinterpret_cast<uint32_t*>(p + at);
  at = (at + 8 + 15) & ~size_t(15);
  s.slot = reinterpret_cast<uint16_t*>(p + at);
  at += 2 * size_t(n);
  s.ans = reinterpret_cast<uint8_t*>(p + at);
  at += size_t(n);
  s.bytes = (at + 15) & ~size_t(15);
  return s;
}

// log2 of the 16-byte chunks of a block where the blocks can be staged
// (words_per_block 4, 8, 16 or 32 and a 16-byte-aligned table), else -1.
int staged_log2(const void* table, uint32_t words_per_block) {
  if (reinterpret_cast<uintptr_t>(table) % 16) return -1;
  switch (words_per_block) {
    case 4: return 0;
    case 8: return 1;
    case 16: return 2;
    case 32: return 3;
    default: return -1;
  }
}

template <int L>
void launch_probe(const uint32_t* t, const Scratch& s, int64_t n,
                  const bloom::Geometry& g, cudaStream_t st) {
  window_probe_kernel<L><<<s.tiles, cuckoo::THREADS, 0, st>>>(
      t, s.seg, s.ans, n, g, s.control);
}

}  // namespace

// table: uint32[num_blocks * words_per_block]; keys: uint32[n, 2] (lo,
// hi); hit: uint8[n]. Returns the cudaError_t of the launch.
CUCKOO_EXPORT int bloom_query_launch(const void* table, const void* keys,
                                     void* hit, int64_t n,
                                     uint32_t num_blocks,
                                     uint32_t words_per_block, uint32_t k,
                                     uint32_t bits_needed, uint32_t hash_kind,
                                     uint64_t seed, void* stream) {
  const bloom::Geometry g{num_blocks, words_per_block, k, bits_needed,
                          hash_kind, seed};
  const int64_t blocks = (n + cuckoo::THREADS - 1) / cuckoo::THREADS;
  bloom_query_kernel<<<dim3(unsigned(blocks)), cuckoo::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint2*>(keys),
      static_cast<uint8_t*>(hit), n, g);
  return int(cudaGetLastError());
}

// Bytes of scratch the windowed route takes for n keys and `windows`
// windows.
CUCKOO_EXPORT int64_t bloom_query_scratch_bytes(int64_t n, uint32_t windows) {
  return int64_t(carve(nullptr, n, windows).bytes);
}

// The current device's L2 size in bytes, or -(cudaError_t) on failure.
CUCKOO_EXPORT int64_t bloom_query_l2_bytes() {
  int bytes = 0;
  const int e = bloom::l2_bytes(&bytes);
  return e ? -int64_t(e) : int64_t(bytes);
}

// The windowed route: `windows` windows of 2^log2_window blocks (1 <
// windows <= 256, the last one not empty), 1 <= n < 2^31, hit 4-byte
// aligned; scratch: bloom_query_scratch_bytes(n, windows) bytes, 16-byte
// aligned. Returns the cudaError_t of the launches.
CUCKOO_EXPORT int bloom_query_windowed_launch(
    const void* table, const void* keys, void* hit, int64_t n, void* scratch,
    uint32_t log2_window, uint32_t windows, uint32_t num_blocks,
    uint32_t words_per_block, uint32_t k, uint32_t bits_needed,
    uint32_t hash_kind, uint64_t seed, void* stream) {
  if (n < 1 || n >= (int64_t(1) << 31) || windows < 2 ||
      windows > MAX_WINDOWS || log2_window > 31 ||
      (uint64_t(windows) << log2_window) < num_blocks ||
      (uint64_t(windows - 1) << log2_window) >= num_blocks ||
      reinterpret_cast<uintptr_t>(scratch) % 16 ||
      reinterpret_cast<uintptr_t>(hit) % 4)
    return int(cudaErrorInvalidValue);
  const bloom::Geometry g{num_blocks, words_per_block, k, bits_needed,
                          hash_kind, seed};
  const Scratch s = carve(scratch, n, windows);
  const auto* kk = static_cast<const uint2*>(keys);
  const auto* t = static_cast<const uint32_t*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  window_count_kernel<<<s.tiles, cuckoo::THREADS, 0, st>>>(
      kk, n, g, log2_window, windows, s.stride, s.counts, s.control);
  window_scan_kernel<<<windows, SCAN_THREADS, 0, st>>>(
      s.counts, s.tiles, s.stride, windows, s.bases, s.control);
  window_scatter_kernel<<<s.tiles, cuckoo::THREADS, 0, st>>>(
      kk, n, g, log2_window, windows, s.stride, s.counts, s.bases, s.seg,
      s.slot);
  switch (staged_log2(table, words_per_block)) {
    case 0: launch_probe<0>(t, s, n, g, st); break;
    case 1: launch_probe<1>(t, s, n, g, st); break;
    case 2: launch_probe<2>(t, s, n, g, st); break;
    case 3: launch_probe<3>(t, s, n, g, st); break;
    default: launch_probe<-1>(t, s, n, g, st); break;
  }
  window_unpermute_kernel<<<s.tiles, cuckoo::THREADS, 0, st>>>(
      s.slot, s.ans, n, windows, s.stride, s.counts, s.bases,
      static_cast<uint8_t*>(hit));
  return int(cudaGetLastError());
}
