// The partition of a batch by table window, shared by the windowed routes
// of the blocked-Bloom query (bloom_query.cu) and of the bucket-major bulk
// insert (cuckoo_insert_bulk.cu).
//
// The table is cut into `windows` windows of 2^s units (blocks or
// buckets), a window small enough to stay in L2, and the batch is
// partitioned by window, so that a pass working through the segments in
// order finds each window's units in L2 while its keys are served. Three
// launches before that pass and one after it, no host sync between them:
//   1. count: each tile of TILE keys counts its keys of each window
//      (shared-memory counters) into counts[window][tile];
//   2. scan: one block a window scans its row of counts; the last block
//      to finish turns the row totals into each window's base;
//   3. scatter: each tile takes its keys' slots in its runs (one run a
//      window, in window order) from shared-memory cursors, stages their
//      entries there, and writes each run contiguously into its window's
//      segment; each key's slot goes out as two bytes in input order;
//   (the route's own pass: blocks claim tiles of the concatenated
//    segments in order through an atomic ticket, control[1], and write
//    one answer byte an entry in segment order;)
//   4. un-permute: each tile loads its runs of answers into shared memory
//      and writes out[i] = the answer at key i's slot, in input order.
//
// A partition P says what a key is to the route:
//   bool P::entry(int64_t i, uint2 key, uint2& e) const: false leaves key
//     i out (its answer is 0); else e is its entry;
//   uint32_t P::window(uint2 e) const: the entry's window.
#pragma once

#include "cuckoo_common.cuh"

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int TILE = 4096;          // keys a tile of passes 1, 3 and 4
constexpr int WARPS = cuckoo::THREADS / 32;
constexpr int PER_LANE = TILE / cuckoo::THREADS;  // keys a lane a tile
constexpr int MAX_WINDOWS = 256;    // at most one window a thread
constexpr int SCAN_THREADS = 1024;
// The slot of a key the partition leaves out: past the tile's answers,
// where the un-permute keeps a 0.
constexpr uint16_t NO_SLOT = TILE;
static_assert(MAX_WINDOWS <= cuckoo::THREADS, "tile_runs: a window a thread");
static_assert(TILE < 1 << 16, "a slot in the tile is two bytes");
static_assert(TILE % (4 * cuckoo::THREADS) == 0, "four keys a thread a round");

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
// also clears the scan's and the route's counters.
template <class P>
__global__ void __launch_bounds__(cuckoo::THREADS)
    window_count_kernel(const uint2* __restrict__ keys, int64_t n, P part,
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
    uint2 e;
    if (i < n && part.entry(i, keys[i], e))
      atomicAdd(&cnt[part.window(e)], 1u);
  }
  __syncthreads();
  for (uint32_t w = threadIdx.x; w < windows; w += blockDim.x)
    counts[size_t(w) * stride + blockIdx.x] = cnt[w];
}

// Pass 2: block w turns row w of counts into exclusive offsets within the
// window (four to a thread, coalesced) and writes the row's total to
// bases[w]; the last block to finish turns bases[0..windows] into each
// window's exclusive prefix, bases[windows] = the keys partitioned.
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

// Pass 3: each key's entry into its window's run of its tile (in the
// order the shared-memory cursors hand out the slots), and its slot in
// the tile (NO_SLOT for a key left out) as two bytes in input order.
template <class P>
__global__ void __launch_bounds__(cuckoo::THREADS)
    window_scatter_kernel(const uint2* __restrict__ keys, int64_t n, P part,
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
    uint2 e;
    if (i < n) {
      if (part.entry(i, key[r], e)) {
        const uint32_t at = atomicAdd(&cursor[part.window(e)], 1u);
        stage[at] = e;
        slot[i] = uint16_t(at);
      } else {
        slot[i] = NO_SLOT;
      }
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

// Pass 4: out[i] = the answer at key i's slot (0 at NO_SLOT).
__global__ void __launch_bounds__(cuckoo::THREADS)
    window_unpermute_kernel(const uint16_t* __restrict__ slot,
                            const uint8_t* __restrict__ ans, int64_t n,
                            uint32_t windows, uint32_t stride,
                            const uint32_t* __restrict__ offsets,
                            const uint32_t* __restrict__ bases,
                            uint8_t* __restrict__ out) {
  __shared__ uint8_t answers[TILE + 16];
  __shared__ uint32_t run[MAX_WINDOWS], len[MAX_WINDOWS], dst[MAX_WINDOWS];
  __shared__ uint32_t buf[WARPS + 1];
  // A thread's four keys a round are consecutive: one 8-byte load of their
  // slots and one 4-byte store of their answers (lone bytes at the tail).
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
  if (threadIdx.x == 0) answers[NO_SLOT] = 0;
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
      *reinterpret_cast<uint32_t*>(out + i) = got;
    } else {
      for (int q = 0; q < 4; ++q)
        if (i + q < n) out[i + q] = uint8_t(got >> (8 * q));
    }
  }
}

// The scratch of a windowed route, carved from one buffer: the segments
// (8 bytes a key), counts (windows rows of `stride` words, 16-byte
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

// Whether a windowed route takes these arguments: 1 <= n < 2^31; 1 <
// windows <= MAX_WINDOWS windows of 2^log2_window of the table's `units`
// units, the last one not empty; scratch 16-byte and out 4-byte aligned.
bool windows_fit(int64_t n, uint32_t log2_window, uint32_t windows,
                 uint32_t units, const void* scratch, const void* out) {
  return n >= 1 && n < (int64_t(1) << 31) && windows >= 2 &&
         windows <= MAX_WINDOWS && log2_window <= 31 &&
         (uint64_t(windows) << log2_window) >= units &&
         (uint64_t(windows - 1) << log2_window) < units &&
         reinterpret_cast<uintptr_t>(scratch) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 4 == 0;
}

// Passes 1-3 on the stream.
template <class P>
void partition(const uint2* keys, int64_t n, const P& part, uint32_t windows,
               const Scratch& s, cudaStream_t st) {
  window_count_kernel<P><<<s.tiles, cuckoo::THREADS, 0, st>>>(
      keys, n, part, windows, s.stride, s.counts, s.control);
  window_scan_kernel<<<windows, SCAN_THREADS, 0, st>>>(
      s.counts, s.tiles, s.stride, windows, s.bases, s.control);
  window_scatter_kernel<P><<<s.tiles, cuckoo::THREADS, 0, st>>>(
      keys, n, part, windows, s.stride, s.counts, s.bases, s.seg, s.slot);
}

// Pass 4 on the stream.
void unpermute(int64_t n, uint32_t windows, const Scratch& s, uint8_t* out,
               cudaStream_t st) {
  window_unpermute_kernel<<<s.tiles, cuckoo::THREADS, 0, st>>>(
      s.slot, s.ans, n, windows, s.stride, s.counts, s.bases, out);
}

}  // namespace
