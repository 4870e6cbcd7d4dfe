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
// window (window_route.cuh: count, scan, scatter; an entry is the key's
// (block, hash word)), so that each window's blocks come from device
// memory about once while its keys are tested. Five launches, no host
// sync between them: the partition's three, then the probe, in which
// blocks claim tiles of the concatenated segments in order through an
// atomic ticket, so that the tiles in flight cover one or two windows,
// and test each entry's bits against its block in L2, writing its answer
// as one byte in segment order; then the un-permute back to input order.
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
#include "window_route.cuh"

namespace {

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

// The windowed route's partition: every key, its entry (block, hash word).
struct BloomPartition {
  bloom::Geometry g;
  uint32_t log2_window;

  __device__ __forceinline__ bool entry(int64_t, uint2 key, uint2& e) const {
    const bloom::Hashed hk = bloom::hash_block(key.x, key.y, g);
    e = make_uint2(hk.block, hk.h);
    return true;
  }
  __device__ __forceinline__ uint32_t window(uint2 e) const {
    return e.x >> log2_window;
  }
};

// The probe: the bits of each segment entry, a tile of TILE entries at a time
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
  if (!windows_fit(n, log2_window, windows, num_blocks, scratch, hit))
    return int(cudaErrorInvalidValue);
  const bloom::Geometry g{num_blocks, words_per_block, k, bits_needed,
                          hash_kind, seed};
  const Scratch s = carve(scratch, n, windows);
  const auto* t = static_cast<const uint32_t*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  partition(static_cast<const uint2*>(keys), n,
            BloomPartition{g, log2_window}, windows, s, st);
  switch (staged_log2(table, words_per_block)) {
    case 0: launch_probe<0>(t, s, n, g, st); break;
    case 1: launch_probe<1>(t, s, n, g, st); break;
    case 2: launch_probe<2>(t, s, n, g, st); break;
    case 3: launch_probe<3>(t, s, n, g, st); break;
    default: launch_probe<-1>(t, s, n, g, st); break;
  }
  unpermute(n, windows, s, static_cast<uint8_t*>(hit), st);
  return int(cudaGetLastError());
}
