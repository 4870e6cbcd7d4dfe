// Blocked-Bloom batch insert (the paper's GBBF baseline).
//
// Replaces the TPU kernel repro/kernels/bloom.py: bloom_insert_pallas
// (_insert_kernel), which made its read-modify-writes race-free by running
// the grid in order on one core. OR commutes, so the table does not depend
// on the order the atomics land in: it equals the plain version's bit for
// bit.
//
// Design: a group of G lanes owns one key's block at a time, lane w of the
// group word w (G = words_per_block rounded up to a power of two, at most
// 32: two keys a warp at the default 16 words). Each lane first hashes its
// own key and derives its k bit positions once (bloom::BitWalk), in
// registers. The group then walks its G keys: in round r the owner, lane
// r of the group, hands its block index and positions to the group by
// __shfl_sync; each lane keeps the bits that fall in its word (one
// clamped shift a position: 1 << (pos - 32 w) is 0 outside the word) and
// issues one atomic OR (a red.global.or: the result is unused) if its
// mask is not empty. The group's atomics fall in one block, so the
// load/store unit sends one L2 request a 32-byte sector, where one atomic
// a bit sent k. Lanes past n and keys that are not valid take part in
// every shuffle with no bits. Wider blocks (more than 32 words) give each
// lane the words w, w + 32, ...: a round then visits each distinct
// 32-word chunk its key's bits touch. The registers hold KC = 8 positions
// a lane (the default k): a larger k takes its bits 8 at a time, a round
// of atomics each.
//
// Bound: device-memory bytes — each touched 64-byte block read and written
// once (the atomics' read-modify-write stays in L2), 8 key bytes and one
// valid byte in. Where the table is many times the L2, as in the k-mer
// case study, a block has left L2 before most of its next keys come: each
// key's two 32-byte sectors are read and written back at random, and that
// traffic, not the count of atomics, holds the kernel. So, for a table
// larger than L2, each lane first asks L2 for its key's block with a bulk
// prefetch. Beside the bytes, a key costs one hash and its k positions,
// then G lanes x (k + 1) shuffles and k clamped shifts each: at 16 words
// and k = 8 about 40 instructions a lane a round in the SASS, 640 a key in
// the rounds alone, eight times the operations floor. That is what bounds
// the kernel where the table stays in L2.
#include "bloom_common.cuh"

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int KC = 8;  // positions a lane holds at once
// A position no block has: its shift is clamped to 0 in every word.
constexpr uint32_t NO_BIT = 0xFFFFFFFFu;

// 1 << d, and 0 for d >= 32 (PTX clamps the shift amount).
__device__ __forceinline__ uint32_t bit_at(uint32_t d) {
  uint32_t r;
  asm("shl.b32 %0, 1, %1;" : "=r"(r) : "r"(d));
  return r;
}

template <bool WIDE>
__global__ void __launch_bounds__(cuckoo::THREADS)
    bloom_insert_kernel(uint32_t* __restrict__ table,
                        const uint2* __restrict__ keys,
                        const uint8_t* __restrict__ valid, int64_t n,
                        bloom::Geometry g, uint32_t log2_group,
                        bool prefetch) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t group = 1u << log2_group;
  const uint32_t first = lane & ~(group - 1u);  // the group's lane 0
  const uint32_t word = lane - first;           // this lane's word (mod 32)
  // This lane's word in block 0; a block is block_bytes further on.
  char* const lane_base = reinterpret_cast<char*>(table + word);
  const uint32_t block_bytes = g.words_per_block * 4u;
  // No return before the shuffles: a lane without a key carries no bits.
  const bool live = i < n && valid[i];
  const uint2 key = i < n ? keys[i] : make_uint2(0u, 0u);  // (lo, hi)
  bloom::BitWalk walk(key.x, key.y, g);
  // Ask L2 for the key's block now (a bulk prefetch, 16-byte granules): its
  // device-memory read overlaps the positions and the rounds before the
  // group's atomics reach it.
  if (prefetch && live)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                     table + size_t(walk.block) * g.words_per_block),
                 "r"(block_bytes)
                 : "memory");

  for (uint32_t j0 = 0; j0 < g.k; j0 += KC) {
    uint32_t pos[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const uint32_t p = j0 + j < g.k ? walk.next() : NO_BIT;
      pos[j] = live ? p : NO_BIT;
    }
    for (uint32_t r = 0; r < group; ++r) {
      const uint32_t owner = first + r;
      const uint32_t blk = __shfl_sync(FULL, walk.block, owner);
      // One wide multiply-add gives the address; an atomic whose result
      // is unused compiles to a reduction (RED).
      uint32_t* const base = reinterpret_cast<uint32_t*>(
          lane_base + size_t(blk) * block_bytes);
      if (!WIDE) {
        // One word a lane: positions below 32 w and from 32 (w + 1) on
        // give no bit, and so do all of a lane past words_per_block.
        const uint32_t off = word * 32u;
        uint32_t mask = 0;
#pragma unroll
        for (int j = 0; j < KC; ++j)
          mask |= bit_at(__shfl_sync(FULL, pos[j], owner) - off);
        if (mask) atomicOr(base, mask);
      } else {
        uint32_t got[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) got[j] = __shfl_sync(FULL, pos[j], owner);
        // Each chunk of 32 words (1024 bits) once, at its first position.
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const uint32_t chunk = got[c] >> 10;
          bool seen = got[c] == NO_BIT;
#pragma unroll
          for (int j = 0; j < c; ++j) seen |= (got[j] >> 10) == chunk;
          if (seen) continue;
          const uint32_t off = (chunk << 10) + word * 32u;
          uint32_t mask = 0;
#pragma unroll
          for (int j = c; j < KC; ++j) mask |= bit_at(got[j] - off);
          if (mask) atomicOr(base + (chunk << 5), mask);
        }
      }
    }
  }
}

}  // namespace

// table: uint32[num_blocks * words_per_block], updated in place; keys:
// uint32[n, 2] (lo, hi); valid: uint8[n]. Returns the cudaError_t of the
// launch.
CUCKOO_EXPORT int bloom_insert_launch(void* table, const void* keys,
                                      const void* valid, int64_t n,
                                      uint32_t num_blocks,
                                      uint32_t words_per_block, uint32_t k,
                                      uint32_t bits_needed,
                                      uint32_t hash_kind, uint64_t seed,
                                      void* stream) {
  const bloom::Geometry g{num_blocks, words_per_block, k, bits_needed,
                          hash_kind, seed};
  auto* t = static_cast<uint32_t*>(table);
  auto* kk = static_cast<const uint2*>(keys);
  auto* v = static_cast<const uint8_t*>(valid);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(unsigned((n + cuckoo::THREADS - 1) / cuckoo::THREADS));
  if (words_per_block > 32) {
    bloom_insert_kernel<true><<<grid, cuckoo::THREADS, 0, s>>>(t, kk, v, n, g,
                                                              5, false);
  } else {
    uint32_t log2_group = 0;
    while ((1u << log2_group) < words_per_block) ++log2_group;
    // Prefetch only a table that L2 cannot hold: where it can, the blocks
    // are there already and the prefetches only cost issue slots. The bulk
    // prefetch takes 16-byte-aligned multiples of 16 bytes.
    int l2_bytes = 0;
    const int e = bloom::l2_bytes(&l2_bytes);
    if (e != 0) return e;
    const bool prefetch =
        uint64_t(num_blocks) * words_per_block * 4u > uint64_t(l2_bytes) &&
        reinterpret_cast<uintptr_t>(table) % 16 == 0 && words_per_block % 4 == 0;
    bloom_insert_kernel<false><<<grid, cuckoo::THREADS, 0, s>>>(
        t, kk, v, n, g, log2_group, prefetch);
  }
  return int(cudaGetLastError());
}
